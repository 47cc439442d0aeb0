"""Splitters: turn a byte stream into framed messages and push them
through a Handler.

Parity model: flowgger src/flowgger/splitter/ — trait
``Splitter<T> { run(BufReader<T>, tx, decoder, encoder) }``
(splitter/mod.rs:18-26).  The port's batch handler frames on the card:
the line, NUL and syslen splitters hand it *raw* transport chunks
through a per-stream session (``handler.open_raw``) and do no scanning
of their own; record boundaries — including records split across
chunks — are resolved at flush.  ``ScalarHandler`` reproduces the reference's
per-line semantics and serves the rows the kernel sends to the oracle.

Stream contract: a binary file-like with ``read(n)`` returning ``b""`` on
EOF; idle timeouts surface as ``TimeoutError`` and end the stream like
the reference's ``WouldBlock``.
"""

from __future__ import annotations

import sys

from ..decoders import DecodeError
from ..encoders import EncodeError

_CHUNK = 1 << 16


class Handler:
    """Sink for framed messages coming out of a splitter."""

    quiet_empty = False  # NulSplitter sets this: suppress empty-frame errors
    bare_errors = False  # errors print without the line

    def handle_bytes(self, raw: bytes) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Called at end-of-stream (and by batching handlers on timers)."""


class ScalarHandler(Handler):
    """Reference-exact per-line path: utf-8 validate → decode → encode →
    enqueue; errors go to stderr and drop the message
    (line_splitter.rs:17-54)."""

    def __init__(self, tx, decoder, encoder):
        self.tx = tx
        self.decoder = decoder
        self.encoder = encoder

    def handle_bytes(self, raw: bytes) -> None:
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            print("Invalid UTF-8 input", file=sys.stderr)
            return
        self.handle_line(line)

    def handle_line(self, line: str) -> None:
        try:
            encoded = self.encoder.encode(self.decoder.decode(line))
        except (DecodeError, EncodeError) as e:
            self._report_error(e, line)
            return
        self.tx.put(encoded)

    def _report_error(self, e, line: str) -> None:
        if self.bare_errors:
            print(e, file=sys.stderr)
            return
        stripped = line.strip()
        if not (self.quiet_empty and not stripped):
            print(f"{e}: [{stripped}]", file=sys.stderr)


def _read_stream(stream):
    """Yield chunks until EOF; an idle timeout prints the reference's
    WouldBlock close notice (line_splitter.rs:26-33) and ends the stream."""
    while True:
        try:
            chunk = stream.read(_CHUNK)
        except TimeoutError:
            print(
                "Client hasn't sent any data for a while - Closing idle connection",
                file=sys.stderr,
            )
            return
        except OSError:
            return
        if not chunk:
            return
        yield chunk


def _run_raw_sep(stream, handler, framing: str) -> None:
    """Hand every raw chunk to the handler's per-stream session; at EOF
    the session emits a trailing partial frame (BufRead::lines parity)."""
    sess = handler.open_raw(framing)
    for chunk in _read_stream(stream):
        sess.push(chunk)
    sess.finish()
    handler.flush()


def _run_raw_syslen(stream, handler) -> None:
    """Raw chunks to the handler's syslen session; the octet-count scan
    happens at flush (on the card, or the host scan on a decline).
    Stderr parity with the host splitter: an idle timeout and the EOF
    leftover print the same messages, from the session, which owns the
    carry."""
    sess = handler.open_raw("syslen")
    while True:
        try:
            chunk = stream.read(_CHUNK)
        except TimeoutError:
            sess.finish(idle=True)
            return
        except OSError:
            chunk = b""
        if not chunk:
            break
        if not sess.push(chunk):
            # a malformed length prefix: the session printed the host
            # scan's message and went dead; finish() unregisters it
            # (printing nothing more) and the stream closes
            sess.finish()
            handler.flush()
            return
    sess.finish()
    handler.flush()


def _scan_syslen_region(chunk: bytes):
    """``(starts, lens, n, consumed, err)``: the host octet-count scan
    of a region — frames back to back from offset 0, stopping at the
    first incomplete frame; ``err`` when the stop holds a malformed
    length prefix (syslen_splitter.rs:26-52)."""
    import numpy as np

    starts, lens = [], []
    pos = 0
    err = False
    size = len(chunk)
    while pos < size:
        sp = chunk.find(b" ", pos)
        if sp < 0:
            break
        len_s = chunk[pos:sp]
        if not len_s.isdigit():
            err = True
            break
        val = int(len_s)
        if val > 2**31 - 1:
            # int32 span arrays cannot describe such a frame, and
            # buffering one would never complete anyway
            err = True
            break
        if sp + 1 + val > size:
            break
        starts.append(sp + 1)
        lens.append(val)
        pos = sp + 1 + val
    return (np.array(starts, np.int32), np.array(lens, np.int32),
            len(starts), pos, err)


class Splitter:
    def run(self, stream, handler) -> None:
        raise NotImplementedError


class LineSplitter(Splitter):
    """``\\n`` framing with trailing-``\\r`` strip (line_splitter.rs:9-41)."""

    def run(self, stream, handler) -> None:
        _run_raw_sep(stream, handler, "line")


class NulSplitter(Splitter):
    """NUL framing; errors on all-whitespace frames are suppressed
    (nul_splitter.rs:10-49)."""

    def run(self, stream, handler) -> None:
        handler.quiet_empty = True
        _run_raw_sep(stream, handler, "nul")


class SyslenSplitter(Splitter):
    """RFC5425-style octet counting: ASCII decimal length, one space, then
    exactly that many bytes (syslen_splitter.rs:10-69)."""

    def run(self, stream, handler) -> None:
        _run_raw_syslen(stream, handler)

    @staticmethod
    def _mid_body(buf: bytes) -> bool:
        """True when the carry holds a valid length prefix awaiting its
        body — the reference's loop would be in its read-body phase."""
        sp = buf.find(b" ")
        return sp > 0 and buf[:sp].isdigit()


def get_splitter(framing: str) -> Splitter:
    """Framing-name → splitter (stdin_input.rs:56-63 match arms)."""
    if framing == "line":
        return LineSplitter()
    if framing == "nul":
        return NulSplitter()
    if framing == "syslen":
        return SyslenSplitter()
    from ..config import ConfigError

    raise ConfigError(f'input.framing = "{framing}" is not ported yet '
                      "(capnp framing comes in a later slice of "
                      "flowgger_tpu_torch)")
