"""Splitters: turn a byte stream into framed messages and push them
through a Handler.

Parity model: flowgger src/flowgger/splitter/ — trait
``Splitter<T> { run(BufReader<T>, tx, decoder, encoder) }``
(splitter/mod.rs:18-26).  The port's batch handler frames on the card:
when ``handler.wants_raw(framing)`` the line, NUL and syslen splitters
hand it *raw* transport chunks through a per-stream session
(``handler.open_raw``) and do no scanning of their own; record
boundaries — including records split across chunks — are resolved at
flush.  Any other handler (``ScalarHandler``, the scalar input formats'
path) gets one frame at a time from the host splitters, with the
reference's per-line semantics.  ``CapnpSplitter`` builds Records from
the Cap'n Proto wire and bypasses the decoder (``handle_record``).

Stream contract: a binary file-like with ``read(n)`` returning ``b""`` on
EOF; idle timeouts surface as ``TimeoutError`` and end the stream like
the reference's ``WouldBlock``.
"""

from __future__ import annotations

import struct as _struct
import sys
from typing import Optional

from .. import capnp_wire
from ..decoders import DecodeError
from ..encoders import EncodeError
from ..record import FACILITY_MAX, Record, SEVERITY_MAX, StructuredData

_CHUNK = 1 << 16


class Handler:
    """Sink for framed messages coming out of a splitter."""

    quiet_empty = False  # NulSplitter sets this: suppress empty-frame errors
    bare_errors = False  # errors print without the line

    def handle_bytes(self, raw: bytes) -> None:
        raise NotImplementedError

    def handle_record(self, record: Record) -> None:
        """Used by the capnp splitter, which bypasses the decoder."""
        raise NotImplementedError

    def flush(self) -> None:
        """Called at end-of-stream (and by batching handlers on timers)."""

    def wants_raw(self, framing: str) -> bool:
        """A handler that returns True gets *raw* transport chunks via a
        per-stream session (``open_raw``) and finds record boundaries
        itself; the default is the host splitters."""
        return False


class ScalarHandler(Handler):
    """Reference-exact per-line path: utf-8 validate → decode → encode →
    enqueue; errors go to stderr and drop the message
    (line_splitter.rs:17-54)."""

    # applied to every decoded Record before encode (tenancy's template
    # mining and enrichment, tenancy/templates.py); None = no-op
    record_hook = None

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
            record = self.decoder.decode(line)
            if self.record_hook is not None:
                self.record_hook(record)
            encoded = self.encoder.encode(record)
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

    def handle_record(self, record: Record) -> None:
        try:
            if self.record_hook is not None:
                self.record_hook(record)
            encoded = self.encoder.encode(record)
        except EncodeError as e:
            print(e, file=sys.stderr)
            return
        self.tx.put(encoded)


class LineAssembler:
    """Carry-over framing: split incoming chunks on a separator, holding
    the partial tail until the next chunk.  Shared by the host stream
    splitters and the file tailer."""

    def __init__(self, handler: Handler, sep: bytes = b"\n",
                 strip_cr: bool = True):
        self.handler = handler
        self.sep = sep
        self.strip_cr = strip_cr
        self.carry = b""

    def push(self, chunk: bytes) -> None:
        parts = (self.carry + chunk).split(self.sep)
        self.carry = parts.pop()
        for part in parts:
            if self.strip_cr and part.endswith(b"\r"):
                part = part[:-1]
            self.handler.handle_bytes(part)

    def finish(self) -> None:
        """Emit the trailing partial line (BufRead::lines yields it too)."""
        if self.carry:
            part = self.carry
            self.carry = b""
            if self.strip_cr and part.endswith(b"\r"):
                part = part[:-1]
            self.handler.handle_bytes(part)


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


def _read_chunks_split(stream, handler: Handler, sep: bytes,
                       strip_cr: bool) -> None:
    """The host path for line / NUL framing: each chunk split with one
    ``bytes.split``, the partial tail carried to the next chunk."""
    asm = LineAssembler(handler, sep, strip_cr)
    for chunk in _read_stream(stream):
        asm.push(chunk)
    asm.finish()
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
        if handler.wants_raw("line"):
            _run_raw_sep(stream, handler, "line")
        else:
            _read_chunks_split(stream, handler, b"\n", strip_cr=True)


class NulSplitter(Splitter):
    """NUL framing; errors on all-whitespace frames are suppressed
    (nul_splitter.rs:10-49)."""

    def run(self, stream, handler) -> None:
        handler.quiet_empty = True
        if handler.wants_raw("nul"):
            _run_raw_sep(stream, handler, "nul")
        else:
            _read_chunks_split(stream, handler, b"\0", strip_cr=False)


class SyslenSplitter(Splitter):
    """RFC5425-style octet counting: ASCII decimal length, one space, then
    exactly that many bytes (syslen_splitter.rs:10-69)."""

    def run(self, stream, handler) -> None:
        if handler.wants_raw("syslen"):
            _run_raw_syslen(stream, handler)
        else:
            self._run_scalar(stream, handler)

    @staticmethod
    def _mid_body(buf: bytes) -> bool:
        """True when the carry holds a valid length prefix awaiting its
        body — the reference's loop would be in its read-body phase."""
        sp = buf.find(b" ")
        return sp > 0 and buf[:sp].isdigit()

    @staticmethod
    def _run_scalar(stream, handler) -> None:
        buf = b""
        while True:
            # read the length prefix up to the space
            sp = buf.find(b" ")
            while sp < 0:
                try:
                    chunk = stream.read(_CHUNK)
                except TimeoutError:
                    print(
                        "Client hasn't sent any data for a while - Closing idle connection",
                        file=sys.stderr,
                    )
                    handler.flush()
                    return
                except OSError:
                    chunk = b""
                if not chunk:
                    if buf:
                        print("Can't read message's length", file=sys.stderr)
                    handler.flush()
                    return
                buf += chunk
                sp = buf.find(b" ")
            len_s = buf[:sp]
            if not len_s.isdigit():
                print("Can't read message's length", file=sys.stderr)
                handler.flush()
                return
            size = int(len_s)
            buf = buf[sp + 1:]
            while len(buf) < size:
                try:
                    chunk = stream.read(_CHUNK)
                except (TimeoutError, OSError):
                    chunk = b""
                if not chunk:
                    print("failed to fill whole buffer", file=sys.stderr)
                    handler.flush()
                    return
                buf += chunk
            msg, buf = buf[:size], buf[size:]
            handler.handle_bytes(msg)


class CapnpSplitter(Splitter):
    """Binary Cap'n Proto stream; builds Records directly from the wire
    (bypassing the decoder) and hands them to the handler
    (capnp_splitter.rs:15-167)."""

    def run(self, stream, handler) -> None:
        buf = b""

        def read_exact(n: int) -> Optional[bytes]:
            nonlocal buf
            while len(buf) < n:
                try:
                    chunk = stream.read(_CHUNK)
                except TimeoutError:
                    print(
                        "Client hasn't sent any data for a while - Closing idle connection",
                        file=sys.stderr,
                    )
                    return None
                except OSError:
                    return None
                if not chunk:
                    return None
                buf += chunk
            out, buf = buf[:n], buf[n:]
            return out

        while True:
            head = read_exact(4)
            if head is None:
                break
            nseg = _struct.unpack("<I", head)[0] + 1
            table_rest = read_exact(4 * nseg + (4 * nseg + 4) % 8)
            if table_rest is None:
                print("Capnp decoding error: truncated segment table",
                      file=sys.stderr)
                break
            sizes = _struct.unpack_from(f"<{nseg}I", table_rest, 0)
            body = read_exact(8 * sum(sizes))
            if body is None:
                print("Capnp decoding error: truncated message",
                      file=sys.stderr)
                break
            try:
                reader = capnp_wire.parse_message(head + table_rest + body)
                record = _record_from_capnp(reader)
            except _MessageError as e:
                print(e, file=sys.stderr)
                continue
            except (capnp_wire.CapnpDecodeError, _struct.error, IndexError,
                    ValueError, UnicodeDecodeError) as e:
                # malformed wire data ends the stream: the reference logs
                # and closes (capnp_splitter.rs:27-31)
                print(f"Capnp decoding error: {e}", file=sys.stderr)
                break
            handler.handle_record(record)
        handler.flush()


class _MessageError(Exception):
    pass


def _record_from_capnp(reader: "capnp_wire.RecordReader") -> Record:
    """handle_message + get_sd + get_pairs (capnp_splitter.rs:65-167):
    nan/non-positive ts rejected; facility/severity above their max read
    as missing; pairs get the ``_`` prefix; extra pairs only keep string
    values; sd is always present (capnp null text reads as "")."""
    ts = reader.get_ts()
    if ts != ts or ts <= 0.0:
        raise _MessageError("Missing timestamp")
    facility = reader.get_facility()
    severity = reader.get_severity()
    pairs = []
    for name, value in reader.get_pairs():
        if not name.startswith("_"):
            name = f"_{name}"
        pairs.append((name, value))
    for name, value in reader.get_extra():
        if value.kind == value.STRING:
            pairs.append((name, value))
    sd = StructuredData(reader.get_sd_id())
    sd.pairs = pairs
    return Record(
        ts=ts,
        hostname=reader.get_hostname(),
        facility=facility if facility <= FACILITY_MAX else None,
        severity=severity if severity <= SEVERITY_MAX else None,
        appname=reader.get_appname(),
        procid=reader.get_procid(),
        msgid=reader.get_msgid(),
        msg=reader.get_msg(),
        full_msg=reader.get_full_msg(),
        sd=[sd],
    )


def get_splitter(framing: str) -> Splitter:
    """Framing-name → splitter (stdin_input.rs:56-63 match arms)."""
    if framing == "capnp":
        return CapnpSplitter()
    if framing == "line":
        return LineSplitter()
    if framing == "syslen":
        return SyslenSplitter()
    if framing == "nul":
        return NulSplitter()
    from ..config import ConfigError

    raise ConfigError("Unsupported framing scheme")
