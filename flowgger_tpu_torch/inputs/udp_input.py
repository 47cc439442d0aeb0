"""UDP input: one datagram = one message, with transparent zlib/gzip
decompression.

Parity model: flowgger src/flowgger/input/udp_input.rs:12-143.
Magic sniffing: zlib = 0x78 {0x01,0x9c,0xda} with length >= 8; gzip =
1f 8b 08 with length >= 24.  Max datagram 65,527 bytes; decompression is
bounded at 5x the max packet size (the reference sizes its buffer to
that ratio; here the bound is enforced, rejecting bombs).  A handler with
``ingest_spans`` (the batch handler of a ``*_tpu`` pipeline) takes the
recvmmsg path: up to 64 datagrams a syscall, the plain ones handed over
as one region with a span each.
"""

from __future__ import annotations

import errno
import socket
import sys
import zlib

from . import Input
from ..config import Config
from ..splitters import Handler
from .tcp_input import parse_listen

DEFAULT_LISTEN = "0.0.0.0:514"
MAX_UDP_PACKET_SIZE = 65_527
MAX_COMPRESSION_RATIO = 5
_MAX_DECOMPRESSED = MAX_UDP_PACKET_SIZE * MAX_COMPRESSION_RATIO
# compression magic, shared between the scalar sniffing path and the
# vectorized recvmmsg classifier so the two can never drift
ZLIB_MIN_LEN = 8
ZLIB_MAGIC0 = 0x78
ZLIB_MAGIC1 = (0x01, 0x9C, 0xDA)
GZIP_MIN_LEN = 24
GZIP_MAGIC = (0x1F, 0x8B, 0x08)


def _inflate(data: bytes, wbits: int) -> bytes:
    """Decompress with the expansion bounded *during* decompression (no
    bomb-sized allocation); a bomb raises like corrupt data."""
    d = zlib.decompressobj(wbits=wbits)
    out = d.decompress(data, _MAX_DECOMPRESSED)
    if d.unconsumed_tail:
        raise zlib.error("compression bomb")
    return out + d.flush()


def handle_record_maybe_compressed(data: bytes, handler: Handler) -> None:
    """Sniff compression magic, inflate, hand off; errors go to stderr
    (udp_input.rs:100-123 semantics, messages included)."""
    if (len(data) >= ZLIB_MIN_LEN and data[0] == ZLIB_MAGIC0
            and data[1] in ZLIB_MAGIC1):
        try:
            out = _inflate(data, zlib.MAX_WBITS)
        except zlib.error:
            print("Corrupted compressed (gzip/zlib) record", file=sys.stderr)
            return
        handler.handle_bytes(out)
    elif len(data) >= GZIP_MIN_LEN and data[:3] == bytes(GZIP_MAGIC):
        try:
            # wbits=47: zlib-or-gzip auto-detect
            out = _inflate(data, 47)
        except zlib.error:
            print("Corrupted compressed (gzip) record", file=sys.stderr)
            return
        handler.handle_bytes(out)
    else:
        handler.handle_bytes(data)


class UdpInput(Input):
    def __init__(self, config: Config):
        listen = config.lookup_str(
            "input.listen", "input.listen must be an ip:port string", DEFAULT_LISTEN)
        self.listen = parse_listen(listen)
        self.bound_port = None
        self._sock = None

    def accept(self, handler_factory) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            try:
                self._sock.bind(self.listen)
            except OSError:
                raise RuntimeError(
                    f"Unable to listen to {self.listen[0]}:{self.listen[1]}")
            self.bound_port = self._sock.getsockname()[1]
            self._serve(self._sock, handler_factory)
        finally:
            self._sock.close()

    def stop(self) -> None:
        """Wake a blocked receive: a shutdown of the unconnected socket
        sets its receive side down (the call reports ENOTCONN, and the
        receive returns); the loops see the flag and return."""
        self._stopping = True
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:  # flowcheck: disable=FC04 -- ENOTCONN on a datagram socket; the receive wakes all the same
                pass

    def _serve(self, sock, handler_factory) -> None:
        handler = handler_factory()
        handler.bare_errors = True
        if hasattr(handler, "ingest_spans"):
            from ..utils import recvmmsg as _rm

            if _rm.available():
                if self._accept_batched(sock, handler):
                    return  # socket closed: normal exit
                # the syscall exists but doesn't work (sandboxed/old
                # kernels return EINVAL/ENOSYS): degrade to recvfrom
                # instead of silently killing the input
                print("recvmmsg unusable on this kernel; falling back to "
                      "per-datagram recvfrom", file=sys.stderr)
        # per-source handlers; bounded cache (spoofed-source floods must
        # not grow it forever)
        per_src: dict = {}
        while not self._stopping:
            try:
                data, src = sock.recvfrom(MAX_UDP_PACKET_SIZE)
            except OSError as e:
                # a closed socket must end the loop (so the pipeline can
                # drain), not busy-spin on EBADF forever
                if e.errno == errno.EBADF or sock.fileno() < 0:
                    return
                continue
            if self._stopping:
                return
            h = handler
            if src:
                h = per_src.get(src[0])
                if h is None:
                    if len(per_src) >= 1024:
                        per_src.clear()
                    h = handler_factory(peer=src[0])
                    h.bare_errors = True
                    per_src[src[0]] = h
            handle_record_maybe_compressed(data, h)

    def _accept_batched(self, sock, handler) -> bool:
        """recvmmsg fast path for span-capable handlers: up to 64
        datagrams per syscall; plain datagrams compact into one chunk
        and flow as frame spans with zero per-datagram Python, while
        compressed ones (zlib/gzip magic) take the sniffing path.
        Relative ordering between plain and compressed datagrams of one
        batch is unspecified — UDP guarantees no ordering anyway.

        Returns True on a normal exit (socket closed) and False when the
        syscall itself is unusable before ever delivering a batch, so
        the caller can fall back to the scalar recvfrom loop."""
        import numpy as np

        from ..tpu.assemble import concat_segments, exclusive_cumsum
        from ..utils.recvmmsg import BatchReceiver

        rx = BatchReceiver(sock)
        delivered = False
        while not self._stopping:
            try:
                got = rx.recv_batch()
            # flowcheck: disable=FC04 -- availability probe: False falls back to the recvfrom loop
            except OSError as e:
                if not delivered and e.errno in (
                        errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP):
                    return False
                return True
            if got is None or self._stopping:
                continue
            delivered = True
            buf, starts, lens = got
            b0 = buf[starts]
            b1 = buf[starts + 1]
            b2 = buf[starts + 2]
            zlibm = (lens >= ZLIB_MIN_LEN) & (b0 == ZLIB_MAGIC0) & (
                (b1 == ZLIB_MAGIC1[0]) | (b1 == ZLIB_MAGIC1[1])
                | (b1 == ZLIB_MAGIC1[2]))
            gzm = ((lens >= GZIP_MIN_LEN) & (b0 == GZIP_MAGIC[0])
                   & (b1 == GZIP_MAGIC[1]) & (b2 == GZIP_MAGIC[2]))
            special = zlibm | gzm
            clean = ~special
            if clean.any():
                cs, cl = starts[clean], lens[clean]
                chunk = concat_segments(buf, cs, cl).tobytes()
                new_starts = exclusive_cumsum(cl)[:-1].astype(np.int32)
                handler.ingest_spans(chunk, new_starts,
                                     cl.astype(np.int32))
            for i in np.flatnonzero(special).tolist():
                s = int(starts[i])
                handle_record_maybe_compressed(
                    bytes(buf[s:s + int(lens[i])]), handler)
        return True
