"""Batched UDP receive via the Linux ``recvmmsg(2)`` syscall (ctypes,
no external deps).

The reference's UDP input performs one ``recv_from`` syscall per
datagram (udp_input.rs:78-82).  For the batched pipeline on the card
that loop is the ingest bottleneck, so this binding pulls up to ``vlen``
datagrams per syscall into one resident buffer and hands back (offsets,
lengths) arrays that flow straight into the batch handler's span ingest
(``BatchHandler.ingest_spans``) — no per-datagram Python objects for
well-formed traffic.  ``available()`` is False off Linux and callers keep
the portable loop.  A copy of the JAX package's ``utils/recvmmsg.py``,
except that a receive polls for the first datagram and drains without
blocking (:meth:`BatchReceiver.recv_batch`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import socket
from typing import Optional, Tuple

import numpy as np

from ..inputs.udp_input import MAX_UDP_PACKET_SIZE


class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p),
                ("iov_len", ctypes.c_size_t)]


class _MsgHdr(ctypes.Structure):
    _fields_ = [("msg_name", ctypes.c_void_p),
                ("msg_namelen", ctypes.c_uint32),
                ("msg_iov", ctypes.POINTER(_IoVec)),
                ("msg_iovlen", ctypes.c_size_t),
                ("msg_control", ctypes.c_void_p),
                ("msg_controllen", ctypes.c_size_t),
                ("msg_flags", ctypes.c_int)]


class _MMsgHdr(ctypes.Structure):
    _fields_ = [("msg_hdr", _MsgHdr),
                ("msg_len", ctypes.c_uint32)]


_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        try:
            lib = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                              use_errno=True)
            lib.recvmmsg
            _libc = lib
        except (OSError, AttributeError):  # flowcheck: disable=FC04 -- availability probe; caller falls back to recvfrom
            _libc = False
    return _libc


def available() -> bool:
    import sys

    return bool(sys.platform.startswith("linux") and _get_libc())


class BatchReceiver:
    """Reusable recvmmsg state for one socket: ``vlen`` iovecs of
    ``MAX_UDP_PACKET_SIZE`` bytes over one resident buffer."""

    def __init__(self, sock: socket.socket, vlen: int = 64):
        self._libc = _get_libc()
        if not self._libc:
            raise OSError("recvmmsg unavailable")
        self.sock = sock
        self.vlen = vlen
        self._buf = np.empty(vlen * MAX_UDP_PACKET_SIZE, dtype=np.uint8)
        base = self._buf.ctypes.data
        self._iovecs = (_IoVec * vlen)()
        self._hdrs = (_MMsgHdr * vlen)()
        for i in range(vlen):
            self._iovecs[i].iov_base = base + i * MAX_UDP_PACKET_SIZE
            self._iovecs[i].iov_len = MAX_UDP_PACKET_SIZE
            h = self._hdrs[i].msg_hdr
            h.msg_name = None
            h.msg_namelen = 0
            h.msg_iov = ctypes.pointer(self._iovecs[i])
            h.msg_iovlen = 1
            h.msg_control = None
            h.msg_controllen = 0
            h.msg_flags = 0
        self._starts = (np.arange(vlen, dtype=np.int64)
                        * MAX_UDP_PACKET_SIZE)
        self._poll = None

    def recv_batch(self, timeout_ms: int = 500
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Wait (at most ``timeout_ms``) for one datagram, then drain
        whatever else is already queued, up to ``vlen``, in one recvmmsg
        (MSG_DONTWAIT).  Returns (buffer view, starts, lens) for n >= 1
        datagrams, or None on a timeout, EINTR or EAGAIN.  The JAX
        package's receiver blocks in the call itself (MSG_WAITFORONE),
        which sandboxed kernels such as gVisor's reject with EINVAL; a
        poll first and a non-blocking drain after keep the contract and
        run there too."""
        import errno as _errno
        import select

        fd = self.sock.fileno()
        if fd < 0:
            raise OSError(_errno.EBADF, "socket closed")
        if self._poll is None:
            self._poll = select.poll()
            self._poll.register(fd, select.POLLIN)
        if not self._poll.poll(timeout_ms):
            return None
        MSG_DONTWAIT = 0x40
        n = self._libc.recvmmsg(fd, self._hdrs, self.vlen, MSG_DONTWAIT,
                                None)
        if n <= 0:
            err = ctypes.get_errno()
            if err in (_errno.EBADF, _errno.ENOTSOCK, _errno.EINVAL):
                # socket closed under us: surface instead of hot-spinning
                raise OSError(err, "socket closed")
            return None
        lens = np.fromiter((self._hdrs[i].msg_len for i in range(n)),
                           dtype=np.int64, count=n)
        return self._buf, self._starts[:n], lens
