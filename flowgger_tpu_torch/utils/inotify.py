"""Minimal inotify binding via ctypes (no external deps).

The reference's file input reacts to filesystem events through the
notify crate (input/file/discovery.rs:44-87, worker.rs:37-78); this is
the equivalent capability on raw libc: ``inotify_init1`` /
``inotify_add_watch`` plus ``os.read`` of the event stream, with
``select`` supplying bounded waits so callers stay responsive to stop
flags.  ``available()`` is False off Linux (or in sandboxes rejecting
the syscalls) and callers fall back to polling.  A copy of the JAX
package's ``utils/inotify.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import select
import struct
import sys
import threading
from typing import List, Optional, Tuple

IN_ACCESS = 0x001
IN_MODIFY = 0x002
IN_ATTRIB = 0x004
IN_CLOSE_WRITE = 0x008
IN_MOVED_FROM = 0x040
IN_MOVED_TO = 0x080
IN_CREATE = 0x100
IN_DELETE = 0x200
IN_DELETE_SELF = 0x400
IN_MOVE_SELF = 0x800
IN_IGNORED = 0x8000
IN_ISDIR = 0x40000000

_EVENT_HEAD = struct.Struct("iIII")

_libc = None
_libc_lock = threading.Lock()


def _get_libc():
    global _libc
    with _libc_lock:
        if _libc is None:
            try:
                _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                                    use_errno=True)
                _libc.inotify_init1
                _libc.inotify_add_watch
            except (OSError, AttributeError):  # flowcheck: disable=FC04 -- availability probe; caller falls back to polling
                _libc = False
        return _libc


def available() -> bool:
    if not sys.platform.startswith("linux"):
        return False
    libc = _get_libc()
    if not libc:
        return False
    # some sandboxes stub the symbol but fail the syscall: probe once
    fd = libc.inotify_init1(os.O_CLOEXEC)
    if fd < 0:
        return False
    os.close(fd)
    return True


class Inotify:
    """One inotify instance; thread-safe adds, single reader."""

    def __init__(self):
        libc = _get_libc()
        if not libc:
            raise OSError("inotify unavailable")
        self._libc = libc
        self.fd = libc.inotify_init1(os.O_CLOEXEC)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._closed = False

    def add_watch(self, path: str, mask: int) -> int:
        wd = self._libc.inotify_add_watch(
            self.fd, os.fsencode(path), ctypes.c_uint32(mask))
        if wd < 0:
            raise OSError(ctypes.get_errno(),
                          f"inotify_add_watch failed for {path}")
        return wd

    def read(self, timeout_s: Optional[float] = None
             ) -> List[Tuple[int, int, int, str]]:
        """Blocking (bounded by ``timeout_s``) read of pending events:
        [(wd, mask, cookie, name)], empty list on timeout/close."""
        if self._closed:
            return []
        try:
            r, _, _ = select.select([self.fd], [], [], timeout_s)
        except (OSError, ValueError):  # flowcheck: disable=FC04 -- fd closed mid-select; caller treats [] as quiet
            return []
        if not r:
            return []
        try:
            buf = os.read(self.fd, 65536)
        except OSError:  # flowcheck: disable=FC04 -- watch fd gone; caller treats [] as quiet
            return []
        events = []
        pos = 0
        while pos + _EVENT_HEAD.size <= len(buf):
            wd, mask, cookie, nlen = _EVENT_HEAD.unpack_from(buf, pos)
            pos += _EVENT_HEAD.size
            name = buf[pos:pos + nlen].split(b"\0", 1)[0].decode(
                "utf-8", "surrogateescape")
            pos += nlen
            events.append((wd, mask, cookie, name))
        return events

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                os.close(self.fd)
            except OSError:  # flowcheck: disable=FC04 -- fd already dead; close is best-effort
                pass
