"""Size/time-based rotating file writer.

Parity model: flowgger src/flowgger/utils/rotating_file.rs:13-372 and
the JAX package's ``utils/rotating_file.py``.

- size mode (``max_time == 0 and max_size > 0``): when the next write
  would exceed ``max_size``, shift ``base.(n)`` → ``base.(n+1)`` for the
  newest ``max_files`` slots (the extension *replaces* the basename's,
  Rust ``set_extension``) and reopen the base file;
- time mode (``max_time > 0``): writes go to a timestamped file
  ``{stem}-{time_format}.{ext}``; rotation when the deadline passes or
  the size cap is hit, each rotation opening a freshly stamped file;
  ``max_files`` is *not* enforced in this mode (reference behavior);
- append-mode opens, size primed from existing file length.

``now_fn`` is injectable for tests — the reference uses a test-only
``now_time_mock`` field (rotating_file.rs:24-26).
"""

from __future__ import annotations

import os
import sys
import time as _time
from pathlib import Path
from typing import Callable, Optional

from .timeparse import format_time_description


class RotatingFile:
    def __init__(self, basepath: str, max_size: int, max_time: int,
                 max_files: int, time_format: str,
                 now_fn: Callable[[], float] = _time.time):
        self.basename = Path(basepath)
        self.max_size = max_size
        self.max_time = max_time
        self.max_files = max_files
        self.time_format = time_format
        self.now_fn = now_fn
        self.current_file = None
        self.current_size = 0
        self.next_rotation_time: Optional[float] = None

    # -- mode predicates (rotating_file.rs:176-188) ------------------------
    def is_enabled(self) -> bool:
        return self.is_time_triggered() or self.is_size_triggered()

    def is_time_triggered(self) -> bool:
        return self.max_time > 0

    def is_size_triggered(self) -> bool:
        return self.max_time == 0 and self.max_size > 0

    # ----------------------------------------------------------------------
    def _build_timestamped_filename(self) -> Path:
        now = self.now_fn()
        self.next_rotation_time = now + self.max_time * 60
        dt_str = format_time_description(self.time_format, now)
        stem = self.basename.stem
        ext = self.basename.suffix[1:] if self.basename.suffix else ""
        return self.basename.with_name(f"{stem}-{dt_str}.{ext}")

    def open(self):
        path = (self._build_timestamped_filename()
                if self.is_time_triggered() else self.basename)
        # buffering=0: the reference writes straight to the fd (Rust File
        # has no userspace buffer); buffering is opt-in via BufferedWriter.
        self.current_file = open(path, "ab", buffering=0)
        self.current_size = os.fstat(self.current_file.fileno()).st_size

    @staticmethod
    def open_file(path: str):
        return open(path, "ab", buffering=0)

    def _build_file_path(self, file_num: int) -> Path:
        if file_num < 0:
            return self.basename
        return self.basename.with_suffix(f".{file_num}")

    def _rotate_size(self):
        print(f"File {self.basename} reached size limit {self.max_size}, rotating",
              file=sys.stderr)
        if self.current_file is not None:
            self.current_file.close()
            self.current_file = None
        dest = self._build_file_path(self.max_files - 1)
        for file_num in range(self.max_files - 1, -1, -1):
            src = self._build_file_path(file_num - 1)
            try:
                os.rename(src, dest)
            except OSError:  # flowcheck: disable=FC04 -- gaps in the rotation chain are expected (missing older files)
                pass
            dest = src
        self.open()
        self.current_size = 0

    def _rotate_time(self):
        print(
            f"File {self.basename} reached time/size limit "
            f"{self.max_time}min/{self.max_size}bytes, rotating",
            file=sys.stderr,
        )
        if self.current_file is not None:
            self.current_file.close()
            self.current_file = None
        self.open()
        self.current_size = 0

    def _is_rotation_time_reached(self) -> bool:
        return (self.next_rotation_time is not None
                and self.next_rotation_time <= self.now_fn())

    def _is_rotation_size_reached(self, nbytes: int) -> bool:
        return self.max_size > 0 and self.current_size + nbytes > self.max_size

    def _check_rotation_trigger(self, nbytes: int):
        if self.is_time_triggered():
            if self._is_rotation_time_reached() or self._is_rotation_size_reached(nbytes):
                self._rotate_time()
        elif self.is_size_triggered() and self._is_rotation_size_reached(nbytes):
            self._rotate_size()

    # -- Write impl (rotating_file.rs:345-372) -----------------------------
    def write(self, buf: bytes) -> int:
        self._check_rotation_trigger(len(buf))
        self.current_size += len(buf)
        if self.current_file is not None:
            self.current_file.write(buf)
        return len(buf)

    def flush(self):
        if self.current_file is not None:
            self.current_file.flush()

    def close(self):
        if self.current_file is not None:
            self.current_file.close()
            self.current_file = None


class BufferedWriter:
    """Rust-style BufWriter: buffer up to ``capacity`` bytes; a write that
    doesn't fit flushes the buffer first; oversized writes go straight
    through (file_output.rs:172-177 pairs this with RotatingFile)."""

    def __init__(self, inner, capacity: int):
        self.inner = inner
        self.capacity = capacity
        self.buf = bytearray()

    def write(self, data: bytes) -> int:
        if len(self.buf) + len(data) > self.capacity:
            self.flush()
        if len(data) >= self.capacity:
            self.inner.write(data)
        else:
            self.buf.extend(data)
        return len(data)

    def flush(self):
        if self.buf:
            self.inner.write(bytes(self.buf))
            self.buf.clear()
        self.inner.flush()

    def close(self):
        self.flush()
        if hasattr(self.inner, "close"):
            self.inner.close()
