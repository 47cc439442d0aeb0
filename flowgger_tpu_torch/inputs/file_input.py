"""File input: tail files matching a glob, discovering new ones.

Parity model: flowgger src/flowgger/input/file/{mod,discovery,worker}.rs.
``input.src`` is a glob; matching files that exist at startup are tailed
from EOF (worker.rs:89-91), files appearing later are read from the
start.  Discovery and tailing are inotify-driven (utils/inotify.py, the
equivalent of the reference's notify-crate watchers: parent directories
watched for Create/MovedTo — discovery.rs:44-87 — and each tailed file
for Modify — worker.rs:37-78), with a polling fallback on platforms
without inotify.  Truncation (size shrinks) rewinds to the new end,
matching follow-reader behavior; logrotate's rename-create ends the old
worker and starts a fresh one at the path, read from the start.  A
``*_tpu`` pipeline hands every worker the same batch handler (the lines
are framed on the host, one ``handle_bytes`` each).
"""

from __future__ import annotations

import glob as _glob
import os
import sys
import threading
import time

from . import Input
from ..config import Config, ConfigError
from ..utils import inotify as _ino

POLL_INTERVAL_S = 0.05        # fallback tail poll (no inotify)
DISCOVERY_INTERVAL_S = 0.5    # fallback discovery poll
STOP_CHECK_S = 0.5            # bounded event waits keep stop responsive


class FileWorker:
    def __init__(self, path: str, handler, from_tail: bool,
                 use_inotify: bool):
        self.path = path
        self.handler = handler
        self.from_tail = from_tail
        self.use_inotify = use_inotify
        self.stop = threading.Event()
        self.open_failed = False

    def run(self):
        try:
            fd = open(self.path, "rb")
        except OSError as e:
            self.open_failed = True
            print(f"Failed to open file {self.path}: {e}", file=sys.stderr)
            return
        with fd:
            self._tail(fd)

    def _tail(self, fd) -> None:
        if self.from_tail:
            fd.seek(0, os.SEEK_END)
        from ..splitters import LineAssembler

        asm = LineAssembler(self.handler)
        watcher = None
        if self.use_inotify:
            try:
                watcher = _ino.Inotify()
                watcher.add_watch(
                    self.path,
                    _ino.IN_MODIFY | _ino.IN_DELETE_SELF | _ino.IN_MOVE_SELF
                    | _ino.IN_ATTRIB | _ino.IN_CLOSE_WRITE)
            except OSError:  # flowcheck: disable=FC04 -- no inotify watch: the poll loop below still tails the file
                watcher = None
        try:
            while not self.stop.is_set():
                chunk = fd.read(1 << 16)
                if chunk:
                    asm.push(chunk)
                    continue
                # drained: check for truncation/deletion
                try:
                    size = os.path.getsize(self.path)
                except OSError:  # flowcheck: disable=FC04 -- file removed (logrotate); reap() starts a fresh worker
                    return
                if size < fd.tell():
                    fd.seek(0, os.SEEK_END)
                self.handler.flush()
                if watcher is not None:
                    events = watcher.read(STOP_CHECK_S)
                    if any(m & (_ino.IN_DELETE_SELF | _ino.IN_MOVE_SELF)
                           for _, m, _, _ in events):
                        return
                else:
                    time.sleep(POLL_INTERVAL_S)
        finally:
            if watcher is not None:
                watcher.close()


class FileInput(Input):
    def __init__(self, config: Config):
        src = config.lookup("input.src")
        if src is None:
            raise ConfigError("input.src is missing")
        if not isinstance(src, str):
            raise ConfigError("input.src must be a string")
        self.src = src
        self.use_inotify = _ino.available()
        self._stop_event = threading.Event()
        self._workers: dict = {}

    def stop(self) -> None:
        """Stop discovery and every worker (each within its bounded event
        wait); ``accept`` returns once they have."""
        self._stopping = True
        self._stop_event.set()

    def accept(self, handler_factory) -> None:
        workers = self._workers

        def start_worker(path: str, from_tail: bool):
            worker = FileWorker(path, handler_factory(peer=path),
                                from_tail, self.use_inotify)
            t = threading.Thread(target=self._guarded, args=(worker.run,),
                                 daemon=True, name=f"file-worker-{path}")
            t.start()
            workers[path] = (worker, t)

        def reap() -> bool:
            # drop finished workers so a vanished or atomically replaced
            # file (logrotate's rename+create) can start a fresh worker
            # reading from the start — EXCEPT unopenable files that
            # still exist, which stay parked instead of restarting in a
            # spawn/stderr loop
            reaped = False
            for path in list(workers):
                worker, t = workers[path]
                if t.is_alive():
                    continue
                if worker.open_failed and os.path.exists(path):
                    continue
                del workers[path]
                reaped = True
            return reaped

        try:
            for path in _glob.glob(self.src):
                if os.path.isfile(path):
                    start_worker(path, from_tail=True)
            if self.use_inotify:
                self._discover_inotify(start_worker, workers, reap)
            else:
                while not self._stop_event.wait(DISCOVERY_INTERVAL_S):
                    for path in _glob.glob(self.src):
                        if os.path.isfile(path) and path not in workers:
                            start_worker(path, from_tail=False)
                    reap()
        finally:
            for worker, _t in workers.values():
                worker.stop.set()
            for _worker, t in list(workers.values()):
                t.join(STOP_CHECK_S * 4)

    def _discover_inotify(self, start_worker, workers, reap) -> None:
        """Event-driven discovery: watch every directory the glob's
        parent pattern matches for Create/MovedTo (discovery.rs:44-87);
        new directories matching the parent pattern are watched as they
        appear, new files matching the glob start workers immediately."""
        ino = _ino.Inotify()
        try:
            self._discover_loop(ino, start_worker, workers, reap)
        finally:
            ino.close()

    def _discover_loop(self, ino, start_worker, workers, reap) -> None:
        dir_mask = (_ino.IN_CREATE | _ino.IN_MOVED_TO | _ino.IN_CLOSE_WRITE)
        watched = {}  # wd -> dir path

        # ancestor pattern chain: every wildcarded prefix of the glob's
        # directory part plus the first concrete ancestor, so creation
        # of an intermediate directory (e.g. the `*` in /logs/*/app.log)
        # is itself observable before any matching file exists
        dir_patterns = []
        p = os.path.dirname(self.src) or "."
        while True:
            dir_patterns.append(p)
            if not _glob.has_magic(p):
                break
            parent = os.path.dirname(p)
            if not parent or parent == p:
                break
            p = parent

        def watch_dirs():
            for pat in dir_patterns:
                for d in _glob.glob(pat):
                    if os.path.isdir(d) and d not in watched.values():
                        try:
                            wd = ino.add_watch(d, dir_mask)
                            watched[wd] = d
                        except OSError:  # flowcheck: disable=FC04 -- directory vanished mid-walk; the next event rescans
                            pass

        def rescan_files():
            # race closure: files that appeared before a watch went live
            for path in _glob.glob(self.src):
                if os.path.isfile(path) and path not in workers:
                    start_worker(path, from_tail=False)

        watch_dirs()
        rescan_files()

        while not self._stop_event.is_set():
            events = ino.read(STOP_CHECK_S)
            for wd, mask, _cookie, name in events:
                if mask & _ino.IN_IGNORED:
                    # the kernel dropped this watch (directory deleted
                    # or moved): forget it so a recreated directory gets
                    # re-watched, and rescan for anything created in the
                    # unwatched window
                    watched.pop(wd, None)
                    watch_dirs()
                    rescan_files()
                    continue
                base = watched.get(wd)
                if base is None or not name:
                    continue
                path = os.path.join(base, name)
                if mask & _ino.IN_ISDIR:
                    # a new directory may extend the watchable chain and
                    # may already contain matching files
                    watch_dirs()
                    rescan_files()
                    continue
                if (path not in workers and os.path.isfile(path)
                        and path in _glob.glob(self.src)):
                    # glob (not fnmatch) so event-driven discovery keeps
                    # glob's hidden-file semantics, same as the startup
                    # scan and the poll fallback
                    start_worker(path, from_tail=False)
            if reap():
                # a finished worker may have been replaced by a new file
                # whose create event raced the old entry: rescan now
                rescan_files()
