"""Inputs (transports): drive the splitter → handler pipeline.

Parity model: flowgger src/flowgger/input/ — trait
``Input { accept(tx, decoder, encoder) }`` (input/mod.rs:33-40), taking a
handler factory instead of decoder+encoder: each connection or worker
asks the factory for its handler (a ``*_tpu`` pipeline hands every one
the same batch handler, a scalar pipeline a new ``ScalarHandler`` each).

Two additions the port makes to the reference's contract, both for the
pipeline's drain: :meth:`Input.stop` closes what ``accept`` waits on, so
it returns, and a failure on a connection or worker thread goes to
``on_failure`` (the pipeline's keeper of the run's first failure, which
then ends the run) instead of ending only its thread.
"""

from __future__ import annotations

import threading
import time


class Input:
    # the pipeline's failure keeper: called with the exception that ended
    # a connection or worker thread (None: the thread dies with it, as in
    # the reference)
    on_failure = None
    _stopping = False

    def accept(self, handler_factory) -> None:
        """Run the transport until it ends or :meth:`stop` is called;
        ``handler_factory(peer=...)`` returns the handler the splitter
        feeds (``peer``: the source's identity, peer IP or file path)."""
        raise NotImplementedError

    def stop(self) -> None:
        """Make :meth:`accept` return: transports close their listeners
        and stop their workers (stdin has nothing to close: its read ends
        at EOF)."""
        self._stopping = True

    def _guarded(self, target, *args) -> None:
        """Run one connection's or worker's loop; a failure goes to
        ``on_failure`` when the pipeline set one."""
        try:
            target(*args)
        except BaseException as e:  # flowcheck: disable=FC04 -- handed to the pipeline, which ends the run and raises it
            if self.on_failure is None:
                raise
            self.on_failure(e)

    # -- per-connection handler-thread lifecycle ---------------------------
    # Thread-per-connection transports (tcp/tls) spawn through here so
    # every handler is tracked: finished ones are reaped on each accept
    # (the set stays bounded by live connections), and the drain can
    # wait, boundedly, for the rest through join_handlers().

    def _spawn_handler(self, target, args: tuple) -> None:
        """Start a tracked daemon thread for one connection."""
        lock = self.__dict__.setdefault("_handlers_lock", threading.Lock())
        t = threading.Thread(target=self._guarded, args=(target, *args),
                             daemon=True)
        with lock:
            live = {h for h in self.__dict__.get("_handlers", ())
                    if h.is_alive()}
            live.add(t)
            self._handlers = live
        t.start()

    def join_handlers(self, timeout: float = 2.0) -> int:
        """Drain hook: wait (boundedly, across ALL handlers) for in-flight
        connection handlers to finish; returns how many are still alive
        (abandoned daemon threads)."""
        lock = self.__dict__.setdefault("_handlers_lock", threading.Lock())
        with lock:
            live = [h for h in self.__dict__.get("_handlers", ())
                    if h.is_alive()]
        deadline = time.monotonic() + timeout
        for t in live:
            t.join(max(0.0, deadline - time.monotonic()))
        with lock:
            self._handlers = {h for h in live if h.is_alive()}
            return len(self._handlers)


from .stdin_input import StdinInput  # noqa: E402

__all__ = ["Input", "StdinInput"]
