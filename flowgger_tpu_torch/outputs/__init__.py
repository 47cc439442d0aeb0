"""Outputs (sinks): consumer threads draining the bounded queue.

Parity model: flowgger src/flowgger/output/ — trait
``Output { start(arx, merger) }`` (output/mod.rs:21-30): ``start`` spawns
the worker thread and returns it; a ``None`` item is the shutdown
sentinel.  The port has the file (buffered and rotating), stdout /
debug, TLS and Kafka sinks; the TLS and Kafka sinks start
``tls_threads`` / ``kafka_threads`` workers and return the list.

A sink thread that dies of an exception hands it to ``on_failure`` (the
pipeline's keeper of the run's first failure, which then ends the run
non-zero), where the reference's supervisor would restart the sink.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..block import EncodedBlock
from ..mergers import Merger

SHUTDOWN = None


def stream_bytes(item, merger: Optional[Merger]) -> bytes:
    """Wire bytes for byte-stream sinks.  EncodedBlock items are
    pre-framed by the producer with the pipeline's merger, so they are
    written wholesale; plain items get framed here, matching the
    reference's consumer loop (file_output.rs:203-216)."""
    if isinstance(item, EncodedBlock):
        return item.data
    return merger.frame(item) if merger is not None else item


class Output:
    # the pipeline's failure keeper (None: the thread dies with it)
    on_failure = None

    def start(self, arx, merger: Optional[Merger]):
        """Start the sink's worker threads; returns the list of them."""
        raise NotImplementedError

    def spawn(self, target, name: str) -> threading.Thread:
        t = threading.Thread(target=self._guarded, args=(target,),
                             name=name, daemon=True)
        t.start()
        return t

    def _guarded(self, target) -> None:
        try:
            target()
        except BaseException as e:  # flowcheck: disable=FC04 -- handed to the pipeline, which ends the run and raises it
            if self.on_failure is None:
                raise
            self.on_failure(e)


from .debug_output import DebugOutput  # noqa: E402
from .file_output import FileOutput  # noqa: E402

__all__ = ["Output", "DebugOutput", "FileOutput", "SHUTDOWN"]
