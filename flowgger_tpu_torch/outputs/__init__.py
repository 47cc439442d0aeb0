"""Outputs (sinks): consumer threads draining the bounded queue.

Parity model: flowgger src/flowgger/output/ — trait
``Output { start(arx, merger) }`` (output/mod.rs:21-30): ``start`` spawns
the worker thread and returns it; a ``None`` item is the shutdown
sentinel.  This slice ports the file and stdout sinks.
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
    def start(self, arx, merger: Optional[Merger]) -> threading.Thread:
        raise NotImplementedError

    @staticmethod
    def spawn(target, name: str) -> threading.Thread:
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        return t


from .debug_output import DebugOutput  # noqa: E402
from .file_output import FileOutput  # noqa: E402

__all__ = ["Output", "DebugOutput", "FileOutput", "SHUTDOWN"]
