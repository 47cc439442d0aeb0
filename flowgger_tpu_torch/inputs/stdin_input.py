"""Stdin input.

Parity model: flowgger src/flowgger/input/stdin_input.rs:11-66.
Framing from ``input.framing`` (line, nul or syslen; default line).
"""

from __future__ import annotations

import sys

from . import Input
from ..config import Config, ConfigError
from ..splitters import get_splitter

DEFAULT_FRAMING = "line"


class _PipeStream:
    """``read(n)`` that returns as soon as *some* bytes arrive:
    ``read1`` returns after one raw read — the reference's ``BufReader``
    fill semantics — so a still-open pipe never sits on buffered lines."""

    def __init__(self, buf):
        self.buf = buf

    def read(self, n: int) -> bytes:
        if hasattr(self.buf, "read1"):
            return self.buf.read1(n)
        return self.buf.read(n)


class StdinInput(Input):
    def __init__(self, config: Config):
        framing = config.lookup("input.framing")
        if framing is None:
            framing = DEFAULT_FRAMING
        elif not isinstance(framing, str):
            raise ConfigError(
                'input.framing must be a string set to "line", "nul" or "syslen"'
            )
        self.splitter = get_splitter(framing)

    def accept(self, handler_factory) -> None:
        self.splitter.run(_PipeStream(sys.stdin.buffer), handler_factory())
