"""Mergers: output framing applied by the sink consumer.

Parity model: flowgger src/flowgger/merger/ — trait
``Merger { frame(&self, bytes: &mut Vec<u8>) }`` (merger/mod.rs:30-32).
Python bytes are immutable so ``frame`` returns the framed value; the
reference's in-place unsafe shift (syslen_merger.rs:20-28) is just a
concatenation here.
"""

from __future__ import annotations


class Merger:
    def frame(self, data: bytes) -> bytes:
        raise NotImplementedError


class LineMerger(Merger):
    """Append ``\\n`` (line_merger.rs:13-17)."""

    def __init__(self, config=None):
        pass

    def frame(self, data: bytes) -> bytes:
        return data + b"\n"


class NulMerger(Merger):
    """Append ``\\0`` (nul_merger.rs:13-17)."""

    def __init__(self, config=None):
        pass

    def frame(self, data: bytes) -> bytes:
        return data + b"\0"


class SyslenMerger(Merger):
    """Prepend ``"{len} "`` and append ``\\n``; the length counts the
    payload plus the trailing newline (syslen_merger.rs:14-31)."""

    def __init__(self, config=None):
        pass

    def frame(self, data: bytes) -> bytes:
        return f"{len(data) + 1} ".encode("ascii") + data + b"\n"
