"""Snappy block-format codec (raw, un-framed): the compression Kafka's
record batches v2 name ``attributes = 2``.

Parity model: the JAX package's ``utils/snappy.py`` — the reference gets
snappy from the kafka crate (kafka_output.rs:169-196); this is the
from-scratch equivalent.  Both directions run the native host tier's
``fg_snappy_compress`` / ``fg_snappy_decompress``
(``csrc/flowgger_host.cpp``, greedy 64 KiB-block hash matching).  The
JAX package falls back to Python (all-literal blocks) when its library
is missing; the port raises, as the rest of its native tier does
(README deviation).
"""

from __future__ import annotations

from .. import native as _native


class SnappyError(Exception):
    pass


def compress(data: bytes) -> bytes:
    return _native.snappy_compress(data)


def _read_varint(data: bytes, pos: int):
    v = 0
    shift = 0
    while pos < len(data):
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7
        if shift > 35:
            break
    raise SnappyError("bad varint preamble")


def decompress(data: bytes) -> bytes:
    ulen, _ = _read_varint(data, 0)
    out = _native.snappy_decompress(data, ulen)
    if out is None:
        raise SnappyError("malformed snappy block")
    return out
