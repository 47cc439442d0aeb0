"""Host helpers between the decode channels and the block encoder: the
f64 timestamp from the kernel's calendar channels, and the scalar
oracle for rows the kernel flagged (``ok=False``) or that exceed
``tpu_max_line_len`` — so errors and edge cases stay byte-identical with
the reference's per-line behavior (line_splitter.rs:37-39).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..decoders import DecodeError
from ..decoders.rfc5424 import RFC5424Decoder
from ..record import Record

_SCALAR = RFC5424Decoder()


def compute_ts(out: Dict[str, np.ndarray]) -> np.ndarray:
    """Vectorized f64 timestamps from the kernel's int32 components —
    the same integer-nanos-then-divide the oracle uses, so results are
    bit-identical."""
    epoch = (
        out["days"].astype(np.int64) * 86400
        + out["sod"].astype(np.int64)
        - out["off"].astype(np.int64)
    )
    nanos = out["nanos"].astype(np.int64)
    with np.errstate(over="ignore"):
        ts = (epoch * 1_000_000_000 + nanos) / 1e9
    # |epoch| beyond ~year 2262 overflows int64 nanos; redo those rows with
    # exact Python integers (the oracle's arithmetic is arbitrary-precision)
    big = np.abs(epoch) > 9_000_000_000
    if big.any():
        for i in np.flatnonzero(big):
            ts[i] = (int(epoch[i]) * 1_000_000_000 + int(nanos[i])) / 1e9
    return ts


class LineResult:
    """Either a Record or a per-line decode error (message, line)."""

    __slots__ = ("record", "error", "line")

    def __init__(self, record: Optional[Record], error: Optional[str], line: str):
        self.record = record
        self.error = error
        self.line = line


def _scalar_line(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
