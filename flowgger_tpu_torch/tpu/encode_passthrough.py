"""Columnar-to-passthrough encode, per row (a copy of the JAX package's
``tpu/encode_passthrough.py``): decode-ok RFC5424 rows emit their raw
line (BOM-stripped, whitespace-rtrimmed) without materializing Records
— the passthrough encoder's output *is* ``full_msg``
(passthrough_encoder.rs:22-46), which for these rows is a byte slice.
Rows the decode flagged, over-length rows and non-ASCII rows take the
scalar decoder and the encoder.

The batch handler's Record path takes it for rfc5424 into passthrough
with no ``syslog_prepend_timestamp`` (the reference's
``_encode_packed_rfc5424_gelf``), which no pipeline config reaches: such
a config takes the block route, and one with the prepend set takes the
Record path through the encoder (both packages).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..encoders import EncodeError
from .encode_gelf import EncodedResult
from .materialize import _scalar_line


def encode_rfc5424_passthrough(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
) -> List[EncodedResult]:
    ok = np.asarray(out["ok"]).tolist()
    full_start = np.asarray(out["full_start"]).tolist()
    starts_l = starts.tolist() if hasattr(starts, "tolist") else starts
    lens_l = orig_lens.tolist() if hasattr(orig_lens, "tolist") else orig_lens
    results: List[EncodedResult] = []
    for n in range(n_real):
        s = starts_l[n]
        ln = lens_l[n]
        raw = chunk_bytes[s:s + ln]
        if ok[n] and ln <= max_len and raw.isascii():
            results.append(EncodedResult(raw[full_start[n]:].rstrip(), None, ""))
            continue
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            results.append(EncodedResult(None, "__utf8__", ""))
            continue
        res = _scalar_line(line)
        if res.record is None:
            results.append(EncodedResult(None, res.error, line))
            continue
        try:
            results.append(EncodedResult(encoder.encode(res.record), None, line))
        except EncodeError as e:
            results.append(EncodedResult(None, str(e), line))
    return results
