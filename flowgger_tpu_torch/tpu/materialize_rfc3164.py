"""The RFC3164 Record path, and the scalar oracle row.

Fast-path rows — the standard single-spaced ``[<pri>]Mon d hh:mm:ss host
msg`` layout the rfc3164 decode accepts (tpu/rfc3164.py) — become
Records from their spans; a line the decode flagged, one longer than
``input.tpu_max_line_len`` or one with multi-byte characters decodes
through the scalar decoder (``decoders/rfc3164.py``), so its bytes and
errors are the reference's.

A trimmed copy of the JAX package's ``tpu/materialize_rfc3164.py``:
``materialize_rfc3164`` (:22) and ``_scalar_3164``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..decoders import DecodeError
from ..decoders.rfc3164 import RFC3164Decoder
from ..record import Record
from .materialize import LineResult, compute_ts

_SCALAR = RFC3164Decoder()


def materialize_rfc3164(chunk_bytes: bytes, starts: np.ndarray,
                        orig_lens: np.ndarray, out: Dict[str, np.ndarray],
                        n_real: int, max_len: int) -> List[LineResult]:
    """One LineResult per row, in row order."""
    ts = compute_ts(out).tolist()
    o = {k: np.asarray(v).tolist() for k, v in out.items()}
    ok = o["ok"]
    results: List[LineResult] = []
    for n in range(n_real):
        s = int(starts[n])
        ln = int(orig_lens[n])
        raw = chunk_bytes[s:s + ln]
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            results.append(LineResult(None, "__utf8__", ""))
            continue
        if not ok[n] or ln > max_len or len(line) != ln:
            results.append(_scalar_3164(line))
            continue
        has_pri = o["has_pri"][n]
        record = Record(
            ts=float(ts[n]),
            hostname=line[o["host_start"][n]:o["host_end"][n]],
            facility=o["facility"][n] if has_pri else None,
            severity=o["severity"][n] if has_pri else None,
            msg=line[o["msg_start"][n]:],
            full_msg=line,
            sd=None,
        )
        results.append(LineResult(record, None, line))
    return results


def _scalar_3164(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
