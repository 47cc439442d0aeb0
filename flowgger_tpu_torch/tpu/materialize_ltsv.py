"""The LTSV Record path, and the scalar oracle row.

Rows the ltsv decode accepted become Records from their spans: schema
typing (ltsv_decoder.rs:23-84) runs here through the handler's scalar
decoder's ``_typed_pair`` (its schema and suffixes), the special keys
route as the decode found them, and the scalar path's side effects stay
(the "Missing value for name" notices on stdout, the error precedence).
A line the decode flagged, or one longer than
``input.tpu_max_line_len``, decodes through the scalar decoder
(``decoders/ltsv.py``), so its bytes, errors and notices are the
reference's.

A trimmed copy of the JAX package's ``tpu/materialize_ltsv.py``:
``materialize_ltsv`` (:23), ``_from_spans`` (:61) and ``_scalar_ltsv``,
without its ``fallback_rows`` metric (the port emits no metrics yet).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..decoders import DecodeError
from ..decoders.ltsv import LTSVDecoder
from ..record import Record, StructuredData
from .materialize import LineResult, compute_ts

_SPECIAL = ("time", "host", "message", "level")


def materialize_ltsv(chunk_bytes: bytes, starts: np.ndarray,
                     orig_lens: np.ndarray, out: Dict[str, np.ndarray],
                     n_real: int, max_len: int,
                     decoder: LTSVDecoder) -> List[LineResult]:
    """One LineResult per row, in row order."""
    ts_rfc = compute_ts(out).tolist()
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
        if not ok[n] or ln > max_len:
            results.append(_scalar_ltsv(decoder, line))
            continue
        results.append(_from_spans(line, raw, len(line) == ln, n, o,
                                   ts_rfc, decoder))
    return results


def _scalar_ltsv(decoder: LTSVDecoder, line: str) -> LineResult:
    try:
        return LineResult(decoder.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)


def _from_spans(line: str, raw: bytes, byte_ok: bool, n: int,
                o: Dict[str, list], ts_rfc: list,
                decoder: LTSVDecoder) -> LineResult:
    def take(a: int, b: int) -> str:
        if a < 0 or b < a:
            return ""
        if byte_ok:
            return line[a:b]
        return raw[a:b].decode("utf-8")

    if int(o["ts_kind"][n]) == 0:
        ts = float(ts_rfc[n])
    else:
        ts = float(take(int(o["ts_start"][n]), int(o["ts_end"][n])))
    hostname = take(int(o["host_start"][n]), int(o["host_end"][n])) \
        if int(o["host_pos"][n]) >= 0 else None
    msg = take(int(o["msg_start"][n]), int(o["msg_end"][n])) \
        if int(o["msg_pos"][n]) >= 0 else None
    level = int(o["level_val"][n])
    severity = level if level >= 0 else None

    sd = StructuredData(None)
    try:
        for k in range(int(o["n_parts"][n])):
            ps, pe = int(o["part_start"][n][k]), int(o["part_end"][n][k])
            cp = int(o["colon_pos"][n][k])
            if cp < 0 or cp >= pe:
                print(f"Missing value for name '{take(ps, pe)}'")
                continue
            key = take(ps, cp)
            if key in _SPECIAL:
                continue  # routed by the decode
            sd.pairs.append(decoder._typed_pair(key, take(cp + 1, pe)))
    except DecodeError as e:
        return LineResult(None, str(e), line)

    record = Record(ts=ts, hostname=hostname, severity=severity, msg=msg,
                    full_msg=line, sd=[sd] if sd.pairs else None)
    return LineResult(record, None, line)
