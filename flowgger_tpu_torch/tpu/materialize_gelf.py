"""The GELF Record path, and the scalar oracle row.

Stage 2 of the simdjson-style split: the flat structural index's token
spans → Python values → a ``Record``.  Key routing and error precedence
are the scalar decoder's (``decoders/gelf.py``): duplicate keys keep the
last value, keys are processed in *sorted* order (serde_json 0.8's
BTreeMap), and the special keys timestamp/host/short_message/
full_message/version/level validate with the same messages.  Escaped
strings and all numbers parse with ``json.loads`` on the token span, so
edge cases (\\u escapes, leading zeros, huge exponents) behave exactly
like the oracle's whole-line parse.  A line the index flagged, or one
longer than ``input.tpu_max_line_len``, decodes through the scalar
decoder.  A row without a ``timestamp`` is stamped with the wall clock
here, as the scalar decoder stamps it.

A trimmed copy of the JAX package's ``tpu/materialize_gelf.py``:
``materialize_gelf`` (:32), ``_from_spans`` (:67), ``_scalar_gelf`` (:60)
and ``_PARSE_ERR`` (:28), without its ``fallback_rows`` metric (the port
emits no metrics yet).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from ..decoders import DecodeError
from ..decoders.gelf import GelfDecoder, _I64_MIN, _U64_MAX
from ..record import Record, SDValue, SEVERITY_MAX, StructuredData
from ..utils.timeparse import now_precise
from .jsonidx import VT_FALSE, VT_NULL, VT_NUMBER, VT_STRING, VT_TRUE
from .materialize import LineResult

# the error of a span that does not parse (the scalar decoder's own
# message for a line that does not)
_PARSE_ERR = "Invalid GELF input, unable to parse as a JSON object"
_SCALAR = GelfDecoder()


def materialize_gelf(chunk_bytes: bytes, starts: np.ndarray,
                     orig_lens: np.ndarray, out: Dict[str, np.ndarray],
                     n_real: int, max_len: int) -> List[LineResult]:
    """One LineResult per row, in row order."""
    out = {k: np.asarray(v).tolist() for k, v in out.items()}
    ok = out["ok"]
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
            results.append(_scalar_gelf(line))
            continue
        results.append(_from_spans(line, raw, len(line) == ln, n, out))
    return results


def _scalar_gelf(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)


def _from_spans(line: str, raw: bytes, byte_ok: bool, n: int,
                o: Dict[str, np.ndarray]) -> LineResult:
    def take(a: int, b: int) -> str:
        if byte_ok:
            return line[a:b]
        return raw[a:b].decode("utf-8")

    obj = {}
    try:
        for k in range(int(o["n_fields"][n])):
            ks, ke = int(o["key_start"][n][k]), int(o["key_end"][n][k])
            key = take(ks, ke)
            if o["key_esc"][n][k]:
                key = json.loads(f'"{key}"')
            elif any(ord(c) < 0x20 for c in key):
                raise ValueError("control char")
            vt = int(o["val_type"][n][k])
            vs, ve = int(o["val_start"][n][k]), int(o["val_end"][n][k])
            if vt == VT_STRING:
                value = take(vs, ve)
                if o["val_esc"][n][k]:
                    value = json.loads(f'"{value}"')
                elif any(ord(c) < 0x20 for c in value):
                    raise ValueError("control char")  # oracle rejects too
            elif vt == VT_NUMBER:
                value = json.loads(take(vs, ve))
            elif vt == VT_TRUE:
                value = True
            elif vt == VT_FALSE:
                value = False
            elif vt == VT_NULL:
                value = None
            else:
                raise ValueError("bad token")
            obj[key] = value  # duplicates: last wins, like json.loads
    except (ValueError, json.JSONDecodeError):
        return LineResult(None, _PARSE_ERR, line)

    # sorted-key routing, identical to the scalar oracle
    sd = StructuredData(None)
    ts = None
    hostname = None
    msg = None
    full_msg = None
    severity = None
    try:
        for key in sorted(obj.keys()):
            value = obj[key]
            if key == "timestamp":
                if isinstance(value, bool) or not isinstance(value, (int, float)):
                    raise DecodeError("Invalid GELF timestamp")
                ts = float(value)
            elif key == "host":
                if not isinstance(value, str):
                    raise DecodeError("GELF host name must be a string")
                hostname = value
            elif key == "short_message":
                if not isinstance(value, str):
                    raise DecodeError("GELF short message must be a string")
                msg = value
            elif key == "full_message":
                if not isinstance(value, str):
                    raise DecodeError("GELF full message must be a string")
                full_msg = value
            elif key == "version":
                if not isinstance(value, str):
                    raise DecodeError("GELF version must be a string")
                if value not in ("1.0", "1.1"):
                    raise DecodeError("Unsupported GELF version")
            elif key == "level":
                if isinstance(value, bool) or not isinstance(value, int) or value < 0:
                    raise DecodeError("Invalid severity level")
                if value > SEVERITY_MAX:
                    raise DecodeError("Invalid severity level (too high)")
                severity = value
            else:
                if isinstance(value, str):
                    sval = SDValue.string(value)
                elif isinstance(value, bool):
                    sval = SDValue.bool_(value)
                elif isinstance(value, float):
                    sval = SDValue.f64(value)
                elif isinstance(value, int):
                    if 0 <= value <= _U64_MAX:
                        sval = SDValue.u64(value)
                    elif _I64_MIN <= value < 0:
                        sval = SDValue.i64(value)
                    else:
                        raise DecodeError("Invalid value type in structured data")
                elif value is None:
                    sval = SDValue.null()
                else:
                    raise DecodeError("Invalid value type in structured data")
                name = key if key.startswith("_") else f"_{key}"
                sd.pairs.append((name, sval))
        if hostname is None:
            raise DecodeError("Missing hostname")
    except DecodeError as e:
        return LineResult(None, str(e), line)

    record = Record(
        ts=ts if ts is not None else now_precise(),
        hostname=hostname,
        severity=severity,
        msg=msg,
        full_msg=full_msg,
        sd=[sd] if sd.pairs else None,
    )
    return LineResult(record, None, line)
