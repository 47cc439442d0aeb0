"""Scalar GELF JSON decoder: the byte-identity oracle for the columnar
flat-JSON path (flowgger_tpu_torch/tpu/gelf.py), and for rows the
structural index flags or that exceed ``input.tpu_max_line_len``.

A copy of the JAX package's ``decoders/gelf.py``.  Parity model:
flowgger src/flowgger/decoder/gelf_decoder.rs:34-125.  Known keys: timestamp (f64), host, short_message, full_message, version
(must be 1.0/1.1), level (u64 ≤ 7); every other key becomes an SD pair
(``_``-prefixed if not already).  Keys are processed in *sorted* order —
serde_json 0.8's object is a BTreeMap — which fixes both SD pair order
and which error fires first on multi-error input.  A parse failure from a
raw newline inside a string retries with ``\\n`` escaped
(gelf_decoder.rs:42-48).
"""

from __future__ import annotations

import json

from . import DecodeError, Decoder
from ..record import Record, SDValue, SEVERITY_MAX, StructuredData
from ..utils.timeparse import now_precise

_U64_MAX = (1 << 64) - 1
_I64_MIN = -(1 << 63)


def _as_f64(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


def _as_u64(v):
    if isinstance(v, bool):
        return None
    if isinstance(v, int) and 0 <= v <= _U64_MAX:
        return v
    return None


class GelfDecoder(Decoder):
    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            if e.msg.startswith("Invalid control character"):
                try:
                    obj = json.loads(line.replace("\n", "\\n"))
                except json.JSONDecodeError:
                    raise DecodeError(
                        "Invalid GELF input, unable to parse as a JSON object"
                    )
            else:
                raise DecodeError("Invalid GELF input, unable to parse as a JSON object")
        if not isinstance(obj, dict):
            raise DecodeError("Empty GELF input")

        sd = StructuredData(None)
        ts = None
        hostname = None
        msg = None
        full_msg = None
        severity = None
        for key in sorted(obj.keys()):
            value = obj[key]
            if key == "timestamp":
                ts = _as_f64(value)
                if ts is None:
                    raise DecodeError("Invalid GELF timestamp")
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
                sev = _as_u64(value)
                if sev is None:
                    raise DecodeError("Invalid severity level")
                if sev > SEVERITY_MAX:
                    raise DecodeError("Invalid severity level (too high)")
                severity = sev
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
        return Record(
            ts=ts if ts is not None else now_precise(),
            hostname=hostname,
            severity=severity,
            msg=msg,
            full_msg=full_msg,
            sd=[sd] if sd.pairs else None,
        )
