"""Scalar JSON-lines decoder — the byte-identity oracle for the columnar
structural-index path (flowgger_tpu_torch/tpu/jsonl.py).

One JSON object per line.  There is no version handshake and every key
is optional:

- ``timestamp`` (number) → ``Record.ts`` (absent → receive time);
- ``host`` (string) → hostname (absent → empty, rendered per encoder);
- ``message`` (string) → msg;
- ``level`` (integer 0..7) → severity;
- every other key becomes a typed SD pair, ``_``-prefixed when not
  already (the GELF additional-field convention);
- nested objects/arrays become STRING pairs holding their compact JSON
  re-serialization (``json.dumps(v, separators=(",", ":"))``) — the
  columnar path materializes the same value from the container's span.

Keys are processed in *sorted* order, which pins both SD pair order and
which error fires first on multi-error input.
"""

from __future__ import annotations

import json

from . import DecodeError, Decoder
from ..record import Record, SDValue, SEVERITY_MAX, StructuredData
from ..utils.timeparse import now_precise

_U64_MAX = (1 << 64) - 1
_I64_MIN = -(1 << 63)

PARSE_ERR = "Invalid JSON-lines input, unable to parse as a JSON object"


def nested_json(value) -> str:
    """THE compact re-serialization of a nested container value —
    single-sourced so the oracle and the columnar materializer
    (tpu/materialize_jsonl.py) cannot drift."""
    return json.dumps(value, separators=(",", ":"))


def route_obj(obj: dict) -> Record:
    """THE sorted-key routing/validation of one parsed object into a
    Record — shared by the oracle and the columnar materializer, which
    builds the same dict from token spans.  Raises DecodeError."""
    sd = StructuredData(None)
    ts = None
    hostname = None
    msg = None
    severity = None
    for key in sorted(obj.keys()):
        value = obj[key]
        if key == "timestamp":
            if isinstance(value, bool) or not isinstance(
                    value, (int, float)):
                raise DecodeError("Invalid JSON-lines timestamp")
            ts = float(value)
        elif key == "host":
            if not isinstance(value, str):
                raise DecodeError("JSON-lines host must be a string")
            hostname = value
        elif key == "message":
            if not isinstance(value, str):
                raise DecodeError("JSON-lines message must be a string")
            msg = value
        elif key == "level":
            if isinstance(value, bool) or not isinstance(value, int) \
                    or value < 0:
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
                    raise DecodeError(
                        "Invalid value type in structured data")
            elif value is None:
                sval = SDValue.null()
            elif isinstance(value, (dict, list)):
                sval = SDValue.string(nested_json(value))
            else:
                raise DecodeError(
                    "Invalid value type in structured data")
            name = key if key.startswith("_") else f"_{key}"
            sd.pairs.append((name, sval))
    return Record(
        ts=ts if ts is not None else now_precise(),
        hostname=hostname if hostname is not None else "",
        severity=severity,
        msg=msg,
        sd=[sd] if sd.pairs else None,
    )


class JSONLDecoder(Decoder):
    def __init__(self, config=None):
        pass

    def decode(self, line: str) -> Record:
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            raise DecodeError(PARSE_ERR)
        if not isinstance(obj, dict):
            raise DecodeError("JSON-lines record must be an object")
        return route_obj(obj)
