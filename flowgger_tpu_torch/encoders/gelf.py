"""GELF 1.1 JSON encoder.

Parity model: flowgger src/flowgger/encoder/gelf_encoder.rs:51-116.
Output is a single JSON object with *sorted* keys (serde_json 0.8's
ObjectBuilder is a BTreeMap) and no whitespace.  Fixed keys: version,
host (``unknown`` when empty), short_message (``-`` when absent),
timestamp; optional level/full_message/application_name/process_id; every
SD pair flattens to a top-level field (later SD elements overwrite
earlier on key collision); ``sd_id`` records the (last) element id;
``[output.gelf_extra]`` static pairs overwrite everything.
"""

from __future__ import annotations

from typing import Dict

from . import Encoder, EncodeError
from ..config import Config, ConfigError
from ..record import Record, SDValue
from ..utils.rustfmt import json_f64

# C-accelerated escape: quotes+escapes exactly like serde_json (",\\,
# \b \f \n \r \t short forms, \u00xx for other controls, non-ASCII raw)
from json.encoder import encode_basestring as _quote


def _json_value(v) -> str:
    if isinstance(v, str):
        return _quote(v)
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return json_f64(v)
    if isinstance(v, int):
        return str(v)
    raise EncodeError("Unable to serialize to JSON")


def serialize_sorted_json(obj: Dict[str, object]) -> bytes:
    """serde_json-compatible compact serialization with BTreeMap key order."""
    items = ",".join(
        f"{_quote(k)}:{_json_value(v)}" for k, v in sorted(obj.items())
    )
    return ("{" + items + "}").encode("utf-8")


class GelfEncoder(Encoder):
    def __init__(self, config: Config):
        extra_tbl = config.lookup_table(
            "output.gelf_extra", "output.gelf_extra must be a list of key/value pairs"
        )
        self.extra = []
        if extra_tbl is not None:
            for k, v in extra_tbl.items():
                if not isinstance(v, str):
                    raise ConfigError("output.gelf_extra values must be strings")
                self.extra.append((k, v))

    def encode(self, record: Record) -> bytes:
        obj: Dict[str, object] = {
            "version": "1.1",
            "host": record.hostname if record.hostname else "unknown",
            "short_message": record.msg if record.msg is not None else "-",
            "timestamp": record.ts,
        }
        if record.severity is not None:
            obj["level"] = int(record.severity)
        if record.full_msg is not None:
            obj["full_message"] = record.full_msg
        if record.appname is not None:
            obj["application_name"] = record.appname
        if record.procid is not None:
            obj["process_id"] = record.procid
        if record.sd is not None:
            for sd in record.sd:
                if sd.sd_id is not None:
                    obj["sd_id"] = sd.sd_id
                for name, value in sd.pairs:
                    if value.kind == SDValue.F64:
                        obj[name] = float(value.value)
                    elif value.kind == SDValue.BOOL:
                        obj[name] = bool(value.value)
                    elif value.kind == SDValue.NULL:
                        obj[name] = None
                    elif value.kind == SDValue.STRING:
                        obj[name] = str(value.value)
                    else:
                        obj[name] = int(value.value)
        for name, value in self.extra:
            obj[name] = value
        return serialize_sorted_json(obj)
