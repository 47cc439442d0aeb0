"""LTSV encoder.

Parity model: flowgger src/flowgger/encoder/ltsv_encoder.rs:65-125.
Field order: SD pairs (leading ``_`` stripped), ``[output.ltsv_extra]``
pairs, then host, time, message?, full_message?, level?, facility?,
appname?, procid?, msgid?.  Keys escape ``\\n``/``\\t`` → space and
``:`` → ``_``; values escape ``\\n``/``\\t`` → space.  Null SD values
render as an empty string; floats use Rust Display form.

A copy of the JAX package's ``encoders/ltsv.py``.
"""

from __future__ import annotations

from . import Encoder
from ..config import Config, ConfigError
from ..record import Record, SDValue
from ..utils.rustfmt import display_f64


class _LTSVString:
    def __init__(self):
        self.parts = []

    def insert(self, key: str, value: str):
        if "\n" in key or "\t" in key or ":" in key:
            key = key.replace("\n", " ").replace("\t", " ").replace(":", "_")
        if "\n" in value or "\t" in value:
            value = value.replace("\t", " ").replace("\n", " ")
        self.parts.append(f"{key}:{value}")

    def finalize(self) -> str:
        return "\t".join(self.parts)


def _sd_value_str(value: SDValue) -> str:
    if value.kind == SDValue.NULL:
        return ""
    if value.kind == SDValue.BOOL:
        return "true" if value.value else "false"
    if value.kind == SDValue.F64:
        return display_f64(value.value)
    return str(value.value)


class LTSVEncoder(Encoder):
    def __init__(self, config: Config):
        extra_tbl = config.lookup_table(
            "output.ltsv_extra", "output.ltsv_extra must be a list of key/value pairs"
        )
        self.extra = []
        if extra_tbl is not None:
            for k, v in extra_tbl.items():
                if not isinstance(v, str):
                    raise ConfigError("output.ltsv_extra values must be strings")
                self.extra.append((k, v))

    def encode(self, record: Record) -> bytes:
        res = _LTSVString()
        if record.sd is not None:
            for sd in record.sd:
                for name, value in sd.pairs:
                    name = name[1:] if name.startswith("_") else name
                    res.insert(name, _sd_value_str(value))
        for name, value in self.extra:
            name = name[1:] if name.startswith("_") else name
            res.insert(name, value)
        res.insert("host", record.hostname)
        res.insert("time", display_f64(record.ts))
        if record.msg is not None:
            res.insert("message", record.msg)
        if record.full_msg is not None:
            res.insert("full_message", record.full_msg)
        if record.severity is not None:
            res.insert("level", str(record.severity))
        if record.facility is not None:
            res.insert("facility", str(record.facility))
        if record.appname is not None:
            res.insert("appname", record.appname)
        if record.procid is not None:
            res.insert("procid", record.procid)
        if record.msgid is not None:
            res.insert("msgid", record.msgid)
        return res.finalize().encode("utf-8")
