"""Scalar LTSV decoder: the exactness oracle for rows the LTSV kernel
flags and for lines longer than ``input.tpu_max_line_len``.

A copy of the JAX package's ``decoders/ltsv.py``.  Parity model:
flowgger src/flowgger/decoder/ltsv_decoder.rs:23-267.  Tab-separated
``key:value`` pairs; special keys time/host/message/level; optional typed
schema ``[input.ltsv_schema]`` (string/bool/f64/i64/u64) and per-type key
suffixes ``[input.ltsv_suffixes]`` appended to names not already carrying
them.  ``time`` accepts a unix float, RFC3339, or the apache-english form
(optionally wrapped in ``[...]``).
"""

from __future__ import annotations

from typing import Dict, Optional

from . import DecodeError, Decoder
from ..config import Config, ConfigError
from ..record import Record, SDValue, StructuredData
from ..utils.timeparse import parse_english_time, rfc3339_to_unix

_TYPES = ("string", "bool", "f64", "i64", "u64")
_U64_MAX = (1 << 64) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _parse_unix_strtime(s: str) -> float:
    # Rust f64::from_str: no underscores, no surrounding whitespace;
    # accepts inf/NaN/exponents.
    if not s or s != s.strip() or "_" in s:
        raise ValueError("bad float")
    return float(s)


def _parse_ts(s: str) -> float:
    try:
        return _parse_unix_strtime(s)
    except ValueError:
        pass
    try:
        return rfc3339_to_unix(s)
    except ValueError:
        pass
    try:
        return parse_english_time(s)
    except ValueError:
        raise DecodeError("Unable to parse the English to Unix timestamp in LTSV decoder")


class LTSVDecoder(Decoder):
    def __init__(self, config: Optional[Config] = None):
        self.schema: Optional[Dict[str, str]] = None
        self.suffixes: Dict[str, Optional[str]] = {t: None for t in _TYPES}
        if config is None:
            return
        schema_tbl = config.lookup_table(
            "input.ltsv_schema", "input.ltsv_schema must be a list of key/type pairs"
        )
        if schema_tbl is not None:
            self.schema = {}
            for name, sdtype in schema_tbl.items():
                if not isinstance(sdtype, str):
                    raise ConfigError("input.ltsv_schema types must be strings")
                t = sdtype.lower()
                if t not in _TYPES:
                    raise ConfigError(
                        f"Unsupported type in input.ltsv_schema for name [{name}]"
                    )
                self.schema[name] = t
        suffix_tbl = config.lookup_table(
            "input.ltsv_suffixes", "input.ltsv_suffixes must be a list of type/suffixes pairs"
        )
        if suffix_tbl is not None:
            for sdtype, suffix in suffix_tbl.items():
                if not isinstance(suffix, str):
                    raise ConfigError("input.ltsv_suffixes suffixes must be strings")
                t = sdtype.lower()
                if t == "string":
                    raise ConfigError("Strings cannot be suffixed")
                if t not in _TYPES:
                    raise ConfigError(
                        f"Unsupported type in input.ltsv_suffixes for type [{sdtype}]"
                    )
                self.suffixes[t] = suffix

    def _typed_pair(self, name: str, value: str):
        sdtype = self.schema.get(name) if self.schema is not None else None
        if sdtype is None or sdtype == "string":
            return f"_{name}", SDValue.string(value)
        suffix = self.suffixes.get(sdtype)
        if suffix is not None and not name.endswith(suffix):
            final_name = f"_{name}{suffix}"
        else:
            final_name = f"_{name}"
        if sdtype == "bool":
            if value == "true":
                return final_name, SDValue.bool_(True)
            if value == "false":
                return final_name, SDValue.bool_(False)
            raise DecodeError("Type error; boolean was expected")
        if sdtype == "f64":
            try:
                return final_name, SDValue.f64(_parse_unix_strtime(value))
            except ValueError:
                raise DecodeError("Type error; f64 was expected")
        if sdtype == "i64":
            v = _parse_int_strict(value)
            if v is None or not (_I64_MIN <= v <= _I64_MAX):
                raise DecodeError("Type error; i64 was expected")
            return final_name, SDValue.i64(v)
        # u64
        v = _parse_int_strict(value)
        if v is None or not (0 <= v <= _U64_MAX) or value.startswith("-"):
            raise DecodeError("Type error; u64 was expected")
        return final_name, SDValue.u64(v)

    def decode(self, line: str) -> Record:
        sd = StructuredData(None)
        ts = None
        hostname = None
        msg = None
        severity = None
        for part in line.split("\t"):
            k, sep, v = part.partition(":")
            if not sep:
                print(f"Missing value for name '{k}'")
                continue
            if k == "time":
                ts_s = v[1:-1] if v.startswith("[") and v.endswith("]") else v
                ts = _parse_ts(ts_s)
            elif k == "host":
                hostname = v
            elif k == "message":
                msg = v
            elif k == "level":
                sev = _parse_int_strict(v)
                if sev is None or not (0 <= sev <= 255):
                    raise DecodeError("Invalid severity level")
                if sev > 7:
                    raise DecodeError("Severity level should be <= 7")
                severity = sev
            else:
                sd.pairs.append(self._typed_pair(k, v))
        if ts is None:
            raise DecodeError("Missing timestamp")
        if hostname is None:
            raise DecodeError("Missing hostname")
        return Record(
            ts=ts,
            hostname=hostname,
            severity=severity,
            msg=msg,
            full_msg=line,
            sd=[sd] if sd.pairs else None,
        )


def _parse_int_strict(s: str) -> Optional[int]:
    """Rust integer FromStr: optional sign then ASCII digits only."""
    if not s:
        return None
    body = s[1:] if s[0] in "+-" else s
    if not body or not (body.isdigit() and body.isascii()):
        return None
    return int(s)
