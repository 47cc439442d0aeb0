"""Normalized log record — the contract between decoders and encoders.

Parity model: flowgger src/flowgger/record.rs:4-91 (Record,
StructuredData, SDValue enum, RFC5424 Display impl, facility/severity
constants).  This is a fresh design for a columnar/batched pipeline: the
per-record classes here are the *scalar* views; the TPU path works on
`flowgger_tpu.tpu.columnar.ColumnarBatch` and materializes these lazily.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .utils.rustfmt import display_f64

# record.rs:84-91
FACILITY_MAX = 0xFF >> 3
FACILITY_MISSING = 0xFF
SEVERITY_MAX = (1 << 3) - 1
SEVERITY_MISSING = 0xFF


class SDValue:
    """Typed structured-data value (record.rs:4-11).

    Values are tagged rather than relying on Python's dynamic types because
    the distinction between I64/U64/F64 must survive round-trips (a GELF
    `9001` is U64, `-3` is I64, `1.5` is F64) and `bool` vs int must not
    collapse.
    """

    __slots__ = ("kind", "value")

    STRING = "string"
    BOOL = "bool"
    F64 = "f64"
    I64 = "i64"
    U64 = "u64"
    NULL = "null"

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    # -- constructors ------------------------------------------------------
    @classmethod
    def string(cls, v: str) -> "SDValue":
        return cls(cls.STRING, v)

    @classmethod
    def bool_(cls, v: bool) -> "SDValue":
        return cls(cls.BOOL, bool(v))

    @classmethod
    def f64(cls, v: float) -> "SDValue":
        return cls(cls.F64, float(v))

    @classmethod
    def i64(cls, v: int) -> "SDValue":
        return cls(cls.I64, int(v))

    @classmethod
    def u64(cls, v: int) -> "SDValue":
        return cls(cls.U64, int(v))

    @classmethod
    def null(cls) -> "SDValue":
        return cls(cls.NULL, None)

    # ----------------------------------------------------------------------
    def display(self) -> str:
        """Value as rendered inside RFC5424 structured data (record.rs:55-62)."""
        if self.kind == self.STRING:
            return self.value
        if self.kind == self.BOOL:
            return "true" if self.value else "false"
        if self.kind == self.F64:
            return display_f64(self.value)
        if self.kind in (self.I64, self.U64):
            return str(self.value)
        return ""

    def __eq__(self, other):
        return (
            isinstance(other, SDValue)
            and self.kind == other.kind
            and self.value == other.value
        )

    def __hash__(self):
        return hash((self.kind, self.value))

    def __repr__(self):
        return f"SDValue({self.kind}, {self.value!r})"


@dataclass
class StructuredData:
    """One RFC5424 `[sd_id k="v" ...]` element (record.rs:23-38)."""

    sd_id: Optional[str] = None
    pairs: List[Tuple[str, SDValue]] = field(default_factory=list)

    def to_string(self) -> str:
        """RFC5424 rendering; strips one leading '_' from pair names and
        renders Null values as a bare name (record.rs:42-68)."""
        out = ["["]
        if self.sd_id is not None:
            out.append(self.sd_id)
        for name, value in self.pairs:
            name = name[1:] if name.startswith("_") else name
            if value.kind == SDValue.NULL:
                out.append(f" {name}")
            else:
                out.append(f' {name}="{value.display()}"')
        out.append("]")
        return "".join(out)

    __str__ = to_string


@dataclass
class Record:
    """Normalized record passed decoder → encoder (record.rs:70-82)."""

    ts: float = 0.0
    hostname: str = ""
    facility: Optional[int] = None
    severity: Optional[int] = None
    appname: Optional[str] = None
    procid: Optional[str] = None
    msgid: Optional[str] = None
    msg: Optional[str] = None
    full_msg: Optional[str] = None
    sd: Optional[List[StructuredData]] = None
