"""Rust-compatible number formatting.

The reference emits floats through two distinct Rust paths and the output
bytes differ, so we model both:

- ``display_f64`` — Rust ``f64::to_string()`` / ``{}`` Display (used by the
  RFC5424 structured-data renderer, record.rs:55-62, and the LTSV encoder,
  ltsv_encoder.rs:84-88): shortest round-trip decimal, *never* scientific
  notation, integral values lose the ``.0``.
- ``json_f64`` — serde_json float serialization (gelf_encoder.rs:113): the
  shortest round-trip form, keeping ``.0`` on integral values and using
  ``e``-notation without a ``+`` sign for extreme magnitudes.
"""

from __future__ import annotations

from decimal import Decimal


def display_f64(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "inf"
    if v == float("-inf"):
        return "-inf"
    r = repr(float(v))
    if "e" in r or "E" in r:
        # Expand scientific notation to plain decimal, as Rust Display does.
        d = Decimal(r)
        r = format(d, "f")
    if r.endswith(".0"):
        r = r[:-2]
    # Python prints -0.0; Rust Display prints "-0".
    return r


def json_f64(v: float) -> str:
    if v != v or v in (float("inf"), float("-inf")):
        # serde_json emits null for non-finite floats.
        return "null"
    r = repr(float(v))
    if "e" in r:
        # Python: 1e+20 / 1e-07 ; dtoa (serde_json): 1e20 / 1e-7
        mant, exp = r.split("e")
        sign = "-" if exp.startswith("-") else ""
        exp = exp.lstrip("+-").lstrip("0") or "0"
        r = f"{mant}e{sign}{exp}"
    return r


def display_i64(v: int) -> str:
    return str(int(v))
