"""Host helpers between the RFC5424 decode channels and the encoders:
the f64 timestamp from the kernel's calendar channels, the scalar
oracle for rows the kernel flagged (``ok=False``) or that exceed
``tpu_max_line_len`` — so errors and edge cases stay byte-identical with
the reference's per-line behavior (line_splitter.rs:37-39) — and the
Record-path materializer, which slices each row's spans into a
``Record`` for the per-record encode.

A trimmed copy of the JAX package's ``tpu/materialize.py``
(``materialize`` :56, ``_build_sd`` :106, ``_from_spans_str`` :125,
``_from_spans_bytes`` :146), without its ``fallback_rows`` metric (the
port emits no metrics yet).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..decoders import DecodeError
from ..decoders.rfc5424 import RFC5424Decoder, _unescape_sd_value
from ..record import Record, SDValue, StructuredData

_SCALAR = RFC5424Decoder()


def compute_ts(out: Dict[str, np.ndarray]) -> np.ndarray:
    """Vectorized f64 timestamps from the kernel's int32 components —
    the same integer-nanos-then-divide the oracle uses, so results are
    bit-identical."""
    epoch = (
        out["days"].astype(np.int64) * 86400
        + out["sod"].astype(np.int64)
        - out["off"].astype(np.int64)
    )
    nanos = out["nanos"].astype(np.int64)
    with np.errstate(over="ignore"):
        ts = (epoch * 1_000_000_000 + nanos) / 1e9
    # |epoch| beyond ~year 2262 overflows int64 nanos; redo those rows with
    # exact Python integers (the oracle's arithmetic is arbitrary-precision)
    big = np.abs(epoch) > 9_000_000_000
    if big.any():
        for i in np.flatnonzero(big):
            ts[i] = (int(epoch[i]) * 1_000_000_000 + int(nanos[i])) / 1e9
    return ts


class LineResult:
    """Either a Record or a per-line decode error (message, line)."""

    __slots__ = ("record", "error", "line")

    def __init__(self, record: Optional[Record], error: Optional[str], line: str):
        self.record = record
        self.error = error
        self.line = line


def _scalar_line(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)


def materialize(chunk_bytes: bytes, starts: np.ndarray, lens: np.ndarray,
                orig_lens: np.ndarray, out: Dict[str, np.ndarray],
                n_real: int, max_len: int) -> List[LineResult]:
    """Records for the first ``n_real`` rows.  ``lens`` are the (possibly
    clipped) lengths the kernel saw, ``orig_lens`` the true line
    lengths: rows longer than ``max_len``, and rows the kernel flagged,
    take the scalar oracle."""
    ts = compute_ts(out).tolist()
    # plain-list views: one bulk conversion a batch
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
            results.append(_scalar_line(line))
            continue
        if len(line) != ln:
            # byte spans != str indices: slice the bytes, decode per field
            results.append(_from_spans_bytes(raw, line, n, o, ts))
            continue
        results.append(_from_spans_str(line, n, o, ts))
    return results


def _build_sd(n: int, o: Dict[str, list], take
              ) -> Optional[List[StructuredData]]:
    sd_count = int(o["sd_count"][n])
    if sd_count == 0:
        return None
    blocks = [StructuredData(take(int(o["sid_start"][n][k]),
                                  int(o["sid_end"][n][k])))
              for k in range(sd_count)]
    has_esc = o["val_has_esc"]
    for j in range(int(o["pair_count"][n])):
        name = take(int(o["name_start"][n][j]), int(o["name_end"][n][j]))
        value = take(int(o["val_start"][n][j]), int(o["val_end"][n][j]))
        if has_esc[n][j]:
            value = _unescape_sd_value(value)
        blocks[int(o["pair_sd"][n][j])].pairs.append(
            ("_" + name, SDValue.string(value)))
    return blocks


def _from_spans_str(line: str, n: int, o: Dict[str, list],
                    ts: list) -> LineResult:
    def take(a: int, b: int) -> str:
        return line[a:b]

    msg = line[int(o["msg_start"][n]):].strip()
    record = Record(
        ts=float(ts[n]),
        hostname=take(int(o["host_start"][n]), int(o["host_end"][n])),
        facility=int(o["facility"][n]),
        severity=int(o["severity"][n]),
        appname=take(int(o["app_start"][n]), int(o["app_end"][n])),
        procid=take(int(o["proc_start"][n]), int(o["proc_end"][n])),
        msgid=take(int(o["msgid_start"][n]), int(o["msgid_end"][n])),
        msg=msg if msg else None,
        full_msg=line[int(o["full_start"][n]):].rstrip(),
        sd=_build_sd(n, o, take),
    )
    return LineResult(record, None, line)


def _from_spans_bytes(raw: bytes, line: str, n: int, o: Dict[str, list],
                      ts: list) -> LineResult:
    def take(a: int, b: int) -> str:
        return raw[a:b].decode("utf-8", errors="surrogatepass")

    msg = raw[int(o["msg_start"][n]):].decode("utf-8").strip()
    record = Record(
        ts=float(ts[n]),
        hostname=take(int(o["host_start"][n]), int(o["host_end"][n])),
        facility=int(o["facility"][n]),
        severity=int(o["severity"][n]),
        appname=take(int(o["app_start"][n]), int(o["app_end"][n])),
        procid=take(int(o["proc_start"][n]), int(o["proc_end"][n])),
        msgid=take(int(o["msgid_start"][n]), int(o["msgid_end"][n])),
        msg=msg if msg else None,
        full_msg=raw[int(o["full_start"][n]):].decode("utf-8").rstrip(),
        sd=_build_sd(n, o, take),
    )
    return LineResult(record, None, line)
