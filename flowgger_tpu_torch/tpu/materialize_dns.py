"""Materialize columnar DNS-decode output into Records.

Fixed grammar means fixed routing: ok rows build their Record straight
from the six field spans (the kernel already validated the ts/latency
grammars, so no per-row error path exists on the tier); everything
else re-runs the scalar oracle for the exact error text.

A copy of the JAX package's ``tpu/materialize_dns.py`` (``materialize_dns``
:23, ``_scalar_dns`` :82), without its metrics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..decoders import DecodeError
from ..decoders.dns import DNSDecoder
from ..record import Record, SDValue, StructuredData
from .materialize import LineResult

_SCALAR = DNSDecoder()


def materialize_dns(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
) -> List[LineResult]:
    out = {k: np.asarray(v) for k, v in out.items()}
    ok = out["ok"]
    results: List[LineResult] = []
    # dedup caches: repetitive streams share few distinct stamps and
    # latencies, so the float/int parse is per-unique, not per-row
    ts_cache: dict = {}
    lat_cache: dict = {}
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
            results.append(_scalar_dns(line))
            continue

        def span(key):
            a = int(out[key + "_start"][n])
            b = int(out[key + "_end"][n])
            return raw[a:b]

        ts_b = span("ts")
        ts = ts_cache.get(ts_b)
        if ts is None:
            ts = ts_cache[ts_b] = float(ts_b)
        lat_b = span("lat")
        lat = lat_cache.get(lat_b)
        if lat is None:
            lat = lat_cache[lat_b] = int(lat_b)
        sd = StructuredData(None)
        sd.pairs.append(("_latency_us", SDValue.u64(lat)))
        sd.pairs.append(("_qtype",
                         SDValue.string(span("qtype").decode("utf-8"))))
        sd.pairs.append(("_rcode",
                         SDValue.string(span("rcode").decode("utf-8"))))
        record = Record(
            ts=ts,
            hostname=span("client").decode("utf-8"),
            msg=span("qname").decode("utf-8"),
            sd=[sd],
        )
        results.append(LineResult(record, None, line))
    return results


def _scalar_dns(line: str) -> LineResult:
    try:
        return LineResult(_SCALAR.decode(line), None, line)
    except DecodeError as e:
        return LineResult(None, str(e), line)
