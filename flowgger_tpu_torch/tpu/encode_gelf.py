"""RFC5424 → GELF per row, straight from the decode's span tables: what
``rfc5424_tpu`` into GELF runs when the columnar block route cannot
engage (``output.gelf_extra`` keys that need dynamic placement).

Each row the decode accepted is serialized from its spans — a small
dict of pre-formatted JSON fragments (C-accelerated string escaping),
sorted keys, one join — with no Record built; a row the decode flagged,
one longer than ``input.tpu_max_line_len`` or one with multi-byte
characters goes through the scalar decoder and ``GelfEncoder``.  The
bytes are ``GelfEncoder``'s over the materialized Record: the same
sorted-key order, escaping and last-wins collisions.

A trimmed copy of the JAX package's ``tpu/encode_gelf.py``
(``encode_rfc5424_gelf`` :41), without its ``fallback_rows`` metric (the
port emits no metrics yet).
"""

from __future__ import annotations

from json.encoder import encode_basestring as _quote
from typing import Dict, List

import numpy as np

from ..decoders.rfc5424 import _unescape_sd_value
from ..encoders import EncodeError
from ..encoders.gelf import GelfEncoder
from ..utils.rustfmt import json_f64
from .materialize import _scalar_line, compute_ts


class EncodedResult:
    """Encoded bytes or a per-line error (same contract as LineResult)."""

    __slots__ = ("encoded", "error", "line")

    def __init__(self, encoded, error, line):
        self.encoded = encoded
        self.error = error
        self.line = line


def encode_rfc5424_gelf(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder: GelfEncoder,
) -> List[EncodedResult]:
    ts_arr = compute_ts(out).tolist()
    o = {k: np.asarray(v).tolist() for k, v in out.items()}
    ok = o["ok"]
    extra = encoder.extra
    results: List[EncodedResult] = []
    starts_l = starts.tolist() if hasattr(starts, "tolist") else starts
    lens_l = orig_lens.tolist() if hasattr(orig_lens, "tolist") else orig_lens

    sd_count = o["sd_count"]
    pair_count = o["pair_count"]
    sid_start, sid_end = o["sid_start"], o["sid_end"]
    name_start, name_end = o["name_start"], o["name_end"]
    val_start, val_end = o["val_start"], o["val_end"]
    val_has_esc = o["val_has_esc"]
    host_s, host_e = o["host_start"], o["host_end"]
    app_s, app_e = o["app_start"], o["app_end"]
    proc_s, proc_e = o["proc_start"], o["proc_end"]
    msg_s = o["msg_start"]
    full_s = o["full_start"]
    sev = o["severity"]

    for n in range(n_real):
        s = starts_l[n]
        ln = lens_l[n]
        raw = chunk_bytes[s:s + ln]
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            results.append(EncodedResult(None, "__utf8__", ""))
            continue
        if not ok[n] or ln > max_len or len(line) != ln:
            # flagged, oversized, or multi-byte rows: Record path
            res = _scalar_line(line)
            if res.record is None:
                results.append(EncodedResult(None, res.error, line))
                continue
            try:
                results.append(EncodedResult(encoder.encode(res.record), None, line))
            except EncodeError as e:
                results.append(EncodedResult(None, str(e), line))
            continue

        # fixed fields (gelf_encoder.rs field mapping); msgid is decoded
        # but GELF has no field for it
        host = line[host_s[n]:host_e[n]]
        msg = line[msg_s[n]:].strip()
        nsd = sd_count[n]
        frags: Dict[str, str] = {"version": '"1.1"'}
        frags["host"] = _quote(host) if host else '"unknown"'
        frags["short_message"] = _quote(msg) if msg else '"-"'
        frags["timestamp"] = json_f64(ts_arr[n])
        frags["level"] = str(sev[n])
        frags["full_message"] = _quote(line[full_s[n]:].rstrip())
        frags["application_name"] = _quote(line[app_s[n]:app_e[n]])
        frags["process_id"] = _quote(line[proc_s[n]:proc_e[n]])
        if nsd:
            frags["sd_id"] = _quote(line[sid_start[n][nsd - 1]:sid_end[n][nsd - 1]])
            for j in range(pair_count[n]):
                value = line[val_start[n][j]:val_end[n][j]]
                if val_has_esc[n][j]:
                    value = _unescape_sd_value(value)
                frags["_" + line[name_start[n][j]:name_end[n][j]]] = _quote(value)
        for k, v in extra:
            frags[k] = _quote(v)
        body = ",".join(f"{_quote(k)}:{frags[k]}" for k in sorted(frags))
        results.append(EncodedResult(("{" + body + "}").encode("utf-8"), None, line))
    return results
