"""Columnar RFC3164→RFC3164 re-encode: the legacy-syslog fast path's
span tables become framed legacy-syslog bytes again (the reference's
syslog→syslog relay mode, rfc3164_encoder.rs:28-97).

An rfc3164 fast-path record carries hostname/msg spans, optional PRI
and an integer-second timestamp, so each row is nine fixed segments::

    [ "<" npri-digits ">" ] TS_header hostname " " msg

with npri re-rendered from facility<<3|severity (the decoder may have
normalized leading zeros, so the digits cannot be a span) and the
header timestamp (``Mon  d hh:mm:ss ``) deduplicated host-side
(second granularity makes real streams highly repetitive).  The
``syslog_prepend_timestamp`` option emits wall-clock-at-encode-time
text, which is inherently per-call — those configs keep the Record
path.  Rows outside the tier re-run the scalar oracle, byte-identical
in every case."""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.rfc3164:RFC3164Encoder"
DIFF_TEST = ("tests/test_torch_syslog_out.py::"
             "test_block_encoders_match_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.timeparse import format_rfc3164_header_ts
from .assemble import (
    build_source,
    concat_segments,
    decimal_segments,
    exclusive_cumsum,
)
from .block_common import (
    apply_syslen_prefix,
    finish_block,
    merger_suffix,
    ts_scratch,
)
from .materialize_rfc3164 import _scalar_3164

_SEGS = 10  # < d d d > ts host " " msg suffix


def encode_rfc3164_3164_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
):
    spec = merger_suffix(merger)
    if spec is None or encoder.header_time_format is not None:
        return None
    suffix, syslen = spec

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    cand = ok & (lens64 <= max_len) & ~has_high

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier = None

    if R:
        st = starts64[ridx]
        host_a = st + np.asarray(out["host_start"])[:n][ridx].astype(np.int64)
        host_b = st + np.asarray(out["host_end"])[:n][ridx].astype(np.int64)
        msg_a = st + np.asarray(out["msg_start"])[:n][ridx].astype(np.int64)
        row_end = st + lens64[ridx]
        has_pri = np.asarray(out["has_pri"][:n], dtype=bool)[ridx]
        npri = (((np.asarray(out["facility"])[:n][ridx].astype(np.int64)
                  << 3) & 0xF8)
                + (np.asarray(out["severity"])[:n][ridx].astype(np.int64)
                   & 0x7))

        scratch, ts_off, ts_len = ts_scratch(out, n, ridx,
                                             format_rfc3164_header_ts)
        consts, offs = build_source(b"<", b">", b" ", b"0123456789",
                                    suffix, scratch)
        o_lt, o_gt, o_sp, o_dig, o_suffix, o_scratch = offs
        chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
        cbase = int(chunk_arr.size)
        src = np.concatenate([chunk_arr, consts])

        dsrc, dlen = decimal_segments(npri, cbase + o_dig, width=3)
        dsrc = dsrc.reshape(R, 3)
        dlen = dlen.reshape(R, 3) * has_pri[:, None]

        seg_src = np.empty((R, _SEGS), dtype=np.int64)
        seg_len = np.empty((R, _SEGS), dtype=np.int64)
        cols = (
            (cbase + o_lt, np.where(has_pri, 1, 0)),
            (dsrc[:, 0], dlen[:, 0]),
            (dsrc[:, 1], dlen[:, 1]),
            (dsrc[:, 2], dlen[:, 2]),
            (cbase + o_gt, np.where(has_pri, 1, 0)),
            (cbase + o_scratch + ts_off, ts_len),
            (host_a, np.maximum(host_b - host_a, 0)),
            (cbase + o_sp, 1),
            (msg_a, np.maximum(row_end - msg_a, 0)),
            (cbase + o_suffix, len(suffix)),
        )
        for k, (s, ln) in enumerate(cols):
            seg_src[:, k] = s
            seg_len[:, k] = ln

        flat_src = seg_src.ravel()
        flat_len = seg_len.ravel()
        dst0 = exclusive_cumsum(flat_len)
        body = concat_segments(src, flat_src, flat_len, dst0)
        row_off = dst0[::_SEGS]
        tier_lens = np.diff(row_off)
        if syslen:
            final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
                body, row_off, tier_lens)
        else:
            final_buf = body.tobytes()

    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, scalar_fn=_scalar_3164)
