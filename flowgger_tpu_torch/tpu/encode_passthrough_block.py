"""Columnar RFC5424→passthrough encoding: each kernel-ok row's output
*is* a slice of the input (BOM-stripped, whitespace-rtrimmed full
message, passthrough_encoder.rs:22-46), so the whole batch's framed
bytes are one segment gather — no escaping, no scratch.

Per row: [syslen prefix digits +] ``chunk[full_start : trim_end]``
[+ suffix].  Rows outside the tier (kernel-flagged, oversized,
non-ASCII) take the scalar oracle via block_common.finish_block.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.passthrough:PassthroughEncoder"
DIFF_TEST = ("tests/test_torch_syslog_out.py::"
             "test_block_encoders_match_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from .assemble import (
    build_source,
    concat_segments,
    exclusive_cumsum,
    syslen_prefix_segments,
)
from .block_common import BlockResult, finish_block, merger_suffix


def encode_rfc5424_passthrough_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """Returns None when the route can't apply (prepend-timestamp
    configured or an unknown merger type)."""
    if merger_suffix(merger) is None or encoder.header_time_format is not None:
        return None
    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)

    def spans(ridx):
        a = starts64[ridx] + np.asarray(out["full_start"])[:n][ridx]
        return a, (starts64[ridx]
                   + np.asarray(out["trim_end"])[:n][ridx] - a)

    from .materialize import _scalar_line

    return _passthrough_block(chunk_bytes, starts64, lens64, out,
                              n, max_len, encoder, merger, spans,
                              _scalar_line)


def encode_rfc3164_passthrough_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """rfc3164 variant: full_msg is the whole line, untrimmed
    (materialize_rfc3164.py Record construction)."""
    if merger_suffix(merger) is None or encoder.header_time_format is not None:
        return None
    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)

    def spans(ridx):
        return starts64[ridx], lens64[ridx]

    from .materialize_rfc3164 import _scalar_3164

    return _passthrough_block(chunk_bytes, starts64, lens64, out,
                              n, max_len, encoder, merger, spans,
                              _scalar_3164)


def _passthrough_block(chunk_bytes, starts64, lens64, out, n, max_len,
                       encoder, merger, spans_fn, scalar_fn
                       ) -> Optional[BlockResult]:
    suffix, syslen = merger_suffix(merger)  # caller pre-checked
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    cand = ok & (lens64 <= max_len) & ~has_high

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
        span_src, span_len = spans_fn(ridx)
        deco, offs = build_source(b"0123456789 ", suffix)
        src = np.concatenate([chunk_arr, deco])
        dbase = chunk_arr.size
        sfx_off = dbase + offs[1]

        if syslen:
            # framed value = body length + 1 for the trailing newline
            # (syslen_merger.rs:14-31); suffix IS that newline here
            body = span_len + len(suffix)
            psrc, plen, prefix_lens_tier = syslen_prefix_segments(
                body, dbase)
            seg_src = np.concatenate(
                [psrc, span_src[:, None],
                 np.full((R, 1), sfx_off, dtype=np.int64)], axis=1).ravel()
            seg_len = np.concatenate(
                [plen, span_len[:, None],
                 np.full((R, 1), len(suffix), dtype=np.int64)],
                axis=1).ravel()
            row_lens = span_len + len(suffix) + prefix_lens_tier
        else:
            nseg = 2
            seg_src = np.empty(R * nseg, dtype=np.int64)
            seg_len = np.empty(R * nseg, dtype=np.int64)
            seg_src[0::nseg] = span_src
            seg_len[0::nseg] = span_len
            seg_src[1::nseg] = sfx_off
            seg_len[1::nseg] = len(suffix)
            row_lens = span_len + len(suffix)

        final_buf = concat_segments(src, seg_src, seg_len).tobytes()
        row_off = exclusive_cumsum(row_lens)

    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, scalar_fn=scalar_fn)
