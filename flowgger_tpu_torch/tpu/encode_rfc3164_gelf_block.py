"""Columnar RFC3164→GELF encoding: the legacy-syslog fast path's span
tables become framed GELF bytes with eleven fixed segments per row.

A copy of the JAX package's ``tpu/encode_rfc3164_gelf_block.py``.  An
rfc3164 fast-path record carries no SD, no appname/procid/msgid, an
unstripped message, and the whole line as full_message, so its
sorted-key GELF object is exactly::

    {"full_message":F,"host":H,["level":N,]"short_message":M,
     "timestamp":T,"version":"1.1"}

with JSON escaping on the three spans (the shared sparse EscapeMap) and
the level segments zero-length for no-PRI rows.  Rows outside the tier
(kernel-flagged, oversized, non-ASCII via the kernel's has_high
channel) re-run the scalar rfc3164 oracle, keeping bytes identical to
decoder→GelfEncoder in every case.  The ``_C_*`` constants are the
device tier's bank too (``device_rfc3164``), so a device row and a host
row of one block can never differ.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_rfc3164.py::"
             "test_block_encoder_matches_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.rustfmt import json_f64
from .assemble import (
    build_source,
    concat_segments,
    escape_json,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    finish_block,
    merger_suffix,
    ts_scratch,
)
from .materialize_rfc3164 import _scalar_3164

_C_OPEN = b'{"full_message":"'
_C_HOST = b'","host":"'
_C_LEVEL = b'","level":'
_C_SHORT_PRI = b',"short_message":"'     # after the bare level number
_C_SHORT_NOPRI = b'","short_message":"'  # closing the host string
_C_TS = b'","timestamp":'
_C_TAIL = b',"version":"1.1"}'
_C_SEVD = b"01234567"

_SEGS = 13  # incl. the two extras slot columns (empty without extras)

_FIXED_3164 = ("full_message", "host", "level", "short_message",
               "timestamp", "version")


def gelf_extra_consts_3164(extra):
    """Fold ``[output.gelf_extra]`` pairs into this layout's constants
    (same static-placement idea as encode_gelf_block.gelf_extra_slots,
    adapted to the gated ``level`` key): returns
    (open, host_const, hl_slot, l2_pri, l2_nopri, short_pri,
    short_nopri, ts_const, tail_const) or None when a key needs dynamic
    placement.  The level→short slot is per-row dual-form — after the
    bare level digit (number form) when PRI is present, after a string
    value otherwise — mirroring the existing short-const selection."""
    from .block_common import extra_forms, extra_tail

    pre = hl = b""
    l2a = l2b = b""          # level<k<short: (pri, no-pri) variants
    fh = b""                 # full<k<host
    st = b""                 # short<k<timestamp
    tv = b""                 # timestamp<k<version (number form)
    vz = b""                 # > version (inside tail)
    for k, v in sorted(extra or ()):
        if k in _FIXED_3164:
            return None
        sf, sc, nm = extra_forms(k, v)
        if k < "full_message":
            pre += sf
        elif k < "host":
            fh += sc
        elif k < "level":
            hl += sc
        elif k < "short_message":
            l2a += nm
            l2b += sc
        elif k < "timestamp":
            st += sc
        elif k < "version":
            tv += nm
        else:
            vz += sc
    tail = extra_tail(_C_TAIL, tv, vz)
    # an l2a chain ends quoted -> short needs the after-number variant;
    # an l2b chain ends unquoted -> the string-close variant: exactly
    # the existing has_pri pairing, so no new selection logic is needed
    return (b"{" + pre + _C_OPEN[1:], fh + _C_HOST, hl, l2a, l2b,
            _C_SHORT_PRI, _C_SHORT_NOPRI, st + _C_TS, tail)


def encode_rfc3164_gelf_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    spec = merger_suffix(merger)
    if spec is None:
        return None
    econsts = gelf_extra_consts_3164(encoder.extra)
    if econsts is None:
        return None
    (c_open, c_host, c_hl, c_l2a, c_l2b, c_short_p, c_short_n, c_ts,
     c_tail) = econsts
    suffix, syslen = spec

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    cand = ok & (lens64 <= max_len) & ~has_high

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        emap = escape_json(chunk_arr)
        st = starts64[ridx]

        def espan(a_abs, b_abs):
            ea = emap.map(a_abs)
            return ea, emap.map(b_abs) - ea

        row_end = st + lens64[ridx]
        full_src, full_len = espan(st, row_end)
        host_a = st + np.asarray(out["host_start"])[:n][ridx]
        host_b = st + np.asarray(out["host_end"])[:n][ridx]
        host_src, host_len = espan(host_a, host_b)
        msg_a = st + np.asarray(out["msg_start"])[:n][ridx]
        msg_src, msg_len = espan(msg_a, row_end)
        has_pri = np.asarray(out["has_pri"][:n], dtype=bool)[ridx]
        sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)

        scratch, ts_off, ts_len = ts_scratch(out, n, ridx, json_f64)
        consts, offs = build_source(
            c_open, c_host, _C_LEVEL, c_short_p, c_short_n,
            c_ts, c_tail + suffix, _C_SEVD, c_hl, c_l2a, c_l2b, scratch)
        (o_open, o_host, o_level, o_short_p, o_short_n, o_ts, o_tail,
         o_sevd, o_hl, o_l2a, o_l2b, o_scratch) = offs
        cbase = int(emap.esc.size)
        src = np.concatenate([emap.esc, consts])

        # (no empty-host substitution: the kernel only marks rows ok
        # when the host span is non-empty, rfc3164.py host_e > host_s)
        seg_src = np.empty((R, _SEGS), dtype=np.int64)
        seg_len = np.empty((R, _SEGS), dtype=np.int64)
        cols = (
            (cbase + o_open, len(c_open)),
            (full_src, full_len),
            (cbase + o_host, len(c_host)),
            (host_src, host_len),
            (cbase + o_hl, len(c_hl)),
            (cbase + o_level, np.where(has_pri, len(_C_LEVEL), 0)),
            (cbase + o_sevd + sev, np.where(has_pri, 1, 0)),
            (np.where(has_pri, cbase + o_l2a, cbase + o_l2b),
             np.where(has_pri, len(c_l2a), len(c_l2b))),
            (np.where(has_pri, cbase + o_short_p, cbase + o_short_n),
             np.where(has_pri, len(c_short_p), len(c_short_n))),
            (msg_src, msg_len),
            (cbase + o_ts, len(c_ts)),
            (cbase + o_scratch + ts_off, ts_len),
            (cbase + o_tail, len(c_tail) + len(suffix)),
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
