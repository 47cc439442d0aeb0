"""Columnar RFC5424→RFC5424 re-encoding: span tables → one framed
output buffer per batch (rfc5424_encoder.rs:28-93 semantics).

For kernel-ok ASCII rows without escaped SD values, every output piece
is either a raw chunk span (host/app/proc/msgid, SD ids/names/values —
the reference re-emits decoded values verbatim, record.rs:55-62), a
constant, PRI digits, or a deduplicated millisecond-truncated RFC3339
timestamp; the whole batch gathers in one ``concat_segments`` call.
Multi-block structured data nests pairs inside their block's brackets
via ``pair_sd`` attribution.  Rows outside the tier take the scalar
oracle through block_common.finish_block.

A copy of the JAX package's ``tpu/encode_rfc5424_block.py``: the
rfc5424, rfc3164, gelf and ltsv inputs into RFC5424.  The rfc5424 rows
go through the native row writer (``fg_r5_lens`` / ``fg_r5_write``),
which raises where the library cannot build; the numpy segment plan
beside it is its plain version.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.rfc5424:RFC5424Encoder"
DIFF_TEST = ("tests/test_torch_rfc5424_out.py::"
             "test_block_encoders_match_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.timeparse import unix_to_rfc3339_ms
from .assemble import (
    build_source,
    concat_segments,
    decimal_segments,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    finish_block,
    merger_suffix,
    syslen_prefix_lens_from_framed,
    ts_scratch,
)


def _native_rows(chunk_bytes, starts64, out, n, ridx, suffix, syslen):
    """Assemble tier rows through the native fg_r5 row writer; None when
    the numpy engine is asked for (``native.r5_rows_available`` patched
    to False: the tests' plain version)."""
    from .. import native

    if not native.r5_rows_available():
        return None
    R = ridx.size
    scratch, ts_off, ts_len = ts_scratch(out, n, ridx,
                                         unix_to_rfc3339_ms)
    meta = np.empty((R, 16), dtype=np.int32)
    meta[:, 0] = starts64[ridx]
    fac = np.asarray(out["facility"])[:n][ridx].astype(np.int64)
    sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)
    meta[:, 1] = (fac << 3) + sev
    for k, key in enumerate(("host_start", "host_end", "app_start",
                             "app_end", "proc_start", "proc_end",
                             "msgid_start", "msgid_end",
                             "msg_trim_start", "trim_end")):
        meta[:, 2 + k] = np.asarray(out[key])[:n][ridx]
    sdc = np.asarray(out["sd_count"])[:n][ridx]
    meta[:, 12] = sdc
    meta[:, 13] = np.asarray(out["pair_count"])[:n][ridx]
    meta[:, 14] = ts_off
    meta[:, 15] = ts_len
    return native.r5_rows_native(
        chunk_bytes, meta,
        np.asarray(out["sid_start"])[:n][ridx],
        np.asarray(out["sid_end"])[:n][ridx],
        np.asarray(out["name_start"])[:n][ridx],
        np.asarray(out["name_end"])[:n][ridx],
        np.asarray(out["val_start"])[:n][ridx],
        np.asarray(out["val_end"])[:n][ridx],
        np.asarray(out["pair_sd"])[:n][ridx],
        scratch, suffix, syslen)


def encode_rfc5424_rfc5424_block(
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
    suffix, syslen = spec

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    val_has_esc = np.asarray(out["val_has_esc"][:n], dtype=bool)
    cand = ok & (lens64 <= max_len) & ~has_high
    if val_has_esc.shape[1]:
        cand &= ~val_has_esc.any(axis=1)

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        res = _native_rows(chunk_bytes, starts64, out, n, ridx, suffix,
                           syslen)
        if res is not None:
            buf, row_off = res
            tier_lens = np.diff(row_off)
            if syslen:
                prefix_lens_tier = syslen_prefix_lens_from_framed(tier_lens)
            final_buf = buf.tobytes()
            return finish_block(chunk_bytes, starts64, lens64, n, cand,
                                ridx, final_buf, row_off,
                                prefix_lens_tier, suffix, syslen, merger,
                                encoder)

    if R:
        chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
        st = starts64[ridx]

        def span(skey, ekey):
            a = st + np.asarray(out[skey])[:n][ridx]
            return a, st + np.asarray(out[ekey])[:n][ridx] - a

        host_s, host_l = span("host_start", "host_end")
        app_s, app_l = span("app_start", "app_end")
        proc_s, proc_l = span("proc_start", "proc_end")
        msgid_s, msgid_l = span("msgid_start", "msgid_end")
        msg_s = st + np.asarray(out["msg_trim_start"])[:n][ridx]
        msg_l = st + np.asarray(out["trim_end"])[:n][ridx] - msg_s

        fac = np.asarray(out["facility"])[:n][ridx].astype(np.int64)
        sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)
        pri = (fac << 3) + sev
        sdc = np.asarray(out["sd_count"])[:n][ridx].astype(np.int64)
        pc = np.asarray(out["pair_count"])[:n][ridx].astype(np.int64)
        nsd = sdc > 0

        scratch, ts_off, ts_len = ts_scratch(out, n, ridx,
                                             unix_to_rfc3339_ms)
        consts, offs = build_source(
            b"<", b">1 ", b" ", b'="', b'"', b"[", b"]", b"-",
            b"0123456789 ", suffix, scratch)
        (o_lt, o_gt1, o_sp, o_eqq, o_q, o_lb, o_rb, o_dash,
         o_dec, o_sfx, o_ts) = offs
        cbase = int(chunk_arr.size)
        src = np.concatenate([chunk_arr, consts])

        # segment plan per row:
        #   head (15): '<' d d d '>1 ' ts ' ' host ' ' app ' ' proc ' '
        #              msgid ' '
        #   sd: per block '[' sid ... ']' (3 + 5*pairs segs); dash rows 1
        #   tail (3): ' ' msg framing-suffix
        HEAD = 15
        sd_segs = np.where(nsd, 3 * sdc + 5 * pc, 1)
        segc = HEAD + sd_segs + 3
        rstart = exclusive_cumsum(segc)[:-1]
        S = int(segc.sum())
        seg_src = np.zeros(S, dtype=np.int64)
        seg_len = np.zeros(S, dtype=np.int64)

        hd = rstart[:, None] + np.arange(HEAD, dtype=np.int64)[None, :]
        hsrc = np.empty((R, HEAD), dtype=np.int64)
        hlen = np.empty((R, HEAD), dtype=np.int64)
        dsrc, dlen = decimal_segments(pri, cbase + o_dec, width=3)
        cols = (
            (cbase + o_lt, 1),
            (dsrc[0::3], dlen[0::3]),
            (dsrc[1::3], dlen[1::3]),
            (dsrc[2::3], dlen[2::3]),
            (cbase + o_gt1, 3),
            (cbase + o_ts + ts_off, ts_len),
            (cbase + o_sp, 1),
            (host_s, host_l),
            (cbase + o_sp, 1),
            (app_s, app_l),
            (cbase + o_sp, 1),
            (proc_s, proc_l),
            (cbase + o_sp, 1),
            (msgid_s, msgid_l),
            (cbase + o_sp, 1),
        )
        for k, (s, ln) in enumerate(cols):
            hsrc[:, k] = s
            hlen[:, k] = ln
        seg_src[hd] = hsrc
        seg_len[hd] = hlen

        # dash rows
        dmask = ~nsd
        if dmask.any():
            dpos = rstart[dmask] + HEAD
            seg_src[dpos] = cbase + o_dash
            seg_len[dpos] = 1

        # blocks + pairs
        max_sd = np.asarray(out["sid_start"]).shape[1]
        P = np.asarray(out["name_start"]).shape[1]
        if nsd.any():
            pair_sd = np.asarray(out["pair_sd"])[:n][ridx]       # [R, P]
            jmask = np.arange(P)[None, :] < pc[:, None]
            # pairs with pair_sd < k, per row/block -> block seg offsets
            pb_rb = ((pair_sd[:, None, :] < np.arange(max_sd)[None, :, None])
                     & jmask[:, None, :]).sum(axis=2)            # [R, max_sd]
            p_in = ((pair_sd[:, None, :] == np.arange(max_sd)[None, :, None])
                    & jmask[:, None, :]).sum(axis=2)
            kmask = np.arange(max_sd)[None, :] < sdc[:, None]
            bstart = (rstart[:, None] + HEAD + 3 * np.arange(max_sd)[None, :]
                      + 5 * pb_rb)                               # [R, max_sd]
            sid_s = st[:, None] + np.asarray(out["sid_start"])[:n][ridx]
            sid_e = st[:, None] + np.asarray(out["sid_end"])[:n][ridx]
            km = kmask & nsd[:, None]
            seg_src[bstart[km]] = cbase + o_lb
            seg_len[bstart[km]] = 1
            seg_src[bstart[km] + 1] = sid_s[km]
            seg_len[bstart[km] + 1] = (sid_e - sid_s)[km]
            rb_pos = bstart + 2 + 5 * p_in
            seg_src[rb_pos[km]] = cbase + o_rb
            seg_len[rb_pos[km]] = 1

            # pair segments: ' ' name '="' value '"'; within-block
            # ordinal = j - pairs_before_block(row, block_of_j)
            rows2 = np.repeat(np.arange(R), pc)
            jop = np.arange(int(pc.sum())) - np.repeat(
                exclusive_cumsum(pc)[:-1], pc)
            b_of = pair_sd[rows2, jop]
            w_of = jop - pb_rb[rows2, b_of]
            p0 = bstart[rows2, b_of] + 2 + 5 * w_of
            ns = st[rows2] + np.asarray(out["name_start"])[:n][ridx][rows2, jop]
            ne = st[rows2] + np.asarray(out["name_end"])[:n][ridx][rows2, jop]
            vs = st[rows2] + np.asarray(out["val_start"])[:n][ridx][rows2, jop]
            ve = st[rows2] + np.asarray(out["val_end"])[:n][ridx][rows2, jop]
            seg_src[p0] = cbase + o_sp
            seg_len[p0] = 1
            seg_src[p0 + 1] = ns
            seg_len[p0 + 1] = ne - ns
            seg_src[p0 + 2] = cbase + o_eqq
            seg_len[p0 + 2] = 2
            seg_src[p0 + 3] = vs
            seg_len[p0 + 3] = ve - vs
            seg_src[p0 + 4] = cbase + o_q
            seg_len[p0 + 4] = 1

        # tail: ' ' + msg + framing suffix
        t0 = rstart + HEAD + sd_segs
        seg_src[t0] = cbase + o_sp
        seg_len[t0] = 1
        seg_src[t0 + 1] = msg_s
        seg_len[t0 + 1] = msg_l
        seg_src[t0 + 2] = cbase + o_sfx
        seg_len[t0 + 2] = len(suffix)

        dst0 = exclusive_cumsum(seg_len)
        body = concat_segments(src, seg_src, seg_len, dst0)
        row_off = np.concatenate([dst0[rstart], dst0[-1:]])
        tier_lens = np.diff(row_off)
        if syslen:
            final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
                body, row_off, tier_lens)
        else:
            final_buf = body.tobytes()

    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder)



def encode_rfc3164_rfc5424_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """rfc3164→RFC5424 relay upgrade (rfc5424_encoder.rs:28-93 over the
    legacy Record shape): PRI digits when the line carried one (else
    the encoder's <13> default), re-formatted ms-truncated RFC3339
    stamp, host + message tail spans, and the constant "- - -"
    proc/msgid/sd slots (appname is absent, so its slot is skipped —
    exactly the scalar encoder's gating)."""
    from .encode_ltsv_block import _ltsv_core
    from .materialize_rfc3164 import _scalar_3164

    spec = merger_suffix(merger)
    if spec is None:
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
    if not R:
        return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                            b"", np.zeros(1, dtype=np.int64), None,
                            suffix, syslen, merger, encoder,
                            scalar_fn=_scalar_3164)
    st = starts64[ridx]
    host_a = st + np.asarray(out["host_start"])[:n][ridx].astype(np.int64)
    host_l = (np.asarray(out["host_end"])[:n][ridx].astype(np.int64)
              - np.asarray(out["host_start"])[:n][ridx].astype(np.int64))
    msg_a = st + np.asarray(out["msg_start"])[:n][ridx].astype(np.int64)
    msg_l = np.maximum(st + lens64[ridx] - msg_a, 0)
    has_pri = np.asarray(out["has_pri"][:n], dtype=bool)[ridx]
    fac = np.asarray(out["facility"])[:n][ridx].astype(np.int64)
    sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)
    pri = (fac << 3) + sev

    scratch, ts_off, ts_len = ts_scratch(out, n, ridx,
                                         unix_to_rfc3339_ms)
    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    consts, offs = build_source(
        b"<", b">1 ", b"<13>1 ", b" ", b" - - - ", b"0123456789",
        suffix, scratch)
    (o_lt, o_gt1, o_dflt, o_sp, o_tail, o_dec, o_sfx, o_ts) = offs
    cbase = int(chunk_arr.size)
    src = np.concatenate([chunk_arr, consts])

    pri_d = decimal_segments(pri, cbase + o_dec, width=3)
    pc = np.zeros(R, dtype=np.int64)
    cols = (
        (np.where(has_pri, cbase + o_lt, 0), np.where(has_pri, 1, 0)),
        (pri_d[0][0::3], np.where(has_pri, pri_d[1][0::3], 0)),
        (pri_d[0][1::3], np.where(has_pri, pri_d[1][1::3], 0)),
        (pri_d[0][2::3], np.where(has_pri, pri_d[1][2::3], 0)),
        (np.where(has_pri, cbase + o_gt1, cbase + o_dflt),
         np.where(has_pri, len(b">1 "), len(b"<13>1 "))),
        (cbase + o_ts + ts_off, ts_len),
        (cbase + o_sp, 1),
        (host_a, host_l),
        (cbase + o_tail, len(b" - - - ")),
        (msg_a, msg_l),
        (cbase + o_sfx, len(suffix)),
    )
    return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                      src, cbase, pc, None, 0, 0,
                      cols, (), suffix, syslen, merger, encoder,
                      scalar_fn=_scalar_3164)


def _rfc5424_sd_assemble(chunk_bytes, chunk_arr, src, offs, starts64,
                         lens64, n, cand, ridx, pc, ts_off, ts_len,
                         host_a, host_l, msg_a, msg_l, has_msg, pairs,
                         suffix, syslen, merger, encoder, scalar_fn):
    """Shared RFC5424 row assembly for the Record-shaped routes
    (gelf→RFC5424, ltsv→RFC5424): constant <13> PRI head, rfc3339-ms
    stamp, host, " - - " proc/msgid slots, one SD block (or "- "),
    optional message, framing suffix.

    ``offs`` is the build_source offset tuple for the consts
    ``("<13>1 ", " ", " - - ", "[", "] ", "- ", ' ', '="', '"',
    suffix, scratch)``; ``pairs`` is None or ``(rr [T] compacted row
    ids ASCENDING, ns, nlen, eqlen, vsrc, vlen, qlen)`` — the three
    length columns let callers gate null values (bare names)."""
    (o_pri, o_sp, o_tail3, o_open, o_close, o_dash2, o_psp, o_eq,
     o_q, o_sfx, o_ts) = offs
    cbase = int(chunk_arr.size)
    R = ridx.size
    has_sd = pc > 0

    HEAD = 6
    TAIL = 3
    segc = HEAD + 5 * pc + TAIL
    rstart = exclusive_cumsum(segc)[:-1]
    S = int(segc.sum())
    seg_src = np.zeros(S, dtype=np.int64)
    seg_len = np.zeros(S, dtype=np.int64)

    head = (
        (np.full(R, cbase + o_pri), np.full(R, 6)),   # "<13>1 "
        (cbase + o_ts + ts_off, ts_len),
        (np.full(R, cbase + o_sp), np.full(R, 1)),
        (host_a, host_l),
        (np.full(R, cbase + o_tail3), np.full(R, 5)),  # " - - "
        (np.full(R, cbase + o_open), np.where(has_sd, 1, 0)),
    )
    for k, (sv, lv) in enumerate(head):
        seg_src[rstart + k] = sv
        seg_len[rstart + k] = lv

    if pairs is not None and pairs[0].size:
        rr, ns, nlen, eqlen, vsrc, vlen, qlen = pairs
        new_row = np.ones(rr.size, dtype=bool)
        new_row[1:] = rr[1:] != rr[:-1]
        run_starts = np.flatnonzero(new_row)
        within = (np.arange(rr.size)
                  - np.repeat(run_starts,
                              np.diff(np.append(run_starts, rr.size))))
        p0 = rstart[rr] + HEAD + 5 * within
        seg_src[p0] = cbase + o_psp
        seg_len[p0] = 1
        seg_src[p0 + 1] = ns
        seg_len[p0 + 1] = nlen
        seg_src[p0 + 2] = cbase + o_eq
        seg_len[p0 + 2] = eqlen
        seg_src[p0 + 3] = vsrc
        seg_len[p0 + 3] = vlen
        seg_src[p0 + 4] = cbase + o_q
        seg_len[p0 + 4] = qlen

    fd = (rstart + HEAD + 5 * pc)[:, None] + np.arange(
        TAIL, dtype=np.int64)[None, :]
    tail_cols = (
        (np.where(has_sd, cbase + o_close, cbase + o_dash2),
         np.full(R, 2)),
        (msg_a, np.where(has_msg, msg_l, 0)),
        (np.full(R, cbase + o_sfx), np.full(R, len(suffix))),
    )
    fsrc = np.empty((R, TAIL), dtype=np.int64)
    flen = np.empty((R, TAIL), dtype=np.int64)
    for k, (sv, lv) in enumerate(tail_cols):
        fsrc[:, k] = sv
        flen[:, k] = lv
    seg_src[fd] = fsrc
    seg_len[fd] = flen

    dst0 = exclusive_cumsum(seg_len)
    body = concat_segments(src, seg_src, seg_len, dst0)
    row_off = np.concatenate([dst0[rstart], dst0[-1:]])
    prefix_lens_tier = None
    if syslen:
        final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
            body, row_off, np.diff(row_off))
    else:
        final_buf = body.tobytes()
    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, scalar_fn=scalar_fn)


def encode_gelf_rfc5424_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """gelf→RFC5424 (rfc5424_encoder.rs:28-93 over the GELF Record
    shape): facility is always absent so PRI is the constant <13>
    default; the stamp re-formats ms-truncated rfc3339 from the parsed
    value; appname's slot is skipped, procid/msgid render "-", and the
    typed pairs rebuild one SD block in sorted-ORIGINAL-key Record
    order — ``[ name="value" ...]`` with nulls as bare names, bools as
    constants, clean strings/canonical ints verbatim (record.rs:42-68
    does not escape values, and the escape-free tier's strings cannot
    contain a quote)."""
    from .block_common import gelf_sorted_pairs
    from .encode_gelf_gelf_block import _NAME_CAP, gelf_screen
    from .jsonidx import VT_FALSE, VT_NULL, VT_NUMBER, VT_STRING, VT_TRUE
    from .materialize_gelf import _scalar_gelf

    spec = merger_suffix(merger)
    if spec is None:
        return None
    suffix, syslen = spec

    s = gelf_screen(chunk_bytes, starts, orig_lens, out, n_real, max_len)
    n, starts64, lens64, cand = (s["n"], s["starts64"], s["lens64"],
                                 s["cand"])
    chunk_arr = s["chunk_arr"]
    is_pair = s["is_pair"] & cand[:, None]

    rop_s, ns_s, ne_s, pv_t, pv_a, pv_b = gelf_sorted_pairs(
        chunk_arr, starts64, cand, is_pair, s["kabs"], s["key_e"],
        s["vabs_a"], s["vabs_b"], s["val_t"], s["byte_at"], _NAME_CAP)

    ridx = np.flatnonzero(cand)
    R = ridx.size
    if not R:
        return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                            b"", np.zeros(1, dtype=np.int64), None,
                            suffix, syslen, merger, encoder,
                            scalar_fn=_scalar_gelf)

    # timestamps: per-unique span parse + rfc3339-ms format, one pass
    from .block_common import span_f64_scratch

    scratch, ts_off, ts_len = span_f64_scratch(
        chunk_bytes, s["tsa_all"][ridx], s["tsb_all"][ridx],
        unix_to_rfc3339_ms)

    host_a0, host_b0 = s["vspan_at"](s["host_f"])
    host_a, host_l = host_a0[ridx], (host_b0 - host_a0)[ridx]
    msg_a0, msg_b0 = s["vspan_at"](s["short_f"])
    msg_a, msg_l = msg_a0[ridx], (msg_b0 - msg_a0)[ridx]
    has_msg = s["has_short"][ridx]

    consts, offs = build_source(
        b"<13>1 ", b" ", b" - - ", b"[", b"] ", b"- ", b' ', b'="',
        b'"', suffix, scratch, b"true", b"false")
    o_true, o_false = offs[11], offs[12]
    chunk_src = np.concatenate([chunk_arr, consts])
    cbase = int(chunk_arr.size)

    # pc in ORIGINAL row space, selected down to the candidate rows
    pc = (np.bincount(rop_s, minlength=n)[ridx].astype(np.int64)
          if rop_s.size else np.zeros(R, dtype=np.int64))

    pairs = None
    if rop_s.size:
        tpos = np.cumsum(cand) - 1
        rr = tpos[rop_s]
        is_null = pv_t == VT_NULL
        is_txt = (pv_t == VT_STRING) | (pv_t == VT_NUMBER)
        vsrc = np.where(is_txt, pv_a,
                        np.where(pv_t == VT_TRUE, cbase + o_true,
                                 np.where(pv_t == VT_FALSE,
                                          cbase + o_false, 0)))
        vlen = np.where(is_txt, pv_b - pv_a,
                        np.where(pv_t == VT_TRUE, 4,
                                 np.where(pv_t == VT_FALSE, 5, 0)))
        pairs = (rr, ns_s, ne_s - ns_s,
                 np.where(is_null, 0, 2),
                 vsrc, np.where(is_null, 0, vlen),
                 np.where(is_null, 0, 1))

    return _rfc5424_sd_assemble(
        chunk_bytes, chunk_arr, chunk_src, offs[:11], starts64, lens64,
        n, cand, ridx, pc, ts_off, ts_len, host_a, host_l, msg_a, msg_l,
        has_msg, pairs, suffix, syslen, merger, encoder, _scalar_gelf)


def encode_ltsv_rfc5424_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
    decoder=None,
) -> Optional[BlockResult]:
    """ltsv→RFC5424: facility is always absent so PRI is the constant
    <13> default; stamps re-format ms-truncated rfc3339 (rfc3339 rows
    from the calendar channels, unix literals from the split-integer
    parse); pairs rebuild one SD block in PART order (the Record keeps
    insertion order; record.rs:42-68 renders values unescaped, so raw
    spans are exact).  Typed ``ltsv_schema`` keeps the Record path."""
    from .block_common import (
        ltsv_special_screen,
        ltsv_ts_vals,
        vals_scratch,
    )
    from .materialize_ltsv import _scalar_ltsv

    spec = merger_suffix(merger)
    if spec is None:
        return None
    if decoder is not None and getattr(decoder, "schema", None):
        return None
    suffix, syslen = spec

    def scalar_fn(line):
        return _scalar_ltsv(decoder, line)

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    n_parts = np.asarray(out["n_parts"])[:n].astype(np.int64)
    part_start = np.asarray(out["part_start"])[:n]
    part_end = np.asarray(out["part_end"])[:n]
    colon_pos = np.asarray(out["colon_pos"])[:n]
    host_pos = np.asarray(out["host_pos"])[:n]

    P = part_start.shape[1]
    jmask = np.arange(P)[None, :] < n_parts[:, None]
    cand = ok & (lens64 <= max_len) & ~has_high & (host_pos >= 0)
    cand &= ~(jmask & (colon_pos < 0)).any(axis=1)
    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    nlen = np.where(jmask, colon_pos - part_start, 0)
    special_name, uniq_ok = ltsv_special_screen(
        chunk_arr, starts64, part_start, nlen, jmask)
    cand &= uniq_ok

    ridx = np.flatnonzero(cand)
    R = ridx.size
    if not R:
        return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                            b"", np.zeros(1, dtype=np.int64), None,
                            suffix, syslen, merger, encoder,
                            scalar_fn=scalar_fn)
    st = starts64[ridx]

    ts_vals = ltsv_ts_vals(out, n, ridx, chunk_bytes, starts64)
    scratch, ts_off, ts_len = vals_scratch(ts_vals, unix_to_rfc3339_ms)

    host_a = st + np.asarray(out["host_start"])[:n][ridx].astype(np.int64)
    host_l = (np.asarray(out["host_end"])[:n][ridx].astype(np.int64)
              - np.asarray(out["host_start"])[:n][ridx].astype(np.int64))
    msg_a = st + np.asarray(out["msg_start"])[:n][ridx].astype(np.int64)
    msg_l = (np.asarray(out["msg_end"])[:n][ridx].astype(np.int64)
             - np.asarray(out["msg_start"])[:n][ridx].astype(np.int64))
    has_msg = np.asarray(out["msg_pos"])[:n][ridx].astype(np.int64) >= 0

    consts, offs = build_source(
        b"<13>1 ", b" ", b" - - ", b"[", b"] ", b"- ", b' ', b'="',
        b'"', suffix, scratch)
    chunk_src = np.concatenate([chunk_arr, consts])

    # pairs in PART order: non-special parts, raw name/value spans
    is_pair = jmask[ridx] & ~special_name[ridx]
    pc = is_pair.sum(axis=1).astype(np.int64)

    pairs = None
    if int(pc.sum()):
        rr2, cc = np.nonzero(is_pair)
        rop = rr2.astype(np.int64)
        ns = st[rop] + part_start[ridx][rr2, cc].astype(np.int64)
        ne = st[rop] + colon_pos[ridx][rr2, cc].astype(np.int64)
        ve = st[rop] + part_end[ridx][rr2, cc].astype(np.int64)
        T = rop.size
        pairs = (rop, ns, ne - ns, np.full(T, 2), ne + 1, ve - ne - 1,
                 np.full(T, 1))

    return _rfc5424_sd_assemble(
        chunk_bytes, chunk_arr, chunk_src, offs, starts64, lens64, n,
        cand, ridx, pc, ts_off, ts_len, host_a, host_l, msg_a, msg_l,
        has_msg, pairs, suffix, syslen, merger, encoder, scalar_fn)
