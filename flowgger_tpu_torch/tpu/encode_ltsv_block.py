"""Columnar → LTSV encoding: span tables → one framed output buffer per
batch (ltsv_encoder.rs:65-125 semantics), for the rfc5424, ltsv
(self-encode re-canonicalization), rfc3164 and gelf decoders.

Field order per record: SD pairs (leading ``_`` stripped — i.e. the raw
decoded name span), ltsv_extra config pairs (static, pre-rendered),
host, time, message?, full_message?, level?, facility?, appname?,
procid?, msgid?.  Value escaping (tab/newline → space) is handled two
ways: spans that cannot contain a tab by construction re-emit raw, and
the one that can (a full_message covering a tab-separated LTSV line)
gets one vectorized tab→space pass over its destination intervals
after the gather; rows with newlines (possible only under nul/syslen
framing) fall back.  SD names containing ``:`` (the only key escape)
are screened per-span.

A copy of the JAX package's ``tpu/encode_ltsv_block.py`` (its
``encode_rfc5424_ltsv_block`` :51, ``_ltsv_core`` :188,
``encode_ltsv_ltsv_block`` :255, ``encode_rfc3164_ltsv_block`` :386 and
``encode_gelf_ltsv_block`` :483), on the port's own helpers.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# these routes must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.ltsv:LTSVEncoder"
DIFF_TEST = ("tests/test_torch_ltsv_out.py::"
             "test_ltsv_block_matches_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.rustfmt import display_f64
from .assemble import (
    build_source,
    concat_segments,
    count_in_spans,
    decimal_segments,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    finish_block,
    ltsv_extra_blob,
    ltsv_special_screen,
    merger_suffix,
    ts_scratch,
)



def encode_rfc5424_ltsv_block(
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

    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    # rows containing a tab or newline would need LTSV value escaping
    # (both map to space): cumulative count per row span, one pass over
    # the chunk (newlines reach this route via nul/syslen framing)
    esc_cum = np.cumsum((chunk_arr == 9) | (chunk_arr == 10))
    row_esc = count_in_spans(esc_cum, starts64, starts64 + lens64)
    cand &= row_esc == 0
    # SD names containing ':' would need key escaping (rare): count per
    # name span, reduce per row
    pair_count_all = np.asarray(out["pair_count"])[:n]
    if pair_count_all.shape[0] and np.asarray(out["name_start"]).shape[1]:
        P = np.asarray(out["name_start"]).shape[1]
        jmask = np.arange(P)[None, :] < pair_count_all[:, None]
        ns_all = starts64[:, None] + np.asarray(out["name_start"])[:n]
        ne_all = starts64[:, None] + np.asarray(out["name_end"])[:n]
        col_cum = np.cumsum(chunk_arr == ord(":"))
        ncols = np.where(jmask,
                         count_in_spans(col_cum, ns_all, ne_all), 0)
        cand &= ncols.sum(axis=1) == 0

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        st = starts64[ridx]

        def span(skey, ekey):
            a = st + np.asarray(out[skey])[:n][ridx]
            return a, st + np.asarray(out[ekey])[:n][ridx] - a

        host_s, host_l = span("host_start", "host_end")
        app_s, app_l = span("app_start", "app_end")
        proc_s, proc_l = span("proc_start", "proc_end")
        msgid_s, msgid_l = span("msgid_start", "msgid_end")
        full_s = st + np.asarray(out["full_start"])[:n][ridx]
        full_l = st + np.asarray(out["trim_end"])[:n][ridx] - full_s
        msg_s = st + np.asarray(out["msg_trim_start"])[:n][ridx]
        msg_l = st + np.asarray(out["trim_end"])[:n][ridx] - msg_s

        fac = np.asarray(out["facility"])[:n][ridx].astype(np.int64)
        sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)
        pc = np.asarray(out["pair_count"])[:n][ridx].astype(np.int64)

        scratch, ts_off, ts_len = ts_scratch(out, n, ridx, display_f64)

        # static extra pairs, key/value-escaped once
        extra_blob = ltsv_extra_blob(encoder.extra)

        consts, offs = build_source(
            b":", b"\t", b"host:", b"\ttime:", b"\tmessage:",
            b"\tfull_message:", b"\tlevel:", b"\tfacility:",
            b"\tappname:", b"\tprocid:", b"\tmsgid:",
            b"0123456789 ", suffix, extra_blob, scratch)
        (o_col, o_tab, o_host, o_time, o_msg, o_full, o_lvl, o_fac,
         o_app, o_proc, o_msgid, o_dec, o_sfx, o_extra, o_ts) = offs
        cbase = int(chunk_arr.size)
        src = np.concatenate([chunk_arr, consts])

        T2 = int(pc.sum())
        if T2:
            rows2 = np.repeat(np.arange(R), pc)
            jop = np.arange(T2) - np.repeat(exclusive_cumsum(pc)[:-1], pc)
            pair_flat = (
                st[rows2] + np.asarray(out["name_start"])[:n][ridx][rows2, jop],
                st[rows2] + np.asarray(out["name_end"])[:n][ridx][rows2, jop],
                st[rows2] + np.asarray(out["val_start"])[:n][ridx][rows2, jop],
                st[rows2] + np.asarray(out["val_end"])[:n][ridx][rows2, jop],
            )
        else:
            pair_flat = None

        fac_d = decimal_segments(fac, cbase + o_dec, width=2)
        has_msg = msg_l > 0
        cols = (
            (cbase + o_extra, len(extra_blob)),
            # "host:" carries no leading tab — the pair stream and the
            # extra blob are tab-terminated, so it is always either the
            # first part or already separated
            (cbase + o_host, len(b"host:")),
            (host_s, host_l),
            (cbase + o_time, len(b"\ttime:")),
            (cbase + o_ts + ts_off, ts_len),
            (np.where(has_msg, cbase + o_msg, 0),
             np.where(has_msg, len(b"\tmessage:"), 0)),
            (msg_s, msg_l),
            (cbase + o_full, len(b"\tfull_message:")),
            (full_s, full_l),
            (cbase + o_lvl, len(b"\tlevel:")),
            (cbase + o_dec + sev, 1),
            (cbase + o_fac, len(b"\tfacility:")),
            (fac_d[0][0::2], fac_d[1][0::2]),
            (fac_d[0][1::2], fac_d[1][1::2]),
            (cbase + o_app, len(b"\tappname:")),
            (app_s, app_l),
            (cbase + o_proc, len(b"\tprocid:")),
            (proc_s, proc_l),
            (cbase + o_msgid, len(b"\tmsgid:")),
            (msgid_s, msgid_l),
            (cbase + o_sfx, len(suffix)),
        )
        return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                          src, cbase, pc, pair_flat, o_col, o_tab,
                          cols, (), suffix, syslen, merger, encoder)

    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder)


def _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx, src, cbase,
               pc, pair_flat, o_col, o_tab, fixed_cols, tabfix,
               suffix, syslen, merger, encoder, scalar_fn=None):
    """Segment assembly shared by every →LTSV wrapper.

    Per row: pairs (4 segs each: name ':' value '\\t'), then
    ``fixed_cols`` — (src [R]|scalar, len [R]|scalar) columns; leading
    tabs ride each "\\t<key>:" const.  ``pair_flat``: (ns, ne, vs, ve)
    absolute spans flattened row-major over valid pairs.  ``tabfix``:
    indices into fixed_cols whose gathered bytes get the LTSV value
    escape (tab→space) — one vectorized interval pass over the body."""
    R = ridx.size
    FIXED = len(fixed_cols)
    segc = 4 * pc + FIXED
    rstart = exclusive_cumsum(segc)[:-1]
    S = int(segc.sum())
    seg_src = np.zeros(S, dtype=np.int64)
    seg_len = np.zeros(S, dtype=np.int64)
    T2 = int(pc.sum())
    if T2:
        ns, ne, vs, ve = pair_flat
        rows2 = np.repeat(np.arange(R), pc)
        jop = np.arange(T2) - np.repeat(exclusive_cumsum(pc)[:-1], pc)
        p0 = rstart[rows2] + 4 * jop
        seg_src[p0] = ns
        seg_len[p0] = ne - ns
        seg_src[p0 + 1] = cbase + o_col
        seg_len[p0 + 1] = 1
        seg_src[p0 + 2] = vs
        seg_len[p0 + 2] = ve - vs
        seg_src[p0 + 3] = cbase + o_tab
        seg_len[p0 + 3] = 1

    fd = (rstart + 4 * pc)[:, None] + np.arange(FIXED,
                                                dtype=np.int64)[None, :]
    fsrc = np.empty((R, FIXED), dtype=np.int64)
    flen = np.empty((R, FIXED), dtype=np.int64)
    for k, (s, ln) in enumerate(fixed_cols):
        fsrc[:, k] = s
        flen[:, k] = ln
    seg_src[fd] = fsrc
    seg_len[fd] = flen

    dst0 = exclusive_cumsum(seg_len)
    body = concat_segments(src, seg_src, seg_len, dst0)
    for k in tabfix:
        a = dst0[fd[:, k]]
        ln = flen[:, k]
        d = np.zeros(body.size + 1, dtype=np.int64)
        np.add.at(d, a, 1)
        np.add.at(d, a + ln, -1)
        inside = np.cumsum(d[:-1]) > 0
        body[inside & (body == 9)] = 32
    row_off = np.concatenate([dst0[rstart], dst0[-1:]])
    tier_lens = np.diff(row_off)
    prefix_lens_tier = None
    if syslen:
        final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
            body, row_off, tier_lens)
    else:
        final_buf = body.tobytes()
    kw = {} if scalar_fn is None else {"scalar_fn": scalar_fn}
    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, **kw)


def encode_ltsv_ltsv_block(
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
    """LTSV→LTSV re-canonicalization (the reference's self-encode,
    ltsv_encoder.rs:65-125): pairs keep their raw name/value spans (no
    tab/colon possible by construction), the timestamp re-formats as
    Rust Display, and full_message (the original tab-separated line)
    takes the vectorized tab→space value escape.  Typed ``ltsv_schema``
    rows keep the Record path (per-value rendering is host work)."""
    from .block_common import ltsv_ts_vals, vals_scratch
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
    # newlines (possible under nul/syslen framing) would need the value
    # escape in arbitrary spans: screen per row, one cumsum pass
    nl_cum = np.cumsum(chunk_arr == 10)
    cand &= count_in_spans(nl_cum, starts64, starts64 + lens64) == 0

    # specials route by NAME; repeated special names → oracle (shared
    # screen, block_common.ltsv_special_screen)
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

    def sp(a_key, b_key):
        a = np.asarray(out[a_key])[:n][ridx].astype(np.int64)
        b = np.asarray(out[b_key])[:n][ridx].astype(np.int64)
        return st + a, np.maximum(b - a, 0)

    host_s, host_l = sp("host_start", "host_end")
    msg_s, msg_l = sp("msg_start", "msg_end")
    has_msg = np.asarray(out["msg_pos"])[:n][ridx].astype(np.int64) >= 0
    level = np.asarray(out["level_val"])[:n][ridx].astype(np.int64)
    has_lvl = level >= 0

    ts = ltsv_ts_vals(out, n, ridx, chunk_bytes, starts64)
    scratch, ts_off, ts_len = vals_scratch(ts, display_f64)

    extra_blob = ltsv_extra_blob(encoder.extra)

    consts, offs = build_source(
        b":", b"\t", b"host:", b"\ttime:", b"\tmessage:",
        b"\tfull_message:", b"\tlevel:", b"0123456789",
        suffix, extra_blob, scratch)
    (o_col, o_tab, o_host, o_time, o_msg, o_full, o_lvl, o_dec,
     o_sfx, o_extra, o_ts) = offs
    cbase = int(chunk_arr.size)
    src = np.concatenate([chunk_arr, consts])

    # pairs: non-special parts in part order (raw "_"-stripped names)
    is_pair = jmask[ridx] & ~special_name[ridx]
    pc = is_pair.sum(axis=1).astype(np.int64)
    if int(pc.sum()):
        rr, cc = np.nonzero(is_pair)
        rop = rr.astype(np.int64)
        pair_flat = (
            st[rop] + part_start[ridx][rr, cc].astype(np.int64),
            st[rop] + colon_pos[ridx][rr, cc].astype(np.int64),
            st[rop] + colon_pos[ridx][rr, cc].astype(np.int64) + 1,
            st[rop] + part_end[ridx][rr, cc].astype(np.int64),
        )
    else:
        pair_flat = None

    cols = (
        (cbase + o_extra, len(extra_blob)),
        (cbase + o_host, len(b"host:")),
        (host_s, host_l),
        (cbase + o_time, len(b"\ttime:")),
        (cbase + o_ts + ts_off, ts_len),
        (np.where(has_msg, cbase + o_msg, 0),
         np.where(has_msg, len(b"\tmessage:"), 0)),
        (msg_s, np.where(has_msg, msg_l, 0)),
        (cbase + o_full, len(b"\tfull_message:")),
        (st, lens64[ridx]),                      # tab→space fixed below
        (np.where(has_lvl, cbase + o_lvl, 0),
         np.where(has_lvl, len(b"\tlevel:"), 0)),
        (cbase + o_dec + np.maximum(level, 0), np.where(has_lvl, 1, 0)),
        (cbase + o_sfx, len(suffix)),
    )
    return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                      src, cbase, pc, pair_flat, o_col, o_tab,
                      cols, (8,), suffix, syslen, merger, encoder,
                      scalar_fn=scalar_fn)


def encode_rfc3164_ltsv_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """rfc3164→LTSV: host + re-formatted time + message tail + full
    line + PRI-gated level/facility — the Record shape of
    materialize_rfc3164.py through ltsv_encoder.rs:65-125 (the kernel
    rejects control whitespace, so no value escape can fire here)."""
    from .block_common import vals_scratch
    from .materialize import compute_ts
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
    # no tab/newline screen needed: the rfc3164 kernel's strictness
    # pass already rejects any control whitespace in the line, so no
    # candidate span can need the LTSV value escape
    cand = ok & (lens64 <= max_len) & ~has_high
    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)

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

    ts = compute_ts({k: np.asarray(v)[:n][ridx]
                     for k, v in out.items()
                     if k in ("days", "sod", "off", "nanos")})
    scratch, ts_off, ts_len = vals_scratch(ts, display_f64)

    extra_blob = ltsv_extra_blob(encoder.extra)

    consts, offs = build_source(
        b":", b"\t", b"host:", b"\ttime:", b"\tmessage:",
        b"\tfull_message:", b"\tlevel:", b"\tfacility:", b"0123456789",
        suffix, extra_blob, scratch)
    (o_col, o_tab, o_host, o_time, o_msg, o_full, o_lvl, o_fac, o_dec,
     o_sfx, o_extra, o_ts) = offs
    cbase = int(chunk_arr.size)
    src = np.concatenate([chunk_arr, consts])

    fac_d = decimal_segments(fac, cbase + o_dec, width=2)
    pc = np.zeros(R, dtype=np.int64)
    cols = (
        (cbase + o_extra, len(extra_blob)),
        (cbase + o_host, len(b"host:")),
        (host_a, host_l),
        (cbase + o_time, len(b"\ttime:")),
        (cbase + o_ts + ts_off, ts_len),
        (cbase + o_msg, len(b"\tmessage:")),
        (msg_a, msg_l),
        (cbase + o_full, len(b"\tfull_message:")),
        (st, lens64[ridx]),
        (np.where(has_pri, cbase + o_lvl, 0),
         np.where(has_pri, len(b"\tlevel:"), 0)),
        (cbase + o_dec + np.where(has_pri, sev, 0),
         np.where(has_pri, 1, 0)),
        (np.where(has_pri, cbase + o_fac, 0),
         np.where(has_pri, len(b"\tfacility:"), 0)),
        (fac_d[0][0::2], np.where(has_pri, fac_d[1][0::2], 0)),
        (fac_d[0][1::2], np.where(has_pri, fac_d[1][1::2], 0)),
        (cbase + o_sfx, len(suffix)),
    )
    return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                      src, cbase, pc, None, o_col, o_tab,
                      cols, (), suffix, syslen, merger, encoder,
                      scalar_fn=_scalar_3164)


def encode_gelf_ltsv_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """gelf→LTSV: the JSON tokenizer's spans through ltsv_encoder
    semantics.  Pairs emit in the Record's construction order — sorted
    by ORIGINAL key (materialize_gelf routes sorted(obj.keys()); the
    GELF re-encode sorts by final name instead) — with the leading
    ``_`` stripped back off; clean strings / canonical ints re-emit
    verbatim, true/false/null are constants, and the timestamp
    re-formats as Rust Display through the dedup scratch.  Duplicate
    keys (dict last-wins), floats, and escaped strings take the
    oracle."""
    from .encode_gelf_gelf_block import _NAME_CAP, gelf_screen
    from .jsonidx import VT_FALSE, VT_NUMBER, VT_STRING, VT_TRUE
    from .materialize_gelf import _scalar_gelf

    spec = merger_suffix(merger)
    if spec is None:
        return None
    suffix, syslen = spec

    s = gelf_screen(chunk_bytes, starts, orig_lens, out, n_real, max_len)
    n, starts64, lens64, cand = (s["n"], s["starts64"], s["lens64"],
                                 s["cand"])
    chunk_arr, kabs, key_e = s["chunk_arr"], s["kabs"], s["key_e"]
    byte_at, vt_at, vspan_at = s["byte_at"], s["vt_at"], s["vspan_at"]
    is_pair = s["is_pair"] & cand[:, None]
    vabs_a, vabs_b = s["vabs_a"], s["vabs_b"]
    val_t = s["val_t"]

    # ---- pair table in ORIGINAL-key sorted order (shared helper;
    # drops duplicate-key rows from cand) --------------------------------
    from .block_common import gelf_sorted_pairs

    rop_s, ns_s, ne_s, pv_t, pv_a, pv_b = gelf_sorted_pairs(
        chunk_arr, starts64, cand, is_pair, kabs, key_e, vabs_a, vabs_b,
        val_t, byte_at, _NAME_CAP)

    ridx = np.flatnonzero(cand)
    R = ridx.size
    if not R:
        return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                            b"", np.zeros(1, dtype=np.int64), None,
                            suffix, syslen, merger, encoder,
                            scalar_fn=_scalar_gelf)

    # timestamps: dedupe span texts, per-unique float + Display
    from .block_common import span_f64_scratch

    scratch, ts_off, ts_len = span_f64_scratch(
        chunk_bytes, s["tsa_all"][ridx], s["tsb_all"][ridx], display_f64)

    extra_blob = ltsv_extra_blob(encoder.extra)
    consts, offs = build_source(
        b":", b"\t", b"host:", b"\ttime:", b"\tmessage:",
        b"\tfull_message:", b"\tlevel:", b"true", b"false",
        suffix, extra_blob, scratch)
    (o_col, o_tab, o_host, o_time, o_msg, o_full, o_lvl, o_true,
     o_false, o_sfx, o_extra, o_ts) = offs
    cbase = int(chunk_arr.size)
    src = np.concatenate([chunk_arr, consts])

    # pair values: verbatim spans for strings/ints, consts for literals.
    # pc counts in ORIGINAL row space then selects the candidate rows —
    # rop_s carries original row ids (a fallback row BEFORE a candidate
    # row must not shift the counts).
    if rop_s.size:
        is_txt = (pv_t == VT_STRING) | (pv_t == VT_NUMBER)
        vs_r = np.where(is_txt, pv_a,
                        np.where(pv_t == VT_TRUE, cbase + o_true,
                                 np.where(pv_t == VT_FALSE,
                                          cbase + o_false, 0)))
        vln = np.where(is_txt, pv_b - pv_a,
                       np.where(pv_t == VT_TRUE, 4,
                                np.where(pv_t == VT_FALSE, 5, 0)))
        pair_flat = (ns_s, ne_s, vs_r, vs_r + vln)
        pc = np.bincount(rop_s, minlength=n)[ridx].astype(np.int64)
    else:
        pair_flat = None
        pc = np.zeros(R, dtype=np.int64)

    host_a, host_b = vspan_at(s["host_f"])
    host_a, host_l = host_a[ridx], (host_b - host_a)[ridx]
    sh_a, sh_b = vspan_at(s["short_f"])
    msg_a, msg_l = sh_a[ridx], (sh_b - sh_a)[ridx]
    has_msg = s["has_short"][ridx]
    fm_a, fm_b = vspan_at(s["full_f"])
    full_a, full_l = fm_a[ridx], (fm_b - fm_a)[ridx]
    has_full = s["has_full"][ridx]
    lv_a, _lv_b = vspan_at(s["lvl_f"])
    lv_a = lv_a[ridx]
    has_lvl = s["has_lvl"][ridx]

    cols = (
        (cbase + o_extra, len(extra_blob)),
        (cbase + o_host, len(b"host:")),
        (host_a, host_l),
        (cbase + o_time, len(b"\ttime:")),
        (cbase + o_ts + ts_off, ts_len),
        (np.where(has_msg, cbase + o_msg, 0),
         np.where(has_msg, len(b"\tmessage:"), 0)),
        (msg_a, np.where(has_msg, msg_l, 0)),
        (np.where(has_full, cbase + o_full, 0),
         np.where(has_full, len(b"\tfull_message:"), 0)),
        (full_a, np.where(has_full, full_l, 0)),
        (np.where(has_lvl, cbase + o_lvl, 0),
         np.where(has_lvl, len(b"\tlevel:"), 0)),
        (lv_a, np.where(has_lvl, 1, 0)),
        (cbase + o_sfx, len(suffix)),
    )
    return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                      src, cbase, pc, pair_flat, o_col, o_tab,
                      cols, (), suffix, syslen, merger, encoder,
                      scalar_fn=_scalar_gelf)
