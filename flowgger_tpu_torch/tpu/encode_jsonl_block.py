"""Columnar JSON-lines block encoders: the structural-index span tables
(tpu/jsonl.py) become framed GELF or LTSV bytes per batch.

The decoder (decoders/jsonl.py) routes timestamp/host/message/level
into Record fields and everything else into ``_``-prefixed typed SD
pairs.  On the fast tier every output piece is a raw span or a constant:

- pair keys keep their bytes (conditional ``_`` prefix for GELF, one
  leading ``_`` stripped for LTSV), sorted by final / original name;
- clean strings and canonical integers re-emit verbatim;
  true/false/null are constants;
- ``timestamp`` is float-parsed and re-formatted per row (json_f64 /
  display_f64 through the dedup scratch); missing timestamps — the
  oracle stamps now() — take the oracle;
- host/message default to the GELF encoder's "unknown" / "-" constants.

Everything else — nested-container values, escaped strings, floats,
huge ints, control bytes, duplicate names, non-ASCII — re-runs the
scalar oracle, keeping bytes identical to JSONLDecoder → encoder in
every case.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart these
# routes must stay byte-identical to, and the differential tests that
# enforce them
SCALAR_ORACLE = "flowgger_tpu_torch.decoders.jsonl:JSONLDecoder"
DIFF_TEST = (
    "tests/test_torch_jsonl.py::test_jsonl_gelf_block_matches_scalar_oracle",
    "tests/test_torch_ltsv_out.py::test_ltsv_block_matches_reference",
)

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.rustfmt import json_f64
from .assemble import (
    build_source,
    concat_segments,
    count_in_spans,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    finish_block,
    gelf_sorted_pairs,
    merger_suffix,
    sorted_pair_order,
    span_f64_scratch,
)
from .jsonidx import VT_FALSE, VT_NULL, VT_NUMBER, VT_STRING, VT_TRUE
from .materialize_jsonl import _scalar_jsonl

_SPECIALS = (b"timestamp", b"host", b"message", b"level")
_NAME_CAP = 48
_TSW = 24   # timestamp spans longer than this take the oracle


def jsonl_screen(chunk_bytes, starts, orig_lens, out, n_real: int,
                 max_len: int):
    """JSON-lines route screen: row byte screens, special-key routing
    via packed 8-byte words, per-special validation, and the pair value
    classes the GELF re-emission accepts (clean strings, bools, null,
    canonical ints ≤ 18 digits — container values go to the oracle)."""
    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    n_fields = np.asarray(out["n_fields"])[:n].astype(np.int64)
    key_s = np.asarray(out["key_start"])[:n]
    key_e = np.asarray(out["key_end"])[:n]
    val_s = np.asarray(out["val_start"])[:n]
    val_e = np.asarray(out["val_end"])[:n]
    val_t = np.asarray(out["val_type"])[:n]
    key_esc = np.asarray(out["key_esc"][:n], dtype=bool)
    val_esc = np.asarray(out["val_esc"][:n], dtype=bool)

    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    _KEYW = 16
    chunk_pad = np.concatenate(
        [chunk_arr, np.zeros(max_len + _KEYW + 2, dtype=np.uint8)])
    F = key_s.shape[1]
    jmask = np.arange(F)[None, :] < n_fields[:, None]

    # row-level byte screen: non-ASCII (decode semantics) or any
    # control byte must be absent, one prefix-count pass
    bad_cum = np.cumsum((chunk_arr >= 128) | (chunk_arr < 0x20))
    row_end = starts64 + lens64
    cand = ok & (lens64 <= max_len)
    cand &= count_in_spans(bad_cum, starts64, row_end) == 0
    cand &= ~(jmask & key_esc).any(axis=1)

    kabs = starts64[:, None] + key_s
    klen = key_e - key_s
    k8i = (kabs[:, :, None].astype(np.int32)
           + np.arange(8, dtype=np.int32)[None, None, :])
    k8 = np.where(np.arange(8)[None, None, :] < klen[:, :, None],
                  chunk_pad[k8i], np.uint8(0))
    kwords = np.ascontiguousarray(k8).view(">u8")[:, :, 0]

    def name_is(word: bytes):
        prefix = word[:8] + b"\0" * (8 - min(len(word), 8))
        target = int.from_bytes(prefix, "big")
        m = jmask & (klen == len(word)) & (kwords == np.uint64(target))
        if len(word) > 8 and m.any():
            rr, ff = np.nonzero(m)
            tail_ok = np.ones(rr.size, dtype=bool)
            base = kabs[rr, ff]
            for i, ch in enumerate(word[8:], start=8):
                tail_ok &= chunk_pad[base + i] == ch
            m2 = np.zeros_like(m)
            m2[rr[tail_ok], ff[tail_ok]] = True
            return m2
        return m

    sp_masks = {w: name_is(w) for w in _SPECIALS}
    is_special = np.zeros((n, F), dtype=bool)
    for w, m in sp_masks.items():
        is_special |= m
        cand &= m.sum(axis=1) <= 1  # repeated special keys: oracle

    def field_of(m):
        return m.any(axis=1), m.argmax(axis=1)

    has_ts, ts_f = field_of(sp_masks[b"timestamp"])
    has_host, host_f = field_of(sp_masks[b"host"])
    has_msg, msg_f = field_of(sp_masks[b"message"])
    has_lvl, lvl_f = field_of(sp_masks[b"level"])

    rows = np.arange(n)

    def vt_at(f):
        return val_t[rows, f]

    def vspan_at(f):
        a = starts64 + val_s[rows, f]
        return a, starts64 + val_e[rows, f]

    def vesc_at(f):
        return val_esc[rows, f]

    def byte_at(pos):
        return chunk_pad[np.asarray(pos, dtype=np.int64)]

    nondig_cum = np.cumsum(~((chunk_arr >= ord("0"))
                             & (chunk_arr <= ord("9"))))
    dot_cum = np.cumsum(chunk_arr == ord("."))

    def canonical_number(a, b):
        r"""JSON number grammar ``-?(0|[1-9][0-9]*)(\.[0-9]+)?`` whose
        float() parse matches json.loads semantics (same rules as the
        GELF screen; -0 excluded)."""
        ln = b - a
        first = byte_at(a)
        neg = first == ord("-")
        da = a + neg
        dfirst = byte_at(da)
        last = byte_at(b - 1)
        dots = count_in_spans(dot_cum, a, b)
        nondig = count_in_spans(nondig_cum, a, b)
        okn = (ln > neg) & (nondig == neg.astype(np.int64) + dots)
        okn &= (dots <= 1) & (dfirst != ord(".")) & (last != ord("."))
        okn &= (dfirst != ord("0")) | (b - da == 1) | (byte_at(da + 1)
                                                       == ord("."))
        okn &= ~(neg & (dfirst == ord("0")) & (dots == 0))
        return okn

    # timestamp: required for the tier (the oracle stamps now() when
    # absent — a per-row wall clock no batch constant can reproduce),
    # canonical number, bounded span
    tsa_all, tsb_all = vspan_at(ts_f)
    cand &= has_ts & (vt_at(ts_f) == VT_NUMBER)
    cand &= canonical_number(tsa_all, tsb_all)
    cand &= (tsb_all - tsa_all) <= _TSW
    # host/message: absent or clean strings
    cand &= ~has_host | ((vt_at(host_f) == VT_STRING) & ~vesc_at(host_f))
    cand &= ~has_msg | ((vt_at(msg_f) == VT_STRING) & ~vesc_at(msg_f))
    # level: absent or a bare digit 0-7
    lvl_a, lvl_b = vspan_at(lvl_f)
    lvl_byte = byte_at(lvl_a)
    lvl_ok = ((vt_at(lvl_f) == VT_NUMBER) & (lvl_b - lvl_a == 1)
              & (lvl_byte >= ord("0")) & (lvl_byte <= ord("7")))
    cand &= ~has_lvl | lvl_ok

    # pair fields: clean strings, bools, null, or canonical integers —
    # container values (VT_OBJECT/VT_ARRAY) re-serialize per row and
    # take the oracle
    is_pair = jmask & ~is_special
    vabs_a = starts64[:, None] + val_s
    vabs_b = starts64[:, None] + val_e
    vlen = val_e - val_s
    vfirst = byte_at(vabs_a)
    vsecond = byte_at(vabs_a + 1)
    dot_e_cum = np.cumsum((chunk_arr == ord(".")) | (chunk_arr == ord("e"))
                          | (chunk_arr == ord("E")))
    has_frac = count_in_spans(dot_e_cum, vabs_a, vabs_b) > 0
    neg = vfirst == ord("-")
    digits_len = vlen - neg
    int_ok = ((val_t == VT_NUMBER) & ~has_frac & (digits_len <= 18)
              & canonical_number(vabs_a, vabs_b)
              & ~((vfirst == ord("0")) & (vlen > 1))
              & ~(neg & (vsecond == ord("0"))))
    pair_ok = ((val_t == VT_STRING) & ~val_esc) | (val_t == VT_TRUE) \
        | (val_t == VT_FALSE) | (val_t == VT_NULL) | int_ok
    cand &= (~is_pair | pair_ok).all(axis=1)
    cand &= np.where(jmask, klen, 0).max(axis=1, initial=0) <= _NAME_CAP

    return dict(n=n, starts64=starts64, lens64=lens64, cand=cand,
                chunk_arr=chunk_arr, chunk_pad=chunk_pad, kabs=kabs,
                klen=klen, key_e=key_e, val_s=val_s, val_e=val_e,
                val_t=val_t, val_esc=val_esc, jmask=jmask,
                vabs_a=vabs_a, vabs_b=vabs_b,
                is_pair=is_pair, is_special=is_special,
                byte_at=byte_at, vt_at=vt_at, vspan_at=vspan_at,
                has_ts=has_ts, ts_f=ts_f, tsa_all=tsa_all,
                tsb_all=tsb_all,
                has_host=has_host, host_f=host_f,
                has_msg=has_msg, msg_f=msg_f,
                has_lvl=has_lvl, lvl_f=lvl_f)


def encode_jsonl_gelf_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """jsonl→GELF: sorted-final-name object — pairs (all
    ``_``-prefixed, so they sort before every special), then
    host/level/short_message/timestamp/version."""
    spec = merger_suffix(merger)
    if spec is None or encoder.extra:
        return None
    suffix, syslen = spec

    s = jsonl_screen(chunk_bytes, starts, orig_lens, out, n_real,
                     max_len)
    (n, starts64, lens64, cand, chunk_arr, kabs, klen, key_e, val_s,
     val_e, val_t, jmask, is_pair, byte_at) = (
        s["n"], s["starts64"], s["lens64"], s["cand"], s["chunk_arr"],
        s["kabs"], s["klen"], s["key_e"], s["val_s"], s["val_e"],
        s["val_t"], s["jmask"], s["is_pair"], s["byte_at"])
    tsa_all, tsb_all = s["tsa_all"], s["tsb_all"]
    has_host, host_f = s["has_host"], s["host_f"]
    has_msg, msg_f = s["has_msg"], s["msg_f"]
    has_lvl, lvl_f = s["has_lvl"], s["lvl_f"]
    vabs_a, vabs_b = s["vabs_a"], s["vabs_b"]

    # ---- sorted pair table (by FINAL name: leading '_' skipped) ---------
    is_pair = is_pair & cand[:, None]
    pc = is_pair.sum(axis=1).astype(np.int64)
    T = int(pc.sum())
    if T:
        prow, pcol = np.nonzero(is_pair)
        rop = prow.astype(np.int64)
        ns_abs = kabs[prow, pcol]
        ne_abs = starts64[rop] + key_e[prow, pcol]
        has_us = byte_at(ns_abs) == ord("_")
        order, dup_rows = sorted_pair_order(
            chunk_arr, rop, ns_abs + has_us, ne_abs, _NAME_CAP)
        if dup_rows.size:
            cand[dup_rows] = False
            keep = cand[rop[order]]
            order = order[keep]
        rop_s = rop[order]
        ns_s, ne_s = ns_abs[order], ne_abs[order]
        us_s = has_us[order]
        pv_t = val_t[prow, pcol][order]
        pv_a = vabs_a[prow, pcol][order]
        pv_b = vabs_b[prow, pcol][order]
    else:
        rop_s = ns_s = ne_s = pv_a = pv_b = np.zeros(0, dtype=np.int64)
        us_s = np.zeros(0, dtype=bool)
        pv_t = np.zeros(0, dtype=np.int64)

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        scratch, ts_off, ts_len = span_f64_scratch(
            chunk_bytes, tsa_all[ridx], tsb_all[ridx], json_f64)

        consts, offs = build_source(
            b"{", b'"_', b'"', b'":', b'",', b"true", b"false", b"null",
            b'"host":"', b'"level":', b'"short_message":"',
            b'"timestamp":', b'"version":"1.1"}' + suffix,
            b"unknown", b"-", b",", scratch)
        (o_open, o_kpre, o_q, o_colon, o_qc, o_true, o_false, o_null,
         o_host, o_lvl, o_short, o_ts, o_tail, o_unknown, o_dash,
         o_comma, o_scratch) = offs
        cbase = int(chunk_arr.size)
        src = np.concatenate([chunk_arr, consts])

        # fixed tail is 13 segments; each pair is 7
        FIXED = 13
        p = pc[ridx]
        segc = 1 + 7 * p + FIXED
        rstart = exclusive_cumsum(segc)[:-1]
        S = int(segc.sum())
        seg_src = np.zeros(S, dtype=np.int64)
        seg_len = np.zeros(S, dtype=np.int64)
        seg_src[rstart] = cbase + o_open
        seg_len[rstart] = 1

        if T:
            tpos = np.cumsum(cand) - 1
            tord = tpos[rop_s]
            within = np.zeros(rop_s.size, dtype=np.int64)
            if rop_s.size:
                new_row = np.ones(rop_s.size, dtype=bool)
                new_row[1:] = rop_s[1:] != rop_s[:-1]
                run_starts = np.flatnonzero(new_row)
                within = (np.arange(rop_s.size)
                          - np.repeat(run_starts,
                                      np.diff(np.append(run_starts,
                                                        rop_s.size))))
            p0 = rstart[tord] + 1 + 7 * within
            is_str = pv_t == VT_STRING
            seg_src[p0] = np.where(us_s, cbase + o_q, cbase + o_kpre)
            seg_len[p0] = np.where(us_s, 1, 2)
            seg_src[p0 + 1] = ns_s
            seg_len[p0 + 1] = ne_s - ns_s
            seg_src[p0 + 2] = cbase + o_colon
            seg_len[p0 + 2] = 2
            seg_src[p0 + 3] = cbase + o_q
            seg_len[p0 + 3] = np.where(is_str, 1, 0)
            vsrc = np.where(
                is_str | (pv_t == VT_NUMBER), pv_a,
                np.where(pv_t == VT_TRUE, cbase + o_true,
                         np.where(pv_t == VT_FALSE, cbase + o_false,
                                  cbase + o_null)))
            vln = np.where(
                is_str | (pv_t == VT_NUMBER), pv_b - pv_a,
                np.where(pv_t == VT_TRUE, 4,
                         np.where(pv_t == VT_FALSE, 5, 4)))
            seg_src[p0 + 4] = vsrc
            seg_len[p0 + 4] = vln
            seg_src[p0 + 5] = cbase + o_q
            seg_len[p0 + 5] = np.where(is_str, 1, 0)
            seg_src[p0 + 6] = cbase + o_comma
            seg_len[p0 + 6] = 1

        hf = has_host[ridx]
        hfi = host_f[ridx]
        mf = has_msg[ridx]
        mfi = msg_f[ridx]
        lf = has_lvl[ridx]
        lfi = lvl_f[ridx]
        ri = ridx

        def span_sel(fi):
            a = starts64[ri] + val_s[ri, fi]
            b = starts64[ri] + val_e[ri, fi]
            return a, b - a

        host_a, host_l = span_sel(hfi)
        msg_a, msg_l = span_sel(mfi)
        lvl_src = starts64[ri] + val_s[ri, lfi]

        # absent OR empty host renders "unknown" (GelfEncoder falsy
        # check); absent message renders "-", empty stays empty
        host_eff_l = np.where(hf, host_l, 0)
        host_src = np.where(host_eff_l == 0, cbase + o_unknown, host_a)
        host_len = np.where(host_eff_l == 0, len(b"unknown"), host_eff_l)
        msg_src = np.where(mf, msg_a, cbase + o_dash)
        msg_len = np.where(mf, msg_l, 1)

        fd = (rstart + 1 + 7 * p)[:, None] + np.arange(
            FIXED, dtype=np.int64)[None, :]
        fsrc = np.empty((R, FIXED), dtype=np.int64)
        flen = np.empty((R, FIXED), dtype=np.int64)
        cols = (
            (cbase + o_host, len(b'"host":"')),
            (host_src, host_len),
            (cbase + o_qc, 2),
            (cbase + o_lvl, np.where(lf, len(b'"level":'), 0)),
            (lvl_src, np.where(lf, 1, 0)),
            (cbase + o_comma, np.where(lf, 1, 0)),
            (cbase + o_short, len(b'"short_message":"')),
            (msg_src, msg_len),
            (cbase + o_qc, 2),
            (cbase + o_ts, len(b'"timestamp":')),
            (cbase + o_scratch + ts_off, ts_len),
            (cbase + o_comma, 1),
            (cbase + o_tail, len(b'"version":"1.1"}') + len(suffix)),
        )
        for k, (s_, ln) in enumerate(cols):
            fsrc[:, k] = s_
            flen[:, k] = ln
        seg_src[fd] = fsrc
        seg_len[fd] = flen

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
                        syslen, merger, encoder, scalar_fn=_scalar_jsonl)


def encode_jsonl_ltsv_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """jsonl→LTSV: pairs in the Record's construction order — sorted
    by ORIGINAL key with the leading ``_`` stripped back off — then
    ltsv_extra, host, time, message?, level?.  Names containing ':'
    (LTSV key escape) take the oracle."""
    from ..utils.rustfmt import display_f64
    from .block_common import ltsv_extra_blob, span_f64_scratch
    from .encode_ltsv_block import _ltsv_core

    spec = merger_suffix(merger)
    if spec is None:
        return None
    suffix, syslen = spec

    s = jsonl_screen(chunk_bytes, starts, orig_lens, out, n_real,
                     max_len)
    n, starts64, lens64, cand = (s["n"], s["starts64"], s["lens64"],
                                 s["cand"])
    chunk_arr, kabs, key_e = s["chunk_arr"], s["kabs"], s["key_e"]
    byte_at, vspan_at = s["byte_at"], s["vspan_at"]
    is_pair = s["is_pair"] & cand[:, None]
    vabs_a, vabs_b = s["vabs_a"], s["vabs_b"]
    val_t = s["val_t"]

    # keys needing the LTSV ':'→'_' escape: count per name span
    if is_pair.any():
        col_cum = np.cumsum(chunk_arr == ord(":"))
        ne_all = starts64[:, None] + key_e
        ncols = np.where(is_pair,
                         count_in_spans(col_cum, kabs, ne_all), 0)
        cand &= ncols.sum(axis=1) == 0
        is_pair = is_pair & cand[:, None]

    # pair table in ORIGINAL-key sorted order (shared helper; drops
    # duplicate-key rows from cand, returns '_'-stripped name starts)
    rop_s, ns_s, ne_s, pv_t, pv_a, pv_b = gelf_sorted_pairs(
        chunk_arr, starts64, cand, is_pair, kabs, key_e, vabs_a, vabs_b,
        val_t, byte_at, _NAME_CAP)

    ridx = np.flatnonzero(cand)
    R = ridx.size
    if not R:
        return finish_block(chunk_bytes, starts64, lens64, n, cand,
                            ridx, b"", np.zeros(1, dtype=np.int64),
                            None, suffix, syslen, merger, encoder,
                            scalar_fn=_scalar_jsonl)

    scratch, ts_off, ts_len = span_f64_scratch(
        chunk_bytes, s["tsa_all"][ridx], s["tsb_all"][ridx], display_f64)

    extra_blob = ltsv_extra_blob(encoder.extra)
    consts, offs = build_source(
        b":", b"\t", b"host:", b"\ttime:", b"\tmessage:", b"\tlevel:",
        b"true", b"false", suffix, extra_blob, scratch)
    (o_col, o_tab, o_host, o_time, o_msg, o_lvl, o_true, o_false,
     o_sfx, o_extra, o_ts) = offs
    cbase = int(chunk_arr.size)
    src = np.concatenate([chunk_arr, consts])

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
    has_host = s["has_host"][ridx]
    msg_a, msg_b = vspan_at(s["msg_f"])
    msg_a, msg_l = msg_a[ridx], (msg_b - msg_a)[ridx]
    has_msg = s["has_msg"][ridx]
    lv_a, _lv_b = vspan_at(s["lvl_f"])
    lv_a = lv_a[ridx]
    has_lvl = s["has_lvl"][ridx]

    cols = (
        (cbase + o_extra, len(extra_blob)),
        (cbase + o_host, len(b"host:")),
        (host_a, np.where(has_host, host_l, 0)),
        (cbase + o_time, len(b"\ttime:")),
        (cbase + o_ts + ts_off, ts_len),
        (np.where(has_msg, cbase + o_msg, 0),
         np.where(has_msg, len(b"\tmessage:"), 0)),
        (msg_a, np.where(has_msg, msg_l, 0)),
        (np.where(has_lvl, cbase + o_lvl, 0),
         np.where(has_lvl, len(b"\tlevel:"), 0)),
        (lv_a, np.where(has_lvl, 1, 0)),
        (cbase + o_sfx, len(suffix)),
    )
    return _ltsv_core(chunk_bytes, starts64, lens64, n, cand, ridx,
                      src, cbase, pc, pair_flat, o_col, o_tab,
                      cols, (), suffix, syslen, merger, encoder,
                      scalar_fn=_scalar_jsonl)
