"""Columnar RFC5424→GELF encoding: span tables → one framed output
buffer per batch, with no per-row Python on the fast tier.

Two engines produce identical bytes, chosen as the JAX package
chooses them:

- **native** (every config without ``[output.gelf_extra]``, up to 64
  pairs a row): ``fg_gelf_lens_v2`` / ``fg_gelf_write_v2`` in
  ``csrc/flowgger_host.cpp`` (flowgger_tpu_torch/native.py) assemble each
  tier row's GELF JSON directly from the chunk in two threaded passes
  (measure, prefix-sum, write), including per-row SD-name sorting with
  dict last-wins semantics, JSON escaping and the SD-value unescape.
- **numpy** (``gelf_extra`` configs): the row layout is flattened into
  (source offset, length) segments over a JSON-escaped chunk view, a
  constant bank and a timestamp scratch, then gathered in one
  ``concat_segments`` call (tpu/assemble.py).  This engine additionally
  excludes rows with SD values that need an unescape, duplicate SD
  names or names over 48 bytes; those rows re-run the scalar oracle
  instead.

Rows outside the tier (kernel-flagged, oversized, non-ASCII) re-run the
scalar oracle (decoder → GelfEncoder), so observable bytes stay
identical to the reference semantics (gelf_encoder.rs:51-116) in every
case; tests/test_torch_native.py drives both engines and the JAX
package's block encoder on the same channels, and the pipeline
differential test holds the whole route against the JAX package.

Framing (merger/mod.rs:30-32) is pre-applied: line/nul suffixes ride
the tail constant and syslen's length prefix is rendered inline; the
result is an EncodedBlock the sinks write wholesale.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = "tests/test_torch_pipeline.py::test_block_encoder_matches_scalar_oracle"

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
    sorted_pair_order,
    syslen_prefix_lens_from_framed,
    ts_scratch,
)

__all__ = ["encode_rfc5424_gelf_block", "BlockResult", "merger_suffix"]

_NAME_KEY_MAX = 48   # numpy engine: SD names longer than this fall back
# numpy tier row stride: the open-brace slot + the canonical tail
# columns (asserted against len(cols) below so the two can't desync)
_TAIL_COLS = 18
_ROW_STRIDE = 1 + _TAIL_COLS

# constant bank --------------------------------------------------------------
_C_OPEN = b"{"
_C_P0 = b'"_'
_C_P1 = b'":"'
_C_P2 = b'",'
_C_APP = b'"application_name":"'
_C_FULL = b'","full_message":"'
_C_HOST = b'","host":"'
_C_LEVEL = b'","level":'
_C_PROC = b',"process_id":"'
_C_SDID = b'","sd_id":"'
_C_SHORT = b'","short_message":"'
_C_TS = b'","timestamp":'
_C_TAIL = b',"version":"1.1"}'
_C_UNKNOWN = b"unknown"
_C_DASH = b"-"
_C_SEVD = b"01234567"

_FIXED_KEYS = ("application_name", "full_message", "host", "level",
               "process_id", "sd_id", "short_message", "timestamp",
               "version")


def gelf_extra_slots(extra):
    """Render ``[output.gelf_extra]`` pairs into the static insertion
    slots of the rfc5424 GELF layout (serde_json BTreeMap order means a
    non-``_`` key's position among the fixed keys is config-static, so
    each extra is a constant byte run folded into the neighbouring
    segment constant).  Slot text forms: ``self`` (before a key, fully
    quoted + trailing comma), ``string-close`` (after a string value:
    leading ``",`` closes it, own closing quote supplied by the next
    constant), ``number`` (after a bare number: self-contained with a
    leading comma).  Returns the slot dict, or None when any key needs
    dynamic placement — a leading ``_`` interleaves with SD pairs, and
    a fixed-key name overwrites a computed field (gelf_encoder.rs
    extras overwrite everything) — those configs take the Record path.
    """
    from .block_common import extra_forms

    slots = {k: b"" for k in ("open", "app", "full", "host", "level",
                              "proc", "p6", "short", "ts", "tail_num",
                              "tail_ver")}
    for k, v in sorted(extra or ()):
        if k.startswith("_") or k in _FIXED_KEYS:
            return None
        sf, sc, nm = extra_forms(k, v)
        if k < "_":
            slots["open"] += sf
        elif k < "application_name":
            slots["app"] += sf
        elif k < "full_message":
            slots["full"] += sc
        elif k < "host":
            slots["host"] += sc
        elif k < "level":
            slots["level"] += sc
        elif k < "process_id":
            slots["proc"] += nm
        elif k < "sd_id":
            slots["p6"] += sc
        elif k < "short_message":
            slots["short"] += sc
        elif k < "timestamp":
            slots["ts"] += sc
        elif k < "version":
            slots["tail_num"] += nm
        else:
            slots["tail_ver"] += sc
    return slots


def gelf_extra_consts(extra):
    """(open, app, full, host, level, proc, p6, short, ts, tail) segment
    constants with the extras folded in; None when unsupported."""
    slots = gelf_extra_slots(extra)
    if slots is None:
        return None
    from .block_common import extra_tail

    tail = extra_tail(_C_TAIL, slots["tail_num"], slots["tail_ver"])
    return (_C_OPEN + slots["open"], slots["app"] + _C_APP,
            slots["full"] + _C_FULL, slots["host"] + _C_HOST,
            slots["level"] + _C_LEVEL, slots["proc"] + _C_PROC,
            slots["p6"], slots["short"] + _C_SHORT,
            slots["ts"] + _C_TS, tail)


def encode_rfc5424_gelf_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
) -> Optional[BlockResult]:
    """Returns None when this route can't apply (gelf_extra keys that
    need dynamic placement, or an unknown merger type)."""
    from .. import native

    spec = merger_suffix(merger)
    if spec is None:
        return None
    econsts = gelf_extra_consts(encoder.extra)
    if econsts is None:
        return None
    (c_open, c_app, c_full, c_host, c_level, c_proc, c_p6, c_short,
     c_ts, c_tail) = econsts
    suffix, syslen = spec

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    pair_count = np.asarray(out["pair_count"][:n])
    sd_count = np.asarray(out["sd_count"][:n])
    val_has_esc = np.asarray(out["val_has_esc"][:n], dtype=bool)
    name_start = np.asarray(out["name_start"])[:n]
    name_end = np.asarray(out["name_end"])[:n]

    cand = ok & (lens64 <= max_len) & ~has_high

    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    # the native row engine has no extras slots: extras configs run on
    # the numpy segment engine, as in the JAX package
    use_native = (native.gelf_rows_available()
                  and not encoder.extra
                  and name_start.shape[1] <= native.MAX_PAIRS)
    if not use_native and val_has_esc.shape[1]:
        # the numpy engine emits value spans through the shared escaped
        # chunk view and cannot compose the SD unescape; the native row
        # assembler handles those values directly
        cand &= ~val_has_esc.any(axis=1)

    ns_s = ne_s = vs_s = ve_s = np.zeros(0, dtype=np.int64)
    if not use_native:
        # numpy tier limits: SD name length cap + no duplicate names
        jmask = np.arange(name_start.shape[1])[None, :] < pair_count[:, None]
        nlen = np.where(jmask, name_end - name_start, 0)
        cand &= nlen.max(axis=1, initial=0) <= _NAME_KEY_MAX

        # pair table sorted by (row, name bytes)
        pc = np.where(cand & (sd_count > 0),
                      pair_count.astype(np.int64), 0)
        T = int(pc.sum())
        if T:
            rop = np.repeat(np.arange(n, dtype=np.int64), pc)
            jop = np.arange(T, dtype=np.int64) - np.repeat(
                exclusive_cumsum(pc)[:-1], pc)
            ns_abs = starts64[rop] + name_start[rop, jop]
            ne_abs = starts64[rop] + name_end[rop, jop]
            vs_abs = starts64[rop] + np.asarray(out["val_start"])[:n][rop, jop]
            ve_abs = starts64[rop] + np.asarray(out["val_end"])[:n][rop, jop]
            order, dup_rows = sorted_pair_order(chunk_arr, rop, ns_abs,
                                                ne_abs, _NAME_KEY_MAX)
            if dup_rows.size:
                cand[dup_rows] = False
                order = order[cand[rop[order]]]
            ns_s, ne_s = ns_abs[order], ne_abs[order]
            vs_s, ve_s = vs_abs[order], ve_abs[order]

    ridx = np.flatnonzero(cand)
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R and use_native:
        scratch, ts_off, ts_len = ts_scratch(out, n, ridx, json_f64)
        meta = np.empty((R, 17), dtype=np.int32)
        meta[:, 0] = starts64[ridx]
        for k, key in enumerate(("host_start", "host_end", "app_start",
                                 "app_end", "proc_start", "proc_end",
                                 "msg_trim_start", "trim_end", "full_start",
                                 "severity")):
            meta[:, 1 + k] = np.asarray(out[key])[:n][ridx]
        nsd = (np.asarray(sd_count)[ridx] > 0)
        meta[:, 11] = nsd
        last = np.maximum(np.asarray(sd_count)[ridx] - 1, 0)
        meta[:, 12] = np.asarray(out["sid_start"])[:n][ridx, last]
        meta[:, 13] = np.asarray(out["sid_end"])[:n][ridx, last]
        meta[:, 14] = ts_off
        meta[:, 15] = ts_len
        meta[:, 16] = np.asarray(pair_count)[ridx]
        pns = np.asarray(out["name_start"])[:n][ridx]
        pne = np.asarray(out["name_end"])[:n][ridx]
        pvs = np.asarray(out["val_start"])[:n][ridx]
        pve = np.asarray(out["val_end"])[:n][ridx]
        pesc = val_has_esc[ridx].astype(np.int32)
        buf, row_off = native.gelf_rows_native(chunk_bytes, meta, pns, pne,
                                               pvs, pve, pesc, scratch,
                                               suffix, syslen)
        tier_lens = np.diff(row_off)
        if syslen:
            prefix_lens_tier = syslen_prefix_lens_from_framed(tier_lens)
        final_buf = buf.tobytes()

    if R and not use_native:
        emap = escape_json(chunk_arr)
        esc = emap.esc

        # per-row escaped spans ----------------------------------------
        def espan(skey, ekey):
            a = starts64[ridx] + np.asarray(out[skey])[:n][ridx]
            b = starts64[ridx] + np.asarray(out[ekey])[:n][ridx]
            ea = emap.map(a)
            return ea, emap.map(b) - ea

        app_src, app_len = espan("app_start", "app_end")
        host_src, host_len = espan("host_start", "host_end")
        proc_src, proc_len = espan("proc_start", "proc_end")
        full_src, full_len = espan("full_start", "trim_end")
        msg_src, msg_len = espan("msg_trim_start", "trim_end")

        nsd = np.asarray(sd_count)[ridx] > 0
        last = np.maximum(np.asarray(sd_count)[ridx] - 1, 0)
        sid_a = starts64[ridx] + np.asarray(out["sid_start"])[:n][ridx, last]
        sid_b = starts64[ridx] + np.asarray(out["sid_end"])[:n][ridx, last]
        sid_src = emap.map(sid_a)
        sid_len = emap.map(sid_b) - sid_src

        sev = np.asarray(out["severity"])[:n][ridx].astype(np.int64)

        scratch, ts_off, ts_len = ts_scratch(out, n, ridx, json_f64)
        const_bank, coffs = build_source(
            c_open, _C_P0, _C_P1, _C_P2, c_app, c_full, c_host,
            c_level, c_proc, _C_SDID, c_short, c_ts, c_tail + suffix,
            _C_UNKNOWN, _C_DASH, _C_SEVD, c_p6)
        (o_open, o_p0, o_p1, o_p2, o_app, o_full, o_host, o_level, o_proc,
         o_sdid, o_short, o_ts, o_tail, o_unknown, o_dash, o_sevd,
         o_p6) = coffs
        cbase = int(esc.size)
        tbase = cbase + int(const_bank.size)
        src = np.concatenate([
            esc, const_bank, np.frombuffer(scratch or b"\0", dtype=np.uint8),
        ])
        ts_src = tbase + ts_off
        # empty-field redirects
        host_src = np.where(host_len == 0, cbase + o_unknown, host_src)
        host_len = np.where(host_len == 0, len(_C_UNKNOWN), host_len)
        msg_src = np.where(msg_len == 0, cbase + o_dash, msg_src)
        msg_len = np.where(msg_len == 0, 1, msg_len)

        # ---- segment stream (column-wise construction) ---------------
        # every row gets 19 fixed segment slots (brace + 18 canonical
        # tail parts — incl. the extras slot between process_id and
        # sd_id — with the sd_id pair zero-length when absent) plus
        # 5 slots per SD pair, so destinations are pure index arithmetic
        # and each column is one R- or T-sized write — no S-sized masks.
        pc2 = np.where(cand & (np.asarray(sd_count) > 0),
                       np.asarray(pair_count).astype(np.int64), 0)
        p = pc2[ridx]
        T2 = ns_s.size
        pb = exclusive_cumsum(p)
        rstart = _ROW_STRIDE * np.arange(R, dtype=np.int64) + 5 * pb[:-1]
        S = _ROW_STRIDE * R + 5 * T2
        seg_src = np.empty(S, dtype=np.int64)
        seg_len = np.empty(S, dtype=np.int64)

        seg_src[rstart] = cbase + o_open
        seg_len[rstart] = len(c_open)

        if T2:
            name_src = emap.map(ns_s)
            name_len_e = emap.map(ne_s) - name_src
            val_src = emap.map(vs_s)
            val_len_e = emap.map(ve_s) - val_src
            tord = np.repeat(np.arange(R, dtype=np.int64), p)
            within = np.arange(T2, dtype=np.int64) - np.repeat(pb[:-1], p)
            pd0 = rstart[tord] + 1 + 5 * within
            pair_dest = pd0[:, None] + np.arange(5, dtype=np.int64)[None, :]
            pair_src2 = np.empty((T2, 5), dtype=np.int64)
            pair_len2 = np.empty((T2, 5), dtype=np.int64)
            pair_src2[:, 0] = cbase + o_p0
            pair_len2[:, 0] = 2
            pair_src2[:, 1] = name_src
            pair_len2[:, 1] = name_len_e
            pair_src2[:, 2] = cbase + o_p1
            pair_len2[:, 2] = 3
            pair_src2[:, 3] = val_src
            pair_len2[:, 3] = val_len_e
            pair_src2[:, 4] = cbase + o_p2
            pair_len2[:, 4] = 2
            seg_src[pair_dest] = pair_src2
            seg_len[pair_dest] = pair_len2

        cols = (
            (cbase + o_app, len(c_app)),
            (app_src, app_len),
            (cbase + o_full, len(c_full)),
            (full_src, full_len),
            (cbase + o_host, len(c_host)),
            (host_src, host_len),
            (cbase + o_level, len(c_level)),
            (cbase + o_sevd + sev, 1),
            (cbase + o_proc, len(c_proc)),
            (proc_src, proc_len),
            (cbase + o_p6, len(c_p6)),
            (cbase + o_sdid, np.where(nsd, len(_C_SDID), 0)),
            (sid_src, np.where(nsd, sid_len, 0)),
            (cbase + o_short, len(c_short)),
            (msg_src, msg_len),
            (cbase + o_ts, len(c_ts)),
            (ts_src, ts_len),
            (cbase + o_tail, len(c_tail) + len(suffix)),
        )
        assert len(cols) == _TAIL_COLS
        tail_dest = (rstart + 1 + 5 * p)[:, None] + np.arange(
            _TAIL_COLS, dtype=np.int64)[None, :]
        tsrc = np.empty((R, _TAIL_COLS), dtype=np.int64)
        tlen = np.empty((R, _TAIL_COLS), dtype=np.int64)
        for k, (s, ln) in enumerate(cols):
            tsrc[:, k] = s
            tlen[:, k] = ln
        seg_src[tail_dest] = tsrc
        seg_len[tail_dest] = tlen

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
