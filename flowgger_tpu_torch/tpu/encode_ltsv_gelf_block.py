"""Columnar LTSV→GELF encoding: the LTSV kernel's part/special-key span
tables become framed GELF bytes per batch.

A copy of the JAX package's ``tpu/encode_ltsv_gelf_block.py``.  An
LTSV record (``decoders/ltsv.py``) maps to the sorted-key GELF object::

    {"_<key>":V..., "full_message":L, "host":H, ["level":N,]
     "short_message":M|-, "timestamp":T, "version":"1.1"}

Pair keys are emitted sorted (the shared uint64-word lexsort), values
JSON-escaped via the sparse EscapeMap.  Typed ``ltsv_schema`` keys stay
on the fast tier when their rendered bytes equal the raw span (bool
``true``/``false`` literals, canonical u64/i64 integers, f64 values that
roundtrip through json_f64 — emitted bare); non-canonical numbers,
duplicate keys, repeated special names, colon-less parts (the scalar
path prints a "Missing value" notice), and non-ASCII bytes re-run the
scalar oracle, keeping bytes identical to decoder→GelfEncoder.  A schema
of more than 8 keys, or a configured name suffix for a type the schema
uses, returns None: the reference's Record path, which the port does not
have yet (``pipeline`` refuses those configs).  The ``_C_*`` constants
are the device tier's bank too (``device_ltsv``), so a device row and a
host row of one block can never differ.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_ltsv.py::"
             "test_block_encoder_matches_reference")

from typing import Dict, Optional

import numpy as np

from ..mergers import Merger
from ..utils.rustfmt import json_f64
from .assemble import (
    build_source,
    concat_segments,
    count_in_spans,
    escape_json,
    exclusive_cumsum,
)
from .block_common import (
    BlockResult,
    apply_syslen_prefix,
    extra_forms,
    extra_tail,
    finish_block,
    ltsv_special_screen,
    merger_suffix,
    sorted_pair_order,
    ts_scratch,
)
from .materialize_ltsv import _scalar_ltsv

_C_P0 = b'"_'
_C_P1 = b'":"'
_C_P2 = b'",'
_C_FULL = b'"full_message":"'
_C_HOST = b'","host":"'
_C_LEVEL = b'","level":'
_C_SHORT_LVL = b',"short_message":'    # after the bare level number
_C_SHORT = b'","short_message":'      # closing the host string
_C_TS = b',"timestamp":'
_C_TAIL = b',"version":"1.1"}'
_C_UNKNOWN = b"unknown"
_C_DASH = b'"-"'
_C_SEVD = b"01234567"
_NAME_CAP = 48

_FIXED_LTSV = ("full_message", "host", "level", "short_message",
               "timestamp", "version")


def gelf_extra_consts_ltsv(extra):
    """Fold ``[output.gelf_extra]`` pairs into this layout's constants
    (static BTreeMap placement, same idea as the rfc5424/rfc3164
    renderers).  Slot chain: pre-pairs (k < "_"), post-pairs
    ("_" < k < full_message), then the gated-level chain shared with
    the rfc3164 layout — except the short value here closes its own
    quote, so the short→timestamp slot is after-number form.  Returns
    (open, full_c, host_c, hl, l2_pri, l2_nopri, ts_c, tail_c) or None
    when a key needs dynamic placement (leading '_' interleaves with
    the pair keys; fixed keys overwrite)."""
    pre = post = fh = hl = b""
    l2a = l2b = b""
    st = tv = vz = b""
    for k, v in sorted(extra or ()):
        if k.startswith("_") or k in _FIXED_LTSV:
            return None
        sf, sc, nm = extra_forms(k, v)
        if k < "_":
            pre += sf
        elif k < "full_message":
            post += sf
        elif k < "host":
            fh += sc
        elif k < "level":
            hl += sc
        elif k < "short_message":
            l2a += nm
            l2b += sc
        elif k < "timestamp":
            st += nm                           # short value self-closes
        elif k < "version":
            tv += nm
        else:
            vz += sc
    return (b"{" + pre, post + _C_FULL, fh + _C_HOST, hl, l2a, l2b,
            st + _C_TS, extra_tail(_C_TAIL, tv, vz))


def encode_ltsv_gelf_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
    decoder,
) -> Optional[BlockResult]:
    spec = merger_suffix(merger)
    if spec is None:
        return None
    econsts = gelf_extra_consts_ltsv(encoder.extra)
    if econsts is None:
        return None
    (c_open, c_full, c_host, c_hl, c_l2a, c_l2b, c_ts, c_tail) = econsts
    schema = decoder.schema or {}
    if schema:
        # typed keys are supported on the fast tier when rendered bytes
        # equal the raw span (canonical integers, the exact true/false
        # literals, json_f64-roundtripping floats); any configured name
        # suffix and big schemas take the Record path
        if len(schema) > 8:
            return None
        if any(decoder.suffixes.get(t) is not None
               for t in set(schema.values())):
            return None

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    suffix, syslen = spec
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    n_parts = np.asarray(out["n_parts"])[:n].astype(np.int64)
    part_start = np.asarray(out["part_start"])[:n]
    part_end = np.asarray(out["part_end"])[:n]
    colon_pos = np.asarray(out["colon_pos"])[:n]
    host_pos = np.asarray(out["host_pos"])[:n]
    ts_kind = np.asarray(out["ts_kind"])[:n]

    P = part_start.shape[1]
    jmask = np.arange(P)[None, :] < n_parts[:, None]
    cand = ok & (lens64 <= max_len) & ~has_high & (host_pos >= 0)
    # colon-less parts trigger the scalar path's stdout notice
    cand &= ~(jmask & (colon_pos < 0)).any(axis=1)
    # pair-name length cap for the sort-key matrix; special keys are
    # excluded from pairs but bound the same way for simplicity
    nlen = np.where(jmask, colon_pos - part_start, 0)
    cand &= nlen.max(axis=1, initial=0) <= _NAME_CAP

    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)

    # pair table: parts whose key NAME is not one of the special keys
    # (block_common.ltsv_special_screen — the kernel's special positions
    # only catch the LAST occurrence; rows with repeated special names
    # drop to the oracle for exact parity)
    special_name, uniq_ok = ltsv_special_screen(
        chunk_arr, starts64, part_start, nlen, jmask)
    cand &= uniq_ok
    is_pair = jmask & ~special_name & cand[:, None]

    pc = is_pair.sum(axis=1).astype(np.int64)
    T = int(pc.sum())
    if T:
        rows_all, cols_all = np.nonzero(is_pair)
        rop = rows_all.astype(np.int64)
        ns_abs = starts64[rop] + part_start[rows_all, cols_all]
        ne_abs = starts64[rop] + colon_pos[rows_all, cols_all]
        vs_abs = ne_abs + 1
        ve_abs = starts64[rop] + part_end[rows_all, cols_all]
        # typed-schema pair classification: 0 string, 1 bare literal
        # (bool true/false, canonical int, or canonical f64 — rendered
        # bytes equal the span), 2 needs-oracle (non-canonical)
        ptype = np.zeros(T, dtype=np.int8)
        if schema:
            # zero-padded view for fixed-width gathers past span ends
            # (kernel fill values are bounded by the row-relative
            # max_len); only the typed classification needs it
            chunk_pad = np.concatenate(
                [chunk_arr, np.zeros(max_len + 16, dtype=np.uint8)])
            nlen_p = ne_abs - ns_abs
            vlen_p = ve_abs - vs_abs
            vfirst = chunk_pad[vs_abs]
            vsecond = chunk_pad[np.minimum(vs_abs + 1, vs_abs + vlen_p - 1
                                           + (vlen_p == 0))]

            def name_match(word: bytes):
                m = nlen_p == len(word)
                if not m.any():
                    return m
                rr = np.flatnonzero(m)
                okb = np.ones(rr.size, dtype=bool)
                base = ns_abs[rr]
                for i, ch in enumerate(word):
                    okb &= chunk_pad[base + i] == ch
                out_m = np.zeros(T, dtype=bool)
                out_m[rr[okb]] = True
                return out_m

            def literal_match(word: bytes):
                m = vlen_p == len(word)
                if not m.any():
                    return m
                rr = np.flatnonzero(m)
                okb = np.ones(rr.size, dtype=bool)
                base = vs_abs[rr]
                for i, ch in enumerate(word):
                    okb &= chunk_pad[base + i] == ch
                out_m = np.zeros(T, dtype=bool)
                out_m[rr[okb]] = True
                return out_m

            # canonical integer spans: optional single '-', digits only,
            # no leading zero (except exactly "0"), no '+', not "-0..."
            dig_cum = np.cumsum(~((chunk_arr >= ord("0"))
                                  & (chunk_arr <= ord("9"))))
            neg = vfirst == ord("-")
            nondig = count_in_spans(dig_cum, vs_abs, ve_abs)
            dlen = vlen_p - neg
            int_canon = ((dlen >= 1) & (dlen <= 18)
                         & (nondig == neg.astype(np.int64))
                         & ~((vfirst == ord("0")) & (vlen_p > 1))
                         & ~(neg & (vsecond == ord("0"))))
            for key, sdtype in schema.items():
                m = name_match(key.encode("utf-8"))
                if not m.any():
                    continue
                if sdtype == "string":
                    continue
                if sdtype == "bool":
                    okv = literal_match(b"true") | literal_match(b"false")
                    ptype = np.where(m, np.where(okv, 1, 2), ptype)
                elif sdtype == "u64":
                    okv = int_canon & ~neg
                    ptype = np.where(m, np.where(okv, 1, 2), ptype)
                elif sdtype == "i64":
                    ptype = np.where(m, np.where(int_canon, 1, 2), ptype)
                elif sdtype == "f64":
                    # canonical f64 spans: the raw bytes equal the
                    # encoder's shortest-roundtrip rendering (json_f64)
                    # of the parsed value, so bare emission is
                    # byte-identical to the oracle.  Padded zeros,
                    # rewritten exponents, inf/nan ("null"), and
                    # Python-only forms ("1_0") all fail the roundtrip
                    # and drop that row to the oracle.  Checked per
                    # distinct value (typed fields repeat heavily).
                    okv = np.zeros(T, dtype=bool)
                    seen: dict = {}
                    for t in np.flatnonzero(m).tolist():
                        v = chunk_bytes[vs_abs[t]:ve_abs[t]]
                        ok = seen.get(v)
                        if ok is None:
                            try:
                                ok = (json_f64(float(v)).encode("ascii")
                                      == v)
                            except (ValueError, UnicodeDecodeError):
                                ok = False
                            seen[v] = ok
                        okv[t] = ok
                    ptype = np.where(m, np.where(okv, 1, 2), ptype)
                else:  # unknown type: oracle
                    ptype = np.where(m, 2, ptype)
            bad = ptype == 2
            if bad.any():
                cand[np.unique(rop[bad])] = False

        order, dup_rows = sorted_pair_order(chunk_arr, rop, ns_abs,
                                            ne_abs, _NAME_CAP)
        if dup_rows.size:
            cand[dup_rows] = False
        keep = cand[rop[order]]
        order = order[keep]
        ns_s, ne_s = ns_abs[order], ne_abs[order]
        vs_s, ve_s = vs_abs[order], ve_abs[order]
        rop_s = rop[order]
        bare_s = (ptype == 1)[order] if schema else \
            np.zeros(rop_s.size, dtype=bool)
    else:
        ns_s = ne_s = vs_s = ve_s = rop_s = np.zeros(0, dtype=np.int64)
        bare_s = np.zeros(0, dtype=bool)

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

        full_src, full_len = espan(st, st + lens64[ridx])
        host_a = st + np.asarray(out["host_start"])[:n][ridx]
        host_b = st + np.asarray(out["host_end"])[:n][ridx]
        host_src, host_len = espan(host_a, host_b)
        has_msg = np.asarray(out["msg_pos"])[:n][ridx] >= 0
        msg_a = st + np.asarray(out["msg_start"])[:n][ridx]
        msg_b = st + np.asarray(out["msg_end"])[:n][ridx]
        msg_src, msg_len = espan(msg_a, msg_b)
        level = np.asarray(out["level_val"])[:n][ridx].astype(np.int64)
        has_level = level >= 0

        # timestamps: rfc3339-kind rows share the deduplicated computed
        # scratch; unix-literal rows format float(span) individually
        # (per-row Python, like the f64 canonicality screen above)
        kind = ts_kind[ridx]
        scratch0, ts_off0, ts_len0 = ts_scratch(out, n, ridx, json_f64)
        lit_rows = np.flatnonzero(kind != 0)
        lit_strs = []
        if lit_rows.size:
            tsa = st[lit_rows] + np.asarray(out["ts_start"])[:n][ridx][lit_rows]
            tsb = st[lit_rows] + np.asarray(out["ts_end"])[:n][ridx][lit_rows]
            lit_strs = [
                json_f64(float(chunk_bytes[a:b])).encode("ascii")
                for a, b in zip(tsa.tolist(), tsb.tolist())
            ]
        lit_blob = b"".join(lit_strs)
        lit_len = np.fromiter((len(s) for s in lit_strs), dtype=np.int64,
                              count=len(lit_strs))
        lit_off = exclusive_cumsum(lit_len)[:-1] if lit_strs else \
            np.zeros(0, dtype=np.int64)
        ts_off = ts_off0.copy()
        ts_len = ts_len0.copy()
        ts_off[lit_rows] = len(scratch0) + lit_off
        ts_len[lit_rows] = lit_len
        scratch = scratch0 + lit_blob

        consts, offs = build_source(
            c_open, _C_P0, _C_P1, _C_P2, c_full, c_host, _C_LEVEL,
            _C_SHORT_LVL, _C_SHORT, c_ts, c_tail + suffix,
            _C_UNKNOWN, _C_DASH, _C_SEVD, c_hl, c_l2a, c_l2b, scratch)
        (o_open, o_p0, o_p1, o_p2, o_full, o_host, o_level, o_short_l,
         o_short, o_ts, o_tail, o_unknown, o_dash, o_sevd,
         o_hl, o_l2a, o_l2b, o_scratch) = offs
        cbase = int(emap.esc.size)
        src = np.concatenate([emap.esc, consts])

        host_src = np.where(host_len == 0, cbase + o_unknown, host_src)
        host_len = np.where(host_len == 0, len(_C_UNKNOWN), host_len)

        # short_message value is `"msg"` (quoted, escaped) or `"-"`;
        # emitted as [quote][msg][quote] with const redirects when absent
        p = pc[ridx]
        FIXED = 15  # incl. the two extras slot columns (empty w/o extras)
        segc = 1 + 5 * p + FIXED
        rstart = exclusive_cumsum(segc)[:-1]
        S = int(segc.sum())
        seg_src = np.zeros(S, dtype=np.int64)
        seg_len = np.zeros(S, dtype=np.int64)
        seg_src[rstart] = cbase + o_open
        seg_len[rstart] = len(c_open)

        if T:
            # map sorted pairs to their (possibly shrunk) rows
            tpos = np.cumsum(cand) - 1
            tord = tpos[rop_s]
            within = np.zeros(rop_s.size, dtype=np.int64)
            if rop_s.size:
                # consecutive runs per row in sorted order
                new_row = np.ones(rop_s.size, dtype=bool)
                new_row[1:] = rop_s[1:] != rop_s[:-1]
                run_starts = np.flatnonzero(new_row)
                within = (np.arange(rop_s.size)
                          - np.repeat(run_starts,
                                      np.diff(np.append(run_starts,
                                                        rop_s.size))))
            name_src = emap.map(ns_s)
            name_len = emap.map(ne_s) - name_src
            val_src = emap.map(vs_s)
            val_len = emap.map(ve_s) - val_src
            p0 = rstart[tord] + 1 + 5 * within
            seg_src[p0] = cbase + o_p0
            seg_len[p0] = 2
            seg_src[p0 + 1] = name_src
            seg_len[p0 + 1] = name_len
            # typed bare literals (bool/int) drop the value quotes:
            # '":' is a prefix of the '":"' const and ',' a suffix of
            # the '",' const, so both variants index the same bank
            seg_src[p0 + 2] = cbase + o_p1
            seg_len[p0 + 2] = np.where(bare_s, 2, 3)
            seg_src[p0 + 3] = val_src
            seg_len[p0 + 3] = val_len
            seg_src[p0 + 4] = cbase + o_p2 + bare_s
            seg_len[p0 + 4] = np.where(bare_s, 1, 2)

        fd = (rstart + 1 + 5 * p)[:, None] + np.arange(
            FIXED, dtype=np.int64)[None, :]
        fsrc = np.empty((R, FIXED), dtype=np.int64)
        flen = np.empty((R, FIXED), dtype=np.int64)
        qsrc = cbase + o_p1 + 2  # a '"' byte inside the const bank
        cols = (
            (cbase + o_full, len(c_full)),
            (full_src, full_len),
            (cbase + o_host, len(c_host)),
            (host_src, host_len),
            (cbase + o_hl, len(c_hl)),
            (cbase + o_level, np.where(has_level, len(_C_LEVEL), 0)),
            (cbase + o_sevd + np.maximum(level, 0),
             np.where(has_level, 1, 0)),
            (np.where(has_level, cbase + o_l2a, cbase + o_l2b),
             np.where(has_level, len(c_l2a), len(c_l2b))),
            (np.where(has_level, cbase + o_short_l, cbase + o_short),
             np.where(has_level, len(_C_SHORT_LVL), len(_C_SHORT))),
            (np.where(has_msg, qsrc, cbase + o_dash),
             np.where(has_msg, 1, len(_C_DASH))),
            (msg_src, np.where(has_msg, msg_len, 0)),
            (qsrc, np.where(has_msg, 1, 0)),
            (cbase + o_ts, len(c_ts)),
            (cbase + o_scratch + ts_off, ts_len),
            (cbase + o_tail, len(c_tail) + len(suffix)),
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

    def scalar_fn(line):
        return _scalar_ltsv(decoder, line)

    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, scalar_fn=scalar_fn)
