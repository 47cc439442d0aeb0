"""Columnar →Cap'n Proto encoding: span tables become framed capnp
messages without per-row Python, for the rfc5424, rfc3164, ltsv and gelf
decoders (the reference's capnp encoder is decoder-agnostic,
capnp_encoder.rs:36-109, and kafka + capnp is its default pipeline,
mod.rs:104).

The wire layout (``capnp_wire.py``) is a bump-allocated single segment
whose piece order is fixed:

    framing | root ptr | root struct (2 data + 9 ptr words) |
    hostname, [appname], [procid], [msgid], [msg], full_msg, [sd_id]
    texts | [pairs tag word + 4-word elements | per-pair "_"+name and
    value texts] | [constant capnp_extra blob]

Every pointer is a self-relative word: integer arithmetic over the
per-row word layout, computed as int64 numpy vectors and viewed as
little-endian bytes.  Text bytes come out of the input chunk with one
``concat_segments`` gather (NUL padding from a zero constant).
``capnp_extra`` is allocated last by the reference encoder, so its bytes
are row-invariant: one constant blob plus a computed pointer word.

Format tiers (every other row splices through the scalar oracle →
CapnpEncoder, byte-identical in every case):

- rfc5424: kernel-ok rows without value escapes and within ``max_len``;
- rfc3164: kernel-ok ASCII rows (no SD, no optional fields beyond the
  PRI-gated facility / severity);
- ltsv: untyped rows (a typed ``ltsv_schema`` keeps the Record path), no
  repeated or colon-less specials;
- gelf: the gelf → GELF screen's rows, with typed pair values (strings
  as texts, bools and null as data bits, canonical integers of up to 18
  digits as i64 / u64 words); float values and duplicate keys take the
  oracle.

A copy of the JAX package's ``tpu/encode_capnp_block.py``.
"""


from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.capnp:CapnpEncoder"
DIFF_TEST = ("tests/test_torch_capnp_out.py::"
             "test_block_encoders_match_reference")

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..capnp_wire import (
    FACILITY_MISSING,
    PAIR_DATA_WORDS,
    PAIR_PTR_WORDS,
    RECORD_DATA_WORDS,
    RECORD_PTR_WORDS,
    SEVERITY_MISSING,
    WORD,
)
from ..mergers import Merger
from .assemble import build_source, concat_segments, exclusive_cumsum
from .block_common import apply_syslen_prefix, finish_block, merger_suffix
from .materialize import compute_ts

_PAIR_WORDS = PAIR_DATA_WORDS + PAIR_PTR_WORDS   # 4
_ROOT_WORDS = RECORD_DATA_WORDS + RECORD_PTR_WORDS  # 11
_HDR_BYTES = 8 + 8 + _ROOT_WORDS * WORD  # framing + root ptr + root struct
# pointer slots (word offsets inside the 9-slot pointer section)
_P_HOSTNAME, _P_APPNAME, _P_PROCID, _P_MSGID = 0, 1, 2, 3
_P_MSG, _P_FULL_MSG, _P_SD_ID, _P_PAIRS, _P_EXTRA = 4, 5, 6, 7, 8


def _text_words(lens: np.ndarray) -> np.ndarray:
    """Words a text of ``lens`` bytes occupies (NUL-terminated)."""
    return (lens + 1 + WORD - 1) // WORD


def _list_ptr_words(ptr_word: np.ndarray, target_word: np.ndarray,
                    count: np.ndarray, elem_size: int = 2) -> np.ndarray:
    off = target_word - ptr_word - 1
    lower = ((off << 2) | 1).astype(np.int64) & 0xFFFFFFFF
    upper = np.asarray((elem_size & 7) | ((count & 0x1FFFFFFF) << 3),
                       dtype=np.int64)
    return lower | (upper << 32)


def _extra_blob(extra: List[Tuple[str, str]]) -> bytes:
    """The row-invariant ``capnp_extra`` list bytes: tag word, 4-word
    elements, then per-pair key/value texts — all pointers relative
    within the blob (word 0 = the tag word)."""
    if not extra:
        return b""
    k = len(extra)
    words: List[int] = []
    tag = ((k << 2) & 0xFFFFFFFF) | (
        (PAIR_DATA_WORDS | (PAIR_PTR_WORDS << 16)) << 32)
    words.append(tag)
    elems_start = 1
    texts: List[bytes] = []
    text_word = elems_start + k * _PAIR_WORDS
    ptr_vals = {}
    for i, (name, value) in enumerate(extra):
        for j, s in enumerate((name.encode("utf-8"), value.encode("utf-8"))):
            data = s + b"\x00"
            nw = (len(data) + WORD - 1) // WORD
            ptr_word = elems_start + i * _PAIR_WORDS + PAIR_DATA_WORDS + j
            off = text_word - ptr_word - 1
            ptr_vals[ptr_word] = (((off << 2) | 1) & 0xFFFFFFFF) | (
                (2 | (len(data) << 3)) << 32)
            texts.append(data + b"\x00" * (nw * WORD - len(data)))
            text_word += nw
    for i in range(k):
        base = elems_start + i * _PAIR_WORDS
        words.extend([0, 0])  # data words: string discriminant (0)
        words.append(ptr_vals[base + PAIR_DATA_WORDS])
        words.append(ptr_vals[base + PAIR_DATA_WORDS + 1])
    blob = b"".join(int(w).to_bytes(8, "little", signed=False)
                    for w in words) + b"".join(texts)
    return blob


def _span_f64_values(chunk_bytes: bytes, tsa, tsb) -> np.ndarray:
    """Dedup parse of per-row numeric spans to f64 values."""
    cache = {}
    out = np.empty(len(tsa), dtype=np.float64)
    for i, (a, b) in enumerate(zip(tsa.tolist(), tsb.tolist())):
        key = chunk_bytes[a:b]
        v = cache.get(key)
        if v is None:
            v = float(key)
            cache[key] = v
        out[i] = v
    return out


def _capnp_assemble(chunk_bytes, starts64, lens64, n, cand, ridx,
                    texts, sid, pairs, ts, fac, sev, encoder, merger,
                    suffix, syslen, scalar_fn=None, typed=None):
    """Shared layout + assembly for every format wrapper, over
    ridx-selected [R] arrays.

    ``texts``: the six plain text slots in allocation order —
    hostname/appname/procid/msgid/msg/full_msg — each ``(a, blen,
    gate)`` with gate None = present on every row (an all-False gate =
    the format never sets the field, matching the scalar encoder's
    skipped set_text → NULL pointer).  ``sid``: ``(a, blen, gate)`` or
    None.  ``pairs``: ``(name_a, name_l, val_a, val_l, pvalid,
    has_sd)`` [R, P] / [R] or None — pair names emit with the ``"_"``
    prefix; values are string-discriminant texts unless ``typed``
    overrides.  ``typed``: optional (d0, d1, val_is_text) [R, P] int64
    / int64 / bool — data word 0 (discriminant | bool bit 16), data
    word 1 (f64/i64/u64 bit pattern), and whether the value carries a
    text (strings only).  ``ts``/``fac``/``sev``: [R] float64 / uint8
    values (missing already mapped to the *_MISSING sentinels)."""
    R = ridx.size
    final_buf = b""
    row_off = np.zeros(1, dtype=np.int64)
    prefix_lens_tier: Optional[np.ndarray] = None

    if R:
        # ---- word layout ------------------------------------------------
        def gated(blen, gate):
            return blen if gate is None else np.where(gate, blen, 0)

        tw = []
        for a, blen, gate in texts:
            present = (np.ones(R, dtype=bool) if gate is None
                       else np.asarray(gate, dtype=bool))
            tw.append(np.where(present, _text_words(blen), 0))
        if sid is not None:
            sid_a, sid_l, has_sd_sid = sid
            si_w = np.where(has_sd_sid, _text_words(sid_l), 0)
        else:
            sid_a = sid_l = np.zeros(R, dtype=np.int64)
            has_sd_sid = np.zeros(R, dtype=bool)
            si_w = np.zeros(R, dtype=np.int64)
        if pairs is not None:
            name_a, name_l, val_a, val_l, pvalid, has_sd = pairs
            P = name_a.shape[1]
            name_l = np.where(pvalid, name_l, 0)
            val_l = np.where(pvalid, val_l, 0)
            if typed is not None:
                d0_t, d1_t, val_is_text = typed
                val_l = np.where(val_is_text, val_l, 0)
            else:
                val_is_text = np.ones_like(pvalid)
            k0 = pvalid.sum(axis=1).astype(np.int64)
            key_w = np.where(pvalid, _text_words(name_l + 1), 0)  # "_"+name
            valw = np.where(pvalid & val_is_text, _text_words(val_l), 0)
            pairs_w = np.where(has_sd, 1 + k0 * _PAIR_WORDS
                               + key_w.sum(axis=1) + valw.sum(axis=1), 0)
        else:
            P = 0
            has_sd = np.zeros(R, dtype=bool)
            k0 = np.zeros(R, dtype=np.int64)
            pairs_w = np.zeros(R, dtype=np.int64)
        extra = getattr(encoder, "extra", [])
        blob = _extra_blob(extra)
        blob_w = len(blob) // WORD

        w_at = [np.full(R, 1 + _ROOT_WORDS, dtype=np.int64)]
        for w in tw:
            w_at.append(w_at[-1] + w)
        w_sid = w_at[-1]
        w_pairs = w_sid + si_w            # tag word position
        w_extra = w_pairs + pairs_w
        nwords = w_extra + blob_w

        # ---- binary scratch: framing + root ptr + root struct -----------
        hdr = np.zeros((R, _HDR_BYTES), dtype=np.uint8)
        hdr[:, 4:8] = nwords.astype("<u4").view(np.uint8).reshape(R, 4)
        root_ptr = (RECORD_DATA_WORDS | (RECORD_PTR_WORDS << 16)) << 32
        hdr[:, 8:16] = np.frombuffer(
            int(root_ptr).to_bytes(8, "little"), dtype=np.uint8)
        hdr[:, 16:24] = np.asarray(ts, dtype=np.float64).astype(
            "<f8").view(np.uint8).reshape(R, 8)
        hdr[:, 24] = np.asarray(fac).astype(np.uint8)
        hdr[:, 25] = np.asarray(sev).astype(np.uint8)

        ptrs = np.zeros((R, RECORD_PTR_WORDS), dtype=np.int64)
        pw0 = 1 + RECORD_DATA_WORDS  # word index of pointer slot 0

        def text_ptr(slot, target_w, blen, gate=None):
            v = _list_ptr_words(np.full(R, pw0 + slot, dtype=np.int64),
                                target_w, blen + 1)
            ptrs[:, slot] = v if gate is None else np.where(gate, v, 0)

        for slot, ((a, blen, gate), w0) in enumerate(zip(texts, w_at)):
            text_ptr(slot, w0, blen, gate)
        text_ptr(_P_SD_ID, w_sid, sid_l, has_sd_sid)
        if pairs is not None:
            ptrs[:, _P_PAIRS] = np.where(
                has_sd,
                _list_ptr_words(np.full(R, pw0 + _P_PAIRS, dtype=np.int64),
                                w_pairs, k0 * _PAIR_WORDS, elem_size=7), 0)
        if blob_w:
            ptrs[:, _P_EXTRA] = _list_ptr_words(
                np.full(R, pw0 + _P_EXTRA, dtype=np.int64), w_extra,
                len(extra) * _PAIR_WORDS, elem_size=7)
        hdr[:, 32:] = ptrs.astype("<i8").view(np.uint8).reshape(R, 72)

        # ---- pairs scratch: tag word + 4-word elements -------------------
        if pairs is not None:
            pair_bytes = WORD * (1 + P * _PAIR_WORDS)
            pscratch = np.zeros((R, pair_bytes), dtype=np.uint8)
            tag = ((k0 << 2) & 0xFFFFFFFF) | np.int64(
                (PAIR_DATA_WORDS | (PAIR_PTR_WORDS << 16)) << 32)
            pscratch[:, 0:8] = np.where(has_sd, tag, 0).astype(
                "<i8").view(np.uint8).reshape(R, 8)
            # per-pair text word positions: keys/values alloc in pair order
            kv_w = np.zeros((R, P, 2), dtype=np.int64)
            cursor = w_pairs + 1 + k0 * _PAIR_WORDS
            for p in range(P):
                kv_w[:, p, 0] = cursor
                cursor = cursor + key_w[:, p]
                kv_w[:, p, 1] = cursor
                cursor = cursor + valw[:, p]
            ewords = np.zeros((R, P, _PAIR_WORDS), dtype=np.int64)
            if typed is not None:
                ewords[:, :, 0] = np.where(pvalid, d0_t, 0)
                ewords[:, :, 1] = np.where(pvalid, d1_t, 0)
            for p in range(P):
                base = w_pairs + 1 + p * _PAIR_WORDS
                ewords[:, p, 2] = np.where(
                    pvalid[:, p],
                    _list_ptr_words(base + PAIR_DATA_WORDS, kv_w[:, p, 0],
                                    name_l[:, p] + 2), 0)
                ewords[:, p, 3] = np.where(
                    pvalid[:, p] & val_is_text[:, p],
                    _list_ptr_words(base + PAIR_DATA_WORDS + 1,
                                    kv_w[:, p, 1], val_l[:, p] + 1), 0)
            pscratch[:, 8:] = ewords.astype("<i8").view(np.uint8).reshape(
                R, P * _PAIR_WORDS * WORD)

        # ---- segment table ----------------------------------------------
        chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
        consts, offs = build_source(b"\x00" * (WORD * 2), b"_", blob,
                                    suffix, hdr.tobytes(),
                                    pscratch.tobytes() if pairs is not None
                                    else b"")
        o_zero, o_us, o_blob, o_suffix, o_hdr, o_pscratch = offs
        cbase = int(chunk_arr.size)
        src = np.concatenate([chunk_arr, consts])

        def pad_for(blen, words, gate=None):
            ln = words * WORD - blen
            if gate is not None:
                ln = np.where(gate, ln, 0)
            return ln

        cols: List[Tuple[np.ndarray, np.ndarray]] = []

        def add(srcv, lenv):
            cols.append((np.broadcast_to(srcv, (R,)).astype(np.int64),
                         np.broadcast_to(lenv, (R,)).astype(np.int64)))

        add(cbase + o_hdr + np.arange(R) * _HDR_BYTES,
            np.full(R, _HDR_BYTES))
        for (a, blen, gate), w in zip(texts, tw):
            gl = gated(blen, gate)
            add(a, gl)
            add(cbase + o_zero, pad_for(gl, w, gate))
        add(sid_a, gated(sid_l, has_sd_sid))
        add(cbase + o_zero, pad_for(gated(sid_l, has_sd_sid), si_w,
                                    has_sd_sid))
        if pairs is not None:
            # pairs: tag+elements scratch, then "_name\0pad value\0pad"
            add(cbase + o_pscratch + np.arange(R) * pair_bytes,
                np.where(has_sd, 8 + k0 * _PAIR_WORDS * WORD, 0))
            for p in range(P):
                pv = pvalid[:, p]
                add(cbase + o_us, np.where(pv, 1, 0))
                add(name_a[:, p], name_l[:, p])
                add(cbase + o_zero,
                    pad_for(name_l[:, p] + 1, key_w[:, p], pv))
                add(val_a[:, p], val_l[:, p])
                add(cbase + o_zero, pad_for(val_l[:, p], valw[:, p], pv))
        add(cbase + o_blob, np.full(R, len(blob)))
        add(cbase + o_suffix, np.full(R, len(suffix)))

        nseg = len(cols)
        seg_src = np.empty((R, nseg), dtype=np.int64)
        seg_len = np.empty((R, nseg), dtype=np.int64)
        for k, (s, ln) in enumerate(cols):
            seg_src[:, k] = s
            seg_len[:, k] = ln
        dst0 = exclusive_cumsum(seg_len.ravel())
        body = concat_segments(src, seg_src.ravel(), seg_len.ravel(), dst0)
        row_off = dst0[::nseg]
        tier_lens = np.diff(row_off)
        if syslen:
            final_buf, row_off, prefix_lens_tier = apply_syslen_prefix(
                body, row_off, tier_lens)
        else:
            final_buf = body.tobytes()

    kw = {} if scalar_fn is None else {"scalar_fn": scalar_fn}
    return finish_block(chunk_bytes, starts64, lens64, n, cand, ridx,
                        final_buf, row_off, prefix_lens_tier, suffix,
                        syslen, merger, encoder, **kw)


def encode_rfc5424_capnp_block(
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
    if spec is None:
        return None
    suffix, syslen = spec

    n = int(n_real)
    starts64 = np.asarray(starts[:n], dtype=np.int64)
    lens64 = np.asarray(orig_lens[:n], dtype=np.int64)
    ok = np.asarray(out["ok"][:n], dtype=bool)
    has_high = np.asarray(out["has_high"][:n], dtype=bool)
    val_esc = np.asarray(out["val_has_esc"][:n], dtype=bool)
    pair_count = np.asarray(out["pair_count"][:n], dtype=np.int64)
    esc_any = (val_esc[:, :]
               & (np.arange(val_esc.shape[1])[None, :] < pair_count[:, None])
               ).any(axis=1)
    cand = ok & (lens64 <= max_len) & ~has_high & ~esc_any

    ridx = np.flatnonzero(cand)
    if not ridx.size:
        return _capnp_assemble(chunk_bytes, starts64, lens64, n, cand,
                               ridx, [], None, None, None, None, None,
                               encoder, merger, suffix, syslen)
    st = starts64[ridx]

    def span(a_key, b_key):
        a = np.asarray(out[a_key])[:n][ridx].astype(np.int64)
        b = np.asarray(out[b_key])[:n][ridx].astype(np.int64)
        return st + a, np.maximum(b - a, 0)

    host_a, host_l = span("host_start", "host_end")
    app_a, app_l = span("app_start", "app_end")
    proc_a, proc_l = span("proc_start", "proc_end")
    msgid_a, msgid_l = span("msgid_start", "msgid_end")
    # msg: [msg_trim_start, trim_end) — None (no text) when empty
    msg_a = st + np.asarray(out["msg_trim_start"])[:n][ridx].astype(np.int64)
    trim_e = st + np.asarray(out["trim_end"])[:n][ridx].astype(np.int64)
    msg_l = np.maximum(trim_e - msg_a, 0)
    has_msg = msg_l > 0
    full_a = st + np.asarray(out["full_start"])[:n][ridx].astype(np.int64)
    full_l = np.maximum(trim_e - full_a, 0)
    sd_count = np.asarray(out["sd_count"])[:n][ridx].astype(np.int64)
    has_sd = sd_count > 0
    sid_a = st + np.asarray(out["sid_start"])[:n][ridx, 0].astype(np.int64)
    sid_l = np.maximum(
        np.asarray(out["sid_end"])[:n][ridx, 0].astype(np.int64)
        - np.asarray(out["sid_start"])[:n][ridx, 0].astype(np.int64), 0)
    pc = pair_count[ridx]
    P = np.asarray(out["name_start"]).shape[1]
    pair_sd = np.asarray(out["pair_sd"])[:n][ridx].astype(np.int64)
    name_a = st[:, None] + np.asarray(out["name_start"])[:n][ridx].astype(np.int64)
    name_l = (np.asarray(out["name_end"])[:n][ridx].astype(np.int64)
              - np.asarray(out["name_start"])[:n][ridx].astype(np.int64))
    val_a = st[:, None] + np.asarray(out["val_start"])[:n][ridx].astype(np.int64)
    val_l = (np.asarray(out["val_end"])[:n][ridx].astype(np.int64)
             - np.asarray(out["val_start"])[:n][ridx].astype(np.int64))
    # capnp carries only sd[0] (capnp_encoder.rs:78-80): gate pairs
    # on block 0 membership
    pvalid = (np.arange(P)[None, :] < pc[:, None]) & (pair_sd == 0)

    ts = compute_ts({k: np.asarray(v)[:n][ridx]
                     for k, v in out.items()
                     if k in ("days", "sod", "off", "nanos")})
    fac = np.asarray(out["facility"])[:n][ridx].astype(np.uint8)
    sev = np.asarray(out["severity"])[:n][ridx].astype(np.uint8)

    texts = [
        (host_a, host_l, None),
        (app_a, app_l, None),
        (proc_a, proc_l, None),
        (msgid_a, msgid_l, None),
        (msg_a, msg_l, has_msg),
        (full_a, full_l, None),
    ]
    return _capnp_assemble(
        chunk_bytes, starts64, lens64, n, cand, ridx, texts,
        (sid_a, sid_l, has_sd),
        (name_a, name_l, val_a, val_l, pvalid, has_sd),
        ts, fac, sev, encoder, merger, suffix, syslen)


def encode_rfc3164_capnp_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
):
    """rfc3164 Record → capnp: hostname + msg (tail) + full line, PRI-
    gated facility/severity, no appname/procid/msgid/sd
    (materialize_rfc3164.py's Record shape)."""
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
    st = starts64[ridx]

    def sp(a_key, b_key):
        a = np.asarray(out[a_key])[:n][ridx].astype(np.int64)
        b = np.asarray(out[b_key])[:n][ridx].astype(np.int64)
        return st + a, np.maximum(b - a, 0)

    host_a, host_l = sp("host_start", "host_end")
    msg_a = st + np.asarray(out["msg_start"])[:n][ridx].astype(np.int64)
    msg_l = np.maximum(st + lens64[ridx] - msg_a, 0)
    R = ridx.size
    zero = np.zeros(R, dtype=np.int64)
    absent = np.zeros(R, dtype=bool)
    has_pri = np.asarray(out["has_pri"][:n], dtype=bool)[ridx]
    fac = np.where(has_pri,
                   np.asarray(out["facility"])[:n][ridx], FACILITY_MISSING)
    sev = np.where(has_pri,
                   np.asarray(out["severity"])[:n][ridx], SEVERITY_MISSING)
    ts = compute_ts({k: np.asarray(v)[:n][ridx]
                     for k, v in out.items()
                     if k in ("days", "sod", "off", "nanos")})

    texts = [
        (host_a, host_l, None),
        (zero, zero, absent),          # appname
        (zero, zero, absent),          # procid
        (zero, zero, absent),          # msgid
        (msg_a, msg_l, None),          # msg = line[msg_start:], may be ""
        (st, lens64[ridx], None),      # full_msg = whole line
    ]
    return _capnp_assemble(
        chunk_bytes, starts64, lens64, n, cand, ridx, texts, None, None,
        ts, fac, sev, encoder, merger, suffix, syslen,
        scalar_fn=_scalar_3164)


def encode_ltsv_capnp_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
    decoder=None,
):
    """ltsv Record → capnp: hostname, optional message, full line,
    severity from ``level``, untyped pairs in part order (a configured
    ``ltsv_schema`` types values — those rows keep the Record path,
    gated here like the GELF block's typed screens)."""
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
    ts_kind = np.asarray(out["ts_kind"])[:n]

    P = part_start.shape[1]
    jmask = np.arange(P)[None, :] < n_parts[:, None]
    cand = ok & (lens64 <= max_len) & ~has_high & (host_pos >= 0)
    # colon-less parts trigger the scalar path's stdout notice
    cand &= ~(jmask & (colon_pos < 0)).any(axis=1)

    chunk_arr = np.frombuffer(chunk_bytes, dtype=np.uint8)
    # specials route by NAME (every occurrence), repeated names drop to
    # the oracle — shared screen (block_common.ltsv_special_screen)
    from .block_common import ltsv_special_screen

    nlen = np.where(jmask, colon_pos - part_start, 0)
    special_name, uniq_ok = ltsv_special_screen(
        chunk_arr, starts64, part_start, nlen, jmask)
    cand &= uniq_ok

    ridx = np.flatnonzero(cand)
    st = starts64[ridx]

    def sp(a_key, b_key):
        a = np.asarray(out[a_key])[:n][ridx].astype(np.int64)
        b = np.asarray(out[b_key])[:n][ridx].astype(np.int64)
        return st + a, np.maximum(b - a, 0)

    host_a, host_l = sp("host_start", "host_end")
    msg_a, msg_l = sp("msg_start", "msg_end")
    has_msg = np.asarray(out["msg_pos"])[:n][ridx].astype(np.int64) >= 0
    level = np.asarray(out["level_val"])[:n][ridx].astype(np.int64)
    R = ridx.size
    zero = np.zeros(R, dtype=np.int64)
    absent = np.zeros(R, dtype=bool)
    fac = np.full(R, FACILITY_MISSING, dtype=np.int64)
    sev = np.where(level >= 0, level, SEVERITY_MISSING)

    # timestamps: rfc3339 / split-integer / per-row-exact, shared with
    # the LTSV self-encode block (block_common.ltsv_ts_vals)
    from .block_common import ltsv_ts_vals

    ts = ltsv_ts_vals(out, n, ridx, chunk_bytes, starts64)

    # pairs: non-special parts in part order, "_"-prefixed string values
    is_pair = jmask[ridx] & ~special_name[ridx]
    name_a = st[:, None] + part_start[ridx].astype(np.int64)
    name_l2 = (colon_pos[ridx].astype(np.int64)
               - part_start[ridx].astype(np.int64))
    val_a = st[:, None] + colon_pos[ridx].astype(np.int64) + 1
    val_l = (part_end[ridx].astype(np.int64)
             - colon_pos[ridx].astype(np.int64) - 1)
    # compact pairs left so pvalid is a prefix mask (the layout cursor
    # walks pair slots in order; gaps would still work but waste slots)
    order = np.argsort(~is_pair, axis=1, kind="stable")
    rr = np.arange(R)[:, None]
    pvalid = np.take_along_axis(is_pair, order, axis=1)
    name_a = name_a[rr, order]
    name_l2 = name_l2[rr, order]
    val_a = val_a[rr, order]
    val_l = val_l[rr, order]
    has_sd = pvalid.any(axis=1)

    texts = [
        (host_a, host_l, None),
        (zero, zero, absent),          # appname
        (zero, zero, absent),          # procid
        (zero, zero, absent),          # msgid
        (msg_a, msg_l, has_msg),
        (st, lens64[ridx], None),      # full_msg = whole line
    ]
    return _capnp_assemble(
        chunk_bytes, starts64, lens64, n, cand, ridx, texts,
        (zero, zero, np.zeros(R, dtype=bool)),   # sd_id is None for ltsv
        (name_a, name_l2, val_a, val_l, pvalid, has_sd),
        ts, fac, sev, encoder, merger, suffix, syslen,
        scalar_fn=scalar_fn)


def encode_gelf_capnp_block(
    chunk_bytes: bytes,
    starts: np.ndarray,
    orig_lens: np.ndarray,
    out: Dict[str, np.ndarray],
    n_real: int,
    max_len: int,
    encoder,
    merger: Optional[Merger],
):
    """gelf→capnp: the JSON tokenizer's spans through the decoder-
    agnostic capnp encoder.  Pairs carry their TYPED discriminants —
    strings as texts, bools/null as data bits, canonical ints (≤ 18
    digits) parsed vectorially into i64/u64 words; float pair values
    (a per-value parse+bit pattern) take the oracle.  Pair order is the
    Record's: sorted ORIGINAL keys, duplicates → oracle."""
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
    chunk_arr, chunk_pad = s["chunk_arr"], s["chunk_pad"]
    kabs, key_e = s["kabs"], s["key_e"]
    byte_at, vspan_at = s["byte_at"], s["vspan_at"]
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
        return _capnp_assemble(chunk_bytes, starts64, lens64, n, cand,
                               ridx, [], None, None, None, None, None,
                               encoder, merger, suffix, syslen,
                               scalar_fn=_scalar_gelf)

    # timestamps: per-unique float of the span (dedup dict)
    ts = _span_f64_values(chunk_bytes, s["tsa_all"][ridx],
                         s["tsb_all"][ridx])

    lv_a, _ = vspan_at(s["lvl_f"])
    sev = np.where(s["has_lvl"],
                   chunk_pad[np.asarray(lv_a, dtype=np.int64)] - ord("0"),
                   SEVERITY_MISSING)[ridx]
    fac = np.full(R, FACILITY_MISSING, dtype=np.int64)

    # ---- pair slots: [R, P] matrices in sorted order + typed words ------
    if rop_s.size:
        # rr maps each pair to its COMPACTED candidate row (slot matrix
        # space); pc counts in that same space — a fallback row BEFORE
        # a candidate row must not shift either
        tpos = np.cumsum(cand) - 1
        rr = tpos[rop_s]
        pc = np.bincount(rr, minlength=R).astype(np.int64)
        P = max(1, int(pc.max(initial=0)))
        within = np.zeros(rop_s.size, dtype=np.int64)
        if rop_s.size:
            new_row = np.ones(rop_s.size, dtype=bool)
            new_row[1:] = rop_s[1:] != rop_s[:-1]
            run_starts = np.flatnonzero(new_row)
            within = (np.arange(rop_s.size)
                      - np.repeat(run_starts,
                                  np.diff(np.append(run_starts,
                                                    rop_s.size))))
        name_a = np.zeros((R, P), dtype=np.int64)
        name_l = np.zeros((R, P), dtype=np.int64)
        val_a = np.zeros((R, P), dtype=np.int64)
        val_l = np.zeros((R, P), dtype=np.int64)
        pvalid = np.zeros((R, P), dtype=bool)
        d0 = np.zeros((R, P), dtype=np.int64)
        d1 = np.zeros((R, P), dtype=np.int64)
        vtext = np.zeros((R, P), dtype=bool)
        # vectorized canonical-int parse: <= 19-byte window incl sign
        is_num = pv_t == VT_NUMBER
        neg = chunk_pad[pv_a] == ord("-")
        wnd = (pv_a[:, None]
               + np.arange(19, dtype=np.int64)[None, :])
        wb = chunk_pad[wnd]
        wlen = pv_b - pv_a
        in_w = (np.arange(19)[None, :] >= neg[:, None].astype(np.int64)) \
            & (np.arange(19)[None, :] < wlen[:, None])
        digs = np.where(in_w, wb - ord("0"), 0).astype(np.int64)
        # right-align place values: digit at window index i has place
        # (wlen - 1 - i)
        place = wlen[:, None] - 1 - np.arange(19)[None, :]
        mag = (digs * np.where(in_w, 10 ** np.clip(place, 0, 18), 0)
               ).sum(axis=1)
        ival = np.where(neg, -mag, mag)
        disc = np.where(pv_t == VT_STRING, 0,
                        np.where(pv_t == VT_TRUE, 1 | (1 << 16),
                                 np.where(pv_t == VT_FALSE, 1,
                                          np.where(pv_t == VT_NULL, 5,
                                                   np.where(neg, 3, 4)))))
        slot = (rr, within)
        name_a[slot] = ns_s
        name_l[slot] = ne_s - ns_s
        val_a[slot] = pv_a
        val_l[slot] = pv_b - pv_a
        pvalid[slot] = True
        d0[slot] = disc
        d1[slot] = np.where(is_num, ival, 0)
        vtext[slot] = pv_t == VT_STRING
        has_sd = pc > 0
        pairs = (name_a, name_l, val_a, val_l, pvalid, has_sd)
        typed = (d0, d1, vtext)
    else:
        pairs = None
        typed = None

    zero = np.zeros(R, dtype=np.int64)
    absent = np.zeros(R, dtype=bool)
    host_a0, host_b0 = vspan_at(s["host_f"])
    msg_a0, msg_b0 = vspan_at(s["short_f"])
    full_a0, full_b0 = vspan_at(s["full_f"])
    texts = [
        (host_a0[ridx], (host_b0 - host_a0)[ridx], None),
        (zero, zero, absent),          # appname
        (zero, zero, absent),          # procid
        (zero, zero, absent),          # msgid
        (msg_a0[ridx], (msg_b0 - msg_a0)[ridx], s["has_short"][ridx]),
        (full_a0[ridx], (full_b0 - full_a0)[ridx], s["has_full"][ridx]),
    ]
    return _capnp_assemble(
        chunk_bytes, starts64, lens64, n, cand, ridx, texts,
        (zero, zero, np.zeros(R, dtype=bool)),   # sd_id is None for gelf
        pairs, ts, fac, sev, encoder, merger, suffix, syslen,
        scalar_fn=_scalar_gelf, typed=typed)
