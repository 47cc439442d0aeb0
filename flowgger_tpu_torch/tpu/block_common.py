"""Shared machinery for the columnar block encoders: framing specs, the
scalar-oracle fallback loop, and the splice that interleaves vectorized
tier runs with per-row fallback output in input order.

Each block encoder (every input into GELF, LTSV and RFC5424; rfc5424 and
rfc3164 into passthrough; rfc3164 into RFC3164) produces a
contiguous ``final_buf`` for its fast-tier rows plus ``row_off``
boundaries; this module turns that into an EncodedBlock with the
reference's observable semantics — per-line errors
in order (line_splitter.rs:37-54), framing pre-applied with the
pipeline's merger (merger/mod.rs:30-32).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..block import EncodedBlock
from ..encoders import EncodeError
from ..mergers import LineMerger, Merger, NulMerger, SyslenMerger
from .assemble import (
    build_source,
    concat_segments,
    exclusive_cumsum,
    syslen_prefix_segments,
)
from .materialize import _scalar_line, compute_ts


def vals_scratch(vals: np.ndarray, fmt_fn):
    """Deduplicated formatted values: repetitive streams share few
    distinct stamps, and ``fmt_fn`` (json_f64, display_f64) is the only
    per-value Python.  Returns
    (scratch bytes, per-row offsets, per-row lengths)."""
    uniq, inv = np.unique(vals, return_inverse=True)
    strs = [fmt_fn(float(u)).encode("ascii") for u in uniq]
    scratch = b"".join(strs)
    ulen = np.fromiter((len(s) for s in strs), dtype=np.int64,
                       count=len(strs))
    uoff = exclusive_cumsum(ulen)[:-1]
    return scratch, uoff[inv], ulen[inv]


def ts_scratch(out, n: int, ridx: np.ndarray, fmt_fn):
    """vals_scratch over the calendar-channel timestamps."""
    ts = compute_ts({k: np.asarray(v)[:n][ridx]
                     for k, v in out.items()
                     if k in ("days", "sod", "off", "nanos")})
    return vals_scratch(ts, fmt_fn)


def ltsv_extra_blob(extra) -> bytes:
    """Pre-rendered ``ltsv_extra`` pairs, escaped once per config the
    way the LTSV encoder's insert does (strip leading '_', tab/newline →
    space, ':' → '_' in keys), each pair tab-terminated."""
    parts = []
    for k, v in extra:
        k = k[1:] if k.startswith("_") else k
        k = k.replace("\n", " ").replace("\t", " ").replace(":", "_")
        v = v.replace("\t", " ").replace("\n", " ")
        parts.append(f"{k}:{v}\t".encode("utf-8"))
    return b"".join(parts)


def ltsv_special_screen(chunk_arr: np.ndarray, starts64: np.ndarray,
                        part_start: np.ndarray, nlen: np.ndarray,
                        jmask: np.ndarray):
    """LTSV special-key routing of the LTSV → GELF and LTSV → LTSV block
    encoders:
    specials match by NAME (the kernel's *_pos channels only catch the
    last occurrence, but the scalar decoder routes every occurrence of
    a repeated special), so the blocks screen by the first 8 key bytes.
    Returns (special_name [n, P] mask, uniq_ok [n] — False where a
    special name repeats and the row must take the oracle)."""
    n, P = part_start.shape
    key8 = (starts64[:, None, None] + part_start[:, :, None]
            + np.arange(8, dtype=np.int64)[None, None, :])
    km = chunk_arr[np.clip(key8, 0, max(chunk_arr.size - 1, 0))] \
        if chunk_arr.size else np.zeros((n, P, 8), dtype=np.uint8)
    special_name = np.zeros((n, P), dtype=bool)
    uniq_ok = np.ones(n, dtype=bool)
    for word in (b"time", b"host", b"message", b"level"):
        match = jmask & (nlen == len(word))
        for i, ch in enumerate(word[:8]):
            match &= km[:, :, i] == ch
        special_name |= match
        uniq_ok &= match.sum(axis=1) <= 1
    return special_name, uniq_ok


def span_f64_scratch(chunk_bytes: bytes, tsa, tsb, fmt_fn):
    """Dedup parse+format of per-row numeric SPANS in one dict pass
    keyed on the span bytes (repetitive streams share few distinct
    stamps; fmt_fn is the only per-unique Python).  Returns
    (scratch bytes, per-row offsets, per-row lengths)."""
    cache = {}
    pieces = []
    pos = 0
    R = len(tsa)
    off = np.empty(R, dtype=np.int64)
    ln = np.empty(R, dtype=np.int64)
    for i, (a, b) in enumerate(zip(tsa.tolist(), tsb.tolist())):
        key = chunk_bytes[a:b]
        hit = cache.get(key)
        if hit is None:
            txt = fmt_fn(float(key)).encode("ascii")
            hit = (pos, len(txt))
            cache[key] = hit
            pieces.append(txt)
            pos += len(txt)
        off[i] = hit[0]
        ln[i] = hit[1]
    return b"".join(pieces), off, ln


def gelf_sorted_pairs(chunk_arr, starts64, cand, is_pair, kabs, key_e,
                      vabs_a, vabs_b, val_t, byte_at, cap: int):
    """Flat pair table in sorted-ORIGINAL-key Record order for the gelf
    and jsonl → LTSV routes (the materializers take sorted(obj.keys())).
    Duplicate-key rows drop out of ``cand`` IN PLACE (dict last-wins
    semantics go to the oracle).  Returns (rop_s — ORIGINAL row ids —,
    ns_s stripped name starts so ``'_' + span`` is the final name,
    ne_s, pv_t, pv_a, pv_b)."""
    if not int(is_pair.sum()):
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z.copy(), z, z
    prow, pcol = np.nonzero(is_pair)
    rop = prow.astype(np.int64)
    ns_abs = kabs[prow, pcol]
    ne_abs = starts64[rop] + key_e[prow, pcol]
    order, dup_rows = sorted_pair_order(chunk_arr, rop, ns_abs, ne_abs,
                                        cap)
    if dup_rows.size:
        cand[dup_rows] = False
        order = order[cand[rop[order]]]
    rop_s = rop[order]
    has_us = byte_at(ns_abs[order]) == ord("_")
    return (rop_s, ns_abs[order] + has_us, ne_abs[order],
            val_t[prow, pcol][order], vabs_a[prow, pcol][order],
            vabs_b[prow, pcol][order])


def ltsv_ts_vals(out, n: int, ridx: np.ndarray, chunk_bytes: bytes,
                 starts64: np.ndarray) -> np.ndarray:
    """Per-row f64 timestamps for ltsv tier rows: rfc3339 rows combine
    the calendar channels; unix-literal rows combine the kernel's exact
    split-integer parse (ts_hi * 1e9 + ts_lo over 10**frac, correctly
    rounded within 2**53); signed or 17+-digit stamps take an exact
    per-row ``float(span)`` (ts_meta bit 16 is "has a sign CHARACTER",
    not "negative")."""
    kind = np.asarray(out["ts_kind"])[:n][ridx]
    ts = compute_ts({k: np.where(kind == 0, np.asarray(v)[:n][ridx], 0)
                     for k, v in out.items()
                     if k in ("days", "sod", "off", "nanos")})
    fl = np.flatnonzero(kind == 1)
    if fl.size:
        hi = np.asarray(out["ts_hi"])[:n][ridx][fl].astype(np.float64)
        lo = np.asarray(out["ts_lo"])[:n][ridx][fl].astype(np.float64)
        meta = np.asarray(out["ts_meta"])[:n][ridx][fl].astype(np.int64)
        frac = meta & 255
        ndig = (meta >> 8) & 255
        signed = ((meta >> 16) & 1) == 1
        fv = (hi * 1e9 + lo) / np.power(10.0, frac)
        wide = np.flatnonzero(
            signed | (ndig > 16)
            | ((ndig == 16)
               & ((hi > 9007199.0)
                  | ((hi == 9007199.0) & (lo > 254740992.0)))))
        if wide.size:
            st_fl = starts64[ridx][fl]
            tsa = (st_fl + np.asarray(out["ts_start"])[:n][ridx][fl]
                   ).astype(np.int64)
            tsb = (st_fl + np.asarray(out["ts_end"])[:n][ridx][fl]
                   ).astype(np.int64)
            for w in wide.tolist():
                fv[w] = float(chunk_bytes[tsa[w]:tsb[w]])
        ts[fl] = fv
    return ts


def sorted_pair_order(chunk_arr: np.ndarray, rop: np.ndarray,
                      ns_abs: np.ndarray, ne_abs: np.ndarray, cap: int):
    """Sort a flat pair table by (row, name bytes) and detect duplicate
    names within a row.

    Sort keys are the name bytes packed big-endian into uint64 words via
    a contiguous view, width adapting to the batch's longest name (the
    caller guarantees names <= ``cap`` bytes).  Returns (order indices,
    duplicate-row ids) — callers drop duplicate rows to the scalar
    oracle for dict last-wins semantics."""
    max_name = int((ne_abs - ns_abs).max(initial=0))
    K = max(8, min(cap, -(-max_name // 8) * 8))
    gidx = (ns_abs[:, None]
            + np.arange(K, dtype=np.int64)[None, :]).astype(np.int32)
    nm = np.where(gidx < ne_abs[:, None].astype(np.int32),
                  chunk_arr[np.minimum(gidx, chunk_arr.size - 1)],
                  np.uint8(0))
    words = np.ascontiguousarray(nm).view(">u8")
    order = np.lexsort(tuple(words[:, w] for w in range(K // 8 - 1, -1, -1))
                       + (rop,))
    srop = rop[order]
    swords = words[order]
    dup = (srop[1:] == srop[:-1]) & (swords[1:] == swords[:-1]).all(axis=1)
    dup_rows = np.unique(srop[1:][dup]) if dup.any() else np.zeros(
        0, dtype=rop.dtype)
    return order, dup_rows


def syslen_prefix_lens_from_framed(framed_lens: np.ndarray) -> np.ndarray:
    """Per-row syslen prefix width recovered from framed lengths (the
    native row writer emits the prefix inline, so only the total framed
    length comes back): the unique d with
    decimal_digits(framed - d - 1) == d, plus one for the space."""
    from .assemble import _DEC_WIDTH

    plens = np.zeros(framed_lens.size, dtype=np.int64)
    pow10 = 10 ** np.arange(1, _DEC_WIDTH, dtype=np.int64)
    for d in range(1, _DEC_WIDTH + 1):
        body = framed_lens - d - 1
        ndig = 1 + (body[:, None] >= pow10[None, :]).sum(axis=1)
        plens = np.where((plens == 0) & (ndig == d), d + 1, plens)
    return plens


def apply_syslen_prefix(body: np.ndarray, row_off: np.ndarray,
                        tier_lens: np.ndarray):
    """Prepend the syslen length prefix per row via one more segment
    gather.  The rows in ``body`` must already carry their trailing
    newline (the framed length value counts payload + '\\n',
    syslen_merger.rs:14-31).  Returns (final_buf bytes, new row_off,
    prefix_lens)."""
    deco, _ = build_source(b"0123456789 ")
    src2 = np.concatenate([body, deco])
    psrc, plen, prefix_lens = syslen_prefix_segments(tier_lens,
                                                     int(body.size))
    seg_src = np.concatenate([psrc, row_off[:-1, None]], axis=1).ravel()
    seg_len = np.concatenate([plen, tier_lens[:, None]], axis=1).ravel()
    out = concat_segments(src2, seg_src, seg_len)
    return out.tobytes(), exclusive_cumsum(tier_lens + prefix_lens), prefix_lens


class BlockResult:
    """The block plus per-row errors, in input order.

    ``emit`` marks which input rows produced a message (the block's
    bounds align with ``emit``'s True positions) and ``error_rows``
    carries the input-row index of each error."""

    __slots__ = ("block", "errors", "fallback_rows", "emit", "error_rows")

    def __init__(self, block: EncodedBlock, errors: List[Tuple[str, str]],
                 fallback_rows: int, emit=None, error_rows=None):
        self.block = block
        self.errors = errors
        self.fallback_rows = fallback_rows
        self.emit = emit
        self.error_rows = error_rows


def extra_forms(k: str, v: str) -> Tuple[bytes, bytes, bytes]:
    """The three boundary renderings of one gelf_extra pair, used by the
    slot folder in encode_gelf_block:
    ``self`` (before a key: fully quoted + trailing comma),
    ``string-close`` (after an unclosed string value: leading ``",``
    closes it, own closing quote supplied by the next constant), and
    ``after-number`` (after a bare number or self-closed value:
    self-contained with a leading comma)."""
    from json.encoder import encode_basestring as _quote

    kq = _quote(k).encode("utf-8")
    vq = _quote(v).encode("utf-8")
    return (kq + b":" + vq + b",",
            b'",' + kq + b":" + vq[:-1],
            b"," + kq + b":" + vq)


def extra_tail(default: bytes, tv: bytes, vz: bytes) -> bytes:
    """Rebuild the ``,"version":"1.1"}`` tail with extras before/after
    the version key (tv: after-number form, vz: string-close form)."""
    if not (tv or vz):
        return default
    return tv + b',"version":"1.1' + vz + b'"}'


def merger_suffix(merger: Optional[Merger]) -> Optional[Tuple[bytes, bool]]:
    """(suffix bytes, needs syslen prefix) or None if the merger type is
    not block-encodable."""
    if merger is None:
        return b"", False
    t = type(merger)
    if t is LineMerger:
        return b"\n", False
    if t is NulMerger:
        return b"\0", False
    if t is SyslenMerger:
        return b"\n", True
    return None


def finish_block(
    chunk_bytes: bytes,
    starts64: np.ndarray,
    lens64: np.ndarray,
    n: int,
    cand: np.ndarray,
    ridx: np.ndarray,
    final_buf: bytes,
    row_off: np.ndarray,
    prefix_lens_tier: Optional[np.ndarray],
    suffix: bytes,
    syslen: bool,
    merger: Optional[Merger],
    encoder,
    scalar_fn=_scalar_line,
) -> BlockResult:
    """Fallback rows through the scalar oracle (``scalar_fn``, the
    rfc5424 one by default), splice in input order, compute message
    bounds; returns the BlockResult."""
    errors: List[Tuple[str, str]] = []
    row_bytes_len = np.zeros(n, dtype=np.int64)
    emit = np.zeros(n, dtype=bool)
    if ridx.size:
        row_bytes_len[ridx] = np.diff(row_off)
        emit[ridx] = True

    fb_idx = np.flatnonzero(~cand)
    fallback_payload: Dict[int, bytes] = {}
    fb_prefix: Dict[int, int] = {}
    fallback_rows = 0  # parity with the per-row path: utf8 errors excluded
    error_rows: List[int] = []
    for i in fb_idx.tolist():
        s = int(starts64[i])
        ln = int(lens64[i])
        raw = chunk_bytes[s:s + ln]
        try:
            line = raw.decode("utf-8")
        except UnicodeDecodeError:
            errors.append(("__utf8__", ""))
            error_rows.append(i)
            continue
        fallback_rows += 1
        res = scalar_fn(line)
        if res.record is None:
            errors.append((res.error, line))
            error_rows.append(i)
            continue
        try:
            payload = encoder.encode(res.record)
        except EncodeError as e:
            errors.append((str(e), line))
            error_rows.append(i)
            continue
        framed_b = merger.frame(payload) if merger is not None else payload
        fallback_payload[i] = framed_b
        fb_prefix[i] = len(framed_b) - len(payload) - len(suffix)
        row_bytes_len[i] = len(framed_b)
        emit[i] = True

    # splice tier runs and fallback rows in input order: fb_idx is
    # exactly the non-tier rows, so every gap between consecutive
    # fallback rows is a contiguous run of tier rows whose bytes are
    # already contiguous in final_buf — one slice per run.
    if fb_idx.size:
        pieces: List[bytes] = []
        tpos = np.cumsum(cand) - 1  # tier ordinal per row
        prev = 0
        for i in fb_idx.tolist():
            if i > prev:
                pieces.append(
                    final_buf[int(row_off[tpos[prev]]):
                              int(row_off[tpos[i - 1] + 1])])
            fp = fallback_payload.get(i)
            if fp is not None:
                pieces.append(fp)
            prev = i + 1
        if prev < n:
            pieces.append(final_buf[int(row_off[tpos[prev]]):])
        data = b"".join(pieces)
    else:
        data = final_buf

    bounds = exclusive_cumsum(row_bytes_len[emit])
    prefix_lens = None
    if syslen:
        prefix_lens = np.zeros(n, dtype=np.int64)
        if prefix_lens_tier is not None:
            prefix_lens[ridx] = prefix_lens_tier
        for i, v in fb_prefix.items():
            prefix_lens[i] = v
        prefix_lens = prefix_lens[emit]

    block = EncodedBlock(data, bounds, prefix_lens, len(suffix))
    return BlockResult(block, errors, fallback_rows, emit=emit,
                       error_rows=error_rows)
