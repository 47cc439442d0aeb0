"""Vectorized byte assembly: build output buffers from span tables with
numpy offset math — zero per-row Python on the fast tier.

Output bytes for a whole batch are produced by three primitives:

1. ``escape_json`` — JSON-escape an entire chunk buffer once, sparsely:
   escapable bytes (quotes, backslashes, control chars) are rare in log
   streams, so the escaped buffer is assembled from plain-run segments
   plus a 256-entry escape-sequence bank, and original→escaped position
   mapping is ``x + extra_before(x)`` answered by a binary search over
   the escape positions — O(escapes), not O(bytes), beyond one copy.
2. ``concat_segments`` — materialize an output buffer described as a
   flat list of (source offset, length) segments: a threaded memcpy in
   the native host tier (``flowgger_tpu_torch/native.py``), with
   ``_concat_segments_np`` (one ``np.repeat`` + fancy-index gather in
   int32) as its plain version.
3. ``decimal_segments`` — render an int array as ASCII decimal via
   fixed-width digit segments with zero-length leading-zero segments,
   so even length prefixes (syslen framing) stay columnar.

The per-record reference behavior being replicated bytewise is
``handle_line`` = decode→encode→send (line_splitter.rs:44-54) with the
merger applied by the sink (merger/mod.rs:30-32); differential tests
assert equality against the scalar encoder output.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# JSON escaping (json.encoder.encode_basestring semantics: escape
# backslash, double quote, \b \t \n \f \r shortcuts, \u00XX other ctrl)
# ---------------------------------------------------------------------------

_EXPAND = np.ones(256, dtype=np.int64)
_EXPAND[ord('"')] = 2
_EXPAND[ord("\\")] = 2
for _c in range(0x20):
    _EXPAND[_c] = 6
for _c in (0x08, 0x09, 0x0A, 0x0C, 0x0D):
    _EXPAND[_c] = 2

_NEEDS = _EXPAND != 1


def _esc_seq(b: int) -> bytes:
    if b == 0x22:
        return b'\\"'
    if b == 0x5C:
        return b"\\\\"
    shortcuts = {0x08: b"\\b", 0x09: b"\\t", 0x0A: b"\\n",
                 0x0C: b"\\f", 0x0D: b"\\r"}
    if b in shortcuts:
        return shortcuts[b]
    return ("\\u%04x" % b).encode("ascii")


_ESC_BANK = b"".join(_esc_seq(b) if _NEEDS[b] else b"" for b in range(256))
_ESC_OFF = np.zeros(256, dtype=np.int64)
_pos = 0
for _b in range(256):
    _ESC_OFF[_b] = _pos
    if _NEEDS[_b]:
        _pos += int(_EXPAND[_b])
del _pos


class EscapeMap:
    """JSON-escaped view of a chunk plus original→escaped offset map.

    ``esc``  — the escaped u8 buffer.
    ``map(x)`` — vectorized: escaped offset of original offset x (valid
    for span endpoints: escapes are byte-local so spans stay contiguous).
    """

    __slots__ = ("esc", "pos", "cum", "identity")

    def __init__(self, esc: np.ndarray, pos: Optional[np.ndarray],
                 cum: Optional[np.ndarray]):
        self.esc = esc
        self.pos = pos
        self.cum = cum
        self.identity = pos is None

    def map(self, x: np.ndarray) -> np.ndarray:
        if self.identity:
            return x.astype(np.int64, copy=False)
        k = np.searchsorted(self.pos, x, side="left")
        return x.astype(np.int64, copy=False) + self.cum[k]


def escape_json(buf: np.ndarray) -> EscapeMap:
    pos = np.flatnonzero(_NEEDS[buf])
    e = pos.size
    if e == 0:
        return EscapeMap(buf, None, None)
    widths = _EXPAND[buf[pos]]
    extra = widths - 1
    cum = np.empty(e + 1, dtype=np.int64)
    cum[0] = 0
    np.cumsum(extra, out=cum[1:])
    # alternating segments: plain run, escape sequence, plain run, ...
    nseg = 2 * e + 1
    seg_src = np.empty(nseg, dtype=np.int64)
    seg_len = np.empty(nseg, dtype=np.int64)
    plain_start = np.empty(e + 1, dtype=np.int64)
    plain_start[0] = 0
    plain_start[1:] = pos + 1
    plain_end = np.empty(e + 1, dtype=np.int64)
    plain_end[:e] = pos
    plain_end[e] = buf.size
    seg_src[0::2] = plain_start
    seg_len[0::2] = plain_end - plain_start
    seg_src[1::2] = buf.size + _ESC_OFF[buf[pos]]
    seg_len[1::2] = widths
    src = np.concatenate([buf, np.frombuffer(_ESC_BANK, dtype=np.uint8)])
    esc = concat_segments(src, seg_src, seg_len)
    return EscapeMap(esc, pos, cum)


# ---------------------------------------------------------------------------
# Segment gather
# ---------------------------------------------------------------------------

def exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.empty(x.size + 1, dtype=np.int64)
    out[0] = 0
    np.cumsum(x, out=out[1:])
    return out


def count_in_spans(cum: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Occurrences within [a, b) given an inclusive prefix-count.
    Indices are clipped: callers mask out invalid spans afterwards, but
    padded/kernel-flagged rows may carry out-of-range placeholders.  An
    empty source buffer counts as zero everywhere."""
    if cum.size == 0:
        return np.zeros(np.broadcast(a, b).shape, dtype=np.int64)
    top = cum.size - 1
    hi = np.where(b > 0, cum[np.clip(b - 1, 0, top)], 0)
    lo = np.where(a > 0, cum[np.clip(a - 1, 0, top)], 0)
    return hi - lo


def concat_segments(src: np.ndarray, seg_src: np.ndarray,
                    seg_len: np.ndarray,
                    dst0: Optional[np.ndarray] = None) -> np.ndarray:
    """Concatenate ``src[seg_src[i] : seg_src[i]+seg_len[i]]`` for all i
    into one u8 buffer (``fg_concat_segments``, a threaded memcpy in the
    native host tier).  ``dst0`` is the (len+1) exclusive prefix sum of
    seg_len if the caller already computed it."""
    from .. import native

    seg_len = seg_len.astype(np.int64, copy=False)
    if dst0 is None:
        dst0 = exclusive_cumsum(seg_len)
    return native.concat_segments_native(src, seg_src, seg_len, dst0,
                                         int(dst0[-1]))


def _concat_segments_np(src: np.ndarray, seg_src: np.ndarray,
                        seg_len: np.ndarray,
                        dst0: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain numpy version of :func:`concat_segments`, which the
    tests hold the native gather against."""
    seg_len = seg_len.astype(np.int64, copy=False)
    if dst0 is None:
        dst0 = exclusive_cumsum(seg_len)
    total = int(dst0[-1])
    # one repeat + one arange + one gather, int32 when the buffers allow
    # (they do for any chunk under 2 GiB)
    if total < 2**31 and src.size < 2**31:
        shift = np.repeat(
            seg_src.astype(np.int32, copy=False) - dst0[:-1].astype(np.int32),
            seg_len)
        idx = np.arange(total, dtype=np.int32)
    else:
        shift = np.repeat(seg_src.astype(np.int64, copy=False) - dst0[:-1],
                          seg_len)
        idx = np.arange(total, dtype=np.int64)
    idx += shift
    return src[idx]


# ---------------------------------------------------------------------------
# Decimal rendering as segments
# ---------------------------------------------------------------------------

_DEC_WIDTH = 10  # covers int32 magnitudes


def decimal_segments(values: np.ndarray, digits_off: int,
                     width: int = _DEC_WIDTH
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(seg_src, seg_len) rendering each non-negative value as ASCII
    decimal using ``width`` fixed slots per value; leading-zero slots
    get length 0 so the gather emits exactly ``str(v)``.

    ``digits_off`` is the offset of a 10-byte "0123456789" table in the
    source buffer the caller gathers from.
    """
    v = values.astype(np.int64, copy=False)
    pow10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digs = (v[:, None] // pow10[None, :]) % 10          # [n, W]
    # significant from the first nonzero (last slot always significant)
    sig = np.cumsum(digs != 0, axis=1) > 0
    sig[:, -1] = True
    seg_src = digits_off + digs.reshape(-1)
    seg_len = sig.astype(np.int64).reshape(-1)
    return seg_src, seg_len


def syslen_prefix_segments(body_lens: np.ndarray, digits_base: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row syslen framing prefix ``"{body_len} "`` as 2D segment
    columns: (src2d [R, W+1], len2d [R, W+1], prefix_lens [R]).  Callers
    hstack their body columns and ravel; ``digits_base`` is the offset
    of a ``b"0123456789 "`` table in the gather source.  The single
    place the syslen prefix layout lives (syslen_merger.rs:14-31)."""
    r = body_lens.size
    dsrc, dlen = decimal_segments(body_lens, digits_base)
    src2 = np.empty((r, _DEC_WIDTH + 1), dtype=np.int64)
    len2 = np.empty((r, _DEC_WIDTH + 1), dtype=np.int64)
    src2[:, :_DEC_WIDTH] = dsrc.reshape(r, _DEC_WIDTH)
    len2[:, :_DEC_WIDTH] = dlen.reshape(r, _DEC_WIDTH)
    src2[:, _DEC_WIDTH] = digits_base + 10  # the space
    len2[:, _DEC_WIDTH] = 1
    return src2, len2, len2.sum(axis=1)


def build_source(*parts: bytes) -> Tuple[np.ndarray, List[int]]:
    """Concatenate byte strings into one u8 source array; returns the
    array and each part's base offset."""
    offs = []
    pos = 0
    for p in parts:
        offs.append(pos)
        pos += len(p)
    buf = np.frombuffer(b"".join(parts), dtype=np.uint8)
    return buf, offs
