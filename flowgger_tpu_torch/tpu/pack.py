"""Host-side batch packing: framed lines → dense ``[N, max_len]``
batches, for the records that do not go through device framing (the
trailing partial record at end of stream, and a region the span kernel
declined).

Lines live in one contiguous chunk described by offset/length vectors,
the JAX package's packed contract: ``(batch, clipped_lens, chunk,
starts, orig_lens, n_real)``.  Row counts are bucketed to powers of two
(at least ``_MIN_ROWS``); padding rows have length 0 and fall outside
``n_real``, so the bucket never changes emitted bytes.
:func:`subset_packed` takes a row subset of a packed tuple (the
auto-detect partition), on the card when the batch lies there.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

_MIN_ROWS = 256


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def bucket_rows(n: int) -> int:
    """Padded row count for ``n`` real rows."""
    return max(_MIN_ROWS, _next_pow2(max(int(n), 1)))


def _split(chunk: bytes, strip_cr: bool = True, sep: int = 10
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Separator scan: (starts, lens, n) — BufRead::lines semantics for
    ``sep=\\n`` (one trailing CR stripped), BufRead::split semantics for
    other separators (nul framing)."""
    buf = np.frombuffer(chunk, dtype=np.uint8)
    nl = np.flatnonzero(buf == sep).astype(np.int32)
    n = int(nl.size)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    starts = np.concatenate([np.zeros(1, np.int32), nl[:-1] + 1])
    ends = nl.copy()
    if strip_cr:
        has_cr = (ends > starts) & (buf[np.maximum(ends - 1, 0)] == 13)
        ends = ends - has_cr.astype(np.int32)
    return starts, ends - starts, n


def _finish(chunk: bytes, starts: np.ndarray, lens: np.ndarray, n: int,
            max_len: int):
    rows = bucket_rows(n)
    buf = np.frombuffer(chunk, dtype=np.uint8)
    lens_c = np.minimum(lens, max_len)
    batch = np.zeros((rows, max_len), dtype=np.uint8)
    if n:
        col = np.arange(max_len, dtype=np.int32)[None, :]
        idx = np.clip(starts[:, None] + col, 0, max(buf.size - 1, 0))
        batch[:n] = np.where(col < lens_c[:, None], buf[idx], 0)
    lens_p = np.zeros(rows, dtype=np.int32)
    lens_p[:n] = lens_c
    starts_p = np.zeros(rows, dtype=np.int32)
    starts_p[:n] = starts
    return batch, lens_p, chunk, starts_p, np.asarray(lens, np.int32), n


def pack_lines_2d(lines: List[bytes], max_len: int):
    """Pack a list of framed lines (same return contract as
    :func:`pack_region_2d`)."""
    n = len(lines)
    chunk = b"".join(lines)
    orig_lens = np.fromiter((len(ln) for ln in lines), dtype=np.int32,
                            count=n)
    starts = np.zeros(n, dtype=np.int32)
    if n > 1:
        np.cumsum(orig_lens[:-1], out=starts[1:])
    return _finish(chunk, starts, orig_lens, n, max_len)


def pack_region_2d(region: bytes, max_len: int, sep: int = 10,
                   strip_cr: bool = True):
    """Pack a region of complete separator-terminated records.  Returns
    (batch, clipped_lens, chunk, starts, orig_lens, n_real)."""
    starts, lens, n = _split(region, strip_cr, sep)
    return _finish(region, starts, lens, n, max_len)


def pack_spans_2d(chunk: bytes, starts: np.ndarray, lens: np.ndarray,
                  max_len: int):
    """Pack records given as spans into ``chunk`` (the host syslen scan's
    output; same return contract as :func:`pack_region_2d`)."""
    return _finish(chunk, np.asarray(starts, np.int32),
                   np.asarray(lens, np.int32), len(starts), max_len)


def subset_packed(packed, idx: np.ndarray):
    """The rows ``idx`` of a packed tuple as a packed tuple of their own
    (the auto-detect partition), re-bucketed with :func:`bucket_rows`.
    A batch on a device is gathered on that device (one index gather
    into a zeroed bucket); a numpy batch on the host.  ``orig_lens``
    keeps one entry a real row, as the reference's ``subset_packed``
    (pack.py:262)."""
    batch, lens, chunk, starts, orig_lens, _n = packed
    m = int(idx.size)
    rows = bucket_rows(m)
    L = batch.shape[1]
    s2 = np.zeros(rows, dtype=np.int32)
    if isinstance(batch, torch.Tensor):
        b2 = torch.zeros((rows, L), dtype=torch.uint8, device=batch.device)
        l2 = torch.zeros(rows, dtype=torch.int32, device=batch.device)
        if m:
            dev_idx = torch.from_numpy(np.asarray(idx, np.int64)).to(
                batch.device)
            b2[:m] = batch.index_select(0, dev_idx)
            l2[:m] = lens.index_select(0, dev_idx).to(torch.int32)
    else:
        b2 = np.zeros((rows, L), dtype=np.uint8)
        l2 = np.zeros(rows, dtype=np.int32)
        if m:
            b2[:m] = batch[idx]
            l2[:m] = lens[idx]
    if m:
        s2[:m] = np.asarray(starts)[idx]
    return b2, l2, chunk, s2, np.asarray(orig_lens)[idx], m
