"""Device framing: record spans over a raw region and the dense row
gather, ahead of the decode.

The splitter hands raw transport chunks to the batch handler; at flush
the handler calls :func:`device_frame_region` on each session's region,
which uploads the region once, finds every record on the card and
builds the ``[rows, max_len]`` decode batch there (``frame_gather``) —
the host never splits or copies a record.  Only the span metadata comes
back.  Two span kernels:

- ``frame_sep_spans`` — line/NUL framing over a region cut at its last
  separator, one trailing CR stripped for line framing;
- ``frame_syslen_spans`` — RFC5425/RFC6587 octet counting
  (``<decimal> <body>`` back to back from offset 0): the frame chain,
  where it stops (``consumed``) and whether the stop holds a malformed
  length prefix (``err``).

Host contract: the same records, in the same order, as the host
splitters (``pack.pack_region_2d`` for line/NUL,
``splitters._scan_syslen_region`` for syslen).  A span overflow, or a
reachable syslen prefix longer than ``MAX_PREFIX_DIGITS`` digits, is a
data condition, not a kernel failure: it raises :class:`FramingDeclined`
and the caller re-frames that region on the host, exactly as the JAX
package does.

Each stage has a plain PyTorch version (:func:`frame_sep_spans`,
:func:`frame_syslen_spans`, :func:`frame_gather`) beside the kernel;
:func:`sep_spans`, :func:`syslen_spans` and :func:`gather` launch the
kernel for a CUDA tensor and take the plain version only for a tensor
that lies on the CPU.
"""

from __future__ import annotations

import threading

import torch

from . import pack as _pack

# byte-identity contract (flowcheck FC03): the host splitter the device
# framing must match record for record, and the test that holds it
SCALAR_ORACLE = ("flowgger_tpu_torch.tpu.pack:pack_region_2d",
                 "flowgger_tpu_torch.splitters:_scan_syslen_region")
DIFF_TEST = ("tests/test_torch_framing.py::"
             "test_device_frame_region_matches_host_pack",
             "tests/test_torch_syslen.py::"
             "test_device_frame_region_matches_host_scan")

# region byte floor; regions pad to the next power of two above it
MIN_REGION_BYTES = 1 << 14
# longest syslen length prefix the exact int32 value parse supports;
# longer prefixes decline the region to the host scan, which owns the
# > 2^31-1 error
MAX_PREFIX_DIGITS = 9

# (separator byte, strip one trailing CR) per framing — the statics the
# JAX package's framing_statics passes its span kernels
_FRAMING = {"line": (10, True), "nul": (0, False)}


# regions declined to the host re-frame, per framing, since the last
# reset (a data condition, not a kernel failure; chip_smoke.py reads it)
DECLINES = {"line": 0, "nul": 0, "syslen": 0}
_declines_lock = threading.Lock()


class FramingDeclined(Exception):
    """The span kernel declined this region (span overflow, or a syslen
    prefix over MAX_PREFIX_DIGITS digits); the caller must re-frame it on
    the host — same bytes, no records lost."""


def region_bucket(nbytes: int) -> int:
    """Padded device size for a raw region: next power of two with a
    floor."""
    b = MIN_REGION_BYTES
    while b < nbytes:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def frame_sep_spans(region: torch.Tensor, rlen: int, sep: int = 10,
                    strip_cr: bool = True, ncap: int = 256):
    """Separator framing spans over ``region[:rlen]`` (u8 [B]).

    Returns starts/lens (CR-stripped) int32 [ncap], n, consumed (one past
    the last recorded separator) and overflow (n > ncap) — the JAX
    package's ``frame_sep_spans_jit`` contract."""
    B = region.shape[0]
    dev = region.device
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    is_sep = (region == sep) & (idx < rlen)
    ordc = torch.cumsum(is_sep.to(torch.int64), dim=0)
    n = ordc[-1]
    slot = torch.where(is_sep, torch.clamp(ordc - 1, max=ncap),
                       torch.full_like(ordc, ncap))
    ends = torch.zeros(ncap + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, slot, torch.where(is_sep, idx, 0))[:ncap]
    k = torch.arange(ncap, dtype=torch.int64, device=dev)
    live = k < n
    prev_end = torch.cat([torch.full((1,), -1, dtype=torch.int64,
                                     device=dev), ends[:-1]])
    starts = torch.where(live, prev_end + 1, 0)
    lens = ends - starts
    if strip_cr:
        before = region[torch.clamp(ends - 1, 0, B - 1)]
        lens = lens - (live & (lens > 0) & (before == 13)).to(torch.int64)
    lens = torch.where(live, lens, 0)
    consumed = torch.where(n > 0, ends[torch.clamp(n - 1, 0, ncap - 1)] + 1,
                           0)
    return {"starts": starts.to(torch.int32), "lens": lens.to(torch.int32),
            "n": n.to(torch.int32), "consumed": consumed.to(torch.int32),
            "overflow": n > ncap}


def syslen_hops(nbytes: int) -> int:
    """Pointer-doubling iterations that cover every chain in a region
    of ``nbytes``: frame starts strictly increase, so ceil(log2(B+1))
    hops reach any frame head."""
    return max(1, int(nbytes + 1).bit_length())


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def frame_syslen_spans(region: torch.Tensor, rlen: int, ncap: int = 256):
    """RFC5425 octet-count framing spans over ``region[:rlen]`` (u8
    [B]) — the JAX package's ``frame_syslen_spans_jit`` contract:
    starts/lens int32 [ncap] (zero past ``n``), n, consumed (the start of
    the first incomplete frame), err (the stop holds a malformed prefix:
    a space is reachable but the bytes before it are not all digits, or
    the prefix is empty) and decline (a reachable prefix of more than
    MAX_PREFIX_DIGITS digits, or n > ncap).  The chain from offset 0
    resolves by pointer doubling."""
    B = region.shape[0]
    dev = region.device
    i64 = torch.int64
    idx = torch.arange(B, dtype=i64, device=dev)
    valid = idx < rlen
    bi = region.to(i64)
    is_digit = (bi >= 48) & (bi <= 57) & valid
    is_space = (bi == 32) & valid
    big = 1 << 30
    # next space / next non-digit at-or-after each position (positions
    # at or past rlen act as non-digits)
    sp = _rev_cummin(torch.where(is_space, idx, big))
    nd = _rev_cummin(torch.where(is_digit, big, torch.clamp(idx, max=rlen)))
    has_space = sp < rlen
    prefix_ok = has_space & (nd == sp) & (sp > idx)
    too_long = prefix_ok & (sp - idx > MAX_PREFIX_DIGITS)
    # digit-prefix value at every position: each digit weighted by
    # 10^(distance to its run's space), differenced from a right-to-left
    # cumulative sum (exact in int64; the reference's wrapping int32
    # difference is exact for every prefix of at most 9 digits)
    exp = torch.clamp(sp - 1 - idx, 0, MAX_PREFIX_DIGITS - 1)
    pow10 = torch.tensor([10 ** i for i in range(MAX_PREFIX_DIGITS)],
                         dtype=i64, device=dev)
    w = torch.where(is_digit & has_space, (bi - 48) * pow10[exp], 0)
    suf = torch.flip(torch.cumsum(torch.flip(w, (0,)), 0), (0,))
    suf_ext = torch.cat([suf, torch.zeros(1, dtype=i64, device=dev)])
    val = suf - suf_ext[torch.clamp(sp, 0, B)]
    body = sp + 1
    nxt = body + val
    frame_ok = prefix_ok & ~too_long & (nxt <= rlen)
    # jump[p] = the next frame start (B when p heads no complete frame);
    # each hop propagates the reached set one jump and doubles the table
    jump = torch.cat([torch.where(frame_ok, torch.clamp(nxt, 0, B), B),
                      torch.full((1,), B, dtype=i64, device=dev)])
    reach = torch.zeros(B + 1, dtype=i64, device=dev)
    reach[0] = 1
    j = jump
    for _ in range(syslen_hops(B)):
        reach = reach.scatter_reduce(0, torch.where(reach > 0, j, B), reach,
                                     "amax")
        j = j[j]
    reached = reach[:B] > 0
    heads = reached & frame_ok
    ordc = torch.cumsum(heads.to(i64), 0)
    n = ordc[-1]
    slot = torch.where(heads, torch.clamp(ordc - 1, max=ncap), ncap)
    starts = torch.zeros(ncap + 1, dtype=i64, device=dev).scatter_add_(
        0, slot, torch.where(heads, body, 0))[:ncap]
    lens = torch.zeros(ncap + 1, dtype=i64, device=dev).scatter_add_(
        0, slot, torch.where(heads, val, 0))[:ncap]
    consumed = torch.where(heads, torch.clamp(nxt, 0, B), 0).max()
    # error analysis at the chain stop, mirroring the host scan
    stop = torch.clamp(consumed, 0, B - 1)
    sp_stop, nd_stop = sp[stop], nd[stop]
    bad_prefix = (sp_stop < rlen) & ((nd_stop != sp_stop)
                                     | (sp_stop == consumed))
    err = (consumed < rlen) & bad_prefix
    decline = (reached & too_long).any() | (n > ncap)
    return {"starts": starts.to(torch.int32), "lens": lens.to(torch.int32),
            "n": n.to(torch.int32), "consumed": consumed.to(torch.int32),
            "err": err, "decline": decline}


def frame_gather(region: torch.Tensor, starts: torch.Tensor,
                 lens: torch.Tensor, max_len: int = 512):
    """The framed records as a dense ``[rows, max_len]`` u8 batch, lens
    clipped to ``max_len`` — ``frame_gather_jit``'s contract."""
    dev = region.device
    col = torch.arange(max_len, dtype=torch.int64, device=dev)[None, :]
    lens_c = torch.clamp(lens.to(torch.int32), max=max_len)
    idx = starts.to(torch.int64)[:, None] + col
    vals = region[torch.clamp(idx, 0, region.shape[0] - 1)]
    batch = torch.where(col < lens_c[:, None], vals,
                        torch.zeros((), dtype=torch.uint8, device=dev))
    return batch.to(torch.uint8), lens_c


# ---------------------------------------------------------------------------
# dispatch: the kernel for a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def sep_spans(region: torch.Tensor, rlen: int, sep: int = 10,
              strip_cr: bool = True, ncap: int = 256):
    if region.is_cuda:
        from .kernels import frame_sep_spans_cuda

        out = frame_sep_spans_cuda(region, rlen, sep=sep, strip_cr=strip_cr,
                                   ncap=ncap)
        meta = out["meta"]
        return {"starts": out["starts"], "lens": out["lens"], "n": meta[0],
                "consumed": meta[1], "overflow": meta[2] != 0}
    return frame_sep_spans(region, rlen, sep=sep, strip_cr=strip_cr,
                           ncap=ncap)


def syslen_spans(region: torch.Tensor, rlen: int, ncap: int = 256):
    if region.is_cuda:
        from .kernels import frame_syslen_spans_cuda

        out = frame_syslen_spans_cuda(region, rlen, ncap=ncap)
        meta = out["meta"]
        return {"starts": out["starts"], "lens": out["lens"], "n": meta[0],
                "consumed": meta[1], "err": meta[2] != 0,
                "decline": meta[3] != 0}
    return frame_syslen_spans(region, rlen, ncap=ncap)


def gather(region: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
           max_len: int = 512):
    if region.is_cuda:
        from .kernels import frame_gather_cuda

        return frame_gather_cuda(region, starts, lens, max_len=max_len)
    return frame_gather(region, starts, lens, max_len=max_len)


# ---------------------------------------------------------------------------
# host wrapper: region bytes -> packed tuple
# ---------------------------------------------------------------------------

class Packed(tuple):
    """A packed tuple from device framing on a CUDA device: its host span
    arrays (``starts``, ``orig_lens``) are pinned buffers that a copy on
    the lane's stream is still filling; ``ready`` is the event recorded
    after that copy (see :func:`host_ready`)."""

    ready = None

    def __new__(cls, items, ready):
        t = super().__new__(cls, items)
        t.ready = ready
        return t


def host_ready(packed) -> None:
    """Block until a packed tuple's host span arrays have landed (a no-op
    for a tuple framed on the host or on the CPU)."""
    ev = getattr(packed, "ready", None)
    if ev is not None:
        ev.synchronize()


def device_frame_region(region: bytes, framing: str, max_len: int,
                        n_records: int, device: torch.device,
                        staging=None):
    """Frame one raw region on ``device`` and return
    ``(packed, consumed, err)`` with the packed contract ``(batch,
    clipped_lens, chunk, starts, orig_lens, n_real)`` — batch and
    clipped_lens stay on the device, ready for the decode.

    ``framing`` is ``line`` / ``nul`` / ``syslen``.  For line/NUL the
    caller passes a region ending at its last separator and the exact
    separator count ``n_records`` (``err`` is then always False); for
    syslen ``n_records`` is the region's space count, an upper bound on
    its frames (each frame's own delimiter is one), and the kernel finds
    ``consumed`` and ``err`` itself.  Raises :class:`FramingDeclined` on
    a span overflow or an over-long syslen prefix.

    On a CUDA device the region goes up from pinned memory without
    blocking, on the current stream: through ``staging`` (a lane's
    :class:`~.overlap.PinnedStaging`, which never rewrites a buffer whose
    copy has not completed) or a pinned buffer of its own.  Only what the
    host needs to cut the batch — ``n``, ``consumed``, ``err`` and the
    decline flag — is copied back synchronously; ``starts`` and
    ``orig_lens`` come back without blocking into pinned memory.  With a
    ``staging`` the packed tuple is a :class:`Packed` whose ``ready``
    event the consumer waits on (:func:`host_ready`) before it reads
    them; without one this call waits for them itself."""
    nbytes = len(region)
    size = region_bucket(nbytes)
    cuda = torch.device(device).type == "cuda"
    wait = staging is None
    if cuda:
        if staging is None:
            from .overlap import PinnedStaging

            staging = PinnedStaging(torch.device(device))
        region_dev = staging.upload(region, size)
    else:
        region_dev = torch.zeros(size, dtype=torch.uint8)
        if nbytes:
            region_dev[:nbytes] = torch.frombuffer(bytearray(region),
                                                   dtype=torch.uint8)
    ncap = _pack.bucket_rows(max(n_records, 1))
    if framing == "syslen":
        spans = syslen_spans(region_dev, nbytes, ncap=ncap)
        flags = (spans["err"], spans["decline"])
    else:
        sep, strip_cr = _FRAMING[framing]
        spans = sep_spans(region_dev, nbytes, sep=sep, strip_cr=strip_cr,
                          ncap=ncap)
        flags = (torch.zeros_like(spans["overflow"]), spans["overflow"])
    # the one blocking device-to-host copy of this stage: what cuts the
    # batch
    n, consumed, err, declined = (int(v) for v in torch.stack(
        [spans["n"], spans["consumed"], flags[0].to(torch.int32),
         flags[1].to(torch.int32)]).cpu())
    if declined:
        with _declines_lock:
            DECLINES[framing] += 1
        raise FramingDeclined("span overflow or oversized prefix")  # flowcheck: disable=FC08 -- the port journals no events; the caller re-frames the same bytes on the host
    # slots past n are zero, so the first bucket_rows(n) span slots are
    # the batch's rows (ncap is only an upper bound for syslen)
    rows = _pack.bucket_rows(max(n, 1))
    starts_dev, lens_dev = spans["starts"][:rows], spans["lens"][:rows]
    batch_dev, lens_c_dev = gather(region_dev, starts_dev, lens_dev, max_len)
    if not cuda:
        return ((batch_dev, lens_c_dev, region, starts_dev.numpy(),
                 lens_dev[:n].numpy(), n), consumed, bool(err))
    starts_h = torch.empty(rows, dtype=torch.int32, pin_memory=True)
    lens_h = torch.empty(n, dtype=torch.int32, pin_memory=True)
    starts_h.copy_(starts_dev, non_blocking=True)
    lens_h.copy_(lens_dev[:n], non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    packed = (batch_dev, lens_c_dev, region, starts_h.numpy(),
              lens_h.numpy(), n)
    if wait:
        ready.synchronize()
        return packed, consumed, bool(err)
    return Packed(packed, ready), consumed, bool(err)
