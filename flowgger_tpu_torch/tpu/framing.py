"""Device framing: line/NUL record spans over a raw region and the dense
row gather, ahead of the RFC5424 decode.

The splitter hands raw transport chunks to the batch handler; at flush
the handler cuts each session's region at its last separator and calls
:func:`device_frame_region`, which uploads the region once, finds every
record boundary on the card (``frame_sep_spans``) and builds the
``[rows, max_len]`` decode batch there (``frame_gather``) — the host
never splits or copies a record.  Only the span metadata comes back.

Host contract: the same records, in the same order, as the host
splitters (``pack.pack_region_2d``), including the one trailing CR the
line framing strips.  A span overflow (more records than the caller's
separator count sized the span arrays for) is a data condition, not a
kernel failure: it raises :class:`FramingDeclined` and the caller
re-frames that region on the host, exactly as the JAX package does.

Each stage has a plain PyTorch version (:func:`frame_sep_spans`,
:func:`frame_gather`) beside the kernel; :func:`sep_spans` and
:func:`gather` launch the kernel for a CUDA tensor and take the plain
version only for a tensor that lies on the CPU.
"""

from __future__ import annotations

import torch

from . import pack as _pack

# byte-identity contract (flowcheck FC03): the host splitter the device
# framing must match record for record, and the test that holds it
SCALAR_ORACLE = "flowgger_tpu_torch.tpu.pack:pack_region_2d"
DIFF_TEST = ("tests/test_torch_framing.py::"
             "test_device_frame_region_matches_host_pack")

# region byte floor; regions pad to the next power of two above it
MIN_REGION_BYTES = 1 << 14

# (separator byte, strip one trailing CR) per framing — the statics the
# JAX package's framing_statics passes its span kernels
_FRAMING = {"line": (10, True), "nul": (0, False)}


class FramingDeclined(Exception):
    """The span kernel declined this region (span overflow); the caller
    must re-frame it on the host — same bytes, no records lost."""


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


def gather(region: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
           max_len: int = 512):
    if region.is_cuda:
        from .kernels import frame_gather_cuda

        return frame_gather_cuda(region, starts, lens, max_len=max_len)
    return frame_gather(region, starts, lens, max_len=max_len)


# ---------------------------------------------------------------------------
# host wrapper: region bytes -> packed tuple
# ---------------------------------------------------------------------------

def device_frame_region(region: bytes, framing: str, max_len: int,
                        n_records: int, device: torch.device):
    """Frame one raw region (ending at its last separator) on ``device``
    and return ``(packed, consumed)`` with the packed contract
    ``(batch, clipped_lens, chunk, starts, orig_lens, n_real)`` — batch
    and clipped_lens stay on the device, ready for the decode.

    ``n_records`` is the caller's exact separator count; it sizes the
    span arrays.  Raises :class:`FramingDeclined` on a span overflow."""
    sep, strip_cr = _FRAMING[framing]
    nbytes = len(region)
    buf = torch.zeros(region_bucket(nbytes), dtype=torch.uint8)
    if nbytes:
        buf[:nbytes] = torch.frombuffer(bytearray(region), dtype=torch.uint8)
    region_dev = buf.to(device)
    ncap = _pack.bucket_rows(max(n_records, 1))
    spans = sep_spans(region_dev, nbytes, sep=sep, strip_cr=strip_cr,
                      ncap=ncap)
    # the span metadata is the only device-to-host copy of this stage
    n, consumed, overflow = (int(v) for v in torch.stack(
        [spans["n"], spans["consumed"], spans["overflow"].to(torch.int32)]
    ).cpu())
    if overflow:
        raise FramingDeclined("span overflow")  # flowcheck: disable=FC08 -- the port journals no events in this slice; the caller re-frames the same bytes on the host
    # slots past n are zero, so the ncap span arrays are the batch's rows
    # (ncap == bucket_rows(n) for the exact count the caller passes)
    starts_np = spans["starts"].cpu().numpy()
    lens_np = spans["lens"][:n].cpu().numpy()
    batch_dev, lens_c_dev = gather(region_dev, spans["starts"], spans["lens"],
                                   max_len)
    return (batch_dev, lens_c_dev, region, starts_np, lens_np, n), consumed
