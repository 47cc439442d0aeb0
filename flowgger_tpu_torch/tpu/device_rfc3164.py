"""Device RFC3164→GELF encode: the split device tier of the legacy-syslog
fast path, between the rfc3164 decode and the host block encoder.

A trimmed copy of the JAX package's ``tpu/device_rfc3164.py`` on the
port's driver (``device_common.fetch_encode_driver``): the same tier
rule, decline and hysteresis constants, and the same contract as
``device_gelf``.  The rfc3164 fast-path record carries no SD, no
appname/procid/msgid, an unstripped message, and the whole line as
full_message, so the sorted-key GELF object is eleven segments a row::

    {"full_message":F,"host":H,["level":N,]"short_message":M,
     "timestamp":T,"version":"1.1"}

with the level pair gated per row on has_pri — exactly the layout of
the host tier (``encode_rfc3164_gelf_block``), whose byte constants this
tier shares so spliced rows can never diverge.  The encode leaves out
the head, timestamp-label and tail constants (the reference's
``elide=True``); the host splice restores them.

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the reference's
  ``_encode_kernel(..., elide=True)``, with the width test and the
  text's length moved to the host as in ``device_gelf.encode_rows``;
- the hand-written CUDA kernel E3, the ``fg_encode_gelf3164_*`` entry
  points of ``csrc/encode_gelf.cu`` (through ``tpu/kernels.py``), which
  read the rfc3164 decode kernel's packed ``[C, N]`` channels in place.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_rfc3164.py::"
             "test_device_encode_matches_reference")

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .device_common import (
    E_CAP,
    TS_W,
    _out_width,
    assemble_rows,
    build_bank,
    escape_stage,
    fetch_encode_driver,
    gelf_route_ok,
)
# constant bank: the host tier's own constants, never retyped
from .encode_rfc3164_gelf_block import (
    _C_HOST, _C_LEVEL, _C_OPEN, _C_SEVD, _C_SHORT_NOPRI, _C_SHORT_PRI,
    _C_TAIL, _C_TS, gelf_extra_consts_3164,
)

FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16

_PARTS = {
    "open": _C_OPEN,
    "host": _C_HOST,
    "level": _C_LEVEL,
    "short_p": _C_SHORT_PRI,
    "short_n": _C_SHORT_NOPRI,
    "ts": _C_TS,
    "tail": _C_TAIL,
    "sevd": _C_SEVD,
}
# the constants the kernel reads, in the order of its consts table
# (csrc/encode_gelf.cu, enum Const3164)
KERNEL_CONSTS = ("host", "hl", "level", "sevd", "l2a", "l2b", "short_p",
                 "short_n")


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """Constant bank; extras fold in via the host tier's
    gelf_extra_consts_3164 so the two tiers can never diverge."""
    parts = dict(_PARTS)
    parts["hl"] = b""
    parts["l2a"] = b""
    parts["l2b"] = b""
    if extras:
        econsts = gelf_extra_consts_3164(list(extras))
        assert econsts is not None  # route_ok pre-checked
        (parts["open"], parts["host"], parts["hl"], parts["l2a"],
         parts["l2b"], parts["short_p"], parts["short_n"], parts["ts"],
         parts["tail"]) = econsts
    bank, offs = build_bank(parts, suffix)
    return bank, offs, parts


def elide_spec(suffix: bytes, extras=()):
    """(head, ts-label, tail + suffix): the constants the encode skips
    and the host splice restores — shared with the fused route."""
    _, _, parts = _bank(suffix, tuple(extras))
    return (parts["open"], parts["ts"], parts["tail"] + suffix)


def out_width(L: int, suffix: bytes, extras=()) -> int:
    """OW of a batch of width L: the longest output row of the tier."""
    bank, _, _ = _bank(suffix, tuple(extras))
    return _out_width(L, L + E_CAP + len(bank) + TS_W)


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], ts_text=None, ts_len=None,
                *, suffix: bytes, extras=(), assemble: bool = True,
                n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over an rfc3164 decode channel dict; the contract of
    ``device_gelf.encode_rows``: without ``assemble`` the probe
    ``(base bool [N], base_len int32 [N])``, with it ``(rows [N, OW] u8,
    out_len, tier)`` at the given timestamp text."""
    N, L = batch.shape
    i64 = torch.int64
    bank, off, parts = _bank(suffix, tuple(extras))
    OW = _out_width(L, L + E_CAP + len(bank) + TS_W)
    es = escape_stage(batch, lens, assemble)
    dmap = es["dmap"]

    host_s = dmap(dec["host_start"])
    host_e = dmap(dec["host_end"])
    msg_s = dmap(dec["msg_start"])
    row_e = lens.to(i64) + es["ne_total"]
    has_pri = dec["has_pri"].to(torch.bool)

    cbase = L + E_CAP
    tbase = cbase + len(bank)
    zero = torch.zeros((N,), dtype=i64, device=batch.device)

    def const(name):
        return (zero + (cbase + off[name]), zero + len(parts[name]))

    def pick(a, b):
        return (torch.where(has_pri, cbase + off[a], cbase + off[b]),
                torch.where(has_pri, len(parts[a]), len(parts[b])))

    segs = [
        (zero, row_e),                                   # full_message
        const("host"),
        (host_s, torch.clamp(host_e - host_s, min=0)),
        const("hl"),
        (zero + (cbase + off["level"]),
         torch.where(has_pri, len(parts["level"]), 0)),
        (cbase + off["sevd"] + dec["severity"].to(i64),
         torch.where(has_pri, 1, 0)),
        # extras between level and short: after-number variant when PRI
        # present, string-close variant otherwise
        pick("l2a", "l2b"),
        pick("short_p", "short_n"),
        (msg_s, torch.clamp(row_e - msg_s, min=0)),      # short_message
    ]
    base_len = segs[0][1]
    for _, ln in segs[1:]:
        base_len = base_len + ln
    base = (dec["ok"].to(torch.bool)
            & ~dec["has_high"].to(torch.bool)
            & ~es["bad_ctl"].any(dim=1)
            & (es["ne_total"] <= E_CAP))
    if not assemble:
        if n is not None:
            base &= torch.arange(N, device=batch.device) < n
        return base, torch.where(base, base_len, 0).to(torch.int32)
    segs.append((zero + tbase, ts_len.to(i64)))
    out_len = base_len + ts_len.to(i64)
    rows, _ = assemble_rows(segs, es["esc_row"], bank, ts_text, OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, the kernel's consts table: offsets then lengths of
    :data:`KERNEL_CONSTS` in the bank, int32)."""
    bank, offs, parts = _bank(suffix, tuple(extras))
    table = [offs[k] for k in KERNEL_CONSTS] + \
        [len(parts[k]) for k in KERNEL_CONSTS]
    return bank, (ctypes.c_int * len(table))(*table)


class _Rows:
    """One decoded rfc3164 batch as the fetch driver sees it (the
    contract of ``device_gelf._Rows``): ``out`` is the decode kernel's
    packed ``[C, N]`` channels for a CUDA batch, the plain decode's
    channel dict for a CPU batch."""

    def __init__(self, batch, lens, out, suffix, extras):
        from .device_gelf import _bank_on

        self.batch, self.lens, self.out = batch, lens, out
        self.N = batch.shape[0]
        self.device = batch.device
        self.kw = {"suffix": suffix, "extras": extras}
        self.OW = out_width(batch.shape[1], suffix, extras)
        if batch.is_cuda:
            bank, self.table = kernel_consts(suffix, extras)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf3164_cuda

            return encode_gelf3164_cuda(self.batch, self.lens, self.out, n,
                                        self.bank, self.table)
        return encode_rows(self.batch, self.lens, self.out, assemble=False,
                           n=n, **self.kw)

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf3164_cuda

            return encode_gelf3164_cuda(self.batch, self.lens, self.out, n,
                                        self.bank, self.table, self.OW,
                                        ts_text=ts_text, ts_len=ts_len,
                                        row_off=row_off, total=total)
        from .device_gelf import flat_rows

        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       ts_text, ts_len, **self.kw)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok`` and the four timestamp channels of the first ``n`` rows
        on the host, and the bytes that crossed."""
        if isinstance(self.out, torch.Tensor):
            from .rfc3164 import KEYS

            rows = [KEYS.index(k) for k in ("ok", "days", "sod", "off",
                                            "nanos")]
            h = self.out[rows, :n].cpu().numpy()
            small = {"ok": h[0] != 0, "days": h[1], "sod": h[2],
                     "off": h[3], "nanos": h[4]}
        else:
            small = {k: self.out[k][:n].cpu().numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")}
        return small, sum(v.nbytes for v in small.values())


def route_ok(encoder, merger) -> bool:
    """GELF output over line/nul/syslen framing; gelf_extra rides as
    constant segments when this layout can place the keys statically
    (gelf_extra_consts_3164 — the rfc3164 fixed-key set differs from the
    rfc5424 one, so placeability differs too)."""
    return gelf_route_ok(
        encoder, merger,
        lambda e: gelf_extra_consts_3164(e) is not None)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """Device rfc3164→GELF encode for a submitted rfc3164 decode handle
    ``(out, batch, lens)``: (BlockResult | None, fetch_seconds); None =
    the caller runs the host tier."""
    from .block_common import merger_suffix
    from .materialize_rfc3164 import _scalar_3164

    out, batch_dev, lens_dev = handle
    suffix, syslen = merger_suffix(merger)
    extras = tuple((k, v) for k, v in encoder.extra)
    kern = _Rows(batch_dev, lens_dev, out, suffix, extras)
    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=_scalar_3164, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN,
        elide=elide_spec(suffix, extras), timings=timings)
