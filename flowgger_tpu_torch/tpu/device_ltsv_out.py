"""Device RFC5424→LTSV encode (kernel OL): the split tier between the
rfc5424 decode and the host block encoder for LTSV output
(ltsv_encoder.rs:18-74 semantics, ``encode_ltsv_block``'s ``_ltsv_core``
segment plan byte for byte).

No escape stage and no pair sort: the tier takes rows whose emitted
spans need no LTSV value escaping (no tab or newline anywhere in the
row, no ``:`` inside an SD name, no JSON-escaped SD value), so every
segment re-emits verbatim from the raw row, pairs first (``name:value\\t``
a slot), then the ``ltsv_extra`` blob, host, message, full_message,
level, facility, appname, procid and msgid, as the host tier writes them.

Elision drops three constants from the device rows — ``\\ttime:<stamp>``
(the stamp is rendered on the host anyway, Rust ``Display`` form),
``\\tfull_message:`` and the framing suffix — and the probe reports two
offsets a row, ``gap0`` / ``gap1``, where the host splice puts the first
two back (the suffix goes at the row's end).

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the JAX package's
  ``device_ltsv_out._encode_kernel`` (:133, ``elide=True``): the tier
  mask before its width test, the elided length, the gaps, and the
  tier rows' bytes.  The CPU takes it, and the tests hold it against the
  JAX function.
- the hand-written CUDA kernel ``csrc/encode_ltsv_out.cu``
  (``kernels.encode_ltsv_out_cuda``), which reads K1's packed ``[C, N]``
  channels at 6 pairs in place; :class:`_Rows` launches it for a CUDA
  batch.

The fetch driver (``device_common.fetch_encode_driver``) keeps the
reference's rule: the tier takes a batch when at most 5 % of its rows
fall outside it, three declines in a row cool it down for 16 batches;
there is no 16-pair escalation.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.ltsv:LTSVEncoder"
DIFF_TEST = ("tests/test_torch_device_ltsv_out.py::"
             "test_handler_matches_reference_batch_for_batch")

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .device_common import (
    TS_W,
    _out_width,
    assemble_rows,
    build_bank,
    encode_route_ok,
    fetch_encode_driver,
    splice_rows,
)

_PARTS = {
    "col": b":",
    "tab": b"\t",
    "host": b"host:",
    "time": b"\ttime:",
    "msgl": b"\tmessage:",
    "full": b"\tfull_message:",
    "lvl": b"\tlevel:",
    "fac": b"\tfacility:",
    "app": b"\tappname:",
    "proc": b"\tprocid:",
    "msgid": b"\tmsgid:",
    "dec": b"0123456789 ",
    "extra": b"",  # the config's ltsv_extra blob (_bank)
    "tail": b"",
}
# the constants the kernel reads, in the order of its consts table
# (csrc/encode_ltsv_out_row.cuh, enum ConstO)
KERNEL_CONSTS = ("col", "tab", "extra", "host", "msgl", "lvl", "fac", "app",
                 "proc", "msgid", "dec")

# the ladder constants of the → GELF split tier
FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, {name: offset}, {name: constant}); the ``ltsv_extra``
    pairs render to the host tier's own blob (``ltsv_extra_blob``), so the
    two tiers can never disagree on its bytes."""
    from .block_common import ltsv_extra_blob

    parts = dict(_PARTS)
    parts["extra"] = ltsv_extra_blob(list(extras))
    bank, offs = build_bank(parts, suffix)
    return bank, offs, parts


def out_width(L: int, suffix: bytes, extras=()) -> int:
    """OW of a batch of width L: the longest elided row of the tier."""
    bank, _, _ = _bank(suffix, tuple(extras))
    return _out_width(L, L + len(bank) + TS_W)


def _render_display(val: float) -> bytes:
    """Stamp text: Rust ``Display`` (the host tier's display_f64)."""
    from ..utils.rustfmt import display_f64

    return display_f64(val).encode("ascii")


def make_elide(suffix: bytes):
    """The host splice of a taken batch: ``\\ttime:<stamp>`` at gap0,
    ``\\tfull_message:`` at gap1 and the framing suffix at the row end,
    from the probe's gap channels (the reference's ``make_elide``)."""
    TIME = b"\ttime:"
    FULL = b"\tfull_message:"

    def splice(body, row_off, small, ts_text, ts_len, ridx):
        R = ridx.size
        W = ts_text.shape[1]
        stride = len(TIME) + W
        buf = np.zeros((R, stride), dtype=np.uint8)
        buf[:, :len(TIME)] = np.frombuffer(TIME, dtype=np.uint8)
        buf[:, len(TIME):] = np.asarray(ts_text, np.uint8)[ridx]
        ins_src = np.concatenate(
            [buf.ravel(), np.frombuffer(FULL + suffix, dtype=np.uint8)])
        gap0 = small["gap0"][ridx].astype(np.int64)
        gap1 = small["gap1"][ridx].astype(np.int64)
        lens = np.diff(row_off).astype(np.int64)
        ins_at = np.stack([gap0, gap1, lens], axis=1)
        ins_a = np.stack([
            np.arange(R, dtype=np.int64) * stride,
            np.full(R, R * stride, dtype=np.int64),
            np.full(R, R * stride + len(FULL), dtype=np.int64),
        ], axis=1)
        ins_l = np.stack([
            len(TIME) + np.asarray(ts_len, dtype=np.int64)[ridx],
            np.full(R, len(FULL), dtype=np.int64),
            np.full(R, len(suffix), dtype=np.int64),
        ], axis=1)
        return splice_rows(body, row_off, ins_src, ins_at, ins_a, ins_l)

    return splice


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], *, suffix: bytes, extras=(),
                assemble: bool = True, n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over an rfc5424 decode channel dict.

    Without ``assemble`` it is the probe: ``(base bool [N], base_len
    int32 [N], gaps int32 [2, N])``, the tier rule before its width test,
    the row's elided length and its ``gap0`` / ``gap1`` offsets, all 0 for
    rows outside the rule and for rows at or past ``n`` (default: none).
    A row is in the reference's tier when ``base`` holds and ``base_len
    <= out_width``.

    With ``assemble``: ``(rows [N, OW] u8, out_len int32, tier)``, where
    a tier row holds its elided LTSV bytes in ``rows[:out_len]``."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    bank, off, parts = _bank(suffix, tuple(extras))
    OW = _out_width(L, L + len(bank) + TS_W)
    zero = torch.zeros((N,), dtype=i64, device=dev)
    cbase = L
    segs = []

    def ch(k):
        return dec[k].to(i64)

    def add_const(name, gate=None):
        ln = zero + len(parts[name])
        if gate is not None:
            ln = torch.where(gate, ln, 0)
        segs.append((zero + (cbase + off[name]), ln))

    def add_span(s, e, gate=None):
        ln = torch.clamp(e - s, min=0)
        if gate is not None:
            ln = torch.where(gate, ln, 0)
        segs.append((s, ln))

    fac, sev = ch("facility"), ch("severity")
    host_s, host_e = ch("host_start"), ch("host_end")
    msg_s, trim_e = ch("msg_trim_start"), ch("trim_end")
    msg_l = torch.clamp(trim_e - msg_s, min=0)
    has_msg = msg_l > 0
    pc = ch("pair_count")
    P = dec["name_start"].shape[1]

    # pairs first: name ':' value '\t' a slot
    pairs_total = zero
    for j in range(P):
        pv = j < pc
        ns, ne = dec["name_start"][:, j].to(i64), dec["name_end"][:, j].to(i64)
        vs, ve = dec["val_start"][:, j].to(i64), dec["val_end"][:, j].to(i64)
        add_span(ns, ne, pv)
        add_const("col", pv)
        add_span(vs, ve, pv)
        add_const("tab", pv)
        pairs_total = pairs_total + torch.where(
            pv, torch.clamp(ne - ns, min=0) + torch.clamp(ve - vs, min=0)
            + 2, 0)
    add_const("extra")
    add_const("host")
    add_span(host_s, host_e)
    # "\ttime:<stamp>" elided (spliced back at gap0)
    add_const("msgl", has_msg)
    add_span(msg_s, trim_e)
    # "\tfull_message:" elided (spliced back at gap1)
    add_span(ch("full_start"), trim_e)
    add_const("lvl")
    segs.append((cbase + off["dec"] + sev, zero + 1))
    add_const("fac")
    segs.append((cbase + off["dec"] + torch.remainder(fac // 10, 10),
                 (fac >= 10).to(i64)))
    segs.append((cbase + off["dec"] + torch.remainder(fac, 10), zero + 1))
    add_const("app")
    add_span(ch("app_start"), ch("app_end"))
    add_const("proc")
    add_span(ch("proc_start"), ch("proc_end"))
    add_const("msgid")
    add_span(ch("msgid_start"), ch("msgid_end"))
    # the suffix elided (spliced back at the row's end)
    out_len = segs[0][1]
    for _, ln in segs[1:]:
        out_len = out_len + ln

    # the screens of the host tier: no tab / newline in the row (LTSV
    # value escape), no ':' in an SD name (key escape), no JSON-escaped SD
    # value
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens.to(i64)[:, None]
    bb = batch.to(i64)
    row_esc = (((bb == 9) | (bb == 10)) & valid).any(dim=1)
    colon_in_names = torch.zeros((N,), dtype=torch.bool, device=dev)
    val_esc_any = torch.zeros((N,), dtype=torch.bool, device=dev)
    is_colon = bb == ord(":")
    for j in range(P):
        pv = j < pc
        ns, ne = dec["name_start"][:, j].to(i64), dec["name_end"][:, j].to(i64)
        colon_in_names |= ((is_colon & (iota >= ns[:, None])
                            & (iota < ne[:, None])).any(dim=1) & pv)
        val_esc_any |= dec["val_has_esc"][:, j].to(torch.bool) & pv
    base = (dec["ok"].to(torch.bool) & ~dec["has_high"].to(torch.bool)
            & ~row_esc & ~colon_in_names & ~val_esc_any)
    if not assemble:
        if n is not None:
            base &= torch.arange(N, device=dev) < n
        gap0 = (pairs_total + len(parts["extra"]) + len(parts["host"])
                + torch.clamp(host_e - host_s, min=0))
        gap1 = gap0 + torch.where(has_msg, len(parts["msgl"]), 0) + msg_l
        gaps = torch.stack([gap0, gap1])
        return (base, torch.where(base, out_len, 0).to(torch.int32),
                torch.where(base, gaps, 0).to(torch.int32))
    rows, _ = assemble_rows(segs, batch, bank,
                            torch.zeros((N, 0), dtype=torch.uint8,
                                        device=dev), OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, the kernel's consts table: offsets then lengths of
    :data:`KERNEL_CONSTS` in the bank, int32), built once per (suffix,
    extras)."""
    bank, offs, parts = _bank(suffix, tuple(extras))
    table = [offs[k] for k in KERNEL_CONSTS] + \
        [len(parts[k]) for k in KERNEL_CONSTS]
    return bank, (ctypes.c_int * len(table))(*table)


def gaps_small(gaps: torch.Tensor, n: int, OW: int):
    """``gap0`` / ``gap1`` of the first ``n`` rows on the host (u16 when
    ``OW`` fits, as the reference fetches them) and their bytes."""
    g = gaps[:, :n].to(torch.uint16 if OW <= 0xFFFF else torch.int32)
    h = g.cpu().numpy()
    return {"gap0": h[0], "gap1": h[1]}, h.nbytes


class _Rows:
    """One decoded rfc5424 batch as the fetch driver sees it: ``probe``
    and ``assemble`` launch OL for a CUDA batch (``out`` is K1's packed
    ``[C, N]`` channels at 6 pairs) and run the plain version for a CPU
    batch (``out`` is the plain decode's channel dict).  The timestamp
    text is not in the device rows (``ts_in_row``): the host splice puts
    it back."""

    ts_in_row = False

    def __init__(self, batch, lens, out, suffix, extras):
        self.batch, self.lens, self.out = batch, lens, out
        self.N = batch.shape[0]
        self.device = batch.device
        self.kw = {"suffix": suffix, "extras": extras}
        self.OW = out_width(batch.shape[1], suffix, extras)
        self.gaps = None
        if batch.is_cuda:
            from .device_gelf import _bank_on

            bank, self.table = kernel_consts(suffix, extras)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        """``(base bool [N], base_len int32 [N])`` of the first ``n``
        rows (:func:`encode_rows` without ``assemble``); keeps the
        gaps."""
        if self.batch.is_cuda:
            from .kernels import encode_ltsv_out_cuda

            base, base_len, self.gaps = encode_ltsv_out_cuda(
                self.batch, self.lens, self.out, n, self.bank, self.table)
            return base, base_len
        base, base_len, self.gaps = encode_rows(
            self.batch, self.lens, self.out, assemble=False, n=n, **self.kw)
        return base, base_len

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        """The elided bytes of the rows with ``row_off >= 0`` (all below
        ``n``), each at its offset, in one ``total``-byte u8 buffer."""
        if self.batch.is_cuda:
            from .kernels import encode_ltsv_out_cuda

            return encode_ltsv_out_cuda(self.batch, self.lens, self.out, n,
                                        self.bank, self.table, self.OW,
                                        row_off=row_off, total=total)
        from .device_gelf import flat_rows

        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       **self.kw)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok``, the four timestamp channels and the two gaps of the
        first ``n`` rows on the host (the reference's ``_small_fetch``),
        and the bytes that crossed."""
        if isinstance(self.out, torch.Tensor):
            # rows 0 and 4-7 of the packed [C, N] channels
            ok = (self.out[0, :n] != 0).cpu().numpy()
            ts = self.out[4:8, :n].cpu().numpy()
            small = {"ok": ok, "days": ts[0], "sod": ts[1], "off": ts[2],
                     "nanos": ts[3]}
        else:
            small = {k: self.out[k][:n].cpu().numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")}
        nbytes = sum(v.nbytes for v in small.values())
        gaps, gbytes = gaps_small(self.gaps, n, self.OW)
        small.update(gaps)
        return small, nbytes + gbytes


# the fused route FO/ltsv's leg (fused_routes._FusedRows)
ts_render = _render_display


def fused_cuda(fmt, batch, lens, n, bank, consts, year=None, **asm):
    """FO/ltsv's probe, or with the assemble's keywords its assemble
    (``kernels.fused_ltsv_out_cuda``)."""
    from .kernels import fused_ltsv_out_cuda

    return fused_ltsv_out_cuda(batch, lens, n, bank, consts, **asm)


def fused_elide(suffix: bytes, fmt: str):
    return make_elide(suffix)


def fused_small(extra, n: int, OW: int):
    """gap0 / gap1 of the first ``n`` rows on the host, and their bytes."""
    return gaps_small(extra[0], n, OW)


def route_ok(encoder, merger) -> bool:
    """LTSV output over line, NUL or syslen framing (or none); the
    ``ltsv_extra`` pairs always render to one static blob."""
    from ..encoders.ltsv import LTSVEncoder

    return encode_route_ok(encoder, merger, LTSVEncoder)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """The device encode of a submitted rfc5424 decode into LTSV:
    (BlockResult | None, fetch_seconds); None = the caller runs the host
    tier."""
    from .block_common import merger_suffix
    from .materialize import _scalar_line

    out, batch_dev, lens_dev, _max_sd = handle
    suffix, syslen = merger_suffix(merger)
    extras = tuple((str(k), str(v)) for k, v in encoder.extra)
    kern = _Rows(batch_dev, lens_dev, out, suffix, extras)
    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=_scalar_line, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN,
        elide=make_elide(suffix), timings=timings,
        ts_render=_render_display)
