"""Device LTSV→GELF encode: the split device tier of the LTSV input,
between the ltsv decode and the host block encoder.

A trimmed copy of the JAX package's ``tpu/device_ltsv.py`` on the port's
driver (``device_common.fetch_encode_driver``): the same tier rule,
decline and hysteresis constants, the 16-pair escalation when a batch
declines at 6 pairs, and the same contract as ``device_gelf``.  The
layout mirrors the host tier (``encode_ltsv_gelf_block``) byte for
byte::

    {"_<key>":"V"..., "full_message":L, "host":H|unknown, ["level":N,]
     "short_message":"M"|"-", "timestamp":T, "version":"1.1"}

Pair selection rides the decode's part and special channels over the
part axis: a part is a pair iff its start is none of the
(last-occurrence) special positions, and rows with a REPEATED special
name leave the tier (counted at part starts), so last occurrence equals
name match on every tier row, as in the host tier.  The tier also needs
an RFC3339 stamp or an unsigned unix float of at most 16 digits within
2**53 (the decode's exact split-integer parse; the host combines it in
float64, ``ts_vals_ltsv``), at most ``max_pairs`` pairs whose 8-byte
name keys order them, no colon-less part, ASCII rows within the escape
budget, and no typed ``ltsv_schema`` (gated at the route).  The encode
leaves out the head, timestamp-label and tail constants (the
reference's ``elide=True``); the host splice restores them.

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the reference's
  ``_encode_kernel(..., elide=True)``, with the width test and the
  text's length moved to the host as in ``device_gelf.encode_rows``;
- the hand-written CUDA kernel EL, the ``fg_encode_gelf_ltsv_*`` entry
  points of ``csrc/encode_gelf.cu`` (through ``tpu/kernels.py``) at 6 and
  16 pairs, which read the ltsv decode kernel's packed ``[C, N]``
  channels in place.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_device_ltsv.py::"
             "test_plain_encode_matches_reference")

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
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
    sort_pairs_by_key8,
)
# constant bank: the host tier's own constants, never retyped
from .encode_ltsv_gelf_block import (
    _C_DASH, _C_FULL, _C_HOST, _C_LEVEL, _C_P0, _C_P1, _C_P2, _C_SEVD,
    _C_SHORT, _C_SHORT_LVL, _C_TAIL, _C_TS, _C_UNKNOWN,
    gelf_extra_consts_ltsv,
)

FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16
MAX_DEV_PAIRS = 6
# escalation width when the 6-pair tier declines a batch (the decode
# always holds 24 parts, so the wide probe decodes nothing again)
WIDE_DEV_PAIRS = 16

_PARTS = {
    "open": b"{",
    "p0": _C_P0,
    "p1": _C_P1,
    "p2": _C_P2,
    "full": _C_FULL,
    "host": _C_HOST,
    "level": _C_LEVEL,
    "short_l": _C_SHORT_LVL,
    "short": _C_SHORT,
    "ts": _C_TS,
    "tail": _C_TAIL,
    "unknown": _C_UNKNOWN,
    "dash": _C_DASH,
    "sevd": _C_SEVD,
}
# the constants the kernel reads, in the order of its consts table
# (csrc/encode_ltsv_row.cuh, enum ConstLtsv)
KERNEL_CONSTS = ("p0", "p1", "p2", "full", "host", "hl", "level", "sevd",
                 "l2a", "l2b", "short_l", "short", "dash", "unknown")
_SPECIAL_KEYS = ("time_pos", "host_pos", "msg_pos", "level_pos")


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """Constant bank; extras fold in via the host tier's
    gelf_extra_consts_ltsv so the two tiers can never diverge."""
    parts = dict(_PARTS)
    parts["hl"] = b""
    parts["l2a"] = b""
    parts["l2b"] = b""
    if extras:
        econsts = gelf_extra_consts_ltsv(list(extras))
        assert econsts is not None  # route_ok pre-checked
        (parts["open"], parts["full"], parts["host"], parts["hl"],
         parts["l2a"], parts["l2b"], parts["ts"],
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


def select_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], dmap, max_pairs: int):
    """What the encode reads after pair selection and the sort, in
    escaped coordinates: ``pair_count``, the ``ns`` / ``ne`` / ``vs`` /
    ``ve`` lists of the sorted pairs' spans (``max_pairs`` each; 0 past
    the row's pairs), ``host_s`` / ``host_e`` / ``msg_s`` / ``msg_e``,
    ``has_msg`` and ``level``; and the row gates ``colonless``,
    ``rep_special`` (a special name at more than one part start) and
    ``ambig`` (names the 8-byte key cannot order)."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens.to(i64)[:, None]
    # bytes past a row's length are zero (the batch contract)
    bb = torch.where(valid, batch.to(i64), 0)

    # ---- repeated special names at part starts ----------------------------
    prev_tab = torch.zeros_like(valid)
    prev_tab[:, 1:] = (bb[:, :-1] == 9) & valid[:, :-1]
    pstart = valid & ((iota == 0) | prev_tab)
    rep_special = torch.zeros((N,), dtype=torch.bool, device=dev)
    for word in (b"time:", b"host:", b"message:", b"level:"):
        m = pstart.clone()
        for i, ch in enumerate(word):
            sh = torch.zeros_like(bb)
            sh[:, :L - i] = bb[:, i:]
            m &= sh == ch
        rep_special |= m.sum(dim=1) > 1

    # ---- pair selection over the part axis --------------------------------
    n_parts = dec["n_parts"].to(i64)
    P = dec["part_start"].shape[1]
    ps = dec["part_start"].to(i64)
    in_row = torch.arange(P, device=dev)[None, :] < n_parts[:, None]
    is_spec = torch.zeros_like(in_row)
    for k in _SPECIAL_KEYS:
        sp = dec[k].to(i64)[:, None]
        is_spec |= (sp >= 0) & (ps == sp)
    is_pair = in_row & ~is_spec
    colonless = (in_row & (dec["colon_pos"].to(i64) < 0)).any(dim=1)
    pair_ord = torch.cumsum(is_pair.to(i64), dim=1)
    pair_count = pair_ord[:, -1]

    def sel(key, plus=0):
        ch = dec[key].to(i64) + plus
        return [torch.where(is_pair & (pair_ord == p + 1), ch, 0).sum(dim=1)
                for p in range(max_pairs)]

    ns_r, ne_r = sel("part_start"), sel("colon_pos")
    cols = {"_pair_count": pair_count,
            "ns_raw": list(ns_r), "ne_raw": list(ne_r),
            "ns": [dmap(x) for x in ns_r], "ne": [dmap(x) for x in ne_r],
            "vs": [dmap(x) for x in sel("colon_pos", 1)],
            "ve": [dmap(x) for x in sel("part_end")]}
    ambig = sort_pairs_by_key8(bb, cols, max_pairs)
    return {"pair_count": pair_count,
            **{k: cols[k] for k in ("ns", "ne", "vs", "ve")},
            "host_s": dmap(dec["host_start"]),
            "host_e": dmap(dec["host_end"]),
            "msg_s": dmap(dec["msg_start"]), "msg_e": dmap(dec["msg_end"]),
            "has_msg": dec["msg_pos"].to(i64) >= 0,
            "level": dec["level_val"].to(i64),
            "colonless": colonless, "rep_special": rep_special,
            "ambig": ambig}


def ts_tier(dec: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Rows whose stamp the tier formats: RFC3339, or an unsigned unix
    float of at most 16 digits within 2**53 (the host combine is then
    the correctly rounded strtod value)."""
    kind = dec["ts_kind"].to(torch.int64)
    meta = dec["ts_meta"].to(torch.int64)
    ts_hi = dec["ts_hi"].to(torch.int64)
    ts_lo = dec["ts_lo"].to(torch.int64)
    ndig = (meta >> 8) & 255
    signed = ((meta >> 16) & 1) == 1
    f16_ok = (ts_hi < 9007199) | ((ts_hi == 9007199)
                                  & (ts_lo <= 254740992))
    float_dev = ((kind == 1) & ~signed
                 & ((ndig <= 15) | ((ndig == 16) & f16_ok)))
    return (kind == 0) | float_dev


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], ts_text=None, ts_len=None,
                *, suffix: bytes, extras=(), assemble: bool = True,
                n: Optional[int] = None, max_pairs: int = MAX_DEV_PAIRS):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over an ltsv decode channel dict; the contract of
    ``device_gelf.encode_rows``: without ``assemble`` the probe ``(base
    bool [N], base_len int32 [N])``, with it ``(rows [N, OW] u8,
    out_len, tier)`` at the given timestamp text."""
    N, L = batch.shape
    i64 = torch.int64
    bank, off, parts = _bank(suffix, tuple(extras))
    OW = _out_width(L, L + E_CAP + len(bank) + TS_W)
    es = escape_stage(batch, lens, assemble)
    s = select_rows(batch, lens, dec, es["dmap"], max_pairs)
    row_e = lens.to(i64) + es["ne_total"]
    pc = s["pair_count"]
    has_msg = s["has_msg"]
    level = s["level"]
    has_level = level >= 0

    cbase = L + E_CAP
    tbase = cbase + len(bank)
    zero = torch.zeros((N,), dtype=i64, device=batch.device)

    def const(name, gate=None):
        ln = zero + len(parts[name])
        if gate is not None:
            ln = torch.where(gate, ln, 0)
        return (zero + (cbase + off[name]), ln)

    def pick(gate, a, b):
        return (torch.where(gate, cbase + off[a], cbase + off[b]),
                torch.where(gate, len(parts[a]), len(parts[b])))

    segs = []
    for p in range(max_pairs):
        pv = p < pc
        segs += [const("p0", pv),
                 (s["ns"][p], torch.where(pv, s["ne"][p] - s["ns"][p], 0)),
                 const("p1", pv),
                 (s["vs"][p], torch.where(pv, s["ve"][p] - s["vs"][p], 0)),
                 const("p2", pv)]
    host_s, host_e = s["host_s"], s["host_e"]
    host_empty = host_e <= host_s
    qsrc = cbase + off["p1"] + 2   # a '"' byte inside the '":"' const
    segs += [
        const("full"),
        (zero, row_e),
        const("host"),
        (torch.where(host_empty, cbase + off["unknown"], host_s),
         torch.where(host_empty, len(parts["unknown"]), host_e - host_s)),
        const("hl"),
        const("level", has_level),
        (cbase + off["sevd"] + torch.clamp(level, min=0),
         torch.where(has_level, 1, 0)),
        # extras between level and short: after-number when a level is
        # present, string-close otherwise
        pick(has_level, "l2a", "l2b"),
        pick(has_level, "short_l", "short"),
        (torch.where(has_msg, qsrc, cbase + off["dash"]),
         torch.where(has_msg, 1, len(parts["dash"]))),
        (s["msg_s"], torch.where(has_msg, s["msg_e"] - s["msg_s"], 0)),
        (zero + qsrc, torch.where(has_msg, 1, 0)),
    ]
    base_len = segs[0][1]
    for _, ln in segs[1:]:
        base_len = base_len + ln
    base = (dec["ok"].to(torch.bool)
            & ~dec["has_high"].to(torch.bool)
            & ~es["bad_ctl"].any(dim=1)
            & (es["ne_total"] <= E_CAP)
            & ts_tier(dec)
            & (dec["host_pos"].to(i64) >= 0)
            & ~s["colonless"]
            & ~s["rep_special"]
            & (pc <= max_pairs)
            & ~s["ambig"])
    if not assemble:
        if n is not None:
            base &= torch.arange(N, device=batch.device) < n
        return base, torch.where(base, base_len, 0).to(torch.int32)
    segs.append((zero + tbase, ts_len.to(i64)))
    out_len = base_len + ts_len.to(i64)
    rows, _ = assemble_rows(segs, es["esc_row"], bank, ts_text, OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


# the timestamp channels the tier's stamp text is made from
TS_KEYS = ("days", "sod", "off", "nanos", "ts_kind",
           "ts_hi", "ts_lo", "ts_meta")
# bytes a row of the probes' narrowed stamp channels (small_pack)
SMALL_BYTES = 25


def small_pack(dec: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """The probes' narrowed stamp channels of a decode, as EL's and FL's
    probe kernels write them: one u8 buffer of :data:`SMALL_BYTES` a row,
    int32 days, sod, nanos, ts_hi, ts_lo [5, N], then int16 off / 60 [N]
    (RFC3339 offsets are whole minutes), then uint8 ok, ts_kind and
    ts_meta & 255 [3, N]; zeros at and past ``n``.  The reference's fused
    probe narrows the same channels (``_fused_ltsv_gelf``) so a tier row's
    stamp crosses in fewer bytes than the constants the encode leaves
    out."""
    N = dec["ok"].shape[0]
    live = torch.arange(N, device=dec["ok"].device) < n

    def col(k):
        return torch.where(live, dec[k].to(torch.int32), 0)

    i32 = torch.stack([col(k) for k in ("days", "sod", "nanos", "ts_hi",
                                        "ts_lo")])
    off16 = torch.div(col("off"), 60, rounding_mode="floor").to(torch.int16)
    u8 = torch.stack([col("ok"), col("ts_kind"),
                      col("ts_meta") & 255]).to(torch.uint8)
    return torch.cat([i32.reshape(-1).view(torch.uint8),
                      off16.view(torch.uint8), u8.reshape(-1)])


def small_fetch(small: torch.Tensor, N: int, n: int):
    """The channel dict ``ts_vals_ltsv`` reads, for the first ``n`` of
    ``N`` rows, from a :func:`small_pack` buffer on any device — the dict
    the reference's ``_ltsv_small_fetch`` rebuilds (off = off_min * 60,
    ts_meta = its fraction count): ok and ts_kind always, the calendar
    channels only if an ok row is RFC3339 and the split-integer ones only
    if one is a float span (zeros otherwise).  Returns (dict, bytes that
    crossed)."""
    def fetch(t):
        return t.cpu().numpy()

    i32 = small[:20 * N].view(torch.int32)
    ok = fetch(small[22 * N:22 * N + n]) != 0
    kind = fetch(small[23 * N:23 * N + n]).astype(np.int32)
    nbytes = 2 * n
    out = {"ok": ok, "ts_kind": kind}
    zero = np.zeros(n, dtype=np.int32)
    if (ok & (kind == 0)).any():
        out.update(days=fetch(i32[:n]), sod=fetch(i32[N:N + n]),
                   nanos=fetch(i32[2 * N:2 * N + n]),
                   off=fetch(small[20 * N:22 * N].view(torch.int16)[:n])
                   .astype(np.int32) * 60)
        nbytes += 14 * n
    else:
        out.update(days=zero, sod=zero, nanos=zero, off=zero)
    if (ok & (kind == 1)).any():
        out.update(ts_hi=fetch(i32[3 * N:3 * N + n]),
                   ts_lo=fetch(i32[4 * N:4 * N + n]),
                   ts_meta=fetch(small[24 * N:24 * N + n]).astype(np.int32))
        nbytes += 9 * n
    else:
        out.update(ts_hi=zero, ts_lo=zero, ts_meta=zero)
    return out, nbytes


def ts_vals_ltsv(small, okh):
    """rfc3339 rows combine days/sod/off/nanos; float-span rows combine
    the kernel's exact split-integer parse (vectorized numpy float64,
    never a torch reduction).  Shared by the split and fused ltsv
    tiers."""
    from .materialize import compute_ts

    kind = small["ts_kind"]
    rfc = okh & (kind == 0)
    masked = {k: np.where(rfc, small[k], 0)
              for k in ("days", "sod", "off", "nanos")}
    vals = compute_ts(masked)
    fv = ((small["ts_hi"].astype(np.float64) * 1e9
           + small["ts_lo"].astype(np.float64))
          / np.power(10.0, (small["ts_meta"] & 255).astype(np.int64)))
    return np.where(okh & (kind == 1), fv, vals)


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
    """One decoded ltsv batch as the fetch driver sees it (the contract
    of ``device_gelf._Rows``): ``out`` is the decode kernel's packed
    ``[C, N]`` channels for a CUDA batch, the plain decode's channel dict
    for a CPU batch."""

    def __init__(self, batch, lens, out, suffix, extras,
                 max_pairs: int = MAX_DEV_PAIRS):
        from .device_gelf import _bank_on

        self.batch, self.lens, self.out = batch, lens, out
        self.small = None      # the probe's narrowed stamp channels
        self.N = batch.shape[0]
        self.device = batch.device
        self.max_pairs = max_pairs
        self.kw = {"suffix": suffix, "extras": extras,
                   "max_pairs": max_pairs}
        self.OW = out_width(batch.shape[1], suffix, extras)
        if batch.is_cuda:
            bank, self.table = kernel_consts(suffix, extras)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf_ltsv_cuda

            base, base_len, self.small = encode_gelf_ltsv_cuda(
                self.batch, self.lens, self.out, n, self.bank, self.table,
                self.max_pairs)
            return base, base_len
        self.small = small_pack(self.out, n)
        return encode_rows(self.batch, self.lens, self.out, assemble=False,
                           n=n, **self.kw)

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf_ltsv_cuda

            return encode_gelf_ltsv_cuda(self.batch, self.lens, self.out, n,
                                         self.bank, self.table,
                                         self.max_pairs, self.OW,
                                         ts_text=ts_text, ts_len=ts_len,
                                         row_off=row_off, total=total)
        from .device_gelf import flat_rows

        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       ts_text, ts_len, **self.kw)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok`` and the :data:`TS_KEYS` channels of the first ``n`` rows
        on the host, from the probe's narrowed buffer (:func:`small_fetch`),
        and the bytes that crossed."""
        return small_fetch(self.small, self.N, n)


def route_ok(encoder, merger, decoder=None) -> bool:
    """GELF output over line/nul/syslen framing, untyped decode only
    (``ltsv_schema`` rows carry per-value canonicality screens that are
    host work); gelf_extra rides as constant segments when this
    layout's keys place statically (gelf_extra_consts_ltsv)."""
    if decoder is not None and getattr(decoder, "schema", None):
        return False
    return gelf_route_ok(
        encoder, merger,
        lambda e: gelf_extra_consts_ltsv(e) is not None)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 decoder=None, timings=None):
    """Device ltsv→GELF encode for a submitted ltsv decode handle
    ``(out, batch, lens)``: (BlockResult | None, fetch_seconds); None =
    the caller runs the host tier."""
    from .block_common import merger_suffix
    from .materialize_ltsv import _scalar_ltsv

    out, batch_dev, lens_dev = handle
    suffix, syslen = merger_suffix(merger)
    extras = tuple((k, v) for k, v in encoder.extra)
    kern = _Rows(batch_dev, lens_dev, out, suffix, extras)

    def wide():
        """The 16-pair probe of the same decode, only when the 6-pair
        tier declines."""
        return _Rows(batch_dev, lens_dev, out, suffix, extras,
                     WIDE_DEV_PAIRS)

    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=lambda line: _scalar_ltsv(decoder, line),
        fallback_frac=FALLBACK_FRAC, decline_limit=DECLINE_LIMIT,
        cooldown=COOLDOWN, wide=wide, elide=elide_spec(suffix, extras),
        timings=timings, ts_vals_fn=ts_vals_ltsv)
