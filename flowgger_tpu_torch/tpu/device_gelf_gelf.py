"""Device GELF→GELF re-canonicalization (EG): the split device tier of the
gelf input, between the flat structural index and the host block
encoder.

A trimmed copy of the JAX package's ``tpu/device_gelf_gelf.py`` on the
port's driver (``device_common.fetch_encode_driver``): the same tier
rule, decline and hysteresis constants, the 16-field escalation when a
batch declines at 8 fields (``wide``: the batch decoded again at 16
fields), and the contract of ``device_gelf``.  The layout mirrors the
host tier (``encode_gelf_gelf_block``) byte for byte::

    {"_<key>":V..., ["full_message":"F",] "host":H|unknown,
     ["level":D,] "short_message":"S"|"-", "timestamp":T,
     "version":"1.1"}

The tier is **escape-free**: string spans re-emit verbatim, so rows with
escape flags, control bytes or non-ASCII leave it, and the assembly's
source is the raw row.  Special keys route by quoted-name patterns
(``"timestamp"`` with both quotes: the closing quote pins the key's
length) matched at each field's opening quote; each field carries its
point bytes (the key's first byte, the value's bytes 0, 1, 2 and last)
and span counts (dots, non-digits, fraction characters) for the
canonical-number screens; pair keys sort by their final name (a leading
``_`` stripped) through the shared sorter with the fields fed in raw
order (``slot_valid``).  The timestamp is parsed exactly as split
integers (``ts_hi`` / ``ts_lo`` nine digits each, ``ts_meta`` the
fraction digits, the digit count and the sign in bit 16), and the host
combines them in numpy float64 (:func:`ts_vals_gelf`): at most 16
digits within 2**53, so the result is the correctly rounded strtod
value the host tier's ``float(span)`` gives.  The encode leaves out the
head, timestamp-label and tail constants (the reference's
``elide=True``); the host splice restores them.  ``gelf_extra`` keeps
the tier off (route-gated, as in the reference).

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the reference's
  ``_encode_kernel(..., elide=True)``, with the width test and the
  text's length moved to the host as in ``device_gelf.encode_rows``;
- the hand-written CUDA kernel EG, the ``fg_encode_gelf_gelf_*`` entry
  points of ``csrc/encode_gelf.cu`` (``encode_gelf_gelf_row.cuh``;
  through ``tpu/kernels.py``) at 8 and 16 fields, which read the flat
  structural index's packed ``[2 + 7F, N]`` channels in place.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_device_gelf_gelf.py::"
             "test_plain_encode_matches_reference")

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from .device_common import (
    TS_W,
    _out_width,
    assemble_rows,
    build_bank,
    fetch_encode_driver,
    gelf_route_ok,
    sort_pairs_by_key8,
)
from .jsonidx import VT_FALSE, VT_NULL, VT_NUMBER, VT_STRING, VT_TRUE

FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16
# the decode width of the tier, and of its escalation when a batch
# declines at it (the reference's wide hook: 16, not the decode's
# 24-field rescue bound)
BASE_FIELDS = 8
WIDE_FIELDS = 16

_TSW = 24   # host-tier bound: longer timestamp spans take the oracle
_SPECIALS = (b"timestamp", b"host", b"short_message", b"full_message",
             b"version", b"level")
_SP_TS, _SP_HOST, _SP_SHORT, _SP_FULL, _SP_VER, _SP_LVL = range(1, 7)

_PARTS = {
    "open": b"{",
    "kpre": b'"_',
    "q": b'"',
    "colon": b'":',
    "qc": b'",',
    "true": b"true",
    "false": b"false",
    "null": b"null",
    "full": b'"full_message":"',
    "host": b'"host":"',
    "lvl": b'"level":',
    "short": b'"short_message":"',
    "ts": b'"timestamp":',
    "unknown": b"unknown",
    "dash": b"-",
    "comma": b",",
    "tail": b'"version":"1.1"}',
}
# the constants the kernel reads, in the order of its consts table
# (csrc/encode_gelf_gelf_row.cuh, enum ConstGG).  It folds a pair's
# seven segments into five: '"' is the first byte of '"_', '":"' the
# colon constant and the quote that opens "qc" after it, ',' the second
# byte of '",' (kernel_consts checks the bank holds them so)
KERNEL_CONSTS = ("kpre", "colon", "qc", "true", "false", "null", "full",
                 "host", "lvl", "short", "unknown", "dash")
# the probe's stamp channels (int32 [3, N], zeros off the tier)
TS_KEYS = ("ts_hi", "ts_lo", "ts_meta")


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes):
    return build_bank(dict(_PARTS), suffix)


def out_width(L: int, suffix: bytes, extras=()) -> int:
    """OW of a batch of width L: the longest output row of the tier (no
    escape room: the tier is escape-free)."""
    bank, _ = _bank(suffix)
    return _out_width(L, L + len(bank) + TS_W)


def elide_spec(suffix: bytes, extras=()):
    """(head, ts-label, tail + suffix): the constants the encode skips
    and the host splice restores — shared with the fused route."""
    return (_PARTS["open"], _PARTS["ts"],
            _PARTS["comma"] + _PARTS["tail"] + suffix)


def _packed_counts(counts: torch.Tensor) -> torch.Tensor:
    """The reference's span counts as its packed words give them back:
    three fields a word, ten bits each, each slot ``& 1023`` (a count
    of 1024 or more carries into the next slot there)."""
    N, F = counts.shape
    out = torch.zeros_like(counts)
    for base in range(0, F, 3):
        w = min(3, F - base)
        word = torch.zeros(N, dtype=counts.dtype, device=counts.device)
        for s in range(w):
            word = word + (counts[:, base + s] << (10 * s))
        for s in range(w):
            out[:, base + s] = (word >> (10 * s)) & 1023
    return out


def analyze(batch: torch.Tensor, lens: torch.Tensor,
            dec: Dict[str, torch.Tensor]) -> dict:
    """Everything the tier decides about a batch from its flat-JSON
    channels ``dec`` (any field width F), the reference's
    ``_encode_kernel`` up to its segment table: ``base`` (its tier rule
    without the width test), the unmasked stamp channels ``ts_hi`` /
    ``ts_lo`` / ``ts_meta`` (every row, as the reference computes them),
    the special fields (``has_*``, spans ``*_a`` / ``*_b``) and the
    sorted pair columns (``pc``; lists ``us``, ``ns``, ``ne``, ``vs``,
    ``ve``, ``vt`` of F slots, the valid pairs first)."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    F = dec["key_start"].shape[1]
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens.to(i64)[:, None]
    bb = torch.where(valid, batch.to(i64), 0)

    ok = dec["ok"].to(torch.bool)
    nf = torch.clamp(dec["n_fields"].to(i64), max=F)
    key_s = dec["key_start"].to(i64)
    key_e = dec["key_end"].to(i64)
    val_s = dec["val_start"].to(i64)
    val_e = dec["val_end"].to(i64)
    val_t = dec["val_type"].to(i64)
    key_esc = dec["key_esc"].to(torch.bool)
    val_esc = dec["val_esc"].to(torch.bool)
    jm = (torch.arange(F, device=dev)[None, :] < nf[:, None]) & ok[:, None]

    # escape-free tier: any control byte or non-ASCII in the row → host
    viol_row = (((bb >= 128) | (bb < 32)) & valid).any(dim=1)

    def at(pos: torch.Tensor) -> torch.Tensor:
        """Bytes at [N, K] positions (0 outside the row's valid bytes)."""
        inb = (pos >= 0) & (pos < L)
        return torch.where(inb, bb.gather(1, pos.clamp(0, L - 1)), 0)

    # ---- special-key ids: quoted-name patterns at each key's quote ------
    kopen = key_s - 1
    spid = torch.zeros((N, F), dtype=i64, device=dev)
    for sid, name in enumerate(_SPECIALS, start=1):
        m = torch.ones((N, F), dtype=torch.bool, device=dev)
        for i, ch in enumerate(b'"' + name + b'"'):
            m &= at(kopen + i) == ch
        spid = torch.where(m, sid, spid)

    # ---- per-field point bytes + span counts -------------------------------
    kfirst = at(key_s)
    v0, v1, v2 = at(val_s), at(val_s + 1), at(val_s + 2)
    vlast = at(val_e - 1)
    is_dot = bb == ord(".")
    is_nondig = ((bb < ord("0")) | (bb > ord("9"))) & valid
    is_fracc = is_dot | (bb == ord("e")) | (bb == ord("E"))

    def span_counts(mask):
        cum = torch.cat([torch.zeros((N, 1), dtype=i64, device=dev),
                         torch.cumsum(mask.to(i64), dim=1)], dim=1)
        a = val_s.clamp(0, L)
        b = val_e.clamp(0, L)
        c = cum.gather(1, b) - cum.gather(1, a)
        return _packed_counts(torch.where(val_e > val_s, c, 0))

    dots = span_counts(is_dot)
    nondig = span_counts(is_nondig)
    fracc = span_counts(is_fracc)
    vlen = val_e - val_s

    def canonical(ln, c0, c1, c2, clast, ndots, nnondig):
        r"""JSON grammar ``-?(0|[1-9][0-9]*)(\.[0-9]+)?`` (the host
        tier's canonical_number)."""
        neg = (c0 == ord("-")).to(i64)
        dfirst = torch.where(neg == 1, c1, c0)
        dsecond = torch.where(neg == 1, c2, c1)
        okn = (ln > neg) & (nnondig == neg + ndots)
        okn &= (ndots <= 1) & (dfirst != ord(".")) & (clast != ord("."))
        okn &= ((dfirst != ord("0")) | (ln - neg == 1)
                | (dsecond == ord(".")))
        okn &= ~((neg == 1) & (dfirst == ord("0")) & (ndots == 0))
        return okn

    # ---- specials: presence, uniqueness, the (last) field of each ----------
    rep_special = torch.zeros(N, dtype=torch.bool, device=dev)
    fidx = torch.arange(F, device=dev).expand(N, F)
    sel = {}
    for sid in range(1, 7):
        hit = jm & (spid == sid)
        rep_special |= hit.sum(dim=1) > 1
        last = torch.where(hit, fidx, -1).max(dim=1).values
        sel[sid] = (last >= 0, last.clamp(min=0)[:, None])

    def pick(sid, ch):
        pres, f = sel[sid]
        return torch.where(pres, ch.gather(1, f)[:, 0], 0)

    has = {sid: sel[sid][0] for sid in sel}
    tsa, tsb = pick(_SP_TS, val_s), pick(_SP_TS, val_e)
    ts_vt = pick(_SP_TS, val_t)
    ts_dots, ts_nondig = pick(_SP_TS, dots), pick(_SP_TS, nondig)
    ts_v0, ts_v1 = pick(_SP_TS, v0), pick(_SP_TS, v1)
    ts_v2, ts_vlast = pick(_SP_TS, v2), pick(_SP_TS, vlast)

    # ---- timestamp validation + exact split-integer parse ------------------
    ts_ln = tsb - tsa
    ts_neg = (ts_v0 == ord("-")).to(i64)
    ts_ok = (has[_SP_TS] & (ts_vt == VT_NUMBER)
             & canonical(ts_ln, ts_v0, ts_v1, ts_v2, ts_vlast, ts_dots,
                         ts_nondig)
             & (ts_ln <= _TSW))
    r = iota - tsa[:, None]
    in_ts = (r >= 0) & (r < ts_ln[:, None])
    dot_r = torch.where(in_ts & is_dot, r, 1 << 20).min(dim=1).values
    has_dot = ts_dots == 1
    nd_digits = ts_ln - ts_neg - has_dot.to(i64)
    frac_digits = torch.where(has_dot, ts_ln - 1 - dot_r, 0)
    di = r - ts_neg[:, None] - (r > dot_r[:, None]).to(i64)
    place = nd_digits[:, None] - 1 - di
    dig = bb - 48
    dig_m = (in_ts & ~is_nondig & (r >= ts_neg[:, None])
             & (r != dot_r[:, None]))
    p10 = 10 ** torch.arange(9, dtype=i64, device=dev)
    lo_w = torch.where(dig_m & (place >= 0) & (place <= 8),
                       p10[place.clamp(0, 8)], 0)
    hi_w = torch.where(dig_m & (place >= 9) & (place <= 17),
                       p10[(place - 9).clamp(0, 8)], 0)
    ts_lo = (dig * lo_w).sum(dim=1)
    ts_hi = (dig * hi_w).sum(dim=1)
    ts_meta = (frac_digits.clamp(0, 255) | (nd_digits.clamp(0, 255) << 8)
               | (ts_neg << 16))
    f16_ok = (ts_hi < 9007199) | ((ts_hi == 9007199) & (ts_lo <= 254740992))
    ts_ok &= (nd_digits <= 15) | ((nd_digits == 16) & f16_ok)

    # ---- the other specials --------------------------------------------------
    def clean_str(sid):
        return (pick(sid, val_t) == VT_STRING) & (pick(sid, val_esc.to(i64))
                                                  == 0)

    host_ok = has[_SP_HOST] & clean_str(_SP_HOST)
    short_ok = ~has[_SP_SHORT] | clean_str(_SP_SHORT)
    full_ok = ~has[_SP_FULL] | clean_str(_SP_FULL)
    ver_ok = ~has[_SP_VER] | (clean_str(_SP_VER)
                              & (pick(_SP_VER, vlen) == 3)
                              & (pick(_SP_VER, v0) == ord("1"))
                              & (pick(_SP_VER, v1) == ord("."))
                              & ((pick(_SP_VER, v2) == ord("0"))
                                 | (pick(_SP_VER, v2) == ord("1"))))
    lvl_v0 = pick(_SP_LVL, v0)
    lvl_ok = ~has[_SP_LVL] | ((pick(_SP_LVL, val_t) == VT_NUMBER)
                              & (pick(_SP_LVL, vlen) == 1)
                              & (lvl_v0 >= ord("0")) & (lvl_v0 <= ord("7")))

    # ---- pair validation -------------------------------------------------------
    isp = jm & (spid == 0)
    neg = (v0 == ord("-")).to(i64)
    int_ok = ((val_t == VT_NUMBER) & (fracc == 0) & (vlen - neg <= 18)
              & canonical(vlen, v0, v1, v2, vlast, dots, nondig)
              & ~((v0 == ord("0")) & (vlen > 1))
              & ~((neg == 1) & (v1 == ord("0"))))
    p_ok = (((val_t == VT_STRING) & ~val_esc) | (val_t == VT_TRUE)
            | (val_t == VT_FALSE) | (val_t == VT_NULL) | int_ok)
    pair_bad = (isp & ~p_ok).any(dim=1) | (jm & key_esc).any(dim=1)
    pc = isp.sum(dim=1)

    # pair slots feed the sorter in raw field order with a per-slot
    # validity mask; the sort key is the final name (leading '_'
    # stripped)
    us = (kfirst == ord("_")).to(i64)
    cols = {"_pair_count": pc,
            "ns_raw": [key_s[:, f] + us[:, f] for f in range(F)],
            "ne_raw": [key_e[:, f] for f in range(F)],
            "us": [us[:, f] for f in range(F)],
            "ns": [key_s[:, f] for f in range(F)],
            "ne": [key_e[:, f] for f in range(F)],
            "vs": [val_s[:, f] for f in range(F)],
            "ve": [val_e[:, f] for f in range(F)],
            "vt": [val_t[:, f] for f in range(F)]}
    ambig = sort_pairs_by_key8(bb, cols, F,
                               slot_valid=[isp[:, f] for f in range(F)])

    base = (ok & ~viol_row & ~rep_special & ts_ok & host_ok & short_ok
            & full_ok & ver_ok & lvl_ok & ~pair_bad & ~ambig)
    return {"base": base, "bb": bb, "F": F,
            "ts_hi": ts_hi, "ts_lo": ts_lo, "ts_meta": ts_meta,
            "pc": pc, **{k: cols[k] for k in ("us", "ns", "ne", "vs", "ve",
                                              "vt")},
            "has_full": has[_SP_FULL], "full_a": pick(_SP_FULL, val_s),
            "full_b": pick(_SP_FULL, val_e),
            "host_a": pick(_SP_HOST, val_s), "host_b": pick(_SP_HOST, val_e),
            "has_lvl": has[_SP_LVL], "lvl_a": pick(_SP_LVL, val_s),
            "has_short": has[_SP_SHORT], "short_a": pick(_SP_SHORT, val_s),
            "short_b": pick(_SP_SHORT, val_e)}


def segments(s: dict, L: int, suffix: bytes):
    """The reference's segment table (elide=True) without the timestamp
    text: sources index ``row ∥ bank ∥ ts text``; returns (segs, its
    summed length)."""
    bank, off = _bank(suffix)
    cbase = L
    pc = s["pc"]
    zero = torch.zeros_like(pc)

    def const(name, gate=None):
        ln = zero + len(_PARTS[name])
        return (zero + (cbase + off[name]),
                ln if gate is None else torch.where(gate, ln, 0))

    segs = []
    for p in range(s["F"]):
        pv = p < pc
        us = s["us"][p] == 1
        vt = s["vt"][p]
        is_str = vt == VT_STRING
        span = is_str | (vt == VT_NUMBER)
        vsrc = torch.where(
            span, s["vs"][p],
            torch.where(vt == VT_TRUE, cbase + off["true"],
                        torch.where(vt == VT_FALSE, cbase + off["false"],
                                    cbase + off["null"])))
        vln = torch.where(span, s["ve"][p] - s["vs"][p],
                          torch.where(vt == VT_FALSE, 5, 4))
        segs += [
            (torch.where(us, cbase + off["q"], cbase + off["kpre"]),
             torch.where(pv, torch.where(us, 1, 2), 0)),
            (s["ns"][p], torch.where(pv, s["ne"][p] - s["ns"][p], 0)),
            const("colon", pv),
            const("q", pv & is_str),
            (vsrc, torch.where(pv, vln, 0)),
            const("q", pv & is_str),
            const("comma", pv),
        ]
    has_full, has_lvl, has_short = s["has_full"], s["has_lvl"], s["has_short"]
    host_len = s["host_b"] - s["host_a"]
    host_empty = host_len <= 0
    segs += [
        const("full", has_full),
        (s["full_a"], torch.where(has_full, s["full_b"] - s["full_a"], 0)),
        const("qc", has_full),
        const("host"),
        (torch.where(host_empty, cbase + off["unknown"], s["host_a"]),
         torch.where(host_empty, len(_PARTS["unknown"]), host_len)),
        const("qc"),
        const("lvl", has_lvl),
        (s["lvl_a"], torch.where(has_lvl, 1, 0)),
        const("comma", has_lvl),
        const("short"),
        (torch.where(has_short, s["short_a"], cbase + off["dash"]),
         torch.where(has_short, s["short_b"] - s["short_a"], 1)),
        const("qc"),
    ]
    total = segs[0][1]
    for _, ln in segs[1:]:
        total = total + ln
    return segs, total


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], ts_text=None, ts_len=None,
                *, suffix: bytes, extras=(), assemble: bool = True,
                n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over a flat-JSON channel dict (8 or 16 fields).
    Without ``assemble`` the probe ``(base bool [N], base_len int32 [N],
    small int32 [3, N])``: the tier bit before the width test, the
    length without the timestamp text, and the ``TS_KEYS`` stamp
    channels — all 0 off the base tier and at or past ``n``.  With it
    ``(rows [N, OW] u8, out_len, tier)`` at the given timestamp text."""
    N, L = batch.shape
    s = analyze(batch, lens, dec)
    segs, base_len = segments(s, L, suffix)
    base = s["base"]
    if not assemble:
        if n is not None:
            base = base & (torch.arange(N, device=batch.device) < n)
        small = torch.stack([torch.where(base, s[k], 0) for k in TS_KEYS])
        return (base, torch.where(base, base_len, 0).to(torch.int32),
                small.to(torch.int32))
    bank, _ = _bank(suffix)
    OW = out_width(L, suffix)
    segs.append((torch.zeros_like(base_len) + L + len(bank),
                 ts_len.to(torch.int64)))
    rows, out_len = assemble_rows(segs, s["bb"].to(torch.uint8), bank,
                                  ts_text, OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


def ts_vals_gelf(small, okh):
    """Combine the kernel's split-integer parse; the sign rides ts_meta
    bit 16 (canonical JSON allows negative stamps).  numpy float64, never
    a torch reduction.  Shared by the split and fused gelf→GELF tiers."""
    hi = small["ts_hi"].astype(np.float64)
    lo = small["ts_lo"].astype(np.float64)
    meta = small["ts_meta"]
    frac = (meta & 255).astype(np.int64)
    sign = np.where((meta >> 16) & 1, -1.0, 1.0)
    return sign * (hi * 1e9 + lo) / np.power(10.0, frac)


def small_channels(small: torch.Tensor, n: int):
    """The driver's stamp dict from a probe's int32 [3, N] ``small``
    (one fetch of the first ``n`` rows), and the bytes that crossed.
    ``ok`` is all set: the driver intersects it with the probe's tier,
    which implies the decode's ok."""
    h = small[:, :n].cpu().numpy()
    return ({"ok": np.ones(n, dtype=bool), "ts_hi": h[0], "ts_lo": h[1],
             "ts_meta": h[2]}, h.nbytes)


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras=()):
    """(bank bytes, the kernel's consts table: offsets then lengths of
    :data:`KERNEL_CONSTS` in the bank, int32)."""
    bank, offs = _bank(suffix)
    # the folded pair segments read these bytes past their constants
    assert bank[offs["kpre"]:offs["kpre"] + 1] == b'"'
    assert bank[offs["colon"]:offs["colon"] + 3] == b'":"'
    assert bank[offs["qc"] + 1:offs["qc"] + 2] == b","
    table = [offs[k] for k in KERNEL_CONSTS] + \
        [len(_PARTS[k]) for k in KERNEL_CONSTS]
    return bank, (ctypes.c_int * len(table))(*table)


class _Rows:
    """One decoded gelf batch as the fetch driver sees it (the contract
    of ``device_gelf._Rows``): ``out`` is the flat index kernel's packed
    ``[2 + 7F, N]`` channels for a CUDA batch, the plain decode's channel
    dict for a CPU batch, at ``fields`` = 8 or 16."""

    def __init__(self, batch, lens, out, suffix, fields: int = BASE_FIELDS):
        from .device_gelf import _bank_on

        self.batch, self.lens, self.out = batch, lens, out
        self.small = None      # the probe's stamp channels
        self.N = batch.shape[0]
        self.device = batch.device
        self.fields = fields
        self.suffix = suffix
        self.OW = out_width(batch.shape[1], suffix)
        if batch.is_cuda:
            bank, self.table = kernel_consts(suffix)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf_gelf_cuda

            base, base_len, self.small = encode_gelf_gelf_cuda(
                self.batch, self.lens, self.out, n, self.bank, self.table,
                self.fields)
            return base, base_len
        base, base_len, self.small = encode_rows(
            self.batch, self.lens, self.out, assemble=False, n=n,
            suffix=self.suffix)
        return base, base_len

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        if self.batch.is_cuda:
            from .kernels import encode_gelf_gelf_cuda

            return encode_gelf_gelf_cuda(
                self.batch, self.lens, self.out, n, self.bank, self.table,
                self.fields, self.OW, ts_text=ts_text, ts_len=ts_len,
                row_off=row_off, total=total)
        from .device_gelf import flat_rows

        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       ts_text, ts_len, suffix=self.suffix)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        return small_channels(self.small, n)


def route_ok(encoder, merger, decoder=None) -> bool:
    """GELF output over line/nul/syslen framing; gelf_extra cannot place
    statically in a re-canonicalized object (dynamic input keys), so any
    extras keep the host paths — exactly the host block's gate."""
    return gelf_route_ok(encoder, merger, lambda e: False)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """Device gelf→GELF encode for a submitted gelf decode handle ``(out,
    batch, lens)``: (BlockResult | None, fetch_seconds); None = the
    caller runs the host tier."""
    from .block_common import merger_suffix
    from .gelf import decode_on
    from .materialize_gelf import _scalar_gelf

    out, batch_dev, lens_dev = handle
    suffix, syslen = merger_suffix(merger)
    kern = _Rows(batch_dev, lens_dev, out, suffix)

    def wide():
        """The batch decoded again at 16 fields, only when the 8-field
        tier declines (the [N, F] field axis sizes the whole encode)."""
        return _Rows(batch_dev, lens_dev,
                     decode_on(batch_dev, lens_dev, WIDE_FIELDS), suffix,
                     WIDE_FIELDS)

    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=_scalar_gelf, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN, wide=wide,
        elide=elide_spec(suffix), timings=timings, ts_vals_fn=ts_vals_gelf)
