"""Device RFC5424→GELF encode: the tier between the decode and the host
block encoder.

For each real row of a decoded batch the encode computes whether the
row is in the tier before its width test and its output length without
the timestamp text (a *probe*, once a batch: a row's length is that
plus its text's, so the width test is the host's), and for the tier rows
their GELF bytes without the row-constant head, timestamp label and
tail (an *assemble*), each row written at its byte offset in one flat
buffer.  The host fetches exactly those bytes plus a few per-row
channels, splices the constants back (``device_common.
splice_elided_rows``) and runs the scalar oracle for the rest of the
batch; the fetch driver (``device_common.fetch_encode_driver``) keeps
the reference's tier, decline and hysteresis rules.

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the JAX package's
  ``device_gelf._encode_kernel`` (``elide=True``): with the width test
  and the text's length added, the same tier mask, ``out_len`` and
  tier-row bytes.  The CPU takes it, and the tests hold
  it against the JAX function.
- the hand-written CUDA kernel ``csrc/encode_gelf.cu`` (through
  ``tpu/kernels.py``), which reads the decode kernel's packed ``[C, N]``
  channels in place; ``_Rows.probe`` and ``_Rows.assemble`` launch it
  for a batch on a CUDA device.

Rows outside the tier — kernel-flagged, non-ASCII, more pairs than the
width, SD values with escapes, control bytes that need ``\\u00XX``,
more than ``E_CAP`` escapes, names the 8-byte sort key cannot order,
oversized output — keep the host tier's scalar path, so the bytes stay
the scalar path's in every case.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.gelf:GelfEncoder"
DIFF_TEST = ("tests/test_torch_device_gelf.py::"
             "test_handler_matches_reference_batch_for_batch")

import ctypes
import functools
import threading
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
    sort_pairs_by_key8,
)
# constant bank: the host tier's own constants, never retyped (device
# rows are spliced with host-tier rows in one block)
from .encode_gelf_block import (
    _C_APP, _C_DASH, _C_FULL, _C_HOST, _C_LEVEL, _C_OPEN, _C_P0, _C_P1,
    _C_P2, _C_PROC, _C_SDID, _C_SEVD, _C_SHORT, _C_TAIL, _C_TS,
    _C_UNKNOWN, gelf_extra_consts, gelf_extra_slots,
)

_PARTS = {
    "open": _C_OPEN, "p0": _C_P0, "p1": _C_P1, "p2": _C_P2, "app": _C_APP,
    "full": _C_FULL, "host": _C_HOST, "level": _C_LEVEL, "proc": _C_PROC,
    "sdid": _C_SDID, "short": _C_SHORT, "ts": _C_TS, "tail": _C_TAIL,
    "unknown": _C_UNKNOWN, "dash": _C_DASH, "sevd": _C_SEVD,
}
# the constants the kernel reads, in the order of its consts table
# (csrc/encode_gelf.cu, enum Const)
KERNEL_CONSTS = ("p0", "p1", "p2", "app", "full", "host", "level", "proc",
                 "p6x", "sdid", "short", "unknown", "dash", "sevd")

# fraction of non-tier rows above which the host tier takes the batch:
# the scalar oracle is far slower a row than the block encoders, and rows
# the decode flagged (7-16-pair rows included) count against it
FALLBACK_FRAC = 0.05
# hysteresis: after this many declined batches in a row, skip the device
# attempt for COOLDOWN batches before probing again
DECLINE_LIMIT = 3
COOLDOWN = 16


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, {name: offset}, {name: constant}) with any
    ``gelf_extra`` pairs folded into the neighbouring constants — the
    host tier's own ``gelf_extra_consts``.  Built once per (suffix,
    extras); callers only read the dicts."""
    parts = dict(_PARTS)
    if extras:
        econsts = gelf_extra_consts(list(extras))
        assert econsts is not None  # route_ok pre-checked
        (parts["open"], parts["app"], parts["full"], parts["host"],
         parts["level"], parts["proc"], parts["p6x"], parts["short"],
         parts["ts"], parts["tail"]) = econsts
    bank, offs = build_bank(parts, suffix)
    return bank, offs, parts


def elide_spec(suffix: bytes, extras=()):
    """(head, ts-label, tail + suffix): the constants the encode skips
    and the host splice restores."""
    _, _, parts = _bank(suffix, tuple(extras))
    return (parts["open"], parts["ts"], parts["tail"] + suffix)


def out_width(L: int, suffix: bytes, extras=()) -> int:
    """OW of a batch of width L: the longest output row of the tier."""
    bank, _, _ = _bank(suffix, tuple(extras))
    return _out_width(L, L + E_CAP + len(bank) + TS_W)


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], ts_text=None, ts_len=None,
                *, suffix: bytes, max_sd: int, extras=(),
                assemble: bool = True, n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over a decode channel dict.

    Without ``assemble`` it is the probe: ``(base bool [N], base_len
    int32 [N])``, the tier rule before its width test and the row's
    length without its timestamp text, both 0 for rows outside it and
    for rows at or past ``n`` (default: none).  A row's length is
    ``base_len + ts_len``, and it is in the tier when ``base`` holds and
    that length is at most ``out_width``: the reference's ``out_len``
    and tier mask, whatever the text.

    With ``assemble``: ``(rows [N, OW] u8, out_len, tier)`` at the given
    timestamp text, where a tier row holds its elided GELF bytes in
    ``rows[:out_len]``."""
    N, L = batch.shape
    i64 = torch.int64
    bank, off, parts = _bank(suffix, tuple(extras))
    OW = _out_width(L, L + E_CAP + len(bank) + TS_W)
    bb = batch.to(i64)
    es = escape_stage(batch, lens, assemble)
    dmap = es["dmap"]

    def ch(k):
        return dec[k].to(i64)

    # ---- fixed-field spans in escaped coordinates ------------------------
    app_s, app_e = dmap(ch("app_start")), dmap(ch("app_end"))
    proc_s, proc_e = dmap(ch("proc_start")), dmap(ch("proc_end"))
    host_s, host_e = dmap(ch("host_start")), dmap(ch("host_end"))
    full_s = dmap(ch("full_start"))
    trim_e = dmap(ch("trim_end"))
    msg_s = dmap(ch("msg_trim_start"))

    sd_count = ch("sd_count")
    nsd = sd_count > 0
    # the last SD element's id span
    sid_s_raw = torch.zeros_like(sd_count)
    sid_e_raw = torch.zeros_like(sd_count)
    for k in range(dec["sid_start"].shape[1]):
        pick = sd_count - 1 == k
        sid_s_raw = torch.where(pick, dec["sid_start"][:, k].to(i64),
                                sid_s_raw)
        sid_e_raw = torch.where(pick, dec["sid_end"][:, k].to(i64),
                                sid_e_raw)
    sid_s, sid_e = dmap(sid_s_raw), dmap(sid_e_raw)

    # ---- SD pairs: 8-byte name keys, escaped spans, sorting network -----
    pair_count = ch("pair_count")
    P = dec["name_start"].shape[1]
    val_esc_any = torch.zeros((N,), dtype=torch.bool, device=batch.device)
    cols = {"_pair_count": pair_count, "ns_raw": [], "ne_raw": [],
            "ns": [], "ne": [], "vs": [], "ve": []}
    for p in range(P):
        ns_r = dec["name_start"][:, p].to(i64)
        ne_r = dec["name_end"][:, p].to(i64)
        val_esc_any |= dec["val_has_esc"][:, p].to(torch.bool) \
            & (p < pair_count)
        cols["ns_raw"].append(ns_r)
        cols["ne_raw"].append(ne_r)
        cols["ns"].append(dmap(ns_r))
        cols["ne"].append(dmap(ne_r))
        cols["vs"].append(dmap(dec["val_start"][:, p]))
        cols["ve"].append(dmap(dec["val_end"][:, p]))
    ambig = sort_pairs_by_key8(bb, cols, P)

    # ---- segment table (head, timestamp label and tail elided) ----------
    cbase = L + E_CAP
    tbase = cbase + len(bank)
    zero = torch.zeros((N,), dtype=i64, device=batch.device)
    segs = []  # (src0 [N], seglen [N]) in destination order

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

    for p in range(P):
        pv = p < pair_count
        add_const("p0", pv)
        add_span(cols["ns"][p], cols["ne"][p], pv)
        add_const("p1", pv)
        add_span(cols["vs"][p], cols["ve"][p], pv)
        add_const("p2", pv)
    add_const("app")
    add_span(app_s, app_e)
    add_const("full")
    add_span(full_s, trim_e)
    add_const("host")
    host_empty = host_e <= host_s
    segs.append((torch.where(host_empty, cbase + off["unknown"], host_s),
                 torch.where(host_empty, len(parts["unknown"]),
                             host_e - host_s)))
    add_const("level")
    segs.append((cbase + off["sevd"] + ch("severity"), zero + 1))
    add_const("proc")
    add_span(proc_s, proc_e)
    if parts.get("p6x"):
        # extras sorting between "process_id" and "sd_id"
        add_const("p6x")
    add_const("sdid", nsd)
    add_span(sid_s, sid_e, nsd)
    add_const("short")
    msg_empty = trim_e <= msg_s
    segs.append((torch.where(msg_empty, cbase + off["dash"], msg_s),
                 torch.where(msg_empty, 1, trim_e - msg_s)))

    base_len = segs[0][1]
    for _, ln in segs[1:]:
        base_len = base_len + ln

    # ---- tier before its width test ---------------------------------------
    base = (dec["ok"].to(torch.bool)
            & ~dec["has_high"].to(torch.bool)
            & ~es["bad_ctl"].any(dim=1)
            & (es["ne_total"] <= E_CAP)
            & (pair_count <= P)
            & (sd_count <= max_sd)
            & ~val_esc_any
            & ~ambig)
    if not assemble:
        if n is not None:
            base &= torch.arange(N, device=batch.device) < n
        return base, torch.where(base, base_len, 0).to(torch.int32)
    # the timestamp text is the last segment
    segs.append((zero + tbase, ts_len.to(i64)))
    out_len = base_len + ts_len.to(i64)
    rows, _ = assemble_rows(segs, es["esc_row"], bank, ts_text, OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


def flat_rows(rows: torch.Tensor, out_len: torch.Tensor,
              row_off: torch.Tensor, total: int) -> torch.Tensor:
    """The assemble output from output rows: row r's first ``out_len[r]``
    bytes at ``row_off[r]`` of a ``total``-byte buffer, for the rows
    whose offset is not negative."""
    OW = rows.shape[1]
    o = torch.arange(OW, device=rows.device)
    keep = (row_off[:, None] >= 0) & (o < out_len.to(torch.int64)[:, None])
    flat = torch.zeros(total, dtype=torch.uint8, device=rows.device)
    flat[(row_off[:, None] + o)[keep]] = rows[keep]
    return flat


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

_BANKS: Dict[Tuple[bytes, str], torch.Tensor] = {}
_BANKS_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, the kernel's consts table: offsets then lengths of
    :data:`KERNEL_CONSTS` in the bank, int32), built once per (suffix,
    extras)."""
    bank, offs, parts = _bank(suffix, tuple(extras))
    table = [offs.get(k, 0) for k in KERNEL_CONSTS] + \
        [len(parts.get(k, b"")) for k in KERNEL_CONSTS]
    return bank, (ctypes.c_int * len(table))(*table)


def _bank_on(bank: bytes, device: torch.device) -> torch.Tensor:
    """The bank on ``device``, uploaded once per bank and device.  Lanes
    read it from several streams: it is made under a lock and its upload
    completes before any stream sees it (never freed, so no stream's
    later use can race the allocator)."""
    key = (bank, str(device))
    t = _BANKS.get(key)
    if t is None:
        with _BANKS_LOCK:
            t = _BANKS.get(key)
            if t is None:
                t = torch.tensor(list(bank), dtype=torch.uint8,
                                 device=device)
                if t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
                _BANKS[key] = t
    return t


class _Rows:
    """One decoded batch as the fetch driver sees it: ``probe`` and
    ``assemble`` launch the CUDA kernel for a CUDA batch (``out`` is the
    decode kernel's packed ``[C, N]`` channels) and run the plain
    version for a CPU batch (``out`` is the plain decode's channel
    dict)."""

    def __init__(self, batch, lens, out, max_sd, max_pairs, suffix,
                 extras):
        self.batch, self.lens, self.out = batch, lens, out
        self.N = batch.shape[0]
        self.device = batch.device
        self.max_sd, self.max_pairs = max_sd, max_pairs
        self.kw = {"suffix": suffix, "max_sd": max_sd, "extras": extras}
        self.OW = out_width(batch.shape[1], suffix, extras)
        if batch.is_cuda:
            bank, self.table = kernel_consts(suffix, extras)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        """``(base bool [N], base_len int32 [N])`` of the first ``n``
        rows on the batch's device (:func:`encode_rows` without
        ``assemble``; 0 for the other rows)."""
        if self.batch.is_cuda:
            from .kernels import encode_gelf_cuda

            return encode_gelf_cuda(self.batch, self.lens, self.out, n,
                                    self.bank, self.table, self.max_sd,
                                    self.max_pairs)
        return encode_rows(self.batch, self.lens, self.out, assemble=False,
                           n=n, **self.kw)

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        """The elided bytes of the rows with ``row_off >= 0`` (all below
        ``n``), each at its offset, in one ``total``-byte u8 buffer on
        the batch's device."""
        if self.batch.is_cuda:
            from .kernels import encode_gelf_cuda

            return encode_gelf_cuda(self.batch, self.lens, self.out, n,
                                    self.bank, self.table, self.max_sd,
                                    self.max_pairs, self.OW, ts_text=ts_text,
                                    ts_len=ts_len, row_off=row_off,
                                    total=total)
        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       ts_text, ts_len, **self.kw)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok`` and the four timestamp channels of the first ``n`` rows
        on the host, and the bytes that crossed: 17 a row."""
        if isinstance(self.out, torch.Tensor):
            # rows 0 and 4-7 of the packed [C, N] channels
            ok = (self.out[0, :n] != 0).cpu().numpy()
            ts = self.out[4:8, :n].cpu().numpy()
            small = {"ok": ok, "days": ts[0], "sod": ts[1], "off": ts[2],
                     "nanos": ts[3]}
        else:
            small = {k: self.out[k][:n].cpu().numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")}
        return small, sum(v.nbytes for v in small.values())


def route_ok(encoder, merger) -> bool:
    """GELF output over line/NUL/syslen framing (or none), with
    ``gelf_extra`` keys of static placement."""
    return gelf_route_ok(encoder, merger,
                         lambda e: gelf_extra_slots(e) is not None)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """The device encode of a submitted rfc5424 decode: (BlockResult |
    None, fetch_seconds); None = the caller runs the host tier."""
    from .block_common import merger_suffix
    from .materialize import _scalar_line
    from .rfc5424 import (DEFAULT_MAX_PAIRS, RESCUE_MAX_PAIRS,
                          decode_rfc5424_wide)

    out, batch_dev, lens_dev, max_sd = handle
    suffix, syslen = merger_suffix(merger)
    extras = tuple((k, v) for k, v in encoder.extra)
    kern = _Rows(batch_dev, lens_dev, out, max_sd, DEFAULT_MAX_PAIRS,
                 suffix, extras)

    def wide():
        """The batch decoded again at 16 pairs, only when the 6-pair
        tier declines."""
        return _Rows(batch_dev, lens_dev, decode_rfc5424_wide(handle),
                     max_sd, RESCUE_MAX_PAIRS, suffix, extras)

    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=_scalar_line, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN, wide=wide,
        elide=elide_spec(suffix, extras), timings=timings)
