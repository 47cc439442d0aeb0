"""Device →RFC5424 encode (kernels O5 and O5/3164): the split tier
between the rfc5424 or rfc3164 decode and the host block encoder for
RFC5424 output (rfc5424_encoder.rs:28-93 semantics, ``encode_rfc5424_
block``'s segment plans byte for byte).

RFC5424 output never escapes (record.rs:55-62), so there is no escape
stage: every segment of a row is a raw span of the input row or a
constant of the bank.

- O5, rfc5424 → RFC5424: the host, appname, procid and msgid spans with
  a space after each; ``-`` for a row without SD, else per SD block
  ``[`` sid, then `` name="value"`` for each pair the decode attributes
  to the block (``pair_sd``, pairs in (block, pair) order), then ``]``;
  then a space and the message.
- O5/3164, rfc3164 → RFC5424 (the relay upgrade): two segments, the
  host and the message, ``msg_l = max(lens - msg_start, 0)``.

Elision goes further than the → GELF tiers' fixed triple: the head
``<PRI>1 <stamp> `` is row-dependent, so the probe exports one-byte
channels (``fac8`` / ``sev8``, and on the rfc3164 leg ``pri1`` and the
two-byte ``hostl16``) and the host splice (:func:`make_elide`,
:func:`make_elide_3164`) rebuilds the exact host-tier head from them,
the stamp rendered on the host (``ts_text_block(render=
_render_rfc3339)``, once per distinct stamp), the rfc3164 leg's
``" - - - "`` at ``hostl16``, and the framing suffix at the row's end.
The device rows hold no stamp (``_Rows.ts_in_row``), so the width test
is on the elided length.

Two implementations of one contract each:

- :func:`encode_rows` / :func:`encode_rows_3164` — the plain PyTorch
  versions of the JAX package's ``device_rfc5424_out._encode_kernel``
  (:220) and ``_encode_kernel_3164`` (:335) with ``elide=True``: the
  tier mask before its width test, the elided length, the probe
  channels and the tier rows' bytes.  The CPU takes them, and the tests
  hold them against the JAX functions.
- the hand-written CUDA kernels ``csrc/encode_rfc5424_out.cu``
  (``kernels.encode_rfc5424_out_cuda``), which read K1's packed ``[C,
  N]`` channels at 4 SD blocks and 6 pairs, or D3's, in place;
  :class:`_Rows` launches them for a CUDA batch.

The fetch driver (``device_common.fetch_encode_driver``) keeps the
reference's rule: the tier takes a batch when at most 5 % of its rows
fall outside it, three declines in a row cool it down for 16 batches;
there is no wide escalation.  The two legs keep their decline state
apart (each under its input format).
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.rfc5424:RFC5424Encoder"
DIFF_TEST = ("tests/test_torch_device_rfc5424_out.py::"
             "test_handler_matches_reference_batch_for_batch")

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
    encode_route_ok,
    fetch_encode_driver,
    splice_rows,
)

# constant bank: the same byte constants the host tier uses
# (encode_rfc5424_block builds them per batch with build_source; a
# spliced block mixes both tiers' rows, so they must never diverge)
_PARTS = {
    "lt": b"<",
    "gt1": b">1 ",
    "dflt": b"<13>1 ",       # rfc3164 leg: the PRI-less default head
    "sp": b" ",
    "eqq": b'="',
    "q": b'"',
    "lb": b"[",
    "rb": b"]",
    "dash": b"-",
    "t3164": b" - - - ",     # rfc3164 leg: appname/procid/msgid/sd slots
    "dec": b"0123456789",
    "tail": b"",
}
# the constants O5 reads, in the order of its consts table
# (csrc/encode_rfc5424_out_row.cuh, enum ConstR)
KERNEL_CONSTS = ("sp", "eqq", "q", "lb", "rb", "dash")

# the ladder constants of the → GELF split tier
FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes):
    """(bank bytes, {name: offset}, {name: constant})."""
    parts = dict(_PARTS)
    bank, offs = build_bank(parts, suffix)
    return bank, offs, parts


def out_width(L: int, suffix: bytes, extras=()) -> int:
    """OW of a batch of width L: the longest elided row of the tier."""
    bank, _, _ = _bank(suffix)
    return _out_width(L, L + len(bank) + TS_W)


def _render_rfc3339(val: float) -> bytes:
    """Stamp text: the millisecond-truncated RFC3339 form of the scalar
    encoder and the host block tier."""
    from ..utils.timeparse import unix_to_rfc3339_ms

    return unix_to_rfc3339_ms(val).encode("ascii")


def _head_rows(pri: np.ndarray, has_pri, ts_rows: np.ndarray,
               ts_lens: np.ndarray):
    """The elided ``<PRI>1 <stamp> `` head of each row on the host
    (``<13>1 <stamp> `` where an rfc3164 line carried no PRI): (flat
    bytes, row offsets, row lengths), the host tier's columns 0-6 with
    the same digit gating and constants."""
    from .assemble import (
        build_source,
        concat_segments,
        decimal_segments,
        exclusive_cumsum,
    )

    R = pri.shape[0]
    consts, offs = build_source(b"<", b">1 ", b"<13>1 ", b" ",
                                b"0123456789")
    o_lt, o_gt1, o_dflt, o_sp, o_dec = offs
    W = ts_rows.shape[1] if ts_rows.ndim == 2 else 0
    src = np.concatenate([consts, np.asarray(ts_rows, np.uint8).ravel()])
    tbase = len(consts)
    dsrc, dlen = decimal_segments(pri, o_dec, width=3)
    if has_pri is None:
        has_pri = np.ones(R, dtype=bool)
    else:
        has_pri = np.asarray(has_pri, dtype=bool)
    ndig = np.where(has_pri,
                    1 + (pri >= 10).astype(np.int64)
                    + (pri >= 100).astype(np.int64), 0)
    seg_src = np.stack([
        np.where(has_pri, o_lt, 0),
        dsrc[0::3], dsrc[1::3], dsrc[2::3],
        np.where(has_pri, o_gt1, o_dflt),
        tbase + np.arange(R, dtype=np.int64) * W,
        np.full(R, o_sp, dtype=np.int64),
    ], axis=1)
    seg_len = np.stack([
        np.where(has_pri, 1, 0),
        np.where(has_pri, dlen[0::3], 0),
        np.where(has_pri, dlen[1::3], 0),
        np.where(has_pri, dlen[2::3], 0),
        np.where(has_pri, len(b">1 "), len(b"<13>1 ")),
        np.asarray(ts_lens, dtype=np.int64),
        np.ones(R, dtype=np.int64),
    ], axis=1)
    head = concat_segments(src, seg_src.ravel(), seg_len.ravel())
    head_len = (np.where(has_pri, 1 + 3, 6) + ndig
                + np.asarray(ts_lens, dtype=np.int64) + 1)
    return head, exclusive_cumsum(head_len)[:-1], head_len


def elide_spec(suffix: bytes, leg: str = "rfc5424"):
    """The splice of either leg (the split tier's and the fused route's)."""
    return make_elide(suffix) if leg == "rfc5424" else make_elide_3164(suffix)


def make_elide(suffix: bytes):
    """The host splice of an rfc5424 → RFC5424 batch: the ``<PRI>1
    <stamp> `` head from ``fac8`` / ``sev8`` and the rendered stamp at
    the row's start, the framing suffix at its end."""

    def splice(body, row_off, small, ts_text, ts_len, ridx):
        R = ridx.size
        fac = small["fac8"][ridx].astype(np.int64)
        sev = small["sev8"][ridx].astype(np.int64)
        head, head_off, head_len = _head_rows(
            (fac << 3) + sev, None, ts_text[ridx], ts_len[ridx])
        ins_src = np.concatenate(
            [head, np.frombuffer(suffix, dtype=np.uint8)])
        lens = np.diff(row_off).astype(np.int64)
        ins_at = np.stack([np.zeros(R, dtype=np.int64), lens], axis=1)
        ins_a = np.stack([head_off,
                          np.full(R, head.size, dtype=np.int64)], axis=1)
        ins_l = np.stack([head_len,
                          np.full(R, len(suffix), dtype=np.int64)], axis=1)
        return splice_rows(body, row_off, ins_src, ins_at, ins_a, ins_l)

    return splice


def make_elide_3164(suffix: bytes):
    """The host splice of an rfc3164 → RFC5424 batch: the head
    (``<PRI>1 `` gated on ``pri1``, else ``<13>1 ``, the stamp, a
    space), ``" - - - "`` at ``hostl16`` and the framing suffix."""
    T3164 = b" - - - "

    def splice(body, row_off, small, ts_text, ts_len, ridx):
        R = ridx.size
        fac = small["fac8"][ridx].astype(np.int64)
        sev = small["sev8"][ridx].astype(np.int64)
        has_pri = small["pri1"][ridx].astype(bool)
        hostl = small["hostl16"][ridx].astype(np.int64)
        head, head_off, head_len = _head_rows(
            (fac << 3) + sev, has_pri, ts_text[ridx], ts_len[ridx])
        ins_src = np.concatenate(
            [head, np.frombuffer(T3164 + suffix, dtype=np.uint8)])
        lens = np.diff(row_off).astype(np.int64)
        ins_at = np.stack(
            [np.zeros(R, dtype=np.int64), hostl, lens], axis=1)
        ins_a = np.stack([
            head_off,
            np.full(R, head.size, dtype=np.int64),
            np.full(R, head.size + len(T3164), dtype=np.int64),
        ], axis=1)
        ins_l = np.stack([
            head_len,
            np.full(R, len(T3164), dtype=np.int64),
            np.full(R, len(suffix), dtype=np.int64),
        ], axis=1)
        return splice_rows(body, row_off, ins_src, ins_at, ins_a, ins_l)

    return splice


def _live(N: int, n: Optional[int], dev) -> torch.Tensor:
    return torch.arange(N, device=dev) < (N if n is None else n)


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], *, suffix: bytes,
                max_sd: int = 4, extras=(), assemble: bool = True,
                n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over an rfc5424 decode channel dict.

    Without ``assemble`` it is the probe: ``(base bool [N], base_len
    int32 [N], small u8 [2, N])``, the tier rule before its width test,
    the row's elided length (0 outside the rule) and the ``fac8`` /
    ``sev8`` channels; every output is 0 for rows at or past ``n``
    (default: none).  A row is in the reference's tier when ``base``
    holds and ``base_len <= out_width``.

    With ``assemble``: ``(rows [N, OW] u8, out_len int32, tier)``, where
    a tier row holds its elided RFC5424 bytes in ``rows[:out_len]``."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    bank, off, parts = _bank(suffix)
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

    sdc = ch("sd_count")
    nsd = sdc > 0
    pc = ch("pair_count")
    P = dec["name_start"].shape[1]
    # the '<PRI>1 <stamp> ' head is elided (spliced back from the probe)
    for a, b in (("host_start", "host_end"), ("app_start", "app_end"),
                 ("proc_start", "proc_end"), ("msgid_start", "msgid_end")):
        add_span(ch(a), ch(b))
        add_const("sp")
    # SD: '-' on SD-less rows, else per block '[' sid pairs ']', a pair
    # in block k when pair_sd == k, in (k, j) order
    add_const("dash", ~nsd)
    val_esc_any = torch.zeros((N,), dtype=torch.bool, device=dev)
    for j in range(P):
        val_esc_any |= dec["val_has_esc"][:, j].to(torch.bool) & (j < pc)
    for k in range(max_sd):
        kv = k < sdc
        add_const("lb", kv)
        add_span(dec["sid_start"][:, k].to(i64),
                 dec["sid_end"][:, k].to(i64), kv)
        for j in range(P):
            pv = (j < pc) & (dec["pair_sd"][:, j].to(i64) == k) & kv
            add_const("sp", pv)
            add_span(dec["name_start"][:, j].to(i64),
                     dec["name_end"][:, j].to(i64), pv)
            add_const("eqq", pv)
            add_span(dec["val_start"][:, j].to(i64),
                     dec["val_end"][:, j].to(i64), pv)
            add_const("q", pv)
        add_const("rb", kv)
    add_const("sp")
    add_span(ch("msg_trim_start"), ch("trim_end"))
    # the suffix elided (spliced back at the row's end)
    out_len = segs[0][1]
    for _, ln in segs[1:]:
        out_len = out_len + ln

    base = (dec["ok"].to(torch.bool) & ~dec["has_high"].to(torch.bool)
            & (pc <= P) & (sdc <= max_sd) & ~val_esc_any)
    if not assemble:
        live = _live(N, n, dev)
        base &= live
        small = torch.stack([ch("facility"), ch("severity")]).to(torch.uint8)
        return (base, torch.where(base, out_len, 0).to(torch.int32),
                torch.where(live, small, 0))
    rows, _ = assemble_rows(segs, batch, bank,
                            torch.zeros((N, 0), dtype=torch.uint8,
                                        device=dev), OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


def encode_rows_3164(batch: torch.Tensor, lens: torch.Tensor,
                     dec: Dict[str, torch.Tensor], *, suffix: bytes,
                     extras=(), assemble: bool = True,
                     n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel_3164(...,
    elide=True)`` over an rfc3164 decode channel dict: the elided body
    is the host span and the message (``max(lens - msg_start, 0)``).

    Without ``assemble`` it is the probe: ``(base bool [N], base_len
    int32 [N], small u8 [3, N], hostl16 uint16 [N])``: the tier rule
    before its width test (ok, no byte >= 0x80), the elided length (0
    outside the rule), the ``fac8`` / ``sev8`` / ``pri1`` channels and
    the host span's length; 0 for rows at or past ``n``.  With
    ``assemble``: ``(rows [N, OW] u8, out_len int32, tier)``."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    bank, _, _ = _bank(suffix)
    OW = _out_width(L, L + len(bank) + TS_W)
    host_s = dec["host_start"].to(i64)
    host_l = torch.clamp(dec["host_end"].to(i64) - host_s, min=0)
    msg_s = dec["msg_start"].to(i64)
    msg_l = torch.clamp(lens.to(i64) - msg_s, min=0)
    out_len = host_l + msg_l
    base = dec["ok"].to(torch.bool) & ~dec["has_high"].to(torch.bool)
    if not assemble:
        live = _live(N, n, dev)
        base &= live
        small = torch.stack([dec["facility"].to(i64),
                             dec["severity"].to(i64),
                             dec["has_pri"].to(i64)]).to(torch.uint8)
        hostl16 = torch.where(live, host_l, 0).to(torch.int32).to(
            torch.uint16)
        return (base, torch.where(base, out_len, 0).to(torch.int32),
                torch.where(live, small, 0), hostl16)
    segs = [(host_s, host_l), (msg_s, msg_l)]
    rows, _ = assemble_rows(segs, batch, bank,
                            torch.zeros((N, 0), dtype=torch.uint8,
                                        device=dev), OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras=()):
    """(bank bytes, the kernels' consts table: offsets then lengths of
    :data:`KERNEL_CONSTS` in the bank, int32), built once per suffix."""
    bank, offs, parts = _bank(suffix)
    table = [offs[k] for k in KERNEL_CONSTS] + \
        [len(parts[k]) for k in KERNEL_CONSTS]
    return bank, (ctypes.c_int * len(table))(*table)


def small_probe(small8: torch.Tensor, hostl16: Optional[torch.Tensor],
                n: int):
    """The probe's one- and two-byte channels of the first ``n`` rows on
    the host, as the reference fetches them, and their bytes."""
    h = small8[:, :n].cpu().numpy()
    small = {"fac8": h[0], "sev8": h[1]}
    nbytes = h.nbytes
    if hostl16 is not None:
        small["pri1"] = h[2]
        hl = hostl16[:n].cpu().numpy()
        small["hostl16"] = hl
        nbytes += hl.nbytes
    return small, nbytes


class _Rows:
    """One decoded batch of either leg as the fetch driver sees it:
    ``probe`` and ``assemble`` launch O5 (``leg = "rfc5424"``, ``out``
    K1's packed ``[C, N]`` channels at 4 SD blocks and 6 pairs) or
    O5/3164 (``leg = "rfc3164"``, ``out`` D3's packed channels) for a
    CUDA batch, and the plain version for a CPU batch (``out`` the plain
    decode's channel dict).  The stamp is not in the device rows
    (``ts_in_row``): the host splice puts it back."""

    ts_in_row = False

    def __init__(self, batch, lens, out, suffix, leg: str):
        self.batch, self.lens, self.out = batch, lens, out
        self.leg = leg
        self.N = batch.shape[0]
        self.device = batch.device
        self.suffix = suffix
        self.OW = out_width(batch.shape[1], suffix)
        self.small8 = self.hostl16 = None
        if batch.is_cuda:
            from .device_gelf import _bank_on

            bank, self.table = kernel_consts(suffix)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        """``(base bool [N], base_len int32 [N])`` of the first ``n``
        rows; keeps the probe's small channels."""
        if self.batch.is_cuda:
            from .kernels import encode_rfc5424_out_cuda

            res = encode_rfc5424_out_cuda(self.leg, self.batch, self.lens,
                                          self.out, n, self.bank,
                                          self.table)
        elif self.leg == "rfc5424":
            res = encode_rows(self.batch, self.lens, self.out,
                              suffix=self.suffix, assemble=False, n=n)
        else:
            res = encode_rows_3164(self.batch, self.lens, self.out,
                                   suffix=self.suffix, assemble=False, n=n)
        base, base_len, self.small8 = res[:3]
        self.hostl16 = res[3] if self.leg == "rfc3164" else None
        return base, base_len

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        """The elided bytes of the rows with ``row_off >= 0`` (all below
        ``n``), each at its offset, in one ``total``-byte u8 buffer."""
        if self.batch.is_cuda:
            from .kernels import encode_rfc5424_out_cuda

            return encode_rfc5424_out_cuda(
                self.leg, self.batch, self.lens, self.out, n, self.bank,
                self.table, self.OW, row_off=row_off, total=total)
        from .device_gelf import flat_rows

        fn = encode_rows if self.leg == "rfc5424" else encode_rows_3164
        rows, out_len, _ = fn(self.batch, self.lens, self.out,
                              suffix=self.suffix)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok``, the four timestamp channels and the probe's small
        channels of the first ``n`` rows on the host (the reference's
        ``_small_fetch``), and the bytes that crossed."""
        if isinstance(self.out, torch.Tensor):
            if self.leg == "rfc5424":
                rows = [0, 4, 5, 6, 7]   # K1's ok, days, sod, off, nanos
            else:
                from .rfc3164 import KEYS

                rows = [KEYS.index(k) for k in ("ok", "days", "sod", "off",
                                                "nanos")]
            h = self.out[rows, :n].cpu().numpy()
            small = {"ok": h[0] != 0, "days": h[1], "sod": h[2],
                     "off": h[3], "nanos": h[4]}
        else:
            small = {k: self.out[k][:n].cpu().numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")}
        nbytes = sum(v.nbytes for v in small.values())
        extra, ebytes = small_probe(self.small8, self.hostl16, n)
        small.update(extra)
        return small, nbytes + ebytes


# the fused routes FO/r5's leg (fused_routes._FusedRows)
ts_render = _render_rfc3339
fused_elide = elide_spec


def fused_cuda(fmt, batch, lens, n, bank, consts, year=None, **asm):
    """FO/r5's probe, or with the assemble's keywords its assemble
    (``kernels.fused_rfc5424_out_cuda``)."""
    from .kernels import fused_rfc5424_out_cuda

    return fused_rfc5424_out_cuda(fmt, batch, lens, n, bank, consts,
                                  year=year, **asm)


def fused_small(extra, n: int, OW: int):
    """fac8 / sev8 (/ pri1, the host lengths) of the first ``n`` rows on
    the host, and their bytes."""
    return small_probe(extra[0], extra[1] if len(extra) > 1 else None, n)


def route_ok(encoder, merger) -> bool:
    """RFC5424 output over line, NUL or syslen framing (or none); the
    encoder has no extras."""
    from ..encoders.rfc5424 import RFC5424Encoder

    return encode_route_ok(encoder, merger, RFC5424Encoder)


def _fetch(leg: str, handle, packed, encoder, merger, route_state,
           timings):
    from .block_common import merger_suffix

    if leg == "rfc5424":
        from .materialize import _scalar_line as scalar_fn

        out, batch_dev, lens_dev, _max_sd = handle
    else:
        from .materialize_rfc3164 import _scalar_3164 as scalar_fn

        out, batch_dev, lens_dev = handle
    suffix, syslen = merger_suffix(merger)
    kern = _Rows(batch_dev, lens_dev, out, suffix, leg)
    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=scalar_fn, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN,
        elide=elide_spec(suffix, leg), timings=timings,
        ts_render=_render_rfc3339)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """The device encode of a submitted rfc5424 decode into RFC5424:
    (BlockResult | None, fetch_seconds); None = the caller runs the host
    tier."""
    return _fetch("rfc5424", handle, packed, encoder, merger, route_state,
                  timings)


def fetch_encode_3164(handle, packed, encoder, merger, route_state=None,
                      timings=None):
    """The device encode of a submitted rfc3164 decode ``(out, batch,
    lens)`` into RFC5424, under the rfc3164 leg's own decline state."""
    return _fetch("rfc3164", handle, packed, encoder, merger, route_state,
                  timings)
