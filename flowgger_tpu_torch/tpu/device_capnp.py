"""Device rfc5424→Cap'n Proto encode (kernel OC): the split tier between
the rfc5424 decode and the host block encoder for capnp output
(capnp_encoder.rs:36-109 semantics, ``encode_capnp_block``'s word layout
byte for byte).

The wire image of a row is the host tier's fixed skeleton: the 9 root
pointer words; the hostname, appname, procid, msgid, msg (only when not
empty) and full_msg texts, each NUL-padded to whole words; the SD id
when the row has SD; the pairs' tag word and 4-word elements (two zero
data words, the string discriminant, then the key and value pointers);
each pair's ``"_" + name`` and value texts; the constant ``capnp_extra``
blob.  Only ``sd[0]``'s pairs are emitted (``pair_sd == 0``, a prefix of
the pair slots).  Every pointer is a self-relative word (``lo = (off <<
2) | 1``, ``hi = elem | count << 3``, elem 2 for a text, 7 for a
composite list), so the layout is integer word arithmetic over span
lengths.

No escape stage: the tier excludes rows with an escaped pair value (of
any SD block: ``val_has_esc`` over the first ``pair_count`` slots, as the
reference reckons it), so the texts re-emit verbatim from the raw row.
Elision drops the 32-byte head — the segment count, ``nwords``, the
root pointer, the raw little-endian f64 stamp and facility / severity —
and the framing suffix: the probe exports ``fac8`` / ``sev8`` and the
host splice (:func:`make_elide`) rebuilds the head, ``nwords = body_len
// 8 + 3`` from the elided body, the stamp rendered on the host
(``_render_le_f64``).  The device rows hold no stamp (``_Rows.
ts_in_row``), so the width test is on the elided length.

Two implementations of one contract:

- :func:`encode_rows` — the plain PyTorch version of the JAX package's
  ``device_capnp._encode_kernel`` (:148, ``elide=True``): the tier mask
  before its width test, the elided length, the probe channels and the
  tier rows' bytes.  The CPU takes it, and the tests hold it against the
  JAX function.
- the hand-written CUDA kernel ``csrc/encode_capnp.cu``
  (``kernels.encode_capnp_cuda``), which reads K1's packed ``[C, N]``
  channels at 4 SD blocks and 6 or 16 pairs in place; :class:`_Rows`
  launches it for a CUDA batch.

The fetch driver (``device_common.fetch_encode_driver``) keeps the
reference's rule: the tier takes a batch when at most 5 % of its rows
fall outside it, three declines in a row cool it down for 16 batches;
the reference's capnp tier has no 16-pair escalation, so neither has
this one.
"""

from __future__ import annotations

# byte-identity contract (flowcheck FC03): the scalar counterpart
# this route must stay byte-identical to, and the differential
# test that enforces it
SCALAR_ORACLE = "flowgger_tpu_torch.encoders.capnp:CapnpEncoder"
DIFF_TEST = ("tests/test_torch_device_capnp.py::"
             "test_handler_matches_reference_batch_for_batch")

import ctypes
import functools
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..capnp_wire import (
    PAIR_DATA_WORDS,
    PAIR_PTR_WORDS,
    RECORD_DATA_WORDS,
    RECORD_PTR_WORDS,
    WORD,
)
from .device_common import (
    _out_width,
    assemble_rows,
    build_bank,
    encode_route_ok,
    fetch_encode_driver,
    splice_rows,
)
from .device_rfc5424_out import _live, small_probe
from .rfc5424 import DEFAULT_MAX_PAIRS

_PAIR_WORDS = PAIR_DATA_WORDS + PAIR_PTR_WORDS      # 4
_ROOT_WORDS = RECORD_DATA_WORDS + RECORD_PTR_WORDS  # 11
_HDR_BYTES = 8 + 8 + _ROOT_WORDS * WORD             # 104
_PW0 = 1 + RECORD_DATA_WORDS  # word index of root pointer slot 0
_ROOT_PTR = (RECORD_DATA_WORDS | (RECORD_PTR_WORDS << 16)) << 32

# constant bank: the reference's parts (the blob is the host tier's own
# _extra_blob, so the two tiers can never disagree on its bytes)
_PARTS = {
    "z16": b"\x00" * 16,
    "us": b"_",
    "blob": b"",
    "tail": b"",
}

# the ladder constants of the → GELF split tier
FALLBACK_FRAC = 0.05
DECLINE_LIMIT = 3
COOLDOWN = 16


@functools.lru_cache(maxsize=None)
def _bank(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, {name: offset}, {name: constant})."""
    from .encode_capnp_block import _extra_blob

    parts = dict(_PARTS)
    parts["blob"] = _extra_blob(list(extras))
    bank, offs = build_bank(parts, suffix)
    return bank, offs, parts


def _plane_width(P: int) -> int:
    """Bytes of a row's computed plane: the head and pointer words, the
    tag word and P elements."""
    return _HDR_BYTES + WORD + P * _PAIR_WORDS * WORD


def out_width(L: int, suffix: bytes, extras=(),
              P: int = DEFAULT_MAX_PAIRS) -> int:
    """OW of a batch of width L decoded at P pairs (the reference's: the
    row, the bank and the plane)."""
    bank, _, _ = _bank(suffix, tuple(extras))
    return _out_width(L, L + len(bank) + _plane_width(P))


def _render_le_f64(val: float) -> bytes:
    """Stamp bytes: the raw little-endian f64 the root struct's first
    data word carries."""
    return struct.pack("<d", float(val))


def make_elide(suffix: bytes):
    """The host splice of a taken batch: the 32-byte head (segment count,
    ``nwords`` from the elided body's length, the root pointer, the
    stamp, fac8 / sev8) at the row's start, the framing suffix at its
    end (the reference's ``make_elide``)."""
    root8 = np.frombuffer(int(_ROOT_PTR).to_bytes(8, "little"),
                          dtype=np.uint8)

    def splice(body, row_off, small, ts_text, ts_len, ridx):
        R = ridx.size
        lens = np.diff(row_off).astype(np.int64)
        nwords = lens // WORD + (32 - 8) // WORD
        head = np.zeros((R, 32), dtype=np.uint8)
        head[:, 4:8] = nwords.astype("<u4").view(np.uint8).reshape(R, 4)
        head[:, 8:16] = root8
        W = ts_text.shape[1] if ts_text.ndim == 2 else 0
        head[:, 16:16 + min(8, W)] = np.asarray(
            ts_text, np.uint8)[ridx][:, :8]
        head[:, 24] = small["fac8"][ridx]
        head[:, 25] = small["sev8"][ridx]
        ins_src = np.concatenate(
            [head.ravel(), np.frombuffer(suffix, dtype=np.uint8)])
        ins_at = np.stack([np.zeros(R, dtype=np.int64), lens], axis=1)
        ins_a = np.stack([
            np.arange(R, dtype=np.int64) * 32,
            np.full(R, R * 32, dtype=np.int64),
        ], axis=1)
        ins_l = np.stack([
            np.full(R, 32, dtype=np.int64),
            np.full(R, len(suffix), dtype=np.int64),
        ], axis=1)
        return splice_rows(body, row_off, ins_src, ins_at, ins_a, ins_l)

    return splice


def _le8(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """[N] lo / hi word halves → [N, 8] little-endian bytes."""
    cols = [(lo >> (8 * i)) & 0xFF for i in range(4)]
    cols += [(hi >> (8 * i)) & 0xFF for i in range(4)]
    return torch.stack(cols, dim=1).to(torch.uint8)


def _tw(blen: torch.Tensor) -> torch.Tensor:
    """Words a NUL-terminated text of ``blen`` bytes occupies."""
    return (blen + 1 + WORD - 1) // WORD


def encode_rows(batch: torch.Tensor, lens: torch.Tensor,
                dec: Dict[str, torch.Tensor], *, suffix: bytes,
                extras=(), assemble: bool = True, n: Optional[int] = None):
    """Plain version of the reference's ``_encode_kernel(...,
    elide=True)`` over an rfc5424 decode channel dict (at any pair
    width P).

    Without ``assemble`` it is the probe: ``(base bool [N], base_len
    int32 [N], small u8 [2, N])``, the tier rule before its width test
    (ok, no byte >= 0x80, no escaped value among the first
    ``pair_count`` slots), the row's elided length (0 outside the rule)
    and the ``fac8`` / ``sev8`` channels; every output is 0 for rows at
    or past ``n`` (default: none).  A row is in the reference's tier
    when ``base`` holds and ``base_len <= out_width``.

    With ``assemble``: ``(rows [N, OW] u8, out_len int32, tier)``, where
    a tier row holds its elided wire image in ``rows[:out_len]``."""
    N, L = batch.shape
    i64 = torch.int64
    dev = batch.device
    bank, off, parts = _bank(suffix, tuple(extras))
    blob_w = len(parts["blob"]) // WORD
    P = dec["name_start"].shape[1]
    OW = _out_width(L, L + len(bank) + _plane_width(P))
    zero = torch.zeros((N,), dtype=i64, device=dev)
    cbase = L
    tbase = L + len(bank)

    def ch(k):
        return dec[k].to(i64)

    def span(sk, ek):
        s = ch(sk)
        return s, torch.clamp(ch(ek) - s, min=0)

    host_s, host_l = span("host_start", "host_end")
    app_s, app_l = span("app_start", "app_end")
    proc_s, proc_l = span("proc_start", "proc_end")
    msgid_s, msgid_l = span("msgid_start", "msgid_end")
    msg_s = ch("msg_trim_start")
    trim_e = ch("trim_end")
    msg_l = torch.clamp(trim_e - msg_s, min=0)
    has_msg = msg_l > 0
    full_s = ch("full_start")
    full_l = torch.clamp(trim_e - full_s, min=0)
    has_sd = ch("sd_count") > 0
    sid_s = dec["sid_start"][:, 0].to(i64)
    sid_l = torch.clamp(dec["sid_end"][:, 0].to(i64) - sid_s, min=0)
    pc = ch("pair_count")

    # only sd[0] is emitted (capnp_encoder.rs:78-80); pair_sd is
    # nondecreasing, so block 0's pairs are a prefix of the slots
    pvalid, name_s, name_l, val_s, val_l = [], [], [], [], []
    esc_any = torch.zeros((N,), dtype=torch.bool, device=dev)
    for j in range(P):
        pv = (j < pc) & (dec["pair_sd"][:, j].to(i64) == 0)
        pvalid.append(pv)
        ns = dec["name_start"][:, j].to(i64)
        vs = dec["val_start"][:, j].to(i64)
        name_s.append(ns)
        name_l.append(torch.where(
            pv, torch.clamp(dec["name_end"][:, j].to(i64) - ns, min=0), 0))
        val_s.append(vs)
        val_l.append(torch.where(
            pv, torch.clamp(dec["val_end"][:, j].to(i64) - vs, min=0), 0))
        esc_any |= dec["val_has_esc"][:, j].to(torch.bool) & (j < pc)

    # ---- word layout (encode_capnp_block._capnp_assemble) ----
    texts = [(host_s, host_l, None), (app_s, app_l, None),
             (proc_s, proc_l, None), (msgid_s, msgid_l, None),
             (msg_s, msg_l, has_msg), (full_s, full_l, None)]
    tw = [_tw(ln) if g is None else torch.where(g, _tw(ln), 0)
          for _, ln, g in texts]
    si_w = torch.where(has_sd, _tw(sid_l), 0)
    key_w = [torch.where(pvalid[j], _tw(name_l[j] + 1), 0) for j in range(P)]
    valw = [torch.where(pvalid[j], _tw(val_l[j]), 0) for j in range(P)]
    k0 = sum(pv.to(i64) for pv in pvalid)
    kw_sum = sum(key_w) + sum(valw)
    pairs_w = torch.where(has_sd, 1 + k0 * _PAIR_WORDS + kw_sum, 0)
    w_at = [zero + (1 + _ROOT_WORDS)]
    for w in tw:
        w_at.append(w_at[-1] + w)
    w_sid = w_at[-1]
    w_pairs = w_sid + si_w
    w_extra = w_pairs + pairs_w

    # ---- segment plan, in output order (the 72 pointer bytes first) ----
    segs = [(zero + (tbase + 32), zero + 72)]
    z16 = zero + (cbase + off["z16"])
    for (s, ln, g), w in zip(texts, tw):
        gl = ln if g is None else torch.where(g, ln, 0)
        segs.append((s, gl))
        pad = w * WORD - gl
        segs.append((z16, pad if g is None else torch.where(g, pad, 0)))
    segs.append((sid_s, torch.where(has_sd, sid_l, 0)))
    segs.append((z16, torch.where(has_sd, si_w * WORD - sid_l, 0)))
    segs.append((zero + (tbase + _HDR_BYTES),
                 torch.where(has_sd, WORD + k0 * _PAIR_WORDS * WORD, 0)))
    for j in range(P):
        pv = pvalid[j]
        segs.append((zero + (cbase + off["us"]), torch.where(pv, 1, 0)))
        segs.append((name_s[j], name_l[j]))
        segs.append((z16, torch.where(pv, key_w[j] * WORD
                                      - (name_l[j] + 1), 0)))
        segs.append((val_s[j], val_l[j]))
        segs.append((z16, torch.where(pv, valw[j] * WORD - val_l[j], 0)))
    segs.append((zero + (cbase + off["blob"]), zero + len(parts["blob"])))
    out_len = segs[0][1]
    for _, ln in segs[1:]:
        out_len = out_len + ln

    base = (dec["ok"].to(torch.bool) & ~dec["has_high"].to(torch.bool)
            & ~esc_any)
    if not assemble:
        live = _live(N, n, dev)
        base &= live
        small = torch.stack([ch("facility"), ch("severity")]).to(torch.uint8)
        return (base, torch.where(base, out_len, 0).to(torch.int32),
                torch.where(live, small, 0))

    # ---- the plane: pointer words, tag word, elements ----
    def lptr(ptr_word, target, count, elem, gate):
        lo = ((target - ptr_word - 1) << 2) | 1
        hi = elem | (count << 3)
        if gate is not None:
            lo = torch.where(gate, lo, 0)
            hi = torch.where(gate, hi, 0)
        return _le8(lo, hi)

    planes = [torch.zeros((N, 32), dtype=torch.uint8, device=dev)]
    for slot, ((_, ln, g), w0) in enumerate(zip(texts, w_at)):
        planes.append(lptr(_PW0 + slot, w0, ln + 1, 2, g))
    planes.append(lptr(_PW0 + 6, w_sid, sid_l + 1, 2, has_sd))
    planes.append(lptr(_PW0 + 7, w_pairs, k0 * _PAIR_WORDS, 7, has_sd))
    if blob_w:
        planes.append(lptr(_PW0 + 8, w_extra,
                           zero + len(extras) * _PAIR_WORDS, 7, None))
    else:
        planes.append(torch.zeros((N, 8), dtype=torch.uint8, device=dev))
    planes.append(_le8(torch.where(has_sd, k0 << 2, 0),
                       torch.where(has_sd, zero + (PAIR_DATA_WORDS
                                                   | (PAIR_PTR_WORDS << 16)),
                                   0)))
    cursor = w_pairs + 1 + k0 * _PAIR_WORDS
    for j in range(P):
        kw0 = cursor
        kw1 = kw0 + key_w[j]
        cursor = kw1 + valw[j]
        elem = w_pairs + 1 + j * _PAIR_WORDS
        planes.append(torch.zeros((N, PAIR_DATA_WORDS * WORD),
                                  dtype=torch.uint8, device=dev))
        planes.append(lptr(elem + PAIR_DATA_WORDS, kw0, name_l[j] + 2, 2,
                           pvalid[j]))
        planes.append(lptr(elem + PAIR_DATA_WORDS + 1, kw1, val_l[j] + 1, 2,
                           pvalid[j]))
    plane = torch.cat(planes, dim=1)
    rows, _ = assemble_rows(segs, batch, bank, plane, OW)
    return rows, out_len.to(torch.int32), base & (out_len <= OW)


# ---------------------------------------------------------------------------
# probe / assemble (CUDA kernel on CUDA tensors, plain version on the CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def kernel_consts(suffix: bytes, extras: Tuple[Tuple[str, str], ...] = ()):
    """(bank bytes, the kernels' consts table: the blob's offset and
    length in the bank and the ``capnp_extra`` pair count, int32), built
    once per (suffix, extras)."""
    bank, offs, parts = _bank(suffix, tuple(extras))
    table = [offs["blob"], len(parts["blob"]), len(extras)]
    return bank, (ctypes.c_int * len(table))(*table)


def _pairs_of(out) -> int:
    """The pair width of a decode: a channel dict's, or the packed
    ``[C, N]`` output's (4 SD blocks)."""
    if isinstance(out, torch.Tensor):
        from .rfc5424 import _KEYS_1D, _KEYS_PAIR, _KEYS_SD

        rest = out.shape[0] - len(_KEYS_1D) - len(_KEYS_SD) * 4
        return rest // len(_KEYS_PAIR)
    return out["name_start"].shape[1]


class _Rows:
    """One decoded rfc5424 batch as the fetch driver sees it: ``probe``
    and ``assemble`` launch OC for a CUDA batch (``out`` K1's packed
    ``[C, N]`` channels at 4 SD blocks) and the plain version for a CPU
    batch (``out`` the plain decode's channel dict).  The stamp is not
    in the device rows (``ts_in_row``): the host splice puts it back."""

    ts_in_row = False

    def __init__(self, batch, lens, out, suffix, extras=()):
        self.batch, self.lens, self.out = batch, lens, out
        self.N = batch.shape[0]
        self.device = batch.device
        self.suffix, self.extras = suffix, tuple(extras)
        self.OW = out_width(batch.shape[1], suffix, self.extras,
                            _pairs_of(out))
        self.small8 = None
        if batch.is_cuda:
            from .device_gelf import _bank_on

            bank, self.table = kernel_consts(suffix, self.extras)
            self.bank = _bank_on(bank, batch.device)

    def probe(self, n: int):
        """``(base bool [N], base_len int32 [N])`` of the first ``n``
        rows; keeps the probe's fac8 / sev8."""
        if self.batch.is_cuda:
            from .kernels import encode_capnp_cuda

            base, base_len, self.small8 = encode_capnp_cuda(
                self.batch, self.lens, self.out, n, self.bank, self.table)
        else:
            base, base_len, self.small8 = encode_rows(
                self.batch, self.lens, self.out, suffix=self.suffix,
                extras=self.extras, assemble=False, n=n)
        return base, base_len

    def assemble(self, ts_text, ts_len, row_off, total, n: int):
        """The elided bytes of the rows with ``row_off >= 0`` (all below
        ``n``), each at its offset, in one ``total``-byte u8 buffer."""
        if self.batch.is_cuda:
            from .kernels import encode_capnp_cuda

            return encode_capnp_cuda(self.batch, self.lens, self.out, n,
                                     self.bank, self.table, self.OW,
                                     row_off=row_off, total=total)
        from .device_gelf import flat_rows

        rows, out_len, _ = encode_rows(self.batch, self.lens, self.out,
                                       suffix=self.suffix,
                                       extras=self.extras)
        return flat_rows(rows, out_len, row_off, total)

    def small_channels(self, n: int):
        """``ok``, the four timestamp channels and fac8 / sev8 of the
        first ``n`` rows on the host (the reference's ``_small_fetch``),
        and the bytes that crossed."""
        if isinstance(self.out, torch.Tensor):
            # K1's ok, days, sod, off, nanos
            h = self.out[[0, 4, 5, 6, 7], :n].cpu().numpy()
            small = {"ok": h[0] != 0, "days": h[1], "sod": h[2],
                     "off": h[3], "nanos": h[4]}
        else:
            small = {k: self.out[k][:n].cpu().numpy()
                     for k in ("ok", "days", "sod", "off", "nanos")}
        nbytes = sum(v.nbytes for v in small.values())
        extra, ebytes = small_probe(self.small8, None, n)
        small.update(extra)
        return small, nbytes + ebytes


# the fused route FO/capnp's leg (fused_routes._FusedRows)
ts_render = _render_le_f64


def fused_cuda(fmt, batch, lens, n, bank, consts, year=None, **asm):
    """FO/capnp's probe, or with the assemble's keywords its assemble
    (``kernels.fused_capnp_out_cuda``)."""
    from .kernels import fused_capnp_out_cuda

    return fused_capnp_out_cuda(batch, lens, n, bank, consts, **asm)


def fused_elide(suffix: bytes, fmt: str):
    return make_elide(suffix)


def fused_small(extra, n: int, OW: int):
    """fac8 / sev8 of the first ``n`` rows on the host, and their bytes."""
    return small_probe(extra[0], None, n)


def route_ok(encoder, merger) -> bool:
    """capnp output over line, NUL or syslen framing (or none): any
    ``capnp_extra`` renders to one static blob."""
    from ..encoders.capnp import CapnpEncoder

    return encode_route_ok(encoder, merger, CapnpEncoder)


def fetch_encode(handle, packed, encoder, merger, route_state=None,
                 timings=None):
    """The device capnp encode of a submitted rfc5424 decode: (BlockResult
    | None, fetch_seconds); None = the caller runs the host tier."""
    from .block_common import merger_suffix
    from .materialize import _scalar_line

    out, batch_dev, lens_dev, _max_sd = handle
    suffix, syslen = merger_suffix(merger)
    extras = tuple((str(k), str(v)) for k, v in getattr(encoder, "extra", ()))
    kern = _Rows(batch_dev, lens_dev, out, suffix, extras)
    return fetch_encode_driver(
        kern, packed, encoder, merger, route_state, suffix, syslen,
        scalar_fn=_scalar_line, fallback_frac=FALLBACK_FRAC,
        decline_limit=DECLINE_LIMIT, cooldown=COOLDOWN,
        elide=make_elide(suffix), timings=timings,
        ts_render=_render_le_f64)
