r"""Columnar RFC3164 (BSD syslog) decode over a packed ``[N, L]`` uint8
batch.

Scalar spec: flowgger_tpu_torch/decoders/rfc3164.py (reference
rfc3164_decoder.rs:31-213).  RFC3164 is deliberately lenient — the
scalar decoder tries two layouts, optional years, an IANA timezone
token, and whitespace-run tokenization.  The decode fast-paths only the
overwhelmingly common shape:

    [<pri>]Mon d hh:mm:ss host msg...

with single spaces between tokens and no year/timezone token, because
those are the cases whose decode is position-determined:

- the month is matched at the post-PRI offset;
- the day picks one of three layouts for the hh:mm:ss / host offsets:
  A ``Mon dd``, B ``Mon d`` and C ``Mon  d``;
- any whitespace *run* (double space), trailing space, tab, or leading
  space would change the reference's rebuilt-with-single-spaces message
  — rows containing one in the message region fall back;
- a fourth token that could plausibly be an IANA timezone name (all of
  ``[A-Za-z0-9/_+-]``, starting uppercase, or one of the two lowercase
  names ``localtime`` / ``posixrules``) falls back, since the scalar path
  would consult the tz database; a token with a byte outside that set
  (the ``.`` of an FQDN or IP) can never be a tz name and stays on the
  fast path;
- the current UTC year is a runtime argument, read at each submit — the
  reference assumes it at decode time (rfc3164_decoder.rs:179-184).

Every flagged row decodes via the scalar oracle, so output stays
byte-identical.

Two implementations of one contract:

- :func:`decode_rfc3164` — plain PyTorch, translated from the JAX
  package's ``tpu/rfc3164.py`` ``decode_rfc3164``; the CPU tests hold it
  channel for channel against the JAX function;
- the hand-written CUDA kernel D3 (``csrc/decode_rfc3164.cu`` through
  ``tpu/kernels.py``), one warp a row; :func:`decode_rfc3164_submit`
  launches it for a batch on a CUDA device and takes the plain version
  only for a batch that lies on the CPU.

Returned spans are byte offsets relative to each row.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .rfc5424 import _days_from_civil, _days_in_month, _shift_left

# channel rows of the kernel's packed [C, N] int32 output
KEYS = ("ok", "has_pri", "has_high", "facility", "severity", "days", "sod",
        "off", "nanos", "host_start", "host_end", "msg_start")
_BOOL_KEYS = ("ok", "has_pri", "has_high")
_MONTHS = (b"Jan", b"Feb", b"Mar", b"Apr", b"May", b"Jun",
           b"Jul", b"Aug", b"Sep", b"Oct", b"Nov", b"Dec")


def unpack_channels(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Channel dict from the kernel's ``[C, N]`` int32 output (rows in
    :data:`KEYS` order); the dtypes match :func:`decode_rfc3164`."""
    return {k: packed[i].to(torch.bool if k in _BOOL_KEYS else torch.int32)
            for i, k in enumerate(KEYS)}


def _at(iota, pos, values):
    """values[n, pos[n]], 0 where pos lies outside the row (the
    reference's masked max; ``values`` are bytes, never negative)."""
    hit = iota == pos[:, None]
    return torch.where(hit, values, 0).amax(dim=1)


def _min_where(mask, iota, notfound: int):
    return torch.where(mask, iota, notfound).amin(dim=1)


def decode_rfc3164(batch: torch.Tensor, lens: torch.Tensor,
                   year) -> Dict[str, torch.Tensor]:
    """Decode a packed ``[N, L]`` uint8 batch with plain tensor ops: the
    channels, dtypes and values of the JAX package's ``decode_rfc3164``
    for the same ``year``, on every row.  Integer work is int64 here; no
    value of the reference's int32 arithmetic wraps."""
    N, L = batch.shape
    dev = batch.device
    i64 = torch.int64
    lens = lens.to(i64)
    year = torch.as_tensor(int(year), dtype=i64, device=dev)
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens[:, None]
    bb = torch.where(valid, batch.to(i64), 0)
    is_digit = (bb >= 48) & (bb <= 57)
    dig = bb - 48

    # ---- optional <pri> --------------------------------------------------
    has_pri = bb[:, 0] == ord("<")
    gt = _min_where((bb == ord(">")) & valid, iota, L)
    ndig = gt - 1
    pri_zone = (iota >= 1) & (iota < gt[:, None]) & has_pri[:, None]
    e = gt[:, None] - 1 - iota
    w = torch.where(e == 0, 1, torch.where(e == 1, 10,
                                           torch.where(e == 2, 100, 0)))
    pri = torch.where(pri_zone, dig * w, 0).sum(dim=1)
    pri_ok = torch.where(
        has_pri,
        (gt < L) & (ndig >= 1) & (ndig <= 3) & (pri <= 255)
        & ~(pri_zone & ~is_digit).any(dim=1),
        True)
    m0 = torch.where(has_pri, gt + 1, 0)
    ok = pri_ok

    # ---- month at m0 ------------------------------------------------------
    month = torch.zeros_like(lens)
    at_m0 = iota == m0[:, None]
    for i, mon in enumerate(_MONTHS):
        pat = bb == mon[0]
        pat &= _shift_left(bb, 1, 0) == mon[1]
        pat &= _shift_left(bb, 2, 0) == mon[2]
        month = torch.where((pat & at_m0).any(dim=1), i + 1, month)
    ok &= month > 0

    # ---- day layouts after "Mon " ------------------------------------------
    #   A: "Mon dd "  (two digits)           time at m0+7
    #   B: "Mon d "   (single digit)         time at m0+6
    #   C: "Mon  d "  (classic double-space single digit) time at m0+7
    r = iota - m0[:, None]
    c4 = _at(iota, m0 + 3, bb)
    ok &= c4 == 32  # space after month
    d0 = _at(iota, m0 + 4, bb)
    d1 = _at(iota, m0 + 5, bb)
    d2 = _at(iota, m0 + 6, bb)
    d0_dig = (d0 >= 48) & (d0 <= 57)
    d1_dig = (d1 >= 48) & (d1 <= 57)
    case_a = d0_dig & d1_dig
    case_b = d0_dig & (d1 == 32)
    case_c = (d0 == 32) & d1_dig & (d2 == 32)
    ok &= case_a | case_b | case_c
    day = torch.where(case_a, (d0 - 48) * 10 + (d1 - 48),
                      torch.where(case_b, d0 - 48, d1 - 48))
    t0 = m0 + torch.where(case_b, 6, 7)  # time start
    ok &= _at(iota, t0 - 1, bb) == 32
    rt = r - (t0 - m0)[:, None]
    in_time = (rt >= 0) & (rt < 8)
    dzt = torch.where(in_time, dig, 0)
    hour = (dzt * ((rt == 0).to(i64) * 10 + (rt == 1).to(i64))).sum(dim=1)
    minute = (dzt * ((rt == 3).to(i64) * 10 + (rt == 4).to(i64))).sum(dim=1)
    sec = (dzt * ((rt == 6).to(i64) * 10 + (rt == 7).to(i64))).sum(dim=1)
    tviol = (in_time & ((rt == 2) | (rt == 5))
             & (bb != ord(":"))).any(dim=1)
    tviol |= (in_time & (rt != 2) & (rt != 5) & ~is_digit).any(dim=1)
    ok &= ~tviol & (hour <= 23) & (minute <= 59) & (sec <= 59)
    ok &= (day >= 1) & (day <= _days_in_month(year, month))

    # ---- host token -------------------------------------------------------
    host_s = t0 + 9
    ok &= _at(iota, t0 + 8, bb) == 32
    is_sp = (bb == 32) & valid
    host_e = _min_where(is_sp & (iota >= host_s[:, None]), iota, L)
    host_e = torch.minimum(host_e, lens)
    ok &= host_e > host_s  # nonempty hostname token
    msg_start = torch.minimum(host_e + 1, lens)

    # ---- strictness ------------------------------------------------------
    # str.split() whitespace: tab, LF, VT, FF, CR and the 0x1C-0x1F
    # separators; a double space from the time token on; a leading or
    # trailing space (multi-byte unicode whitespace is caught by the
    # block encoder's has_high gate)
    ws_other = (((bb >= 9) & (bb <= 13))
                | ((bb >= 28) & (bb <= 31))) & valid
    dbl = is_sp & _shift_left(is_sp, 1, False) & (iota >= t0[:, None])
    last_ch_sp = _at(iota, lens - 1, bb) == 32
    first_ch_sp = bb[:, 0] == 32
    ok &= ~(ws_other | dbl).any(dim=1) & ~last_ch_sp & ~first_ch_sp
    ok &= lens >= 1

    # ---- timezone-lookalike guard for the token after the time ----------
    in_host = (iota >= host_s[:, None]) & (iota < host_e[:, None])
    tz_char = (
        ((bb >= ord("A")) & (bb <= ord("Z")))
        | ((bb >= ord("a")) & (bb <= ord("z")))
        | ((bb >= ord("0")) & (bb <= ord("9")))
        | (bb == ord("/")) | (bb == ord("_"))
        | (bb == ord("+")) | (bb == ord("-"))
    )
    has_non_tz_byte = (in_host & ~tz_char).any(dim=1)
    first_host = _at(iota, host_s, bb)
    humble_first = ((first_host >= ord("a")) & (first_host <= ord("z"))) | (
        (first_host >= ord("0")) & (first_host <= ord("9")))
    host_len = host_e - host_s

    def _literal_at(text: bytes):
        pat = bb == text[0]
        for k, ch in enumerate(text[1:], start=1):
            pat &= _shift_left(bb, k, 0) == ch
        return (pat & (iota == host_s[:, None])).any(dim=1) & (
            host_len == len(text))

    is_tz_alias = _literal_at(b"localtime") | _literal_at(b"posixrules")
    ok &= has_non_tz_byte | (humble_first & ~is_tz_alias)

    days = _days_from_civil(year, month, day)
    sod = hour * 3600 + minute * 60 + sec
    zero = torch.zeros_like(sod)
    out = {
        "ok": ok, "has_pri": has_pri,
        "has_high": ((bb >= 128) & valid).any(dim=1),
        "facility": pri >> 3, "severity": pri & 7,
        "days": days, "sod": sod, "off": zero, "nanos": zero,
        "host_start": host_s, "host_end": host_e, "msg_start": msg_start,
    }
    return {k: v.to(torch.bool if k in _BOOL_KEYS else torch.int32)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# submit / fetch (kernel on CUDA tensors, plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _decode_on(batch, lens, year: int):
    """The decode of one batch, left on its device: the CUDA kernel's
    packed ``[C, N]`` int32 tensor for a CUDA batch, the plain version's
    channel dict for a CPU batch."""
    if batch.is_cuda:
        from .kernels import decode_rfc3164_cuda

        return decode_rfc3164_cuda(batch, lens, year)
    return decode_rfc3164(batch, lens, year)


def decode_rfc3164_submit(batch: torch.Tensor, lens: torch.Tensor,
                          year: Optional[int] = None):
    """Launch the decode of one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_rfc3164_fetch`.  ``year`` defaults
    to the current UTC year, read at this call.  The handle keeps the
    batch for the device encode tier (``device_rfc3164``)."""
    from ..utils.timeparse import current_year_utc

    lens = lens.to(torch.int32)
    if year is None:
        year = current_year_utc()
    return (_decode_on(batch, lens, year), batch, lens)


def decode_rfc3164_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels."""
    out = handle[0]
    if isinstance(out, torch.Tensor):
        # one device-to-host copy of the packed channels, split on the host
        out = unpack_channels(out.cpu())
    return {k: v.cpu().numpy() for k, v in out.items()}
