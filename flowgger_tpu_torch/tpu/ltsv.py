r"""Columnar LTSV decode over a packed ``[N, L]`` uint8 batch.

Scalar spec: flowgger_tpu_torch/decoders/ltsv.py (reference
ltsv_decoder.rs:23-267).  Line shape: tab-separated ``key:value`` parts;
special keys time/host/message/level; everything else becomes a pair
(typed by the host-side schema).

What the decode computes for each row, as the JAX package's jnp
``decode_ltsv`` does (flowgger_tpu/tpu/ltsv.py:68):

- the tab ordinals split the row into parts; the span of each of the
  first ``max_parts`` parts, and its first ``:``, come from the
  reference's packed-sum extraction (``extract_by_ord``);
- the special keys are found where ``time:``, ``host:``, ``message:`` or
  ``level:`` starts a part; the last occurrence wins (the scalar decoder
  overwrites), and its value runs to its part's end;
- ``level`` parses as an int; a value over 7 or with other bytes flags
  the row (the oracle gives the exact error text);
- ``time`` (optionally ``[...]``-wrapped) parses on the device in two
  forms: RFC3339 (``ts_kind`` 0, with ``days`` / ``sod`` / ``off`` /
  ``nanos`` as the rfc5424 decode gives them) and a decimal unix float
  (``ts_kind`` 1), parsed exactly as split integers: ``ts_hi`` and
  ``ts_lo`` hold nine digits each, ``ts_meta`` packs
  ``frac_digits | n_digits << 8 | has_sign << 16``, and the host combines
  them in float64 (``device_ltsv.ts_vals_ltsv``); any other form (the
  Apache ``[10/Oct/2000:13:55:36 -0700]`` one included) is ``ts_kind`` 2
  and flags the row.

Every channel is defined on every row, flagged rows included, with the
reference's int32 arithmetic (its wrapping sums included).

Two implementations of one contract:

- :func:`decode_ltsv` — plain PyTorch, translated from the JAX function;
  the CPU tests hold it channel for channel against it;
- the hand-written CUDA kernel L1 (``csrc/decode_ltsv.cu`` through
  ``tpu/kernels.py``), one warp a row; :func:`decode_ltsv_submit`
  launches it for a batch on a CUDA device and takes the plain version
  only for a batch that lies on the CPU.

Returned spans are byte offsets relative to each row.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .rfc5424 import (_days_from_civil, _days_in_month, _extract,
                      _shift_left, _shift_right, _wrap32)

DEFAULT_MAX_PARTS = 24

# channel rows of the kernel's packed [C, N] int32 output: the row
# channels, then each part channel as DEFAULT_MAX_PARTS rows
KEYS_1D = ("ok", "has_high", "n_parts", "time_pos", "host_pos", "msg_pos",
           "level_pos", "host_start", "host_end", "msg_start", "msg_end",
           "level_val", "ts_kind", "ts_start", "ts_end", "days", "sod",
           "off", "nanos", "ts_hi", "ts_lo", "ts_meta")
KEYS_PART = ("part_start", "part_end", "colon_pos")
_BOOL_KEYS = ("ok", "has_high")
_SPECIALS = ((b"time", "time_pos"), (b"host", "host_pos"),
             (b"message", "msg_pos"), (b"level", "level_pos"))


def n_channels(max_parts: int = DEFAULT_MAX_PARTS) -> int:
    """Rows of the kernel's packed channel-major output."""
    return len(KEYS_1D) + len(KEYS_PART) * max_parts


def unpack_channels(packed: torch.Tensor,
                    max_parts: int = DEFAULT_MAX_PARTS
                    ) -> Dict[str, torch.Tensor]:
    """Channel dict from the kernel's ``[C, N]`` int32 output (rows in
    :data:`KEYS_1D` order, then each of :data:`KEYS_PART` as
    ``max_parts`` rows); the dtypes match :func:`decode_ltsv`."""
    out = {k: packed[i].to(torch.bool if k in _BOOL_KEYS else torch.int32)
           for i, k in enumerate(KEYS_1D)}
    i = len(KEYS_1D)
    for k in KEYS_PART:
        out[k] = packed[i:i + max_parts].t().contiguous()
        i += max_parts
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _scan_ordinals(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count of a bool channel along the row."""
    return torch.cumsum(mask.to(torch.int64), dim=1)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=1).values


def _min_where(mask, values, notfound: int):
    return torch.where(mask, values, notfound).amin(dim=1)


def _match_at(bb: torch.Tensor, text: bytes, valid: torch.Tensor):
    """Does ``text`` start at each position (shifted byte planes; bytes
    past the row read 0)."""
    m = (bb == text[0]) & valid
    for i, ch in enumerate(text[1:], start=1):
        m &= _shift_left(bb, i, 0) == ch
    return m


def decode_ltsv(batch: torch.Tensor, lens: torch.Tensor,
                max_parts: int = DEFAULT_MAX_PARTS,
                n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Decode a packed ``[N, L]`` uint8 batch with plain tensor ops: the
    channels, dtypes and values of the JAX package's ``decode_ltsv`` on
    every row.  With ``n``, the rows at and past it (padding) decode as
    empty rows, whatever they hold: the values the reference gives a
    padding row of length 0.  Integer work is int64, each reduction that
    wraps in the reference's int32 wrapped the same way."""
    N, L = batch.shape
    dev = batch.device
    i64 = torch.int64
    lens = lens.to(i64)
    if n is not None:
        lens = torch.where(torch.arange(N, device=dev) < n, lens, 0)
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lens[:, None]
    bb = torch.where(valid, batch.to(i64), 0)
    is_digit = (bb >= 48) & (bb <= 57)
    dig = bb - 48

    is_tab = (bb == 9) & valid
    tab_ord = _scan_ordinals(is_tab)
    n_tabs = torch.where(is_tab, tab_ord, 0).amax(dim=1)
    n_parts = n_tabs + 1
    ok = n_parts <= max_parts

    tab_pos = _extract(is_tab, tab_ord, iota, max_parts - 1, L)
    part_end = torch.cat([torch.minimum(tab_pos, lens[:, None]),
                          lens[:, None]], dim=1)
    part_start = torch.cat([torch.zeros_like(lens)[:, None],
                            torch.minimum(tab_pos + 1, lens[:, None])], dim=1)

    # first ':' of each part: the last tab-or-colon before it is a tab
    # (or the line start)
    is_colon = (bb == ord(":")) & valid
    tag = torch.where(is_tab, 2 * iota + 1,
                      torch.where(is_colon, 2 * iota, -1))
    last_tc = _shift_right(_cummax(tag), 1, -1)
    first_colon = is_colon & ((last_tc & 1) == 1)
    part_of = tab_ord
    colon_pos = _extract(first_colon, part_of + 1, iota, max_parts, L)
    has_colon = colon_pos < part_end

    # ---- special keys at part starts; the last occurrence wins ----------
    at_part_start = (iota == 0) | _shift_right(is_tab, 1, False)
    tbits = int(L + 1).bit_length()
    pos_part = (iota << tbits) | part_of
    krange = torch.arange(max_parts, dtype=i64, device=dev)
    spec = {}
    for key, name in _SPECIALS:
        pat = _match_at(bb, key + b":", valid) & at_part_start
        w = torch.where(pat, pos_part, -1).amax(dim=1)
        pos = torch.where(w >= 0, w >> tbits, -1)
        pidx = torch.where(w >= 0, w & ((1 << tbits) - 1), 0)
        # [value start, part end): the value always runs to its part's end
        vend = torch.where(krange[None, :] == pidx[:, None], part_end,
                           0).sum(dim=1)
        spec[name] = (pos, pos + len(key) + 1,
                      torch.where(pos >= 0, vend, -1))
    time_pos, time_start, time_end = spec["time_pos"]
    host_pos, host_start, host_end = spec["host_pos"]
    msg_pos, msg_start, msg_end = spec["msg_pos"]
    level_pos, level_start, level_end = spec["level_pos"]

    has_time = time_pos >= 0
    ok &= has_time & (host_pos >= 0)  # missing -> oracle for the error
    tv_len = time_end - time_start

    # ---- level parse ----------------------------------------------------
    has_level = level_pos >= 0
    lv_r = iota - level_start[:, None]
    lv_len = level_end - level_start
    in_lv = (lv_r >= 0) & (lv_r < lv_len[:, None]) & has_level[:, None]
    lv_digits_ok = ~(in_lv & ~is_digit).any(dim=1)
    lv_w = torch.where(lv_r >= 0,
                       10 ** torch.clamp(lv_len[:, None] - 1 - lv_r, 0, 8), 0)
    level_val = _wrap32(torch.where(in_lv, dig * lv_w, 0).sum(dim=1))
    lv_ok = ~has_level | (lv_digits_ok & (lv_len >= 1) & (lv_len <= 3)
                          & (level_val <= 7))
    ok &= lv_ok

    # ---- time parse -----------------------------------------------------
    def byte_at(pos):
        return torch.where(iota == pos[:, None], bb, 0).sum(dim=1)

    t_first = torch.where(has_time, byte_at(time_start), 0)
    t_second = torch.where(has_time, byte_at(time_start + 1), 0)
    t_last = torch.where(has_time, byte_at(time_end - 1), 0)
    bracketed = (t_first == ord("[")) & (t_last == ord("]")) & (tv_len >= 2)
    ts_s = torch.where(bracketed, time_start + 1, time_start)
    ts_e = torch.where(bracketed, time_end - 1, time_end)
    tlen = ts_e - ts_s

    r = iota - ts_s[:, None]
    in_t = (r >= 0) & (r < tlen[:, None])

    # float form: [+-]? digits [. digits]
    c0 = torch.where(bracketed, t_second, t_first)
    has_sign = (c0 == ord("+")) | (c0 == ord("-"))
    body_from = has_sign.to(i64)
    is_dot = in_t & (bb == ord("."))
    dot_pos = _min_where(is_dot, r, 1 << 20)
    n_dots = is_dot.sum(dim=1)
    float_viol = ((in_t & (r >= body_from[:, None]) & (r != dot_pos[:, None])
                   & ~is_digit)
                  | (in_t & (r == body_from[:, None]) & (bb == ord("."))))
    float_ok = (~float_viol.any(dim=1) & (n_dots <= 1) & (tlen >= 1)
                & (tlen - body_from >= 1))

    # the exact split-integer parse of the float span
    has_dot = n_dots == 1
    nd_digits = tlen - body_from - has_dot.to(i64)
    frac_digits = torch.where(has_dot, tlen - 1 - dot_pos, 0)
    di = r - body_from[:, None] - (r > dot_pos[:, None]).to(i64)
    place = nd_digits[:, None] - 1 - di
    dig_m = (in_t & is_digit & (r >= body_from[:, None])
             & (r != dot_pos[:, None]))
    lo_w = torch.where(dig_m & (place >= 0) & (place <= 8),
                       10 ** torch.clamp(place, 0, 8), 0)
    hi_w = torch.where(dig_m & (place >= 9) & (place <= 17),
                       10 ** torch.clamp(place - 9, 0, 8), 0)
    ts_lo = _wrap32((dig * lo_w).sum(dim=1))
    ts_hi = _wrap32((dig * hi_w).sum(dim=1))
    ts_meta = (torch.clamp(frac_digits, 0, 255)
               | (torch.clamp(nd_digits, 0, 255) << 8)
               | (has_sign.to(i64) << 16))

    # rfc3339 form: packed 8/14-bit digit fields, as the reference sums
    # them (non-digit bytes count as their byte - 48)
    dz = torch.where(in_t, dig, 0)

    def at(k):
        return (r == k).to(i64)

    w_mdhm = (at(5) * 10 + at(6) + ((at(8) * 10 + at(9)) << 8)
              + ((at(11) * 10 + at(12)) << 16)
              + ((at(14) * 10 + at(15)) << 24))
    wm = _wrap32((dz * w_mdhm).sum(dim=1))
    month = wm & 255
    day = (wm >> 8) & 255
    hour = (wm >> 16) & 255
    minute = (wm >> 24) & 255
    w_ys = (at(0) * 1000 + at(1) * 100 + at(2) * 10 + at(3)
            + ((at(17) * 10 + at(18)) << 14))
    wy = _wrap32((dz * w_ys).sum(dim=1))
    year = wy & 16383
    sec = (wy >> 14) & 255
    digit_off = ((r >= 0) & (r <= 18) & (r != 4) & (r != 7) & (r != 10)
                 & (r != 13) & (r != 16))
    viol_mask = in_t & digit_off & ~is_digit
    viol_mask |= in_t & ((r == 4) | (r == 7)) & (bb != ord("-"))
    viol_mask |= in_t & (r == 10) & (bb != ord("T")) & (bb != ord("t"))
    viol_mask |= in_t & ((r == 13) | (r == 16)) & (bb != ord(":"))
    has_frac = torch.where(in_t & (r == 19), bb, 0).sum(dim=1) == ord(".")
    rd = r - 20
    frac_run = _min_where(in_t & (rd >= 0) & (rd < 10) & ~is_digit, rd, 10)
    frac_run = torch.minimum(frac_run, torch.clamp(tlen - 20, min=0))
    frac_len = torch.where(has_frac, frac_run, 0)
    w_frac = torch.where((rd >= 0) & (rd <= 8),
                         10 ** torch.clamp(8 - rd, 0, 8), 0)
    nanos = _wrap32(torch.where(in_t & (rd >= 0) & (rd < frac_len[:, None]),
                                dig * w_frac, 0).sum(dim=1))
    opos = torch.where(has_frac, 20 + frac_len, 19)
    r2 = r - opos[:, None]
    oc = torch.where(in_t & (r2 == 0), bb, 0).sum(dim=1)
    is_zulu = (oc == ord("Z")) | (oc == ord("z"))
    is_num_off = (oc == ord("+")) | (oc == ord("-"))
    off_ok = torch.where(is_zulu, tlen == opos + 1, True)
    viol_mask |= (in_t & ((r2 == 1) | (r2 == 2) | (r2 == 4) | (r2 == 5))
                  & ~is_digit & is_num_off[:, None])
    viol_mask |= in_t & (r2 == 3) & (bb != ord(":")) & is_num_off[:, None]
    struct_viol = viol_mask.any(dim=1)
    w_ohm = _wrap32((dz * ((r2 == 1).to(i64) * 10 + (r2 == 2).to(i64)
                           + (((r2 == 4).to(i64) * 10 + (r2 == 5).to(i64))
                              << 8))).sum(dim=1))
    oh = w_ohm & 255
    om = (w_ohm >> 8) & 255
    off_ok &= torch.where(is_num_off,
                          (tlen == opos + 6) & (oh <= 23) & (om <= 59), True)
    rfc_ok = ((tlen >= 20) & ~struct_viol & (is_zulu | is_num_off) & off_ok
              & (month >= 1) & (month <= 12) & (day >= 1)
              & (day <= _days_in_month(year, month))
              & (hour <= 23) & (minute <= 59) & (sec <= 59)
              & torch.where(has_frac, (frac_len >= 1) & (frac_len <= 9),
                            True))
    off_secs = torch.where(is_num_off,
                           torch.where(oc == ord("-"), -1, 1)
                           * (oh * 3600 + om * 60), 0)
    days = _days_from_civil(year, month, day)
    sod = hour * 3600 + minute * 60 + sec

    # ts_kind: 0 = rfc3339, 1 = float span, 2 = neither (oracle row)
    ts_kind = torch.where(rfc_ok, 0, torch.where(float_ok, 1, 2))
    ok &= ts_kind < 2

    out = {
        "ok": ok,
        "has_high": ((bb >= 128) & valid).any(dim=1),
        "n_parts": n_parts,
        "part_start": part_start,
        "part_end": part_end,
        "colon_pos": torch.where(has_colon, colon_pos, -1),
        "time_pos": time_pos, "host_pos": host_pos,
        "msg_pos": msg_pos, "level_pos": level_pos,
        "host_start": host_start, "host_end": host_end,
        "msg_start": msg_start, "msg_end": msg_end,
        "level_val": torch.where(has_level, level_val, -1),
        "ts_kind": ts_kind,
        "ts_start": ts_s, "ts_end": ts_e,
        "days": days, "sod": sod, "off": off_secs, "nanos": nanos,
        "ts_hi": ts_hi, "ts_lo": ts_lo, "ts_meta": ts_meta,
    }
    return {k: v.to(torch.bool if k in _BOOL_KEYS else torch.int32)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# submit / fetch (kernel on CUDA tensors, plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _decode_on(batch: torch.Tensor, lens: torch.Tensor,
              n: Optional[int] = None):
    """The decode of one batch, left on its device: the CUDA kernel's
    packed ``[C, N]`` int32 tensor for a CUDA batch, the plain version's
    channel dict for a CPU batch.  Rows at and past ``n`` (default: none)
    are padding."""
    if batch.is_cuda:
        from .kernels import decode_ltsv_cuda

        return decode_ltsv_cuda(batch, lens, batch.shape[0] if n is None
                                else n)
    return decode_ltsv(batch, lens, n=n)


def decode_ltsv_submit(batch: torch.Tensor, lens: torch.Tensor,
                       n: Optional[int] = None):
    """Launch the decode of one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_ltsv_fetch`.  The handle keeps the
    batch for the device encode tier (``device_ltsv``)."""
    lens = lens.to(torch.int32)
    return (_decode_on(batch, lens, n), batch, lens)


def decode_ltsv_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels."""
    out = handle[0]
    if isinstance(out, torch.Tensor):
        # one device-to-host copy of the packed channels, split on the host
        out = unpack_channels(out.cpu())
    return {k: v.cpu().numpy() for k, v in out.items()}
