r"""Columnar RFC5424 decoder over a packed ``[N, L]`` uint8 batch.

Grammar recap (scalar spec: flowgger_tpu_torch/decoders/rfc5424.py):
``[BOM]<PRI>1 TS HOST APP PROCID MSGID ( - | [id k="v" ...]+ ) [msg]``

Two implementations of one contract live side by side:

- :func:`decode_rfc5424` — plain PyTorch tensor code, translated from the
  JAX package's ``decode_rfc5424`` body.  It runs on any device; the CPU
  tests hold it channel for channel against the JAX function, and the
  chip smoke run holds the CUDA kernel against it on the card.
- the hand-written CUDA kernel (``csrc/decode_rfc5424.cu`` through
  ``tpu/kernels.py``), which evaluates the same per-row definitions as a
  sequential loop per row.  :func:`decode_rfc5424_submit` launches it for
  a batch on a CUDA device and takes the plain version only for a batch
  that lies on the CPU.

The definitions are the vectorized ones, not a state machine: every
channel is "the value at the k-th masked position" or a masked row
reduction, so both implementations agree on every row, rejected rows
included.  Extraction follows the reference's bit-packed ``sum`` form
exactly — several ordinals share one wrapping int32 word, so a multi-hit
ordinal on a malformed row carries into its neighbour the same way it
does in the JAX package.  Any deviation from the fast-path grammar
(bogus quotes, empty PRI, nil timestamps, more than ``max_sd`` blocks or
``max_pairs`` pairs, a backslash run of ``ESC_RUN_CAP`` or more feeding
a quote, ...) sets ``ok=False`` for that row only; the host re-runs the
scalar oracle on it.

Returned spans are byte offsets relative to each row.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DEFAULT_MAX_LEN = 512
DEFAULT_MAX_SD = 4
# two-tier pair budget: the common-case kernel extracts 6 pairs; rows
# with more pairs re-dispatch to the 16-pair instantiation, and only rows
# beyond the rescue budget fall back to the scalar oracle
DEFAULT_MAX_PAIRS = 6
RESCUE_MAX_PAIRS = 16
# backslash runs of >= ESC_RUN_CAP feeding a quote send the row to the
# scalar oracle (the reference's bounded escape-parity ladder)
ESC_RUN_CAP = 16

_KEYS_1D = (
    "ok", "bom", "facility", "severity", "days", "sod", "off", "nanos",
    "host_start", "host_end", "app_start", "app_end", "proc_start",
    "proc_end", "msgid_start", "msgid_end", "msg_start", "sd_count",
    "pair_count", "full_start", "trim_end", "msg_trim_start", "has_high",
)
_KEYS_SD = ("sid_start", "sid_end")
_KEYS_PAIR = ("name_start", "name_end", "val_start", "val_end",
              "pair_sd", "val_has_esc")
_BOOL_KEYS = ("ok", "bom", "val_has_esc", "has_high")
# the reference's jnp tier keeps the pair total in its int16 ordinal type
_INT16_KEYS = ("pair_count",)


def n_channels(max_sd: int, max_pairs: int) -> int:
    """Rows of the kernel's packed channel-major output."""
    return len(_KEYS_1D) + len(_KEYS_SD) * max_sd + len(_KEYS_PAIR) * max_pairs


def _dtype_for(key: str):
    if key in _BOOL_KEYS:
        return torch.bool
    if key in _INT16_KEYS:
        return torch.int16
    return torch.int32


def unpack_channels(packed: torch.Tensor, max_sd: int,
                    max_pairs: int) -> Dict[str, torch.Tensor]:
    """Channel dict from the kernel's ``[C, N]`` int32 output (the
    layout ``csrc/decode_rfc5424.cu`` writes: the 1-D keys, then each
    SD key as ``max_sd`` rows, then each pair key as ``max_pairs``
    rows).  Works on any device; the dtypes match
    :func:`decode_rfc5424`."""
    out = {}
    i = 0
    for k in _KEYS_1D:
        out[k] = packed[i].to(_dtype_for(k))
        i += 1
    for keys, width in ((_KEYS_SD, max_sd), (_KEYS_PAIR, max_pairs)):
        for k in keys:
            out[k] = packed[i:i + width].t().contiguous().to(_dtype_for(k))
            i += width
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 sum reduced to the int32 value the reference's wrapping
    int32 arithmetic produces (kept in int64 for the shifts after it)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x)


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return _wrap32(x.sum(dim=1))


def _shift_right(x, k, fill):
    out = torch.full_like(x, fill)
    out[:, k:] = x[:, :-k]
    return out


def _shift_left(x, k, fill):
    out = torch.full_like(x, fill)
    out[:, :-k] = x[:, k:]
    return out


def _slot_geometry(L: int):
    slot_bits = max(10, int(L + 1).bit_length())
    return slot_bits, max(1, 30 // slot_bits)


def _ordinal_sums(mask, ord_, value, K):
    """[N, K] per-ordinal sums of ``value`` over the masked positions
    with ordinal k+1 (exact int64; ordinals outside 1..K are dropped)."""
    N = mask.shape[0]
    hit = mask & (ord_ >= 1) & (ord_ <= K)
    col = torch.where(hit, ord_ - 1, torch.full_like(ord_, K))
    out = torch.zeros((N, K + 1), dtype=torch.int64, device=mask.device)
    out.scatter_add_(1, col, torch.where(hit, value, torch.zeros_like(value)))
    return out[:, :K]


def _unpack_slots(sums, K, slot_bits, slots):
    """Fold per-ordinal sums into the reference's packed int32 words
    (``slots`` ordinals per word, ``slot_bits`` each, wrapping) and read
    each slot back — so a slot that overflows carries into the next
    exactly as the reference's packed reduction does."""
    mask = (1 << slot_bits) - 1
    cols = []
    for base in range(0, K, slots):
        word = torch.zeros_like(sums[:, 0])
        for s in range(min(slots, K - base)):
            word = word + (sums[:, base + s] << (slot_bits * s))
        word = word & 0xFFFFFFFF
        for s in range(min(slots, K - base)):
            cols.append((word >> (slot_bits * s)) & mask)
    return torch.stack(cols, dim=1)


def _extract(mask, ord_, value, K, fill, slot_bits=None):
    """out[n, k] = ``value`` at the position with ordinal k+1, else
    ``fill`` (the reference's ``extract_by_ord`` in its ``sum`` form)."""
    L = mask.shape[1]
    if slot_bits is None:
        slot_bits, slots = _slot_geometry(L)
    else:
        slots = max(1, 30 // slot_bits)
    v1 = value.clamp(0, (1 << slot_bits) - 2) + 1
    v = _unpack_slots(_ordinal_sums(mask, ord_, v1, K), K, slot_bits, slots)
    return torch.where(v == 0, torch.full_like(v, fill), v - 1)


def _extract_counts(mask, ord_, K):
    """out[n, k] = number of masked positions with ordinal k+1."""
    slot_bits, slots = _slot_geometry(mask.shape[1])
    ones = torch.ones(mask.shape, dtype=torch.int64, device=mask.device)
    return _unpack_slots(_ordinal_sums(mask, ord_, ones, K), K, slot_bits,
                         slots)


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + d - 1
    doe = (yoe * 365 + torch.div(yoe, 4, rounding_mode="floor")
           - torch.div(yoe, 100, rounding_mode="floor") + doy)
    return era * 146097 + doe - 719468


def _days_in_month(y, m):
    is31 = torch.where(m >= 8, (m % 2) == 0, (m % 2) == 1)
    base = torch.where(is31, 31, 30)
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    return torch.where(m == 2, torch.where(leap, 29, 28), base)


def decode_rfc5424(batch: torch.Tensor, lens: torch.Tensor,
                   max_sd: int = DEFAULT_MAX_SD,
                   max_pairs: int = DEFAULT_MAX_PAIRS
                   ) -> Dict[str, torch.Tensor]:
    """Decode a packed ``[N, L]`` uint8 batch with plain tensor ops —
    the same channels, dtypes and values as the JAX package's
    ``decode_rfc5424_jit`` at ``extract_impl="sum"``.  Everything is
    computed in int64 and each wrapping int32 reduction of the reference
    is reproduced with :func:`_wrap32`."""
    N, L = batch.shape
    if L < 4:
        raise ValueError("decode_rfc5424 needs rows of at least 4 bytes")
    dev = batch.device
    i64 = torch.int64
    lens = lens.to(i64)
    lcol = lens[:, None]
    iota = torch.arange(L, dtype=i64, device=dev).expand(N, L)
    valid = iota < lcol
    bb = torch.where(valid, batch.to(i64), torch.zeros((), dtype=i64,
                                                        device=dev))
    is_digit = (bb >= 48) & (bb <= 57)
    dig = bb - 48

    # ---- BOM (rs:57-72) -------------------------------------------------
    bom = (lens >= 3) & (bb[:, 0] == 0xEF) & (bb[:, 1] == 0xBB) \
        & (bb[:, 2] == 0xBF)
    start0 = torch.where(bom, 3, 0).to(i64)
    first_ch = torch.where(bom, bb[:, 3], bb[:, 0])
    ok = first_ch == ord("<")

    # ---- escape parity: the backslash run ending at i-1 --------------------
    is_bs = (bb == 92) & valid
    last_non_bs = torch.cummax(torch.where(is_bs, -1, iota), dim=1).values
    run = iota - last_non_bs                # run length ending at i
    run_prev = _shift_right(run, 1, 0)
    escaped = ((run_prev.clamp(max=ESC_RUN_CAP - 1) & 1) == 1)
    cap_hit = run_prev >= ESC_RUN_CAP

    is_sp = (bb == 32) & valid
    quote = (bb == ord('"')) & valid
    real_q_all = quote & ~escaped
    ok &= ~(cap_hit & quote).any(dim=1)
    sp_ord = torch.cumsum(is_sp.to(i64), dim=1)
    q_incl_all = torch.cumsum(real_q_all.to(i64), dim=1)
    sp = _extract(is_sp, sp_ord, iota, 6, L)
    ok &= sp[:, 5] < L
    f_start = torch.cat([start0[:, None], sp + 1], dim=1)
    f_end = torch.cat([sp, lcol], dim=1)

    # ---- PRI + version (rs:74-92) ---------------------------------------
    gt = torch.where((bb == ord(">")) & (iota > start0[:, None]) & valid,
                     iota, L).min(dim=1).values
    ndig = gt - start0 - 1
    ok &= (gt < f_end[:, 0]) & (ndig >= 1) & (ndig <= 3)
    e = gt[:, None] - 1 - iota
    pri_zone = (iota > start0[:, None]) & (iota < gt[:, None])
    w_pri = torch.where(e == 0, 1, torch.where(e == 1, 10,
                                               torch.where(e == 2, 100, 0)))
    viol = pri_zone & ~is_digit

    # ---- packed field sums (the reference's three int32 words) -----------
    ts_s = f_start[:, 1]
    tlen = f_end[:, 1] - ts_s
    r = iota - ts_s[:, None]
    in_ts = (r >= 0) & (r < tlen[:, None])
    dz = torch.where(in_ts, dig, 0)
    rest_s = f_start[:, 6]

    def flag(cond):
        return cond.to(i64)

    w1 = (dz * (flag(r == 0) * 1000 + flag(r == 1) * 100
                + flag(r == 2) * 10 + flag(r == 3))
          + ((dz * (flag(r == 5) * 10 + flag(r == 6))) << 14)
          + ((dz * (flag(r == 8) * 10 + flag(r == 9))) << 21)
          + (flag(in_ts & (r == 19) & (bb == ord("."))) << 28)
          + (flag((iota == gt[:, None] + 1) & (bb == ord("1"))) << 29))
    word1 = _sum32(w1)
    year = word1 & 0x3FFF
    month = (word1 >> 14) & 0x7F
    day = (word1 >> 21) & 0x7F
    has_frac = ((word1 >> 28) & 1) == 1
    ver_ok = ((word1 >> 29) & 1) == 1

    w2 = (dz * (flag(r == 11) * 10 + flag(r == 12))
          + ((dz * (flag(r == 14) * 10 + flag(r == 15))) << 7)
          + ((dz * (flag(r == 17) * 10 + flag(r == 18))) << 14)
          + (torch.where(pri_zone, dig * w_pri, 0) << 21))
    word2 = _sum32(w2)
    hour = word2 & 0x7F
    minute = (word2 >> 7) & 0x7F
    sec = (word2 >> 14) & 0x7F
    pri = word2 >> 21

    ok &= pri <= 255
    ok &= ver_ok & (f_end[:, 0] == gt + 2)
    facility = pri >> 3
    severity = pri & 7

    digit_off = ((r >= 0) & (r <= 18) & (r != 4) & (r != 7) & (r != 10)
                 & (r != 13) & (r != 16))
    viol |= in_ts & digit_off & ~is_digit
    viol |= in_ts & ((r == 4) | (r == 7)) & (bb != ord("-"))
    viol |= in_ts & (r == 10) & (bb != ord("T")) & (bb != ord("t"))
    viol |= in_ts & ((r == 13) | (r == 16)) & (bb != ord(":"))
    ok &= tlen >= 20
    ok &= (month >= 1) & (month <= 12) & (day >= 1) \
        & (day <= _days_in_month(year, month))
    ok &= (hour <= 23) & (minute <= 59) & (sec <= 59)

    # fractional seconds: the digit run from r == 20
    rd = r - 20
    frac_run = torch.where(in_ts & (rd >= 0) & (rd < 10) & ~is_digit,
                           rd, 10).min(dim=1).values
    frac_run = torch.minimum(frac_run, (tlen - 20).clamp(min=0))
    frac_len = torch.where(has_frac, frac_run, 0)
    ok &= torch.where(has_frac, (frac_len >= 1) & (frac_len <= 9), True)
    w_frac = torch.zeros_like(rd)
    for k in range(9):
        w_frac = w_frac + flag(rd == k) * (10 ** (8 - k))
    in_frac = in_ts & (rd >= 0) & (rd < frac_len[:, None])
    nanos = _sum32(torch.where(in_frac, dig * w_frac, 0))

    # offset zone at r2 = r - opos, plus the single-position flags and
    # (L <= 1023) the high-byte count, packed like the reference's word3
    opos = torch.where(has_frac, 20 + frac_len, 19)
    r2 = r - opos[:, None]
    at_off = in_ts & (r2 == 0)
    at_rest = iota == rest_s[:, None]
    pack_high = L <= 1023
    w3 = (dz * (flag(r2 == 1) * 10 + flag(r2 == 2))
          + ((dz * (flag(r2 == 4) * 10 + flag(r2 == 5))) << 7)
          + (flag(at_off & ((bb == ord("Z")) | (bb == ord("z")))) << 14)
          + (flag(at_off & (bb == ord("+"))) << 15)
          + (flag(at_off & (bb == ord("-"))) << 16)
          + (flag(at_rest & (bb == ord("-"))) << 17)
          + (flag(at_rest & (bb == ord("["))) << 18))
    if pack_high:
        w3 = w3 + (flag((bb >= 128) & valid) << 19)
    word3 = _sum32(w3)
    oh = word3 & 0x7F
    om = (word3 >> 7) & 0x7F
    is_zulu = ((word3 >> 14) & 1) == 1
    neg_off = ((word3 >> 16) & 1) == 1
    is_num_off = ((word3 >> 15) & 3) != 0
    is_dash = ((word3 >> 17) & 1) == 1
    is_sd = ((word3 >> 18) & 1) == 1

    ok &= is_zulu | is_num_off
    ok &= torch.where(is_zulu, tlen == opos + 1, True)
    off_dig = (r2 == 1) | (r2 == 2) | (r2 == 4) | (r2 == 5)
    viol |= in_ts & off_dig & ~is_digit & is_num_off[:, None]
    viol |= in_ts & (r2 == 3) & (bb != ord(":")) & is_num_off[:, None]
    ok &= torch.where(is_num_off,
                      (tlen == opos + 6) & (oh <= 23) & (om <= 59), True)
    off_secs = torch.where(is_num_off,
                           torch.where(neg_off, -1, 1) * (oh * 3600 + om * 60),
                           0)
    days = _days_from_civil(year, month, day)
    sod = hour * 3600 + minute * 60 + sec

    # ---- structured data (field 6 / "rest") ------------------------------
    ok &= rest_s < lens
    ok &= is_dash | is_sd
    in_rest = (iota >= rest_s[:, None]) & valid

    # quote parity relative to the rest zone
    q_before_rest = torch.where(valid & (iota < rest_s[:, None]),
                                q_incl_all, 0).max(dim=1).values
    q_excl = q_incl_all - real_q_all.to(i64) - q_before_rest[:, None]
    real_q = real_q_all & in_rest
    outside = (q_excl & 1) == 0
    open_q = real_q & outside
    close_q = real_q & ~outside

    prev_bb = _shift_right(bb, 1, 0)
    next_bb = _shift_left(bb, 1, 0)
    is_name = ((bb >= 33) & (bb <= 126) & (bb != 34) & (bb != 61)
               & (bb != 93))

    # structural ']' chain: pos << 3 | {legal end, next '[', next ' '}
    prev_closeq = _shift_right(close_q, 1, False)
    rbrack = (bb == ord("]")) & outside & in_rest
    next_valid = _shift_left(valid, 1, False)
    rb_payload = (flag((prev_bb == 32) | prev_closeq)
                  + flag((next_bb == ord("[")) & next_valid) * 2
                  + flag((next_bb == 32) & next_valid) * 4)
    rb_ord = torch.cumsum(rbrack.to(i64), dim=1)
    oq_ord = (q_excl >> 1) + 1
    cq_ord = (q_excl + 1) >> 1
    rb_sb = (((L << 3) | 7) + 1).bit_length()
    rb_word = _extract(rbrack, rb_ord, (iota << 3) | rb_payload, max_sd + 1,
                       L << 3, slot_bits=rb_sb)
    rb_pos = rb_word >> 3
    rb_flags = rb_word & 7
    rb_found = rb_pos < L

    term_col = rb_found & (((rb_flags & 4) != 0) | (rb_pos == (lens - 1)[:, None]))
    sd_end_zone = torch.where(term_col, rb_pos, L).min(dim=1).values
    zone_c = in_rest & (iota <= sd_end_zone[:, None]) & is_sd[:, None]
    oq_mask = open_q & zone_c
    cq_mask = close_q & zone_c

    chain_alive = ((rb_flags[:, :max_sd] & 2) != 0) & rb_found[:, :max_sd]
    sd_count_raw = torch.ones_like(lens)
    alive = chain_alive[:, 0]
    for k in range(max_sd):
        sd_count_raw = sd_count_raw + alive.to(i64)
        if k + 1 < max_sd:
            alive = alive & chain_alive[:, k + 1]
    sd_count = torch.where(is_sd, sd_count_raw, 0)
    last_idx = (sd_count - 1).clamp(0, max_sd)
    sd_end = rb_pos[:, 0]
    end_flags = rb_flags[:, 0]
    for k in range(1, max_sd + 1):
        sel = last_idx == k
        sd_end = torch.where(sel, rb_pos[:, k], sd_end)
        end_flags = torch.where(sel, rb_flags[:, k], end_flags)
    ok &= torch.where(is_sd, (sd_count_raw <= max_sd) & (sd_end < L), True)

    blk_start = torch.cat([rest_s[:, None], rb_pos[:, :max_sd - 1] + 1],
                          dim=1)
    sd_axis = torch.arange(max_sd, device=dev)[None, :]
    blk_idx_valid = sd_axis < sd_count[:, None]
    blk_rb = rb_pos[:, :max_sd]
    rb_legal = (rb_flags[:, :max_sd] & 1) != 0
    ok &= torch.where(is_sd, torch.where(blk_idx_valid, rb_legal, True)
                      .all(dim=1), True)

    sid_start = blk_start + 1
    prev_sp = _shift_right(is_sp, 1, False)
    sid_sp_mask = is_sp & outside & zone_c & ~prev_closeq & ~prev_sp
    sid_end = _extract(sid_sp_mask, rb_ord + 1, iota, max_sd, L)
    ok &= torch.where(is_sd, torch.where(blk_idx_valid, sid_end < blk_rb,
                                         True).all(dim=1), True)

    in_pair = torch.zeros((N, L), dtype=torch.bool, device=dev)
    for k in range(max_sd):
        in_pair |= ((iota > sid_end[:, k:k + 1]) & (iota < blk_rb[:, k:k + 1])
                    & blk_idx_valid[:, k:k + 1])
    in_pair &= is_sd[:, None]
    sd_zone = in_rest & (iota <= sd_end[:, None]) & is_sd[:, None]

    viol |= open_q & sd_zone & (prev_bb != ord("="))
    name_struct = is_name & outside & in_pair
    prev_name = _shift_right(name_struct, 1, False)
    next_name = _shift_left(name_struct, 1, False)
    ns_mask = name_struct & ~prev_name
    name_run_end = name_struct & ~next_name
    viol |= name_run_end & (next_bb != ord("="))
    viol |= ns_mask & (prev_bb != 32)
    eq_struct = (bb == ord("=")) & outside & in_pair
    next_open = _shift_left(open_q & in_pair, 1, False)
    viol |= eq_struct & ~next_open
    viol |= real_q & sd_zone & ~in_pair

    # ---- pair extraction -------------------------------------------------
    pair_total = torch.where(oq_mask, oq_ord, 0).max(dim=1).values
    pair_count = torch.where(is_sd, pair_total, 0)
    ok &= torch.where(is_sd, pair_count <= max_pairs, True)

    oq_pos = _extract(oq_mask, oq_ord, iota, max_pairs, L)
    cq_pos = _extract(cq_mask, cq_ord, iota, max_pairs, L)
    inside_val = (q_excl & 1) == 1
    val_esc_count = _extract_counts(is_bs & inside_val, oq_ord, max_pairs)
    pair_valid = (torch.arange(max_pairs, device=dev)[None, :]
                  < pair_count[:, None])
    ns_pos = _extract(ns_mask, oq_ord, iota, max_pairs, L)
    name_start = torch.where(pair_valid, ns_pos, 0)
    ok &= torch.where(pair_valid, ns_pos <= oq_pos - 2, True).all(dim=1)
    ok &= torch.where(pair_valid, cq_pos > oq_pos, True).all(dim=1)
    name_end = oq_pos - 1

    pair_sd = -torch.ones_like(oq_pos)
    for k in range(max_sd):
        pair_sd = pair_sd + (blk_start[:, k:k + 1] <= oq_pos).to(i64)
    pair_sd = torch.where(pair_valid, pair_sd.clamp(0, max_sd - 1), 0)
    val_has_esc = (val_esc_count > 0) & pair_valid & (cq_pos > oq_pos + 1)

    # ---- message span ----------------------------------------------------
    after_sd_pos = sd_end + 1
    sd_msg_ok = (after_sd_pos < lens) & ((end_flags & 4) != 0)
    ok &= torch.where(is_sd, sd_msg_ok, True)
    msg_start = torch.where(is_dash, rest_s + 1, after_sd_pos)

    # ---- host-assembly aux channels --------------------------------------
    is_ws = ((bb >= 9) & (bb <= 13)) | ((bb >= 28) & (bb <= 32))
    non_ws = valid & ~is_ws
    trim_end = torch.maximum(torch.where(non_ws, iota + 1, 0)
                             .max(dim=1).values, start0)
    msg_a = torch.where(non_ws & (iota >= msg_start[:, None]), iota, L) \
        .min(dim=1).values
    msg_trim_start = torch.minimum(msg_a, trim_end)
    if pack_high:
        has_high = ((word3 >> 19) & 0x3FF) > 0
    else:
        has_high = ((bb >= 128) & valid).any(dim=1)
    ok &= ~viol.any(dim=1)

    out = {
        "ok": ok, "bom": bom, "facility": facility, "severity": severity,
        "days": days, "sod": sod, "off": off_secs, "nanos": nanos,
        "host_start": f_start[:, 2], "host_end": f_end[:, 2],
        "app_start": f_start[:, 3], "app_end": f_end[:, 3],
        "proc_start": f_start[:, 4], "proc_end": f_end[:, 4],
        "msgid_start": f_start[:, 5], "msgid_end": f_end[:, 5],
        "msg_start": msg_start, "sd_count": sd_count,
        "sid_start": sid_start, "sid_end": sid_end,
        "pair_count": pair_count,
        "name_start": name_start, "name_end": name_end,
        "val_start": oq_pos + 1, "val_end": cq_pos,
        "pair_sd": pair_sd, "val_has_esc": val_has_esc,
        "full_start": start0, "trim_end": trim_end,
        "msg_trim_start": msg_trim_start, "has_high": has_high,
    }
    return {k: v.to(_dtype_for(k)) for k, v in out.items()}


# ---------------------------------------------------------------------------
# submit / fetch (kernel on CUDA tensors, plain version on CPU tensors)
# ---------------------------------------------------------------------------

def _decode_on(batch, lens, max_sd, max_pairs):
    """The decode of one batch, left on its device: the CUDA kernel's
    packed ``[C, N]`` int32 tensor for a CUDA batch, the plain version's
    channel dict for a CPU batch."""
    if batch.is_cuda:
        from .kernels import decode_rfc5424_cuda

        return decode_rfc5424_cuda(batch, lens, max_sd=max_sd,
                                   max_pairs=max_pairs)
    return decode_rfc5424(batch, lens, max_sd=max_sd, max_pairs=max_pairs)


def _to_host(res, max_sd, max_pairs) -> Dict[str, np.ndarray]:
    if isinstance(res, dict):
        return {k: v.cpu().numpy() for k, v in res.items()}
    # one device-to-host copy of the packed channels, split on the host
    return {k: v.numpy() for k, v in
            unpack_channels(res.cpu(), max_sd, max_pairs).items()}


def decode_rfc5424_submit(batch: torch.Tensor, lens: torch.Tensor,
                          max_sd: int = DEFAULT_MAX_SD):
    """Launch the decode for one packed batch (asynchronous on a CUDA
    device); pair with :func:`decode_rfc5424_fetch`.  The handle keeps
    the batch so the fetch can re-dispatch pair-overflow rows."""
    lens = lens.to(torch.int32)
    out = _decode_on(batch, lens, max_sd, DEFAULT_MAX_PAIRS)
    return (out, batch, lens, max_sd)


def rescue_refetch(host, batch, lens, rows_idx, field_keys, dispatch,
                   width):
    """Tier-2 rescue: re-dispatch ``rows_idx`` through a wider kernel
    (``dispatch(sub_batch, sub_lens) -> host dict``) and merge the
    results back; per-field channels in ``field_keys`` widen to
    ``width``.  The sub-batch is gathered on the batch's own device."""
    if not rows_idx.size:
        return host
    rows = 256
    while rows < rows_idx.size:
        rows <<= 1
    idx = torch.as_tensor(rows_idx, dtype=torch.int64, device=batch.device)
    sub_b = torch.zeros((rows, batch.shape[1]), dtype=torch.uint8,
                        device=batch.device)
    sub_l = torch.zeros(rows, dtype=lens.dtype, device=batch.device)
    sub_b[:rows_idx.size] = batch.index_select(0, idx)
    sub_l[:rows_idx.size] = lens.index_select(0, idx)
    host2 = dispatch(sub_b, sub_l)
    merged = {}
    for k, v in host.items():
        if k in field_keys:
            wide = np.zeros((v.shape[0], width), dtype=v.dtype)
            wide[:, :v.shape[1]] = v
            wide[rows_idx] = host2[k][:rows_idx.size]
            merged[k] = wide
        else:
            v = v.copy()
            v[rows_idx] = host2[k][:rows_idx.size]
            merged[k] = v
    return merged


def decode_rfc5424_fetch(handle) -> Dict[str, np.ndarray]:
    """Wait for a submitted decode and return host numpy channels,
    re-dispatching pair-overflow rows (DEFAULT_MAX_PAIRS < pairs <=
    RESCUE_MAX_PAIRS) through the 16-pair kernel; pair channels come
    back widened to RESCUE_MAX_PAIRS when any row needed it."""
    out, batch, lens, max_sd = handle
    host = _to_host(out, max_sd, DEFAULT_MAX_PAIRS)
    pc = host["pair_count"]
    over = np.flatnonzero((pc > DEFAULT_MAX_PAIRS) & (pc <= RESCUE_MAX_PAIRS))

    def dispatch(sub_b, sub_l):
        return _to_host(_decode_on(sub_b, sub_l, max_sd, RESCUE_MAX_PAIRS),
                        max_sd, RESCUE_MAX_PAIRS)

    return rescue_refetch(host, batch, lens, over, _KEYS_PAIR, dispatch,
                          RESCUE_MAX_PAIRS)


def decode_rfc5424_wide(handle):
    """The whole batch of a submitted decode decoded again at
    RESCUE_MAX_PAIRS, left on its device (the device encode tier's pair
    escalation)."""
    _, batch, lens, max_sd = handle
    return _decode_on(batch, lens, max_sd, RESCUE_MAX_PAIRS)


def decode_rfc5424_host(batch, lens, max_sd: int = DEFAULT_MAX_SD):
    """Synchronous submit + fetch."""
    return decode_rfc5424_fetch(decode_rfc5424_submit(batch, lens, max_sd))
