// The LTSV row decode of kernel L1 (decode_ltsv.cu), one warp a row: the
// device function shared by L1 and the fused ltsv -> GELF route
// (fused_gelf.cu).
//
// It computes the channels of the JAX package's jnp decode_ltsv
// (flowgger_tpu/tpu/ltsv.py:68) for one row, on every row, rejected rows
// included, with the reference's int32 arithmetic (its wrapping sums too):
// - one warp pass over the row's valid bytes, 32 positions a step: tab
//   and colon ballots give each tab its ordinal (popcount prefixes) and
//   each colon whether it is its part's first (the last tab or colon
//   before it is a tab); the first 23 tabs and the first colon of each of
//   the first 24 parts go straight to the part table in the block's
//   channel tile; a lane at a part start matches the four special keys
//   there and keeps the last match of each (position, tabs before it);
// - the level value and the time value are then short warp passes over
//   their spans (per-lane weighted digit sums, reduced with
//   __reduce_add_sync in unsigned, so they wrap as the reference's int32
//   sums do; flags by ballot), and the RFC3339 and float checks read the
//   few fixed positions they need.
// Positions past the row's length read 0, as the reference's zero-masked
// byte plane does; positions past L do not exist (the reference's
// reductions run over the L columns).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace lt {

using namespace fg;

constexpr int kParts = 24;               // DEFAULT_MAX_PARTS

// channel rows of the packed output (tpu/ltsv.py KEYS_1D, then each of
// KEYS_PART as kParts rows)
enum ChLtsv {
  C_OK, C_HAS_HIGH, C_N_PARTS, C_TIME_POS, C_HOST_POS, C_MSG_POS,
  C_LEVEL_POS, C_HOST_S, C_HOST_E, C_MSG_S, C_MSG_E, C_LEVEL_VAL,
  C_TS_KIND, C_TS_START, C_TS_END, C_DAYS, C_SOD, C_OFF, C_NANOS, C_TS_HI,
  C_TS_LO, C_TS_META, kN1D,
  C_PART_START = kN1D, C_PART_END = kN1D + kParts,
  C_COLON = kN1D + 2 * kParts, kChannels = kN1D + 3 * kParts
};

// 10^e for 0 <= e <= 8
__device__ __forceinline__ unsigned pow10u(int e) {
  unsigned v = 1u;
  for (int i = 0; i < e; ++i) v *= 10u;
  return v;
}

// The channels of a padding row (a row at or past the batch's real rows):
// what the reference's decode gives a row of length 0.
__device__ __forceinline__ void pad_row(int32_t* __restrict__ col,
                                        const int lane) {
  auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
  if (lane < kParts) {
    put(C_PART_START + lane, 0);
    put(C_PART_END + lane, 0);
    put(C_COLON + lane, -1);
  }
  if (lane == 0) {
    for (int ch = 0; ch < kN1D; ++ch) put(ch, 0);
    put(C_N_PARTS, 1);
    put(C_TIME_POS, -1);
    put(C_HOST_POS, -1);
    put(C_MSG_POS, -1);
    put(C_LEVEL_POS, -1);
    put(C_HOST_S, 4);
    put(C_HOST_E, -1);
    put(C_MSG_S, 7);
    put(C_MSG_E, -1);
    put(C_LEVEL_VAL, -1);
    put(C_TS_KIND, 2);
    put(C_TS_START, 4);
    put(C_TS_END, -1);
    put(C_DAYS, days_from_civil(0, 0, 0));
  }
}

// Decodes one row with the calling warp and writes its channel values to
// col[ch * kWarps] (the block's channel tile).  With DEMAND only the
// channels the GELF encode reads are written (the fused route's
// fused_routes.DEMAND["ltsv_gelf"]): no ts_start, ts_end.
template <bool DEMAND = false>
__device__ __forceinline__ void decode_ltsv_row(
    const uint8_t* __restrict__ src, const int len, const int L,
    uint4* __restrict__ stage, int32_t* __restrict__ col, const int lane) {
  const int n = len < L ? (len > 0 ? len : 0) : L;  // valid positions
  stage_row(src, n, L, stage, lane);
  auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
  // the part table's values where no tab or colon sets them: a missing
  // tab's position reads L (the reference's extraction fill)
  if (lane < kParts) {
    const int endL = L < len ? L : len;
    put(C_PART_START + lane, lane == 0 ? 0 : (L + 1 < len ? L + 1 : len));
    put(C_PART_END + lane, lane < kParts - 1 ? endL : len);
    put(C_COLON + lane, (lane == kParts - 1 && L < len) ? L : -1);
  }
  __syncwarp();
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(stage);
  auto B = [&](int i) -> int { return (i >= 0 && i < n) ? rb[i] : 0; };

  // ---- pass 1: tabs, first colons, high bytes, special keys ---------------
  const char* keys[4] = {"time:", "host:", "message:", "level:"};
  const int klen[4] = {5, 5, 8, 6};
  int best[4] = {-1, -1, -1, -1};   // position << 15 | tabs before it
  int tabs = 0;                      // tabs before this step
  bool last_is_tab = true;           // the line start counts as a tab
  bool high = false;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    const int c = valid ? rb[i] : 0;
    const unsigned tb = __ballot_sync(kFull, valid && c == 9);
    const unsigned cb = __ballot_sync(kFull, valid && c == ':');
    const int before = tabs + __popc(tb & lanemask_lt(lane));
    if (valid && c == 9 && before + 1 <= kParts - 1) {
      // the tab of ordinal before + 1 ends part `before`, starts the next
      put(C_PART_END + before, i < len ? i : len);
      put(C_PART_START + before + 1, i + 1 < len ? i + 1 : len);
    }
    if (valid && c == ':') {
      const unsigned prior = (tb | cb) & lanemask_lt(lane);
      const bool first = prior ? ((tb >> (31 - __clz((int)prior))) & 1u) != 0
                               : last_is_tab;
      if (first && before < kParts) put(C_COLON + before, i);
    }
    if (tb | cb) last_is_tab = ((tb >> (31 - __clz((int)(tb | cb)))) & 1u) != 0;
    tabs += __popc(tb);
    high = high || c >= 128;
    // a part start: the row's first byte, or one after a tab
    if (valid && (i == 0 || rb[i - 1] == 9)) {
      for (int k = 0; k < 4; ++k) {
        bool m = true;
        for (int q = 0; q < klen[k] && m; ++q) m = B(i + q) == keys[k][q];
        if (m) best[k] = i << 15 | before;
      }
    }
  }
  high = warp_any(high);
  int pos[4], pidx[4];
  for (int k = 0; k < 4; ++k) {
    const int w = warp_max(best[k]);
    pos[k] = w >= 0 ? w >> 15 : -1;
    pidx[k] = w >= 0 ? w & 32767 : 0;
  }
  __syncwarp();
  // [value start, the part's end): the value runs to its part's end
  int vs[4], ve[4];
  for (int k = 0; k < 4; ++k) {
    vs[k] = pos[k] + klen[k];
    ve[k] = pos[k] < 0 ? -1
            : pidx[k] < kParts ? col[(C_PART_END + pidx[k]) * kWarps] : 0;
  }
  const int n_parts = tabs + 1;
  const bool has_time = pos[0] >= 0, has_level = pos[3] >= 0;
  bool ok = n_parts <= kParts && has_time && pos[1] >= 0;

  // ---- level: digits only, 1-3 of them, at most 7 -------------------------
  unsigned lv_sum = 0u;
  bool lv_bad = false;
  const int lv_s = vs[3], lv_e = ve[3], lv_len = lv_e - lv_s;
  if (has_level) {
    for (int b0 = lv_s; b0 < lv_e && b0 < L; b0 += 32) {
      const int p = b0 + lane;
      if (p < lv_e && p < L) {
        const int c = B(p);
        if (!is_digit(c)) lv_bad = true;
        int e = lv_len - 1 - (p - lv_s);
        e = e < 0 ? 0 : e > 8 ? 8 : e;
        lv_sum += (unsigned)(c - 48) * pow10u(e);
      }
    }
  }
  const int level_val = (int)__reduce_add_sync(kFull, lv_sum);
  lv_bad = warp_any(lv_bad);
  ok = ok && (!has_level || (!lv_bad && lv_len >= 1 && lv_len <= 3 &&
                             level_val <= 7));

  // ---- time: an optional [...] wrapper, then the two fast forms -----------
  const int t_s = vs[0], t_e = ve[0];
  const int t_first = has_time ? B(t_s) : 0;
  const int t_second = has_time ? B(t_s + 1) : 0;
  const int t_last = has_time ? B(t_e - 1) : 0;
  const bool bracketed = t_first == '[' && t_last == ']' && t_e - t_s >= 2;
  const int ts_s = bracketed ? t_s + 1 : t_s;
  const int ts_e = bracketed ? t_e - 1 : t_e;
  const int tlen = ts_e - ts_s;
  // a position of the value: r in [0, tlen) and ts_s + r in [0, L)
  auto in_t = [&](int r) { return r >= 0 && r < tlen && ts_s + r < L; };
  auto T = [&](int r) { return in_t(r) ? B(ts_s + r) : 0; };

  // pass T1: the first dot, the dot count, the first non-digit of the
  // RFC3339 fraction (r in [20, 30))
  int dot_pos = 1 << 20, n_dots = 0, frac_stop = 10;
  for (int b0 = 0; b0 < tlen && ts_s + b0 < L; b0 += 32) {
    const int r = b0 + lane;
    const bool in = in_t(r);
    const int c = in ? T(r) : 0;
    const unsigned db = __ballot_sync(kFull, in && c == '.');
    if (db && dot_pos == 1 << 20) dot_pos = b0 + __ffs((int)db) - 1;
    n_dots += __popc(db);
    const unsigned fb =
        __ballot_sync(kFull, in && r >= 20 && r < 30 && !is_digit(c));
    if (fb && frac_stop == 10) frac_stop = b0 + __ffs((int)fb) - 1 - 20;
  }
  const int c0 = bracketed ? t_second : t_first;
  const bool has_sign = c0 == '+' || c0 == '-';
  const int body_from = has_sign ? 1 : 0;
  const bool has_dot = n_dots == 1;
  const int nd_digits = tlen - body_from - (has_dot ? 1 : 0);
  const int frac_digits = has_dot ? tlen - 1 - dot_pos : 0;
  const bool has_frac = T(19) == '.';
  int frac_run = frac_stop;
  const int tail20 = tlen - 20 > 0 ? tlen - 20 : 0;
  if (tail20 < frac_run) frac_run = tail20;
  const int frac_len = has_frac ? frac_run : 0;
  const int opos = has_frac ? 20 + frac_len : 19;
  const int oc = T(opos);
  const bool is_zulu = oc == 'Z' || oc == 'z';
  const bool is_num_off = oc == '+' || oc == '-';

  // pass T2: every weighted sum and violation of both forms
  unsigned s_lo = 0u, s_hi = 0u, s_md = 0u, s_ys = 0u, s_ohm = 0u, s_ns = 0u;
  bool fviol = false, sviol = false;
  for (int b0 = 0; b0 < tlen && ts_s + b0 < L; b0 += 32) {
    const int r = b0 + lane;
    if (!in_t(r)) continue;
    const int c = T(r);
    const bool dg = is_digit(c);
    const unsigned d = (unsigned)(c - 48);
    // float form: [+-]? digits [. digits]
    if ((r >= body_from && r != dot_pos && !dg) ||
        (r == body_from && c == '.'))
      fviol = true;
    if (dg && r >= body_from && r != dot_pos) {
      const int di = r - body_from - (r > dot_pos ? 1 : 0);
      const int place = nd_digits - 1 - di;
      if (place >= 0 && place <= 8) s_lo += d * pow10u(place);
      if (place >= 9 && place <= 17) s_hi += d * pow10u(place - 9);
    }
    // rfc3339 form: month|day|hour|minute and year|sec digit fields
    switch (r) {
      case 0: s_ys += d * 1000u; break;
      case 1: s_ys += d * 100u; break;
      case 2: s_ys += d * 10u; break;
      case 3: s_ys += d; break;
      case 5: s_md += d * 10u; break;
      case 6: s_md += d; break;
      case 8: s_md += (d * 10u) << 8; break;
      case 9: s_md += d << 8; break;
      case 11: s_md += (d * 10u) << 16; break;
      case 12: s_md += d << 16; break;
      case 14: s_md += (d * 10u) << 24; break;
      case 15: s_md += d << 24; break;
      case 17: s_ys += (d * 10u) << 14; break;
      case 18: s_ys += d << 14; break;
      default: break;
    }
    if (r <= 18) {
      if (r == 4 || r == 7) {
        if (c != '-') sviol = true;
      } else if (r == 10) {
        if (c != 'T' && c != 't') sviol = true;
      } else if (r == 13 || r == 16) {
        if (c != ':') sviol = true;
      } else if (!dg) {
        sviol = true;
      }
    }
    const int rd = r - 20;
    if (rd >= 0 && rd < frac_len && rd <= 8) s_ns += d * pow10u(8 - rd);
    const int r2 = r - opos;
    if (r2 == 1) s_ohm += d * 10u;
    if (r2 == 2) s_ohm += d;
    if (r2 == 4) s_ohm += (d * 10u) << 8;
    if (r2 == 5) s_ohm += d << 8;
    if (is_num_off) {
      if ((r2 == 1 || r2 == 2 || r2 == 4 || r2 == 5) && !dg) sviol = true;
      if (r2 == 3 && c != ':') sviol = true;
    }
  }
  const int ts_lo = (int)__reduce_add_sync(kFull, s_lo);
  const int ts_hi = (int)__reduce_add_sync(kFull, s_hi);
  const int wm = (int)__reduce_add_sync(kFull, s_md);
  const int wy = (int)__reduce_add_sync(kFull, s_ys);
  const int w_ohm = (int)__reduce_add_sync(kFull, s_ohm);
  const int nanos = (int)__reduce_add_sync(kFull, s_ns);
  fviol = warp_any(fviol);
  sviol = warp_any(sviol);

  const bool float_ok = !fviol && n_dots <= 1 && tlen >= 1 &&
                        tlen - body_from >= 1;
  const int month = wm & 255, day = (wm >> 8) & 255;
  const int hour = (wm >> 16) & 255, minute = (wm >> 24) & 255;
  const int year = wy & 16383, sec = (wy >> 14) & 255;
  const int oh = w_ohm & 255, om = (w_ohm >> 8) & 255;
  bool off_ok = is_zulu ? tlen == opos + 1 : true;
  if (is_num_off) off_ok = off_ok && tlen == opos + 6 && oh <= 23 && om <= 59;
  const bool rfc_ok =
      tlen >= 20 && !sviol && (is_zulu || is_num_off) && off_ok &&
      month >= 1 && month <= 12 && day >= 1 &&
      day <= days_in_month(year, month) && hour <= 23 && minute <= 59 &&
      sec <= 59 && (!has_frac || (frac_len >= 1 && frac_len <= 9));
  const int ts_kind = rfc_ok ? 0 : float_ok ? 1 : 2;
  ok = ok && ts_kind < 2;
  auto clamp255 = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };

  // ---- channel values into the block's tile -------------------------------
  if (lane == 0) {
    put(C_OK, ok);
    put(C_HAS_HIGH, high);
    put(C_N_PARTS, n_parts);
    for (int k = 0; k < 4; ++k) put(C_TIME_POS + k, pos[k]);
    put(C_HOST_S, vs[1]);
    put(C_HOST_E, ve[1]);
    put(C_MSG_S, vs[2]);
    put(C_MSG_E, ve[2]);
    put(C_LEVEL_VAL, has_level ? level_val : -1);
    put(C_TS_KIND, ts_kind);
    if (!DEMAND) {
      put(C_TS_START, ts_s);
      put(C_TS_END, ts_e);
    }
    put(C_DAYS, days_from_civil(year, month, day));
    put(C_SOD, hour * 3600 + minute * 60 + sec);
    put(C_OFF, is_num_off ? (oc == '-' ? -1 : 1) * (oh * 3600 + om * 60) : 0);
    put(C_NANOS, nanos);
    put(C_TS_HI, ts_hi);
    put(C_TS_LO, ts_lo);
    put(C_TS_META, clamp255(frac_digits) | clamp255(nd_digits) << 8 |
                       (has_sign ? 1 : 0) << 16);
  }
}

}  // namespace lt
