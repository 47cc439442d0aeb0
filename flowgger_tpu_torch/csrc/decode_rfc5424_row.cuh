// The RFC5424 row decode of kernel K1 (decode_rfc5424.cu), one warp a
// row: the device functions shared by K1 and the fused rfc5424 -> GELF
// route (fused_gelf.cu).  The design notes are at the top of
// decode_rfc5424.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace r5 {

using namespace fg;

constexpr int kEscRunCap = 16;
constexpr int kN1D = 23;

// channel rows of the packed output (order of _KEYS_1D)
enum Ch1D {
  C_OK, C_BOM, C_FACILITY, C_SEVERITY, C_DAYS, C_SOD, C_OFF, C_NANOS,
  C_HOST_S, C_HOST_E, C_APP_S, C_APP_E, C_PROC_S, C_PROC_E, C_MSGID_S,
  C_MSGID_E, C_MSG_START, C_SD_COUNT, C_PAIR_COUNT, C_FULL_START,
  C_TRIM_END, C_MSG_TRIM_START, C_HAS_HIGH
};

__device__ __forceinline__ int bit_length(int v) {
  return v <= 0 ? 0 : 32 - __clz(v);
}

// The reference's slot geometry for an extraction over L positions.
__device__ __forceinline__ int slot_bits_for(int L) {
  int b = bit_length(L + 1);
  return b > 10 ? b : 10;
}

// extract_by_ord "sum": ordinal k's slot after the per-ordinal sums of
// its group (slots ordinals per wrapping word, sb bits each) are folded
// into one word.
__device__ __forceinline__ uint32_t unpack_slot(const uint32_t* sums, int K,
                                                int k, int sb) {
  int slots = 30 / sb;
  if (slots < 1) slots = 1;
  const int base = k - k % slots;
  uint32_t word = 0;
  for (int s = 0; s < slots && base + s < K; ++s)
    word += sums[base + s] << (sb * s);
  return (word >> (sb * (k - base))) & ((1u << sb) - 1u);
}

__device__ __forceinline__ bool is_ws(int c) {
  return (c >= 9 && c <= 13) || (c >= 28 && c <= 32);
}
__device__ __forceinline__ bool is_name_byte(int c) {
  return c >= 33 && c <= 126 && c != 34 && c != 61 && c != 93;
}

// The reference's escape / quote state (its _esc_parity, tpu/rfc5424.py
// :285, and the real-quote count) over one 32-position chunk a step:
// escaped(i) is the parity of the
// backslash run ending at i-1 (runs capped at ESC_RUN_CAP-1), and
// q_before counts real quotes strictly before i.  Lanes past the row
// pass c = 0, which is neither a backslash nor a quote.
struct WarpQuote {
  int run = 0;        // backslash run ending at the previous chunk's end
  int q = 0;          // real quotes before this chunk
  bool real_q = false;
  bool cap = false;
  int q_before = 0;   // this lane's real quotes at positions < i
  __device__ __forceinline__ void step(int c, int lane) {
    const unsigned bs = __ballot_sync(kFull, c == 92);
    const unsigned lt = lanemask_lt(lane);
    const unsigned nb = ~bs & lt;   // non-backslash positions below the lane
    const int r = nb ? lane - 32 + __clz((int)nb) : lane + run;
    const int rp = r < kEscRunCap - 1 ? r : kEscRunCap - 1;
    cap = r >= kEscRunCap;
    real_q = c == 34 && (rp & 1) == 0;
    const unsigned qb = __ballot_sync(kFull, real_q);
    q_before = q + __popc(qb & lt);
    run = ~bs ? __clz((int)~bs) : run + 32;
    q += __popc(qb);
  }
};

// One warp's per-ordinal sums (extract_by_ord's operands).
template <int MAX_SD, int MAX_PAIRS>
struct RowSums {
  uint32_t rb[MAX_SD + 1], sid[MAX_SD];
  uint32_t oq[MAX_PAIRS], cq[MAX_PAIRS], esc[MAX_PAIRS], ns[MAX_PAIRS];
};

// Decodes one row with the calling warp and writes its channel values
// to col[ch * kWarps] (the block's channel tile).  With DEMAND only the
// channels the GELF encode reads are written (the fused route's
// fused_routes.DEMAND["rfc5424_gelf"]): no bom, facility, msgid span,
// msg_start or pair_sd.
template <int MAX_SD, int MAX_PAIRS, bool DEMAND = false>
__device__ __forceinline__ void decode_row(
    const uint8_t* __restrict__ src, const int len, const int L,
    uint4* __restrict__ stage, RowSums<MAX_SD, MAX_PAIRS>& S,
    int32_t* __restrict__ col, const int lane) {
  const int n = len < L ? (len > 0 ? len : 0) : L;  // valid positions

  // ---- stage the valid bytes; zero the ordinal sums ------------------------
  stage_row(src, n, L, stage, lane);
  {
    uint32_t* w = reinterpret_cast<uint32_t*>(&S);
    for (int j = lane; j < (int)(sizeof(S) / 4); j += 32) w[j] = 0;
  }
  __syncwarp();
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(stage);
  auto B = [&](int i) -> int { return (i >= 0 && i < n) ? rb[i] : 0; };

  // ---- BOM --------------------------------------------------------------
  const bool bom = len >= 3 && B(0) == 0xEF && B(1) == 0xBB && B(2) == 0xBF;
  const int start0 = bom ? 3 : 0;
  bool ok = (bom ? B(3) : B(0)) == '<';
  bool viol = false;   // this lane's violations; any lane's reject the row

  // ---- pass 1: spaces, '>', quote totals, trim end, high bytes ------------
  int sp_lane = L;     // lane k < 6 holds the k-th space
  int n_sp = 0, gt = L, trim_last = 0, q_before_rest = -1;
  uint32_t n_high = 0;   // bytes >= 128 (this lane's, then the row's)
  {
    WarpQuote qs;
    bool capped_q = false;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool valid = i < n;
      const int c = valid ? rb[i] : 0;
      qs.step(c, lane);
      capped_q = capped_q || (qs.cap && c == 34);
      const unsigned spb = __ballot_sync(kFull, c == 32);
      const int cnt = __popc(spb);
      if (lane < 6 && lane >= n_sp && lane < n_sp + cnt)
        sp_lane = base + nth_set_bit(spb, lane - n_sp);
      if (n_sp <= 5 && 5 < n_sp + cnt) {
        // quotes before the 6th space: the count before the rest zone
        // (the space itself is not a quote)
        q_before_rest = __shfl_sync(kFull, qs.q_before,
                                    nth_set_bit(spb, 5 - n_sp));
      }
      n_sp += cnt;
      const unsigned gtb = __ballot_sync(kFull, c == '>' && i > start0);
      if (gt == L && gtb) gt = base + __ffs((int)gtb) - 1;
      const unsigned nwb = __ballot_sync(kFull, valid && !is_ws(c));
      if (nwb) trim_last = base + 32 - __clz((int)nwb);
      n_high += c >= 128 ? 1u : 0u;
    }
    if (q_before_rest < 0) q_before_rest = qs.q;
    if (warp_any(capped_q)) ok = false;
    n_high = __reduce_add_sync(kFull, n_high);
  }
  int sp[6];
  for (int k = 0; k < 6; ++k) sp[k] = __shfl_sync(kFull, sp_lane, k);
  ok = ok && sp[5] < L;
  int f_start[7], f_end[7];
  f_start[0] = start0;
  for (int k = 0; k < 6; ++k) {
    f_start[k + 1] = sp[k] + 1;
    f_end[k] = sp[k];
  }
  f_end[6] = len;
  const int ndig = gt - start0 - 1;
  ok = ok && gt < f_end[0] && ndig >= 1 && ndig <= 3;
  const int ts_s = f_start[1];
  const int tlen = f_end[1] - ts_s;
  const int rest_s = f_start[6];
  // the PRI and timestamp zones are not masked by the row length: on a
  // malformed row they can run into the zero padding, whose bytes still
  // count (as non-digits) in the packed words, so passes 2 and 3 walk
  // them too — every channel then matches the reference on every row.
  // Past the header zones (PRI, version, timestamp, the rest's first
  // byte) only high bytes add to the words, and pass 1 counted those.
  int m = gt > ts_s + tlen ? gt : ts_s + tlen;
  m = m < L ? m : L;
  m = m > n ? m : n;
  int zone_end = gt + 2 > ts_s + tlen ? gt + 2 : ts_s + tlen;
  zone_end = zone_end > rest_s + 1 ? zone_end : rest_s + 1;
  zone_end = zone_end < m ? zone_end : m;

  // ---- pass 2: words 1 and 2, header violations, fraction run -----------
  uint32_t word1 = 0, word2 = 0;
  int frac_run = 10;
  for (int i = lane; i < zone_end; i += 32) {
    int c = B(i);
    bool dg = is_digit(c);
    int r = i - ts_s;
    bool in_ts = r >= 0 && r < tlen;
    int dz = in_ts ? c - 48 : 0;
    if (i > start0 && i < gt) {
      if (!dg) viol = true;
      int e = gt - 1 - i;
      int w = e == 0 ? 1 : (e == 1 ? 10 : (e == 2 ? 100 : 0));
      word2 += (uint32_t)((c - 48) * w) << 21;
    }
    if (in_ts) {
      int w1 = r == 0 ? 1000 : r == 1 ? 100 : r == 2 ? 10 : r == 3 ? 1 : 0;
      int w5 = r == 5 ? 10 : r == 6 ? 1 : 0;
      int w8 = r == 8 ? 10 : r == 9 ? 1 : 0;
      word1 += (uint32_t)(dz * w1) + ((uint32_t)(dz * w5) << 14)
               + ((uint32_t)(dz * w8) << 21);
      if (r == 19 && c == '.') word1 += 1u << 28;
      int w11 = r == 11 ? 10 : r == 12 ? 1 : 0;
      int w14 = r == 14 ? 10 : r == 15 ? 1 : 0;
      int w17 = r == 17 ? 10 : r == 18 ? 1 : 0;
      word2 += (uint32_t)(dz * w11) + ((uint32_t)(dz * w14) << 7)
               + ((uint32_t)(dz * w17) << 14);
      bool digit_off = r <= 18 && r != 4 && r != 7 && r != 10 && r != 13
                       && r != 16;
      if (digit_off && !dg) viol = true;
      if ((r == 4 || r == 7) && c != '-') viol = true;
      if (r == 10 && c != 'T' && c != 't') viol = true;
      if ((r == 13 || r == 16) && c != ':') viol = true;
      int rd = r - 20;
      if (rd >= 0 && rd < 10 && !dg && rd < frac_run) frac_run = rd;
    }
    if (i == gt + 1 && c == '1') word1 += 1u << 29;
  }
  word1 = __reduce_add_sync(kFull, word1);
  word2 = __reduce_add_sync(kFull, word2);
  frac_run = warp_min(frac_run);
  const int w1s = (int)word1, w2s = (int)word2;
  const int year = w1s & 0x3FFF;
  const int month = (w1s >> 14) & 0x7F;
  const int day = (w1s >> 21) & 0x7F;
  const bool has_frac = ((w1s >> 28) & 1) == 1;
  const bool ver_ok = ((w1s >> 29) & 1) == 1;
  const int hour = w2s & 0x7F;
  const int minute = (w2s >> 7) & 0x7F;
  const int sec = (w2s >> 14) & 0x7F;
  const int pri = w2s >> 21;
  ok = ok && pri <= 255;
  ok = ok && ver_ok && f_end[0] == gt + 2;
  ok = ok && tlen >= 20;
  ok = ok && month >= 1 && month <= 12 && day >= 1
       && day <= days_in_month(year, month);
  ok = ok && hour <= 23 && minute <= 59 && sec <= 59;
  {
    int lim = tlen - 20 > 0 ? tlen - 20 : 0;
    if (frac_run > lim) frac_run = lim;
  }
  const int frac_len = has_frac ? frac_run : 0;
  if (has_frac) ok = ok && frac_len >= 1 && frac_len <= 9;
  const int opos = has_frac ? 20 + frac_len : 19;

  // ---- pass 3: nanos, word 3 (offset, rest flags, high bytes) ------------
  uint32_t nanos_u = 0, word3 = 0;
  bool off_digit_viol = false, off_colon_viol = false;
  const bool pack_high = L <= 1023;
  for (int i = lane; i < zone_end; i += 32) {
    int c = B(i);
    bool dg = is_digit(c);
    int r = i - ts_s;
    bool in_ts = r >= 0 && r < tlen;
    if (in_ts) {
      int dz = c - 48;
      int rd = r - 20;
      if (rd >= 0 && rd < frac_len) {
        int w = 1;
        for (int k = rd; k < 8; ++k) w *= 10;
        nanos_u += (uint32_t)(dz * (rd <= 8 ? w : 0));
      }
      int r2 = r - opos;
      int wa = r2 == 1 ? 10 : r2 == 2 ? 1 : 0;
      int wb = r2 == 4 ? 10 : r2 == 5 ? 1 : 0;
      word3 += (uint32_t)(dz * wa) + ((uint32_t)(dz * wb) << 7);
      if (r2 == 0) {
        if (c == 'Z' || c == 'z') word3 += 1u << 14;
        if (c == '+') word3 += 1u << 15;
        if (c == '-') word3 += 1u << 16;
      }
      if ((r2 == 1 || r2 == 2 || r2 == 4 || r2 == 5) && !dg)
        off_digit_viol = true;
      if (r2 == 3 && c != ':') off_colon_viol = true;
    }
    if (i == rest_s) {
      if (c == '-') word3 += 1u << 17;
      if (c == '[') word3 += 1u << 18;
    }
  }
  nanos_u = __reduce_add_sync(kFull, nanos_u);
  word3 = __reduce_add_sync(kFull, word3);
  if (pack_high) word3 += n_high << 19;
  const bool any_high = n_high > 0;
  off_digit_viol = warp_any(off_digit_viol);
  off_colon_viol = warp_any(off_colon_viol);
  const int w3s = (int)word3;
  const int oh = w3s & 0x7F;
  const int om = (w3s >> 7) & 0x7F;
  const bool is_zulu = ((w3s >> 14) & 1) == 1;
  const bool neg_off = ((w3s >> 16) & 1) == 1;
  const bool is_num_off = ((w3s >> 15) & 3) != 0;
  const bool is_dash = ((w3s >> 17) & 1) == 1;
  const bool is_sd = ((w3s >> 18) & 1) == 1;
  ok = ok && (is_zulu || is_num_off);
  if (is_zulu) ok = ok && tlen == opos + 1;
  if (is_num_off) {
    if (off_digit_viol || off_colon_viol) viol = true;
    ok = ok && tlen == opos + 6 && oh <= 23 && om <= 59;
  }
  const int off_secs = is_num_off ? (neg_off ? -1 : 1) * (oh * 3600 + om * 60)
                                  : 0;
  const int days = days_from_civil(year, month, day);
  const int sod = hour * 3600 + minute * 60 + sec;
  const bool has_high = pack_high ? ((w3s >> 19) & 0x3FF) > 0 : any_high;

  ok = ok && rest_s < len;
  ok = ok && (is_dash || is_sd);

  // ---- pass 4: the structural ']' chain ----------------------------------
  const int rb_sb = bit_length(((L << 3) | 7) + 1);
  {
    const int vmax = (1 << rb_sb) - 2;
    WarpQuote qs;
    int rb_ord = 0;
    int prev_closeq_carry = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int c = i < n ? rb[i] : 0;
      qs.step(c, lane);
      const int q_excl = qs.q_before - q_before_rest;
      const bool outside = (q_excl & 1) == 0;
      const bool in_rest = i >= rest_s;
      const int close_q = qs.real_q && in_rest && !outside;
      int prev_closeq = __shfl_up_sync(kFull, close_q, 1);
      if (lane == 0) prev_closeq = prev_closeq_carry;
      const bool hit = c == ']' && outside && in_rest;
      const unsigned hits = __ballot_sync(kFull, hit);
      const int ord = rb_ord + __popc(hits & lanemask_lt(lane)) + 1;
      if (hit && ord <= MAX_SD + 1) {
        const bool next_valid = i + 1 < n;
        const int next_c = B(i + 1);
        const int payload = ((B(i - 1) == 32) || prev_closeq ? 1 : 0)
                            + ((next_c == '[' && next_valid) ? 2 : 0)
                            + ((next_c == 32 && next_valid) ? 4 : 0);
        const int v = (i << 3) | payload;
        atomicAdd(&S.rb[ord - 1], (uint32_t)((v < vmax ? v : vmax) + 1));
      }
      rb_ord += __popc(hits);
      prev_closeq_carry = __shfl_sync(kFull, close_q, 31);
    }
  }
  __syncwarp();
  int rb_pos[MAX_SD + 1], rb_flags[MAX_SD + 1];
  for (int k = 0; k <= MAX_SD; ++k) {
    const uint32_t v = unpack_slot(S.rb, MAX_SD + 1, k, rb_sb);
    const int w = v == 0 ? (L << 3) : (int)v - 1;
    rb_pos[k] = w >> 3;
    rb_flags[k] = w & 7;
  }
  int sd_end_zone = L;
  for (int k = 0; k <= MAX_SD; ++k) {
    bool found = rb_pos[k] < L;
    bool term = found && (((rb_flags[k] & 4) != 0) || rb_pos[k] == len - 1);
    if (term && rb_pos[k] < sd_end_zone) sd_end_zone = rb_pos[k];
  }
  int sd_count_raw = 1;
  {
    bool alive = ((rb_flags[0] & 2) != 0) && rb_pos[0] < L;
    for (int k = 0; k < MAX_SD; ++k) {
      sd_count_raw += alive ? 1 : 0;
      if (k + 1 < MAX_SD)
        alive = alive && ((rb_flags[k + 1] & 2) != 0) && rb_pos[k + 1] < L;
    }
  }
  const int sd_count = is_sd ? sd_count_raw : 0;
  int last_idx = sd_count - 1;
  last_idx = last_idx < 0 ? 0 : (last_idx > MAX_SD ? MAX_SD : last_idx);
  int sd_end = L, end_flags = 0;
  for (int k = 0; k <= MAX_SD; ++k) {
    if (k == last_idx) {
      sd_end = rb_pos[k];
      end_flags = rb_flags[k];
    }
  }
  if (is_sd) ok = ok && sd_count_raw <= MAX_SD && sd_end < L;
  int blk_start[MAX_SD];
  blk_start[0] = rest_s;
  for (int k = 1; k < MAX_SD; ++k) blk_start[k] = rb_pos[k - 1] + 1;
  if (is_sd) {
    for (int k = 0; k < MAX_SD; ++k)
      if (k < sd_count && (rb_flags[k] & 1) == 0) ok = false;
  }
  const int after_sd_pos = sd_end + 1;
  if (is_sd) ok = ok && after_sd_pos < len && (end_flags & 4) != 0;
  const int msg_start = is_dash ? rest_s + 1 : after_sd_pos;

  // ---- pass 5: SD-ID ends, quote positions, escape counts, msg start ----
  const int sb = slot_bits_for(L);
  const int vclip = (1 << sb) - 2;
  int pair_total = 0;
  int msg_a = L;
  {
    WarpQuote qs;
    int rb_ord = 0;
    int prev_carry = 0;   // bit 0: close quote, bit 1: space
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool valid = i < n;
      const int c = valid ? rb[i] : 0;
      qs.step(c, lane);
      const int q_excl = qs.q_before - q_before_rest;
      const bool outside = (q_excl & 1) == 0;
      const bool in_rest = i >= rest_s;
      const bool real_q = qs.real_q && in_rest;
      const bool open_q = real_q && outside;
      const bool close_q = real_q && !outside;
      const bool zone_c = in_rest && i <= sd_end_zone && is_sd;
      const bool sd_zone = in_rest && i <= sd_end && is_sd;
      const unsigned hits = __ballot_sync(kFull, c == ']' && outside
                                                 && in_rest);
      // ']' at or before i (a space, where it is read, is not one)
      const int rb_ord_i = rb_ord + __popc(hits & lanemask_lt(lane));
      const int vi = (i < vclip ? i : vclip) + 1;
      const bool is_sp = c == 32;
      const int flags = (close_q ? 1 : 0) | (is_sp ? 2 : 0);
      int prev = __shfl_up_sync(kFull, flags, 1);
      if (lane == 0) prev = prev_carry;
      if (valid) {
        if (is_sp && outside && zone_c && (prev & 3) == 0) {
          int ord = rb_ord_i + 1;
          if (ord >= 1 && ord <= MAX_SD) atomicAdd(&S.sid[ord - 1], (uint32_t)vi);
        }
        if (open_q && zone_c) {
          int ord = (q_excl >> 1) + 1;
          if (ord > pair_total) pair_total = ord;
          if (ord >= 1 && ord <= MAX_PAIRS)
            atomicAdd(&S.oq[ord - 1], (uint32_t)vi);
        }
        if (close_q && zone_c) {
          int ord = (q_excl + 1) >> 1;
          if (ord >= 1 && ord <= MAX_PAIRS)
            atomicAdd(&S.cq[ord - 1], (uint32_t)vi);
        }
        if (c == 92 && (q_excl & 1) == 1) {
          int ord = (q_excl >> 1) + 1;
          if (ord >= 1 && ord <= MAX_PAIRS) atomicAdd(&S.esc[ord - 1], 1u);
        }
        if (open_q && sd_zone && B(i - 1) != '=') viol = true;
        if (!is_ws(c) && i >= msg_start && i < msg_a) msg_a = i;
      }
      rb_ord += __popc(hits);
      prev_carry = __shfl_sync(kFull, flags, 31);
    }
  }
  __syncwarp();
  pair_total = warp_max(pair_total);
  msg_a = warp_min(msg_a);
  int sid_end[MAX_SD];
  for (int k = 0; k < MAX_SD; ++k) {
    const uint32_t v = unpack_slot(S.sid, MAX_SD, k, sb);
    sid_end[k] = v == 0 ? L : (int)v - 1;
  }
  if (is_sd) {
    for (int k = 0; k < MAX_SD; ++k)
      if (k < sd_count && !(sid_end[k] < rb_pos[k])) ok = false;
  }
  const int pair_count = is_sd ? pair_total : 0;
  if (is_sd) ok = ok && pair_count <= MAX_PAIRS;
  // pair k lives on lane k from here on
  const int pk = lane < MAX_PAIRS ? lane : 0;
  int oq_pos, cq_pos;
  uint32_t esc_cnt;
  {
    uint32_t v = unpack_slot(S.oq, MAX_PAIRS, pk, sb);
    oq_pos = v == 0 ? L : (int)v - 1;
    v = unpack_slot(S.cq, MAX_PAIRS, pk, sb);
    cq_pos = v == 0 ? L : (int)v - 1;
    esc_cnt = unpack_slot(S.esc, MAX_PAIRS, pk, sb);
  }

  // ---- pass 6: pair-name structure and name starts ----------------------
  {
    WarpQuote qs;
    int prev_carry = 0;   // bit 0: name byte, bit 1: '=' (last position)
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool valid = i < n;
      const int c = valid ? rb[i] : 0;
      qs.step(c, lane);
      const int q_excl = qs.q_before - q_before_rest;
      const bool outside = (q_excl & 1) == 0;
      const bool in_rest = i >= rest_s;
      const bool real_q = qs.real_q && in_rest;
      const bool open_q = real_q && outside;
      const bool sd_zone = in_rest && i <= sd_end && is_sd;
      bool in_pair = false;
      if (is_sd) {
        for (int k = 0; k < MAX_SD; ++k)
          in_pair = in_pair || (k < sd_count && i > sid_end[k]
                                && i < rb_pos[k]);
      }
      const bool name = is_name_byte(c) && outside && in_pair;
      const bool eq = c == '=' && outside && in_pair;
      const int flags = (name ? 1 : 0) | (eq ? 2 : 0);
      int prev = __shfl_up_sync(kFull, flags, 1);
      if (lane == 0) prev = prev_carry;
      const bool prev_name = (prev & 1) != 0;
      if (valid) {
        // run end of the previous position: its next byte must be '='
        if (prev_name && !name && c != '=') viol = true;
        // '=' at the previous position must be followed by an open quote
        if ((prev & 2) && !(open_q && in_pair)) viol = true;
        if (name && !prev_name) {
          if (B(i - 1) != 32) viol = true;
          int ord = (q_excl >> 1) + 1;
          if (ord >= 1 && ord <= MAX_PAIRS)
            atomicAdd(&S.ns[ord - 1], (uint32_t)((i < vclip ? i : vclip) + 1));
        }
        if (real_q && sd_zone && !in_pair) viol = true;
      }
      const int last = n - 1 - base < 31 ? n - 1 - base : 31;
      prev_carry = __shfl_sync(kFull, flags, last);
    }
    // the last valid position: its next byte is padding (never '=', and
    // never an open quote)
    if (prev_carry != 0) viol = true;
  }
  __syncwarp();
  int ns_pos;
  {
    const uint32_t v = unpack_slot(S.ns, MAX_PAIRS, pk, sb);
    ns_pos = v == 0 ? L : (int)v - 1;
  }
  const bool pv = lane < MAX_PAIRS && lane < pair_count;
  if (warp_any(pv && (!(ns_pos <= oq_pos - 2) || !(cq_pos > oq_pos))))
    ok = false;
  const int trim_end = trim_last > start0 ? trim_last : start0;
  const int msg_trim_start = msg_a < trim_end ? msg_a : trim_end;
  ok = ok && !warp_any(viol);

  // ---- channel values into the block's tile -----------------------------
  auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
  if (lane == 0) {
    put(C_OK, ok);
    if (!DEMAND) {
      put(C_BOM, bom);
      put(C_FACILITY, pri >> 3);
      put(C_MSGID_S, f_start[5]);
      put(C_MSGID_E, f_end[5]);
      put(C_MSG_START, msg_start);
    }
    put(C_SEVERITY, pri & 7);
    put(C_DAYS, days);
    put(C_SOD, sod);
    put(C_OFF, off_secs);
    put(C_NANOS, (int)nanos_u);
    put(C_HOST_S, f_start[2]);
    put(C_HOST_E, f_end[2]);
    put(C_APP_S, f_start[3]);
    put(C_APP_E, f_end[3]);
    put(C_PROC_S, f_start[4]);
    put(C_PROC_E, f_end[4]);
    put(C_SD_COUNT, sd_count);
    put(C_PAIR_COUNT, pair_count);
    put(C_FULL_START, start0);
    put(C_TRIM_END, trim_end);
    put(C_MSG_TRIM_START, msg_trim_start);
    put(C_HAS_HIGH, has_high);
    for (int k = 0; k < MAX_SD; ++k) put(kN1D + k, blk_start[k] + 1);
    for (int k = 0; k < MAX_SD; ++k) put(kN1D + MAX_SD + k, sid_end[k]);
  }
  if (lane < MAX_PAIRS) {
    const int k = lane, ch = kN1D + 2 * MAX_SD;
    int psd = -1;
    for (int j = 0; j < MAX_SD; ++j) psd += blk_start[j] <= oq_pos ? 1 : 0;
    psd = psd < 0 ? 0 : (psd > MAX_SD - 1 ? MAX_SD - 1 : psd);
    put(ch + k, pv ? ns_pos : 0);                            // name_start
    put(ch + MAX_PAIRS + k, oq_pos - 1);                     // name_end
    put(ch + 2 * MAX_PAIRS + k, oq_pos + 1);                 // val_start
    put(ch + 3 * MAX_PAIRS + k, cq_pos);                     // val_end
    if (!DEMAND) put(ch + 4 * MAX_PAIRS + k, pv ? psd : 0);  // pair_sd
    put(ch + 5 * MAX_PAIRS + k,                              // val_has_esc
        esc_cnt > 0 && pv && cq_pos > oq_pos + 1);
  }
}

}  // namespace r5
