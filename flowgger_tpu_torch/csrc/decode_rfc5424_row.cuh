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

// The word-parallel passes.  Word w of a row holds positions 32w..32w+31
// (bit b is position 32w + b); lane j owns words j, j + 32, ....  After
// the row is staged, each lane builds its words' class bitmasks once and
// keeps them in the warp's shared area past the staged row, one array a
// slot, so the passes read them instead of stepping the row chunk by
// chunk.  Only positions below the row's valid length have bits.
enum MaskSlot {
  M_BS,     // backslash
  M_SP,     // space
  M_RB,     // ']'
  M_EQ,     // '='
  M_NW,     // not whitespace
  M_NM,     // SD-name byte
  M_RQ,     // real quote: '"' after an even backslash run shorter than the
            // cap (the word's '"' bits until the quote round)
  M_OUT,    // outside: an even count of real quotes between the 6th space
            // and the position (the reference's q_excl parity)
  M_QB,     // real quotes before the word (int)
  M_HB,     // structural ']' before the word (int)
  kMaskSlots
};

__host__ __device__ inline int mask_words(int L) { return (L + 31) >> 5; }

// Shared bytes a warp's decode needs at `stage`: the staged row, then
// kMaskSlots words for each of its 32-position words, then the six space
// positions (eight ints).
__host__ __device__ inline int stage_bytes(int L) {
  return round16(L) + round16(4 * (kMaskSlots * mask_words(L) + 8));
}

// bits of word w at the positions >= p
__device__ __forceinline__ uint32_t from_bits(int w, int p) {
  const int s = p - 32 * w;
  return s <= 0 ? kFull : s >= 32 ? 0u : kFull << s;
}
// bits of word w at the positions <= p
__device__ __forceinline__ uint32_t upto_bits(int w, int p) {
  return ~from_bits(w, p + 1);
}
// bits below bit b
__device__ __forceinline__ uint32_t low_bits(int b) {
  return (1u << b) - 1u;
}

// One warp's per-ordinal sums (extract_by_ord's operands).
template <int MAX_SD, int MAX_PAIRS>
struct RowSums {
  uint32_t rb[MAX_SD + 1], sid[MAX_SD];
  uint32_t oq[MAX_PAIRS], cq[MAX_PAIRS], esc[MAX_PAIRS], ns[MAX_PAIRS];
};

// Decodes one row with the calling warp and writes its channel values
// to col[ch * kWarps] (the block's channel tile).  `stage` is the warp's
// stage_bytes(L) of shared memory: the staged row, then the masks.  With
// DEMAND only the channels the GELF encode reads are written (the fused
// route's
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
  const int nwc = mask_words(L);        // mask words a slot
  const int nwords = (n + 31) >> 5;     // words holding valid positions
  uint32_t* const M =
      reinterpret_cast<uint32_t*>(reinterpret_cast<uint8_t*>(stage) +
                                  round16(L));
  auto MW = [&](int slot, int w) -> uint32_t& { return M[slot * nwc + w]; };
  int* const sp_sh = reinterpret_cast<int*>(M + kMaskSlots * nwc);
  if (lane < 6) sp_sh[lane] = L;
  __syncwarp();
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(stage);
  auto B = [&](int i) -> int { return (i >= 0 && i < n) ? rb[i] : 0; };

  // ---- BOM --------------------------------------------------------------
  const bool bom = len >= 3 && B(0) == 0xEF && B(1) == 0xBB && B(2) == 0xBF;
  const int start0 = bom ? 3 : 0;
  bool ok = (bom ? B(3) : B(0)) == '<';
  bool viol = false;   // this lane's violations; any lane's reject the row

  // ---- pass 1: the class masks, '>', trim end, high bytes -----------------
  // lane j builds words j, j + 32, ...: four bytes at a time (SWAR), a
  // nibble of each class per four bytes
  int gt = L, trim_last = 0;
  uint32_t n_high = 0;   // bytes >= 128 (this lane's, then the row's)
  for (int w = lane; w < nwords; w += 32) {
    uint32_t bs = 0, dq = 0, sp = 0, rbk = 0, eq = 0, gtw = 0, hi = 0, nw = 0,
             nm = 0;
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(rb) + 8 * w;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int nv = n - 32 * w - 4 * t;   // valid bytes from here
      if (nv <= 0) break;
      const uint32_t valid =
          nv >= 4 ? 0x80808080u : 0x80808080u & ((1u << (8 * nv)) - 1u);
      const uint32_t x = rw[t];
      const uint32_t e34 = bytes_equal(x, 34), e61 = bytes_equal(x, 61);
      const uint32_t e93 = bytes_equal(x, 93);
      const uint32_t ws = (bytes_below(x, 14) & ~bytes_below(x, 9)) |
                          (bytes_below(x, 33) & ~bytes_below(x, 28));
      const uint32_t name = ~bytes_below(x, 33) & bytes_below(x, 127) &
                            ~e34 & ~e61 & ~e93;
      const int sh = 4 * t;
      bs |= nibble(bytes_equal(x, 92) & valid) << sh;
      dq |= nibble(e34 & valid) << sh;
      sp |= nibble(bytes_equal(x, 32) & valid) << sh;
      rbk |= nibble(e93 & valid) << sh;
      eq |= nibble(e61 & valid) << sh;
      gtw |= nibble(bytes_equal(x, 62) & valid) << sh;
      hi |= nibble(x & valid) << sh;
      nw |= nibble(~ws & valid) << sh;
      nm |= nibble(name & valid) << sh;
    }
    MW(M_BS, w) = bs;
    MW(M_SP, w) = sp;
    MW(M_RB, w) = rbk;
    MW(M_EQ, w) = eq;
    MW(M_NW, w) = nw;
    MW(M_NM, w) = nm;
    MW(M_RQ, w) = dq;
    gtw &= from_bits(w, start0 + 1);
    if (gtw && gt == L) gt = 32 * w + __ffs((int)gtw) - 1;
    if (nw) trim_last = 32 * w + 32 - __clz((int)nw);
    n_high += __popc(hi);
  }
  gt = warp_min(gt);
  trim_last = warp_max(trim_last);
  n_high = __reduce_add_sync(kFull, n_high);
  __syncwarp();

  // ---- the real quotes, the quotes before each word, the six spaces ------
  // the backslash run before a quote needs at most the previous word: a
  // run that reaches past it is longer than the cap
  int q_total = 0;
  {
    int s_carry = 0;
    bool capped_q = false;
    for (int w0 = 0; w0 < nwords; w0 += 32) {
      const int w = w0 + lane;
      uint32_t rq = 0, spw = 0;
      if (w < nwords) {
        const uint32_t bs = MW(M_BS, w);
        const int run_prev = __clz((int)~(w > 0 ? MW(M_BS, w - 1) : 0u));
        for (uint32_t bits = MW(M_RQ, w); bits; bits &= bits - 1) {
          const int b = __ffs((int)bits) - 1;
          const uint32_t nb = ~bs & low_bits(b);
          const int r = nb ? b - 32 + __clz((int)nb) : b + run_prev;
          if (r >= kEscRunCap)
            capped_q = true;
          else if ((r & 1) == 0)
            rq |= 1u << b;
        }
        spw = MW(M_SP, w);
      }
      const int qc = __popc(rq), sc = __popc(spw);
      const int qi = warp_incl_scan(qc, lane), si = warp_incl_scan(sc, lane);
      if (w < nwords) {
        MW(M_RQ, w) = rq;
        MW(M_QB, w) = (uint32_t)(q_total + qi - qc);
        const int sb = s_carry + si - sc;
        for (int k = sb; k < sb + sc && k < 6; ++k)
          sp_sh[k] = 32 * w + nth_set_bit(spw, k - sb);
      }
      q_total += __shfl_sync(kFull, qi, 31);
      s_carry += __shfl_sync(kFull, si, 31);
    }
    if (warp_any(capped_q)) ok = false;
  }
  __syncwarp();
  int sp[6];
  for (int k = 0; k < 6; ++k) sp[k] = sp_sh[k];
  // real quotes before the 6th space: the count before the rest zone
  int q_before_rest = q_total;
  if (sp[5] < L)
    q_before_rest = (int)MW(M_QB, sp[5] >> 5) +
                    __popc(MW(M_RQ, sp[5] >> 5) & low_bits(sp[5] & 31));
  for (int w = lane; w < nwords; w += 32) {
    // parity of the word's real quotes below each bit, then the word's
    // offset against the rest zone's
    uint32_t x = MW(M_RQ, w) << 1;
    x ^= x << 1;
    x ^= x << 2;
    x ^= x << 4;
    x ^= x << 8;
    x ^= x << 16;
    if (((int)MW(M_QB, w) - q_before_rest) & 1) x = ~x;
    MW(M_OUT, w) = ~x;
  }
  __syncwarp();
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

  // the real quotes before bit b of a word whose real-quote word is rq,
  // less those before the rest zone (the reference's q_excl), from qb:
  // the word's quotes before it less those before the rest zone (read
  // once a word: the passes' atomics may alias the masks for the
  // compiler)
  auto q_excl = [](int qb, uint32_t rq, int b) {
    return qb + __popc(rq & low_bits(b));
  };
  // close quotes of the rest zone in word w
  auto close_bits = [&](int w) {
    return MW(M_RQ, w) & from_bits(w, rest_s) & ~MW(M_OUT, w);
  };

  // ---- pass 4: the structural ']' chain ----------------------------------
  const int rb_sb = bit_length(((L << 3) | 7) + 1);
  {
    const int vmax = (1 << rb_sb) - 2;
    int h_carry = 0;
    for (int w0 = 0; w0 < nwords; w0 += 32) {
      const int w = w0 + lane;
      const uint32_t hits =
          w < nwords ? MW(M_RB, w) & MW(M_OUT, w) & from_bits(w, rest_s)
                     : 0u;
      const int hc = __popc(hits);
      const int hi = warp_incl_scan(hc, lane);
      const int hb = h_carry + hi - hc;
      if (w < nwords) {
        MW(M_HB, w) = (uint32_t)hb;
        // close quotes at the previous positions
        const uint32_t prev_cq =
            (close_bits(w) << 1) | (w > 0 ? close_bits(w - 1) >> 31 : 0u);
        int ord = hb;
        for (uint32_t bits = hits; bits && ord <= MAX_SD; bits &= bits - 1) {
          ++ord;
          const int b = __ffs((int)bits) - 1, i = 32 * w + b;
          const bool next_valid = i + 1 < n;
          const int next_c = B(i + 1);
          const int payload =
              ((B(i - 1) == 32) || ((prev_cq >> b) & 1u) ? 1 : 0) +
              ((next_c == '[' && next_valid) ? 2 : 0) +
              ((next_c == 32 && next_valid) ? 4 : 0);
          const int v = (i << 3) | payload;
          atomicAdd(&S.rb[ord - 1], (uint32_t)((v < vmax ? v : vmax) + 1));
        }
      }
      h_carry += __shfl_sync(kFull, hi, 31);
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
  auto vi = [&](int i) { return (uint32_t)((i < vclip ? i : vclip) + 1); };
  int pair_total = 0;
  int msg_a = L;
  for (int w = lane; w < nwords; w += 32) {
    const uint32_t out = MW(M_OUT, w), rest = from_bits(w, rest_s);
    const uint32_t rq = MW(M_RQ, w), spw = MW(M_SP, w);
    const uint32_t zone_c = is_sd ? rest & upto_bits(w, sd_end_zone) : 0u;
    const uint32_t sd_zone = is_sd ? rest & upto_bits(w, sd_end) : 0u;
    const uint32_t open_q = rq & rest & out;
    const uint32_t close_q = rq & rest & ~out;
    // a close quote or a space at the previous position; '=' there
    const uint32_t prev_cs =
        ((close_q | spw) << 1) |
        (w > 0 ? (close_bits(w - 1) | MW(M_SP, w - 1)) >> 31 : 0u);
    const uint32_t prev_eq =
        (MW(M_EQ, w) << 1) | (w > 0 ? MW(M_EQ, w - 1) >> 31 : 0u);
    const uint32_t hits = MW(M_RB, w) & out & rest, bs = MW(M_BS, w);
    const uint32_t nw = MW(M_NW, w);
    const int hb = (int)MW(M_HB, w), qb = (int)MW(M_QB, w) - q_before_rest;
    const uint32_t sid_sp = spw & out & zone_c & ~prev_cs;
    for (uint32_t bits = sid_sp; bits; bits &= bits - 1) {
      const int b = __ffs((int)bits) - 1;
      // ']' before the space, plus one
      const int ord = hb + __popc(hits & low_bits(b)) + 1;
      if (ord <= MAX_SD) atomicAdd(&S.sid[ord - 1], vi(32 * w + b));
    }
    for (uint32_t bits = open_q & zone_c; bits; bits &= bits - 1) {
      const int b = __ffs((int)bits) - 1;
      const int ord = (q_excl(qb, rq, b) >> 1) + 1;
      if (ord > pair_total) pair_total = ord;
      if (ord >= 1 && ord <= MAX_PAIRS)
        atomicAdd(&S.oq[ord - 1], vi(32 * w + b));
    }
    for (uint32_t bits = close_q & zone_c; bits; bits &= bits - 1) {
      const int b = __ffs((int)bits) - 1;
      const int ord = (q_excl(qb, rq, b) + 1) >> 1;
      if (ord >= 1 && ord <= MAX_PAIRS)
        atomicAdd(&S.cq[ord - 1], vi(32 * w + b));
    }
    // backslashes inside a quoted value
    for (uint32_t bits = bs & ~out; bits; bits &= bits - 1) {
      const int ord = (q_excl(qb, rq, __ffs((int)bits) - 1) >> 1) + 1;
      if (ord >= 1 && ord <= MAX_PAIRS) atomicAdd(&S.esc[ord - 1], 1u);
    }
    if (open_q & sd_zone & ~prev_eq) viol = true;
    const uint32_t msg = nw & from_bits(w, msg_start);
    if (msg && msg_a == L) msg_a = 32 * w + __ffs((int)msg) - 1;
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
    // word w's positions inside a pair's name zone (between an SD-ID end
    // and its ']'), and its name bytes and '=' outside quotes there
    auto pair_bits = [&](int w) {
      uint32_t in_pair = 0;
      if (is_sd)
        for (int k = 0; k < MAX_SD; ++k)
          if (k < sd_count)
            in_pair |= from_bits(w, sid_end[k] + 1) & ~from_bits(w, rb_pos[k]);
      return in_pair;
    };
    for (int w = lane; w < nwords; w += 32) {
      const uint32_t in_pair = pair_bits(w), out = MW(M_OUT, w);
      const uint32_t eqw = MW(M_EQ, w);
      const uint32_t name = MW(M_NM, w) & out & in_pair;
      const uint32_t eqf = eqw & out & in_pair;
      uint32_t name_p = 0, eq_p = 0, sp_p = 0;   // previous word's last bit
      if (w > 0) {
        const uint32_t ip = pair_bits(w - 1), op = MW(M_OUT, w - 1);
        name_p = (MW(M_NM, w - 1) & op & ip) >> 31;
        eq_p = (MW(M_EQ, w - 1) & op & ip) >> 31;
        sp_p = MW(M_SP, w - 1) >> 31;
      }
      const uint32_t prev_name = (name << 1) | name_p;
      const uint32_t prev_eq = (eqf << 1) | eq_p;
      const uint32_t valid = ~from_bits(w, n);
      const uint32_t rest = from_bits(w, rest_s), rq = MW(M_RQ, w);
      const uint32_t open_q = rq & rest & out, spw = MW(M_SP, w);
      const int qb = (int)MW(M_QB, w) - q_before_rest;
      // run end of the previous position: its next byte must be '='
      if (prev_name & ~name & ~eqw & valid) viol = true;
      // '=' at the previous position must be followed by an open quote
      if (prev_eq & ~(open_q & in_pair) & valid) viol = true;
      const uint32_t starts = name & ~prev_name;
      if (starts & ~((spw << 1) | sp_p)) viol = true;
      for (uint32_t bits = starts; bits; bits &= bits - 1) {
        const int b = __ffs((int)bits) - 1;
        const int ord = (q_excl(qb, rq, b) >> 1) + 1;
        if (ord >= 1 && ord <= MAX_PAIRS)
          atomicAdd(&S.ns[ord - 1], vi(32 * w + b));
      }
      const uint32_t sd_zone = is_sd ? rest & upto_bits(w, sd_end) : 0u;
      if (rq & sd_zone & ~in_pair) viol = true;
      // the last valid position: its next byte is padding (never '=', and
      // never an open quote)
      if (w == (n - 1) >> 5 && (((name | eqf) >> ((n - 1) & 31)) & 1u))
        viol = true;
    }
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
