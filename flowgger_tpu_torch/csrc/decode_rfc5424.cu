// RFC5424 structural decode, one CUDA thread per row.
//
// Replaces the JAX package's Pallas kernel decode_rfc5424_pallas
// (flowgger_tpu/tpu/rfc5424.py:1095, pallas_call :1145), which runs the
// vectorized decode_rfc5424 body (:414) over [256, L] VMEM tiles.
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// channels of tpu/rfc5424.py (_KEYS_1D, _KEYS_SD x max_sd, _KEYS_PAIR x
// max_pairs), written channel-major into one int32 [C, N] tensor so each
// channel store is coalesced across the warp.  The definitions are the
// reference's vectorized ones, evaluated here as six sequential passes
// over the row: every "k-th masked position" extraction keeps the
// reference's bit-packed sum form (several ordinals per wrapping 32-bit
// word, so multi-hit ordinals on malformed rows carry exactly as they do
// there), and the three packed field words wrap the same way.  So the
// kernel agrees with the plain PyTorch version on every row — ok and
// pair_count included — not only on accepted rows.
//
// Bound on the H100: bytes.  One read of the batch plus the channel
// writes; the arithmetic per byte is a few dozen integer operations.
// Design: a block stages 32 rows in shared memory with coalesced loads
// (row stride padded to an odd word count, so the 32 threads reading
// byte i of their own rows hit 32 different banks), then each thread
// walks its row from shared memory.  Passes stop at the row's length,
// except where a malformed row's PRI or timestamp zone runs into the
// padding.  This is the simple first kernel; one thread per row leaves
// the card latency-bound at this batch size (see PERF.md).
//
// TPU workarounds not carried over: the u8->i32 widening (bytes stay
// u8), the log-shift scan ladders (sequential counters), and the f32
// reductions (integer sums).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;
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

// Fold per-ordinal sums into packed wrapping words (slots ordinals per
// word, sb bits each) and read the slots back: extract_by_ord "sum".
template <int K>
__device__ __forceinline__ void unpack_slots(const uint32_t* sums,
                                             uint32_t* vals, int sb) {
  int slots = 30 / sb;
  if (slots < 1) slots = 1;
  uint32_t mask = (1u << sb) - 1u;
  for (int base = 0; base < K; base += slots) {
    uint32_t word = 0;
    for (int s = 0; s < slots && base + s < K; ++s)
      word += sums[base + s] << (sb * s);
    for (int s = 0; s < slots && base + s < K; ++s)
      vals[base + s] = (word >> (sb * s)) & mask;
  }
}

__device__ __forceinline__ bool is_digit(int c) { return c >= 48 && c <= 57; }
__device__ __forceinline__ bool is_ws(int c) {
  return (c >= 9 && c <= 13) || (c >= 28 && c <= 32);
}
__device__ __forceinline__ bool is_name_byte(int c) {
  return c >= 33 && c <= 126 && c != 34 && c != 61 && c != 93;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int days_from_civil(int y, int m, int d) {
  y -= (m <= 2) ? 1 : 0;
  int era = floor_div(y, 400);
  int yoe = y - era * 400;
  int mp = m > 2 ? m - 3 : m + 9;
  int doy = floor_div(153 * mp + 2, 5) + d - 1;
  int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

__device__ __forceinline__ int days_in_month(int y, int m) {
  bool is31 = m >= 8 ? (m % 2) == 0 : (m % 2) == 1;
  bool leap = (y % 4 == 0) && ((y % 100 != 0) || (y % 400 == 0));
  if (m == 2) return leap ? 29 : 28;
  return is31 ? 31 : 30;
}

// Running escape / quote state shared by the passes: escaped(i) is the
// parity of the backslash run ending at i-1 (runs capped at
// ESC_RUN_CAP-1), and q_before counts real quotes strictly before i.
struct QuoteState {
  int run = 0;        // backslash run ending at the previous position
  int q_before = 0;   // real quotes at positions < i
  bool real_q = false;
  bool cap = false;
  __device__ __forceinline__ void step(int c) {
    int rp = run < kEscRunCap - 1 ? run : kEscRunCap - 1;
    bool escaped = (rp & 1) != 0;
    cap = run >= kEscRunCap;
    real_q = (c == 34) && !escaped;
    run = (c == 92) ? run + 1 : 0;
  }
  __device__ __forceinline__ void advance() { q_before += real_q ? 1 : 0; }
};

template <int MAX_SD, int MAX_PAIRS>
__global__ void __launch_bounds__(kRowsPerBlock)
decode_rfc5424_kernel(const uint8_t* __restrict__ batch,
                      const int32_t* __restrict__ lens_in,
                      int32_t* __restrict__ out, int N, int L,
                      int stride_words) {
  extern __shared__ uint32_t smem[];
  const int row0 = blockIdx.x * kRowsPerBlock;
  // cooperative, coalesced staging of this block's rows
  for (int r = 0; r < kRowsPerBlock && row0 + r < N; ++r) {
    const uint8_t* src = batch + (size_t)(row0 + r) * L;
    uint8_t* dst = reinterpret_cast<uint8_t*>(smem + r * stride_words);
    for (int j = threadIdx.x; j < L; j += blockDim.x) dst[j] = src[j];
  }
  __syncthreads();
  const int row = row0 + threadIdx.x;
  if (row >= N) return;
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(
      smem + threadIdx.x * stride_words);

  const int len = lens_in[row];
  const int n = len < L ? (len > 0 ? len : 0) : L;  // valid positions
  auto B = [&](int i) -> int { return (i >= 0 && i < n) ? rb[i] : 0; };

  // ---- BOM --------------------------------------------------------------
  const bool bom = len >= 3 && B(0) == 0xEF && B(1) == 0xBB && B(2) == 0xBF;
  const int start0 = bom ? 3 : 0;
  bool ok = (bom ? B(3) : B(0)) == '<';
  bool viol = false;

  // ---- pass 1: spaces, '>', quote totals, trim end -----------------------
  int sp[6];
  for (int k = 0; k < 6; ++k) sp[k] = L;
  int n_sp = 0, gt = L, trim_last = 0, q_before_rest = -1;
  {
    QuoteState qs;
    for (int i = 0; i < n; ++i) {
      int c = rb[i];
      qs.step(c);
      if (qs.cap && c == 34) ok = false;
      qs.advance();
      if (c == 32) {
        if (n_sp < 6) sp[n_sp] = i;
        ++n_sp;
        // quotes up to and including the 6th space: the count before
        // the rest zone (the space itself is not a quote)
        if (n_sp == 6) q_before_rest = qs.q_before;
      }
      if (c == '>' && i > start0 && gt == L) gt = i;
      if (!is_ws(c)) trim_last = i + 1;
    }
    if (q_before_rest < 0) q_before_rest = qs.q_before;
  }
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
  // them too — every channel then matches the reference on every row
  int m = gt > ts_s + tlen ? gt : ts_s + tlen;
  m = m < L ? m : L;
  m = m > n ? m : n;

  // ---- pass 2: words 1 and 2, header violations, fraction run -----------
  uint32_t word1 = 0, word2 = 0;
  int frac_run = 10;
  for (int i = 0; i < m; ++i) {
    int c = i < n ? rb[i] : 0;
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
  bool any_high = false;
  for (int i = 0; i < m; ++i) {
    int c = i < n ? rb[i] : 0;
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
    if (c >= 128) {
      any_high = true;
      if (pack_high) word3 += 1u << 19;
    }
  }
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
  uint32_t rb_sum[MAX_SD + 1];
  for (int k = 0; k <= MAX_SD; ++k) rb_sum[k] = 0;
  {
    QuoteState qs;
    int rb_ord = 0;
    bool prev_closeq = false;
    int prev_c = 0;
    for (int i = 0; i < n; ++i) {
      int c = rb[i];
      qs.step(c);
      int q_excl = qs.q_before - q_before_rest;
      bool outside = (q_excl & 1) == 0;
      bool in_rest = i >= rest_s;
      bool close_q = qs.real_q && in_rest && !outside;
      if (c == ']' && outside && in_rest) {
        ++rb_ord;
        bool next_valid = i + 1 < n;
        int next_c = next_valid ? rb[i + 1] : 0;
        int payload = ((prev_c == 32) || prev_closeq ? 1 : 0)
                      + ((next_c == '[' && next_valid) ? 2 : 0)
                      + ((next_c == 32 && next_valid) ? 4 : 0);
        if (rb_ord <= MAX_SD + 1) {
          int v = (i << 3) | payload;
          int vmax = (1 << rb_sb) - 2;
          rb_sum[rb_ord - 1] += (uint32_t)((v < vmax ? v : vmax) + 1);
        }
      }
      prev_closeq = close_q;
      prev_c = c;
      qs.advance();
    }
  }
  int rb_pos[MAX_SD + 1], rb_flags[MAX_SD + 1];
  {
    uint32_t vals[MAX_SD + 1];
    unpack_slots<MAX_SD + 1>(rb_sum, vals, rb_sb);
    for (int k = 0; k <= MAX_SD; ++k) {
      int w = vals[k] == 0 ? (L << 3) : (int)vals[k] - 1;
      rb_pos[k] = w >> 3;
      rb_flags[k] = w & 7;
    }
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
  const int sd_end = rb_pos[last_idx];
  const int end_flags = rb_flags[last_idx];
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
  uint32_t sid_sum[MAX_SD], oq_sum[MAX_PAIRS], cq_sum[MAX_PAIRS],
      esc_sum[MAX_PAIRS];
  for (int k = 0; k < MAX_SD; ++k) sid_sum[k] = 0;
  for (int k = 0; k < MAX_PAIRS; ++k) oq_sum[k] = cq_sum[k] = esc_sum[k] = 0;
  int pair_total = 0;
  int msg_a = L;
  {
    QuoteState qs;
    int rb_ord = 0;
    bool prev_closeq = false, prev_sp = false;
    int prev_c = 0;
    for (int i = 0; i < n; ++i) {
      int c = rb[i];
      qs.step(c);
      int q_excl = qs.q_before - q_before_rest;
      bool outside = (q_excl & 1) == 0;
      bool in_rest = i >= rest_s;
      bool real_q = qs.real_q && in_rest;
      bool open_q = real_q && outside;
      bool close_q = real_q && !outside;
      bool zone_c = in_rest && i <= sd_end_zone && is_sd;
      bool sd_zone = in_rest && i <= sd_end && is_sd;
      if (c == ']' && outside && in_rest) ++rb_ord;
      int vi = (i < vclip ? i : vclip) + 1;
      bool is_sp = c == 32;
      if (is_sp && outside && zone_c && !prev_closeq && !prev_sp) {
        int ord = rb_ord + 1;
        if (ord >= 1 && ord <= MAX_SD) sid_sum[ord - 1] += (uint32_t)vi;
      }
      if (open_q && zone_c) {
        int ord = (q_excl >> 1) + 1;
        if (ord > pair_total) pair_total = ord;
        if (ord >= 1 && ord <= MAX_PAIRS) oq_sum[ord - 1] += (uint32_t)vi;
      }
      if (close_q && zone_c) {
        int ord = (q_excl + 1) >> 1;
        if (ord >= 1 && ord <= MAX_PAIRS) cq_sum[ord - 1] += (uint32_t)vi;
      }
      if (c == 92 && (q_excl & 1) == 1) {
        int ord = (q_excl >> 1) + 1;
        if (ord >= 1 && ord <= MAX_PAIRS) esc_sum[ord - 1] += 1u;
      }
      if (open_q && sd_zone && prev_c != '=') viol = true;
      if (!is_ws(c) && i >= msg_start && msg_a == L) msg_a = i;
      prev_closeq = close_q;
      prev_sp = is_sp;
      prev_c = c;
      qs.advance();
    }
  }
  int sid_end[MAX_SD];
  {
    uint32_t vals[MAX_SD];
    unpack_slots<MAX_SD>(sid_sum, vals, sb);
    for (int k = 0; k < MAX_SD; ++k)
      sid_end[k] = vals[k] == 0 ? L : (int)vals[k] - 1;
  }
  if (is_sd) {
    for (int k = 0; k < MAX_SD; ++k)
      if (k < sd_count && !(sid_end[k] < rb_pos[k])) ok = false;
  }
  const int pair_count = is_sd ? pair_total : 0;
  if (is_sd) ok = ok && pair_count <= MAX_PAIRS;
  int oq_pos[MAX_PAIRS], cq_pos[MAX_PAIRS];
  uint32_t esc_cnt[MAX_PAIRS];
  {
    uint32_t vals[MAX_PAIRS];
    unpack_slots<MAX_PAIRS>(oq_sum, vals, sb);
    for (int k = 0; k < MAX_PAIRS; ++k)
      oq_pos[k] = vals[k] == 0 ? L : (int)vals[k] - 1;
    unpack_slots<MAX_PAIRS>(cq_sum, vals, sb);
    for (int k = 0; k < MAX_PAIRS; ++k)
      cq_pos[k] = vals[k] == 0 ? L : (int)vals[k] - 1;
    unpack_slots<MAX_PAIRS>(esc_sum, esc_cnt, sb);
  }

  // ---- pass 6: pair-name structure and name starts ----------------------
  uint32_t ns_sum[MAX_PAIRS];
  for (int k = 0; k < MAX_PAIRS; ++k) ns_sum[k] = 0;
  {
    QuoteState qs;
    bool prev_name = false, prev_eq = false;
    int prev_c = 0;
    for (int i = 0; i < n; ++i) {
      int c = rb[i];
      qs.step(c);
      int q_excl = qs.q_before - q_before_rest;
      bool outside = (q_excl & 1) == 0;
      bool in_rest = i >= rest_s;
      bool real_q = qs.real_q && in_rest;
      bool open_q = real_q && outside;
      bool sd_zone = in_rest && i <= sd_end && is_sd;
      bool in_pair = false;
      if (is_sd) {
        for (int k = 0; k < MAX_SD; ++k)
          in_pair = in_pair || (k < sd_count && i > sid_end[k]
                                && i < rb_pos[k]);
      }
      bool name = is_name_byte(c) && outside && in_pair;
      // run end of the previous position: its next byte must be '='
      if (prev_name && !name && c != '=') viol = true;
      // '=' at the previous position must be followed by an open quote
      if (prev_eq && !(open_q && in_pair)) viol = true;
      if (name && !prev_name) {
        if (prev_c != 32) viol = true;
        int ord = (q_excl >> 1) + 1;
        if (ord >= 1 && ord <= MAX_PAIRS)
          ns_sum[ord - 1] += (uint32_t)((i < vclip ? i : vclip) + 1);
      }
      if (real_q && sd_zone && !in_pair) viol = true;
      prev_name = name;
      prev_eq = c == '=' && outside && in_pair;
      prev_c = c;
      qs.advance();
    }
    // the last valid position: its next byte is padding (never '=', and
    // never an open quote)
    if (prev_name || prev_eq) viol = true;
  }
  int ns_pos[MAX_PAIRS];
  {
    uint32_t vals[MAX_PAIRS];
    unpack_slots<MAX_PAIRS>(ns_sum, vals, sb);
    for (int k = 0; k < MAX_PAIRS; ++k)
      ns_pos[k] = vals[k] == 0 ? L : (int)vals[k] - 1;
  }
  for (int k = 0; k < MAX_PAIRS; ++k) {
    if (k < pair_count) {
      if (!(ns_pos[k] <= oq_pos[k] - 2)) ok = false;
      if (!(cq_pos[k] > oq_pos[k])) ok = false;
    }
  }
  int trim_end = trim_last > start0 ? trim_last : start0;
  int msg_trim_start = msg_a < trim_end ? msg_a : trim_end;
  ok = ok && !viol;

  // ---- channel-major stores ---------------------------------------------
  auto put = [&](int ch, int v) { out[(size_t)ch * N + row] = v; };
  put(C_OK, ok);
  put(C_BOM, bom);
  put(C_FACILITY, pri >> 3);
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
  put(C_MSGID_S, f_start[5]);
  put(C_MSGID_E, f_end[5]);
  put(C_MSG_START, msg_start);
  put(C_SD_COUNT, sd_count);
  put(C_PAIR_COUNT, pair_count);
  put(C_FULL_START, start0);
  put(C_TRIM_END, trim_end);
  put(C_MSG_TRIM_START, msg_trim_start);
  put(C_HAS_HIGH, has_high);
  int ch = kN1D;
  for (int k = 0; k < MAX_SD; ++k) put(ch + k, blk_start[k] + 1);
  ch += MAX_SD;
  for (int k = 0; k < MAX_SD; ++k) put(ch + k, sid_end[k]);
  ch += MAX_SD;
  for (int k = 0; k < MAX_PAIRS; ++k) {
    bool pv = k < pair_count;
    int psd = -1;
    for (int j = 0; j < MAX_SD; ++j) psd += blk_start[j] <= oq_pos[k] ? 1 : 0;
    psd = psd < 0 ? 0 : (psd > MAX_SD - 1 ? MAX_SD - 1 : psd);
    put(ch + k, pv ? ns_pos[k] : 0);                          // name_start
    put(ch + MAX_PAIRS + k, oq_pos[k] - 1);                   // name_end
    put(ch + 2 * MAX_PAIRS + k, oq_pos[k] + 1);               // val_start
    put(ch + 3 * MAX_PAIRS + k, cq_pos[k]);                   // val_end
    put(ch + 4 * MAX_PAIRS + k, pv ? psd : 0);                // pair_sd
    put(ch + 5 * MAX_PAIRS + k,                               // val_has_esc
        esc_cnt[k] > 0 && pv && cq_pos[k] > oq_pos[k] + 1);
  }
}

template <int MAX_SD, int MAX_PAIRS>
int launch(const void* batch, const void* lens, void* out, int N, int L,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  const int stride_words = (((L + 3) / 4) | 1);
  const size_t smem = (size_t)kRowsPerBlock * stride_words * 4;
  auto kern = decode_rfc5424_kernel<MAX_SD, MAX_PAIRS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  kern<<<grid, kRowsPerBlock, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, L, stride_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Packed channel count for the instantiations below: 23 + 2*4 + 6*P.
int fg_decode_rfc5424_sd4_p6(const void* batch, const void* lens, void* out,
                             int N, int L, void* stream) {
  return launch<4, 6>(batch, lens, out, N, L,
                      static_cast<cudaStream_t>(stream));
}

int fg_decode_rfc5424_sd4_p16(const void* batch, const void* lens, void* out,
                              int N, int L, void* stream) {
  return launch<4, 16>(batch, lens, out, N, L,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
