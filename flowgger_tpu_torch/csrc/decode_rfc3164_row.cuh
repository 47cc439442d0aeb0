// The RFC3164 row decode of kernel D3 (decode_rfc3164.cu), one warp a
// row: the device function shared by D3 and the fused rfc3164 -> GELF
// route (fused_gelf.cu).
//
// It computes the channels of the JAX package's jnp decode_rfc3164
// (flowgger_tpu/tpu/rfc3164.py:55) for one row, on every row, rejected
// rows included: the reference's whole-row masked reductions become two
// warp passes over the row's valid bytes (ballots for first positions,
// per-lane flags reduced once) and a few single-byte reads at positions
// the passes found.  Positions past the row's length read 0, as the
// reference's zero-masked byte plane does; positions past L do not
// exist (the reference's reductions run over the L columns).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace r3 {

using namespace fg;

// channel rows of the packed output (tpu/rfc3164.py KEYS)
enum Ch3164 {
  C_OK, C_HAS_PRI, C_HAS_HIGH, C_FACILITY, C_SEVERITY, C_DAYS, C_SOD,
  C_OFF, C_NANOS, C_HOST_S, C_HOST_E, C_MSG_START, kChannels
};

// bytes an IANA zone name may hold: letters, digits, / _ + -
__device__ __forceinline__ bool tz_char(int c) {
  return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || is_digit(c) ||
         c == '/' || c == '_' || c == '+' || c == '-';
}

// Decodes one row with the calling warp and writes its channel values to
// col[ch * kWarps] (the block's channel tile).  With DEMAND only the
// channels the GELF encode reads are written (the fused route's
// fused_routes.DEMAND["rfc3164_gelf"]): no facility.
template <bool DEMAND = false>
__device__ __forceinline__ void decode3164_row(
    const uint8_t* __restrict__ src, const int len, const int L,
    const int year, uint4* __restrict__ stage, int32_t* __restrict__ col,
    const int lane) {
  const int n = len < L ? (len > 0 ? len : 0) : L;  // valid positions
  stage_row(src, n, L, stage, lane);
  __syncwarp();
  const uint8_t* rb = reinterpret_cast<const uint8_t*>(stage);
  auto B = [&](int i) -> int { return (i >= 0 && i < n) ? rb[i] : 0; };

  // ---- pass 1: '>', the first non-digit after the '<', high bytes, other
  // whitespace, the last double space ------------------------------------
  int gt = L, nd1 = L, last_dbl = -1;
  bool high = false, ws_other = false;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    const int c = valid ? rb[i] : 0;
    const unsigned gtb = __ballot_sync(kFull, valid && c == '>');
    if (gt == L && gtb) gt = base + __ffs((int)gtb) - 1;
    const unsigned ndb = __ballot_sync(kFull, valid && i >= 1 && !is_digit(c));
    if (nd1 == L && ndb) nd1 = base + __ffs((int)ndb) - 1;
    high = high || (valid && c >= 128);
    ws_other = ws_other || (valid && ((c >= 9 && c <= 13) ||
                                      (c >= 28 && c <= 31)));
    if (valid && c == ' ' && B(i + 1) == ' ') last_dbl = i;
  }
  // positions past the row (up to L) read 0, a non-digit
  if (nd1 == L) {
    const int first_pad = n > 1 ? n : 1;
    if (first_pad < L) nd1 = first_pad;
  }
  high = warp_any(high);
  ws_other = warp_any(ws_other);
  last_dbl = warp_max(last_dbl);

  // ---- optional <pri> ---------------------------------------------------
  const bool has_pri = B(0) == '<';
  int pri = 0;
  if (has_pri) {
    // digits at gt-1, gt-2, gt-3 (those at >= 1) weigh 1, 10, 100
    int w = 1;
    for (int e = 0; e < 3; ++e, w *= 10)
      if (gt - 1 - e >= 1) pri += (B(gt - 1 - e) - 48) * w;
  }
  const int ndig = gt - 1;
  const bool pri_ok = !has_pri || (gt < L && ndig >= 1 && ndig <= 3 &&
                                   pri <= 255 && !(nd1 < gt));
  const int m0 = has_pri ? gt + 1 : 0;
  bool ok = pri_ok;

  // ---- month at m0 ------------------------------------------------------
  int month = 0;
  if (m0 < L) {
    const int b0 = B(m0), b1 = B(m0 + 1), b2 = B(m0 + 2);
    const char* names = "JanFebMarAprMayJunJulAugSepOctNovDec";
    for (int k = 0; k < 12; ++k)
      if (b0 == names[3 * k] && b1 == names[3 * k + 1] &&
          b2 == names[3 * k + 2])
        month = k + 1;
  }
  ok = ok && month > 0;

  // ---- day layouts: A "Mon dd ", B "Mon d ", C "Mon  d " ------------------
  ok = ok && B(m0 + 3) == ' ';
  const int d0 = B(m0 + 4), d1 = B(m0 + 5), d2 = B(m0 + 6);
  const bool case_a = is_digit(d0) && is_digit(d1);
  const bool case_b = is_digit(d0) && d1 == ' ';
  const bool case_c = d0 == ' ' && is_digit(d1) && d2 == ' ';
  ok = ok && (case_a || case_b || case_c);
  const int day = case_a ? (d0 - 48) * 10 + (d1 - 48)
                         : case_b ? d0 - 48 : d1 - 48;
  const int t0 = m0 + (case_b ? 6 : 7);   // time start
  ok = ok && B(t0 - 1) == ' ';
  int hour = 0, minute = 0, sec = 0;
  bool tviol = false;
  for (int rt = 0; rt < 8; ++rt) {
    const int p = t0 + rt;
    if (p >= L) break;
    const int c = B(p);
    const int dz = c - 48;
    if (rt == 0) hour += dz * 10;
    if (rt == 1) hour += dz;
    if (rt == 3) minute += dz * 10;
    if (rt == 4) minute += dz;
    if (rt == 6) sec += dz * 10;
    if (rt == 7) sec += dz;
    if (rt == 2 || rt == 5) {
      if (c != ':') tviol = true;
    } else if (!is_digit(c)) {
      tviol = true;
    }
  }
  ok = ok && !tviol && hour <= 23 && minute <= 59 && sec <= 59;
  ok = ok && day >= 1 && day <= days_in_month(year, month);

  // ---- host token: pass 2 from host_s to its first space -----------------
  const int host_s = t0 + 9;
  ok = ok && B(t0 + 8) == ' ';
  int host_e = L;
  bool non_tz = false;
  for (int base = host_s; base < n && host_e == L; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    const int c = valid ? rb[i] : 0;
    const unsigned spb = __ballot_sync(kFull, valid && c == ' ');
    const int stop = spb ? base + __ffs((int)spb) - 1 : base + 32;
    if (spb) host_e = stop;
    non_tz = non_tz || (valid && i < stop && !tz_char(c));
  }
  non_tz = warp_any(non_tz);
  if (host_e > len) host_e = len;
  ok = ok && host_e > host_s;             // nonempty hostname token
  const int msg_start = host_e + 1 < len ? host_e + 1 : len;

  // ---- strictness: other whitespace, a double space from the time on, a
  // leading or trailing space ----------------------------------------------
  ok = ok && !ws_other && !(last_dbl >= t0) && B(len - 1) != ' ' &&
       B(0) != ' ' && len >= 1;

  // ---- the timezone-lookalike guard on the host token ---------------------
  const int first = B(host_s);
  const bool humble = (first >= 'a' && first <= 'z') || is_digit(first);
  const int host_len = host_e - host_s;
  auto literal = [&](const char* text, int tlen) {
    if (host_s >= L || host_len != tlen) return false;
    for (int k = 0; k < tlen; ++k)
      if (B(host_s + k) != text[k]) return false;
    return true;
  };
  const bool alias = literal("localtime", 9) || literal("posixrules", 10);
  ok = ok && (non_tz || (humble && !alias));

  // ---- channel values into the block's tile --------------------------------
  if (lane == 0) {
    auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
    put(C_OK, ok);
    put(C_HAS_PRI, has_pri);
    put(C_HAS_HIGH, high);
    if (!DEMAND) put(C_FACILITY, pri >> 3);
    put(C_SEVERITY, pri & 7);
    put(C_DAYS, days_from_civil(year, month, day));
    put(C_SOD, hour * 3600 + minute * 60 + sec);
    put(C_OFF, 0);
    put(C_NANOS, 0);
    put(C_HOST_S, host_s);
    put(C_HOST_E, host_e);
    put(C_MSG_START, msg_start);
  }
}

}  // namespace r3
