// Constants and warp helpers shared by the port's one-warp-a-row kernels
// (the decodes, the GELF encodes and the fused routes).  Every lane of a
// warp calls each warp helper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fg {

constexpr int kWarps = 8;                // rows per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ bool is_digit(int c) { return c >= 48 && c <= 57; }

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

__device__ __forceinline__ unsigned lanemask_lt(int lane) {
  return (1u << lane) - 1u;
}

// index of the j-th (from 0) set bit of m; m has more than j set bits
__device__ __forceinline__ int nth_set_bit(unsigned m, int j) {
  for (int t = 0; t < j; ++t) m &= m - 1u;
  return __ffs((int)m) - 1;
}

__device__ __forceinline__ bool warp_any(bool p) {
  return __ballot_sync(kFull, p) != 0;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    int w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    int w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Four bytes at a time (SWAR): 0x80 in each byte of the result where
// the byte of x is below c (c <= 0x80; (x | 0x80) - c never borrows
// across bytes), or equal to c.
__device__ __forceinline__ uint32_t bytes_below(uint32_t x, uint32_t c) {
  return ~((x | 0x80808080u) - c * 0x01010101u) & ~x & 0x80808080u;
}

__device__ __forceinline__ uint32_t bytes_equal(uint32_t x, uint32_t c) {
  const uint32_t y = x ^ (c * 0x01010101u);
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu);
}

// the four flag bits (bits 7, 15, 23, 31) of a SWAR result as a nibble
__device__ __forceinline__ unsigned nibble(uint32_t f) {
  return ((f >> 7) * 0x10204080u) >> 28;
}

// inclusive sum of v over lanes 0..lane
__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Stages a row's first n bytes (its valid bytes) in shared memory: 16-byte
// loads where the row is 16-byte aligned and L a multiple of 16 (the
// last chunk then carries the row's zero padding), bytes otherwise (the
// staged bytes past n are then whatever the buffer held).
__device__ __forceinline__ void stage_row(const uint8_t* __restrict__ src,
                                          int n, int L, uint4* stage,
                                          int lane) {
  if ((L & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int v = lane; v < (n + 15) >> 4; v += 32) stage[v] = s4[v];
  } else {
    uint8_t* d = reinterpret_cast<uint8_t*>(stage);
    for (int j = lane; j < n; j += 32) d[j] = src[j];
  }
}

}  // namespace fg
