// DNS query-log decode, one warp per row: kernel DN.
//
// Replaces the JAX package's jnp device program decode_dns
// (flowgger_tpu/tpu/dns.py:44; jitted as decode_dns_jit :105), which is
// not a pallas_call: the reference builds a tab-ordinal cumsum over the
// [N, L] batch, extracts the first five tab positions with its packed-sum
// extraction, and checks the ts and latency fields with masked [N, L]
// reductions.
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// channels of tpu/dns.py KEYS — ok, has_high and the start and end of
// ts, client, qname, qtype, rcode and latency — written channel-major
// into one int32 [14, N] tensor, equal to the plain version
// (tpu/dns.py decode_dns) on every row:
//   - t0..t4 are the positions of the row's first five tabs among its
//     valid bytes; a missing one is L, then each is clipped to the row's
//     length (the reference's extract_by_ord with fill L, then minimum);
//   - ts is [0, t0), client [t0+1, t1), qname [t1+1, t2), qtype
//     [t2+1, t3), rcode [t3+1, t4), latency [t4+1, len) (its start may
//     pass the length);
//   - ok: exactly five tabs, ts a non-empty digits[.digits] with no dot
//     at either edge, latency 1..19 digits, client and qname non-empty.
// Rows at and past n (the batch's real rows) are padding: they get the
// channels of an empty row and their bytes are never loaded.
//
// Bound on the H100: bytes (one read of each real row's valid bytes and
// 56 bytes of channels a row; a few integer operations a byte).  Design:
// - One warp per row, eight rows per block.  Lane j holds 16 bytes a
//   step (one 16-byte load where the rows are 16-byte aligned, else byte
//   loads; bytes past the row's length masked), 512 bytes a step.
// - Pass 1 builds each lane's 16-bit tab mask (SWAR compares, one flag
//   bit a byte), a warp scan of their popcounts gives each chunk its tabs
//   before it, and the lane that holds the k-th tab (k = 1..5) finds it
//   with nth_set_bit; a ballot and a shuffle hand it to the warp.  The
//   same pass ballots the bytes >= 0x80.
// - Pass 2 knows t0 and t4: per chunk, the non-digit, dot and digit
//   masks against the ts range [0, t0) and the latency range
//   [t4 + 1, len) give the violations (ballots) and the dot count (a
//   warp sum).  The second read of the row hits the cache the first
//   filled.
// - Channel values go through a shared [14, 8] tile, so each channel is
//   stored as one 32-byte run of the block's eight rows.
//
// TPU workarounds not carried over: the [N, L] cumsum and the packed-sum
// extraction, the [N, L] range masks of the two checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace {

using namespace fg;

constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 32 * 16;           // bytes a warp holds a step
constexpr int kChannels = 14;            // tpu/dns.py KEYS
constexpr int kTabs = 5;                 // separators of the six fields
constexpr int kMaxLat = 19;              // latency digits that fit u64

enum ChDns {
  D_OK, D_HIGH, D_TS_S, D_TS_E, D_CL_S, D_CL_E, D_QN_S, D_QN_E, D_QT_S,
  D_QT_E, D_RC_S, D_RC_E, D_LAT_S, D_LAT_E
};

// The 16 bytes of the chunk at j0 (zeros at and past vlen) as four words.
__device__ __forceinline__ void load16(const uint8_t* __restrict__ src,
                                       int j0, int vlen, bool vec,
                                       uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (j0 >= vlen) return;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + j0);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (j0 + i < vlen) w[i >> 2] |= (uint32_t)src[j0 + i] << (8 * (i & 3));
  }
}

// One flag bit a byte (bit i = byte i) of a SWAR predicate over w,
// limited to the chunk's valid bytes.
template <class Pred>
__device__ __forceinline__ unsigned mask16(const uint32_t (&w)[4],
                                           int nvalid, Pred pred) {
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) m |= nibble(pred(w[q])) << (4 * q);
  const unsigned keep =
      nvalid >= 16 ? 0xFFFFu : nvalid <= 0 ? 0u : (1u << nvalid) - 1u;
  return m & keep;
}

// Bits [a, b) of a chunk starting at j0 (empty where b <= a).
__device__ __forceinline__ unsigned range16(int j0, int a, int b) {
  const int lo = a - j0 < 0 ? 0 : (a - j0 > 16 ? 16 : a - j0);
  const int hi = b - j0 < 0 ? 0 : (b - j0 > 16 ? 16 : b - j0);
  if (hi <= lo) return 0u;
  return ((hi == 16 ? 0x10000u : (1u << hi)) - (1u << lo)) & 0xFFFFu;
}

__device__ __forceinline__ unsigned digits16(const uint32_t (&w)[4],
                                             int nvalid) {
  return mask16(w, nvalid, [](uint32_t x) {
    return bytes_below(x, 58) & ~bytes_below(x, 48);
  });
}

// Decodes one row with the calling warp into its column of the tile.
__device__ __forceinline__ void decode_dns_row(
    const uint8_t* __restrict__ src, int len, int L, bool vec,
    int32_t* __restrict__ col, int lane) {
  const int vlen = len < 0 ? 0 : (len > L ? L : len);
  const int fill = L < len ? L : len;    // a missing tab, clipped
  int tpos[kTabs];
#pragma unroll
  for (int k = 0; k < kTabs; ++k) tpos[k] = -1;

  // ---- pass 1: the tabs and the high bytes --------------------------------
  int carry = 0;
  bool high = false;
  for (int base = 0; base < vlen; base += kStep) {
    const int j0 = base + 16 * lane;
    uint32_t w[4];
    load16(src, j0, vlen, vec, w);
    const int nvalid = vlen - j0;
    const unsigned tabs =
        mask16(w, nvalid, [](uint32_t x) { return bytes_equal(x, 9); });
    high |= (w[0] | w[1] | w[2] | w[3]) & 0x80808080u;
    const int cnt = __popc(tabs);
    const int incl = warp_incl_scan(cnt, lane);
    const int before = carry + incl - cnt;
#pragma unroll
    for (int k = 0; k < kTabs; ++k) {
      const bool owns = before < k + 1 && k + 1 <= before + cnt;
      const unsigned b = __ballot_sync(kFull, owns);
      const int p = owns ? j0 + nth_set_bit(tabs, k - before) : 0;
      const int at = __shfl_sync(kFull, p, b ? __ffs((int)b) - 1 : 0);
      if (b && tpos[k] < 0) tpos[k] = at;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  const bool has_high = warp_any(high);
  int t[kTabs];
#pragma unroll
  for (int k = 0; k < kTabs; ++k) t[k] = tpos[k] < 0 ? fill : tpos[k];
  const int t0 = t[0], lat_s = t[4] + 1;

  // ---- pass 2: the ts and latency grammars --------------------------------
  bool ts_bad = false, lat_bad = false;
  int dots = 0;
  for (int base = 0; base < vlen; base += kStep) {
    const int j0 = base + 16 * lane;
    uint32_t w[4];
    load16(src, j0, vlen, vec, w);
    const int nvalid = vlen - j0;
    const unsigned dig = digits16(w, nvalid);
    const unsigned dot =
        mask16(w, nvalid, [](uint32_t x) { return bytes_equal(x, 46); });
    const unsigned valid = range16(j0, 0, vlen);
    const unsigned in_ts = range16(j0, 0, t0);
    const unsigned edge = range16(j0, 0, 1) | range16(j0, t0 - 1, t0);
    ts_bad |= (in_ts & ((valid & ~dig & ~dot) | (dot & edge))) != 0u;
    dots += __popc(in_ts & dot);
    lat_bad |= (range16(j0, lat_s, vlen) & ~dig) != 0u;
  }
  const bool ts_ok = !warp_any(ts_bad) &&
                     (int)__reduce_add_sync(kFull, (unsigned)dots) <= 1 &&
                     t0 >= 1;
  const int lat_len = len - lat_s;
  const bool lat_ok = !warp_any(lat_bad) && lat_len >= 1 && lat_len <= kMaxLat;
  const bool ok = carry == kTabs && ts_ok && lat_ok && t[1] > t0 + 1 &&
                  t[2] > t[1] + 1;

  if (lane == 0) {
    auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
    put(D_OK, ok ? 1 : 0);
    put(D_HIGH, has_high ? 1 : 0);
    put(D_TS_S, 0);
    put(D_TS_E, t0);
    put(D_CL_S, t0 + 1);
    put(D_CL_E, t[1]);
    put(D_QN_S, t[1] + 1);
    put(D_QN_E, t[2]);
    put(D_QT_S, t[2] + 1);
    put(D_QT_E, t[3]);
    put(D_RC_S, t[3] + 1);
    put(D_RC_E, t[4]);
    put(D_LAT_S, lat_s);
    put(D_LAT_E, len);
  }
}

// The channels of an empty row (a padding row's).
__device__ __forceinline__ void pad_dns_row(int32_t* __restrict__ col,
                                            int lane) {
  if (lane < kChannels) {
    const int v = (lane == D_CL_S || lane == D_QN_S || lane == D_QT_S ||
                   lane == D_RC_S || lane == D_LAT_S) ? 1 : 0;
    col[lane * kWarps] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_dns_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lens_in,
                  int32_t* __restrict__ out, int N, int n, int L, int vec) {
  __shared__ int32_t tile[kChannels][kWarps];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const int lane = threadIdx.x & 31;
  if (row < n)
    decode_dns_row(batch + (size_t)row * L, lens_in[row], L, vec != 0,
                   &tile[0][warp], lane);
  else if (row < N)
    pad_dns_row(&tile[0][warp], lane);
  __syncthreads();
  // each channel's eight rows are one contiguous run of [C, N]
  const int rows = N - row0 < kWarps ? N - row0 : kWarps;
  for (int i = threadIdx.x; i < kChannels * kWarps; i += kThreads) {
    const int ch = i / kWarps, r = i % kWarps;
    if (r < rows) out[(size_t)ch * N + row0 + r] = tile[ch][r];
  }
}

}  // namespace

extern "C" {

// channels of the batch, int32 [14, N]; rows at and past n are padding
int fg_decode_dns(const void* batch, const void* lens, void* out, int N,
                  int n, int L, void* stream) {
  if (N <= 0) return 0;
  // 16-byte loads where every row starts on a 16-byte boundary
  const int vec =
      (L % 16 == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0) ? 1 : 0;
  const int grid = (N + kWarps - 1) / kWarps;
  decode_dns_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, n, L, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
