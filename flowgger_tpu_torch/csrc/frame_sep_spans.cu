// Line / NUL record spans over a raw region.
//
// Replaces the JAX package's Pallas kernel frame_sep_spans_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:237, body _sep_kernel :194), which
// builds a next-separator plane with a reverse cummin ladder and then
// walks the record chain sequentially inside one VMEM block.
//
// What it computes, for region[0:rlen) and separator byte `sep`:
// the k-th record (k < ncap) starts one past the (k-1)-th separator
// (0 for k = 0) and ends at the k-th separator, minus one trailing CR
// when strip_cr and the record is non-empty; slots k >= n are zero;
// meta = {n, consumed (one past the last recorded separator), overflow
// (n > ncap), 0}.
//
// Bound on the H100: bytes (one read of the region, 8 bytes written per
// record).  Design: the chain walk is replaced by the parallel form.
//   1. count:   each block counts separators in a 4 KiB tile and notes
//               its last separator position;
//   2. scan:    one block turns the tile counts into exclusive prefix
//               counts and carries the last separator before each tile,
//               writes n / overflow, and zero-fills slots [n, ncap);
//   3. scatter: each block re-counts its tile, scans per thread, and
//               every separator writes its own record: its ordinal gives
//               the slot, the previous separator (from the thread scan
//               and the tile carry) gives the start.
// No 1 MiB single-block cap (PALLAS_MAX_REGION) applies here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTile = kThreads * kBytesPerThread;  // 4096 bytes per block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int warp_incl_sum(int v) {
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_incl_max(int v) {
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) >= o) v = max(v, t);
  }
  return v;
}

// Block-wide exclusive sum and exclusive max (identities 0 and -1),
// plus the block totals.  blockDim.x must be a multiple of 32 and at
// most 1024; every thread of the block must call it.
__device__ void block_excl_scan(int v_sum, int v_max, int* excl_sum,
                                int* excl_max, int* total_sum,
                                int* total_max) {
  __shared__ int s_sum[32], s_max[32], s_tot[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int is = warp_incl_sum(v_sum);
  const int im = warp_incl_max(v_max);
  if (lane == 31) {
    s_sum[warp] = is;
    s_max[warp] = im;
  }
  __syncthreads();
  if (warp == 0) {
    int a = lane < nwarps ? s_sum[lane] : 0;
    int b = lane < nwarps ? s_max[lane] : -1;
    int ia = warp_incl_sum(a);
    int ib = warp_incl_max(b);
    int prev_b = __shfl_up_sync(0xffffffffu, ib, 1);
    if (lane < nwarps) {
      s_sum[lane] = ia - a;
      s_max[lane] = lane == 0 ? -1 : prev_b;
    }
    if (lane == 31) {
      s_tot[0] = ia;
      s_tot[1] = ib;
    }
  }
  __syncthreads();
  int within = __shfl_up_sync(0xffffffffu, im, 1);
  if (lane == 0) within = -1;
  *excl_sum = s_sum[warp] + is - v_sum;
  *excl_max = max(s_max[warp], within);
  *total_sum = s_tot[0];
  *total_max = s_tot[1];
  __syncthreads();  // the next call reuses the shared slots
}

__device__ __forceinline__ void thread_tile(const uint8_t* region, int rlen,
                                            int sep, int base, int* count,
                                            int* last) {
  int c = 0, l = -1;
  for (int j = 0; j < kBytesPerThread; ++j) {
    int p = base + j;
    if (p < rlen && region[p] == sep) {
      ++c;
      l = p;
    }
  }
  *count = c;
  *last = l;
}

__global__ void __launch_bounds__(kThreads)
sep_count_kernel(const uint8_t* __restrict__ region, int rlen, int sep,
                 int32_t* __restrict__ tile_count,
                 int32_t* __restrict__ tile_last) {
  int tot_sum, tot_max;
  int c, l;
  thread_tile(region, rlen, sep,
              blockIdx.x * kTile + threadIdx.x * kBytesPerThread, &c, &l);
  int es, em;
  block_excl_scan(c, l, &es, &em, &tot_sum, &tot_max);
  if (threadIdx.x == 0) {
    tile_count[blockIdx.x] = tot_sum;
    tile_last[blockIdx.x] = tot_max;
  }
}

// One block: tile counts -> exclusive tile offsets; last separator
// before each tile; meta; zero-fill of the unused span slots.
__global__ void __launch_bounds__(kScanThreads)
sep_scan_kernel(int32_t* __restrict__ tile_count,
                int32_t* __restrict__ tile_last, int ntiles, int ncap,
                int32_t* __restrict__ starts, int32_t* __restrict__ lens,
                int32_t* __restrict__ meta) {
  int tot_sum, tot_max;
  int carry_sum = 0, carry_max = -1;
  for (int base = 0; base < ntiles; base += blockDim.x) {
    int t = base + threadIdx.x;
    int c = t < ntiles ? tile_count[t] : 0;
    int l = t < ntiles ? tile_last[t] : -1;
    int es, em;
    block_excl_scan(c, l, &es, &em, &tot_sum, &tot_max);
    if (t < ntiles) {
      tile_count[t] = carry_sum + es;
      tile_last[t] = max(carry_max, em);
    }
    carry_sum += tot_sum;
    carry_max = max(carry_max, tot_max);
    __syncthreads();
  }
  const int n = carry_sum;
  if (threadIdx.x == 0) {
    meta[0] = n;
    meta[1] = 0;  // consumed: written by the scatter when n > 0
    meta[2] = n > ncap ? 1 : 0;
    meta[3] = 0;
  }
  for (int k = n + threadIdx.x; k < ncap; k += blockDim.x) {
    starts[k] = 0;
    lens[k] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
sep_scatter_kernel(const uint8_t* __restrict__ region, int rlen, int sep,
                   int strip_cr, int ncap,
                   const int32_t* __restrict__ tile_off,
                   const int32_t* __restrict__ tile_prev,
                   int32_t* __restrict__ starts, int32_t* __restrict__ lens,
                   int32_t* __restrict__ meta) {
  int tot_sum, tot_max;
  const int base = blockIdx.x * kTile + threadIdx.x * kBytesPerThread;
  int c, l;
  thread_tile(region, rlen, sep, base, &c, &l);
  int es, em;
  block_excl_scan(c, l, &es, &em, &tot_sum, &tot_max);
  if (c == 0) return;
  const int n = meta[0];
  const int last_k = (n < ncap ? n : ncap) - 1;
  int k = tile_off[blockIdx.x] + es;
  int prev = max(tile_prev[blockIdx.x], em);
  for (int j = 0; j < kBytesPerThread && k < ncap; ++j) {
    int p = base + j;
    if (p >= rlen || region[p] != sep) continue;
    int start = prev + 1;
    int ln = p - start;
    if (strip_cr && ln > 0 && region[p - 1] == 13) --ln;
    starts[k] = start;
    lens[k] = ln;
    if (k == last_k) meta[1] = p + 1;
    prev = p;
    ++k;
  }
}

}  // namespace

extern "C" {

// region: u8[B] (B >= rlen); tile scratch: 2 x i32[ceil(rlen / 4096)]
// (at least one tile); starts/lens: i32[ncap]; meta: i32[4].
int fg_frame_sep_spans(const void* region, int rlen, int sep, int strip_cr,
                       int ncap, void* tile_count, void* tile_last,
                       void* starts, void* lens, void* meta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ntiles = (rlen + kTile - 1) / kTile;
  if (ntiles < 1) ntiles = 1;
  const uint8_t* r = static_cast<const uint8_t*>(region);
  int32_t* tc = static_cast<int32_t*>(tile_count);
  int32_t* tl = static_cast<int32_t*>(tile_last);
  int32_t* st = static_cast<int32_t*>(starts);
  int32_t* ln = static_cast<int32_t*>(lens);
  int32_t* m = static_cast<int32_t*>(meta);
  sep_count_kernel<<<ntiles, kThreads, 0, s>>>(r, rlen, sep, tc, tl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sep_scan_kernel<<<1, kScanThreads, 0, s>>>(tc, tl, ntiles, ncap, st, ln, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sep_scatter_kernel<<<ntiles, kThreads, 0, s>>>(r, rlen, sep, strip_cr, ncap,
                                                 tc, tl, st, ln, m);
  return (int)cudaGetLastError();
}

int fg_frame_sep_tile_bytes() { return kTile; }

}  // extern "C"
