// LTSV decode, one warp per row: kernel L1.
//
// Replaces the JAX package's jnp device program decode_ltsv
// (flowgger_tpu/tpu/ltsv.py:68; jitted as decode_ltsv_jit :331), which is
// not a pallas_call: the reference evaluates each channel as a whole-row
// masked reduction over [N, L] (a tab cumsum and a tab/colon cummax, the
// packed-sum extraction of 23 tab positions and 24 first colons, four
// shifted-plane key patterns with a packed max each, and weighted digit
// sums over the time and level spans).
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// channels of tpu/ltsv.py KEYS_1D and KEYS_PART — ok, has_high, n_parts,
// the four special-key positions, the host and message spans, level_val,
// ts_kind, the time span, days, sod, off, nanos, ts_hi, ts_lo, ts_meta, and
// part_start, part_end, colon_pos of the first 24 parts — written
// channel-major into one int32 [94, N] tensor, equal to the plain version
// (tpu/ltsv.py decode_ltsv) on every row: ok = false rows and rows of more
// than 24 parts included.  Rows at and past n (the batch's real rows) are
// padding: they get the channels of an empty row and their bytes are
// never loaded.
//
// Bound on the H100: bytes (one read of each real row's valid bytes and
// 376 bytes of channels a row; a few integer operations a byte).  Design
// (decode_ltsv_row.cuh):
// - One warp per row, eight rows per block.  The row's valid bytes are
//   staged in shared memory with 16-byte loads (K1's staging).
// - One pass, 32 positions a step: tab and colon ballots; a tab's
//   ordinal is a popcount prefix, a colon is its part's first if the
//   highest tab-or-colon bit below it is a tab (or the carried state of
//   the step before); the part table goes straight to the block's
//   channel tile.  A lane at a part start compares the four special keys
//   and keeps its last match; one warp max a key picks the last.
// - The level and time values are short spans: per-lane weighted digit
//   sums in unsigned arithmetic reduced with __reduce_add_sync, so they
//   wrap exactly as the reference's int32 sums do, and ballots for the
//   first dot, the dot count, the fraction's end and the violations.
// - Channel values go through a shared [94, 8] tile, so each channel is
//   stored as one 32-byte run of the block's eight rows.
//
// TPU workarounds not carried over: the shifted-plane pattern matching,
// the packed-sum extraction and the masked max standing in for a gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_ltsv_row.cuh"

namespace {

using namespace lt;

constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
decode_ltsv_kernel(const uint8_t* __restrict__ batch,
                   const int32_t* __restrict__ lens_in,
                   int32_t* __restrict__ out, int N, int n, int L,
                   int stride_vec) {
  extern __shared__ uint4 rows_ltsv_smem[];
  __shared__ int32_t tile[kChannels][kWarps];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const int lane = threadIdx.x & 31;
  if (row < n)
    decode_ltsv_row(batch + (size_t)row * L, lens_in[row], L,
                    rows_ltsv_smem + warp * stride_vec, &tile[0][warp], lane);
  else if (row < N)
    pad_row(&tile[0][warp], lane);
  __syncthreads();
  // each channel's eight rows are one contiguous run of [C, N]
  const int rows = N - row0 < kWarps ? N - row0 : kWarps;
  for (int t = threadIdx.x; t < kChannels * kWarps; t += kThreads) {
    const int ch = t / kWarps, r = t % kWarps;
    if (r < rows) out[(size_t)ch * N + row0 + r] = tile[ch][r];
  }
}

}  // namespace

extern "C" {

// channels of the batch, int32 [94, N]; rows at and past n are padding
int fg_decode_ltsv(const void* batch, const void* lens, void* out, int N,
                   int n, int L, void* stream) {
  if (N <= 0) return 0;
  const int stride_vec = (L + 15) / 16;
  const size_t smem = (size_t)kWarps * stride_vec * 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_ltsv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  decode_ltsv_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, n, L, stride_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
