// RFC3164 (BSD syslog) decode, one warp per row: kernel D3.
//
// Replaces the JAX package's jnp device program decode_rfc3164
// (flowgger_tpu/tpu/rfc3164.py:55; jitted as decode_rfc3164_jit :208),
// which is not a pallas_call: the reference evaluates each channel as a
// whole-row masked reduction over [N, L] (twelve shifted-plane month
// patterns, the two tz-alias literals, the time and PRI digit sums).
//
// What it computes: for every row of a packed [N, L] uint8 batch and a
// year (the current UTC year, read by the caller at each submit), the
// channels of tpu/rfc3164.py KEYS — ok, has_pri, has_high, facility,
// severity, days, sod, off, nanos, host_start, host_end, msg_start —
// written channel-major into one int32 [12, N] tensor, equal to the
// plain version on every row, rejected rows included.
//
// Bound on the H100: bytes (one read of each row's valid bytes and 48
// bytes of channels a row; a few integer operations a byte).  Design
// (decode_rfc3164_row.cuh):
// - One warp per row, eight rows per block.  The row's valid bytes are
//   staged in shared memory with 16-byte loads (K1's staging).
// - Pass 1 walks the row 32 positions a step: ballots give the first '>'
//   and the first non-digit after the '<' (__ffs of the first non-zero
//   ballot), per-lane flags the high bytes, the other whitespace and the
//   last double space; one warp reduction each at the end.
// - The header (PRI digits, month, the day layouts A "Mon dd", B "Mon d",
//   C "Mon  d", hh:mm:ss, the host's leading space) is a handful of
//   single-byte reads at positions pass 1 fixed, done by every lane.
// - Pass 2 walks from the host token's start to its first space (the
//   host is short: usually one step), with the timezone-lookalike byte
//   class on the way; the two lowercase tz aliases are byte compares.
// - Channel values go through a shared [12, 8] tile, so each channel is
//   stored as one 32-byte run of the block's eight rows.
//
// TPU workarounds not carried over: the shifted-plane pattern matching
// and the masked max standing in for a gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc3164_row.cuh"

namespace {

using namespace r3;

constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
decode_rfc3164_kernel(const uint8_t* __restrict__ batch,
                      const int32_t* __restrict__ lens_in, int year,
                      int32_t* __restrict__ out, int N, int L,
                      int stride_vec) {
  extern __shared__ uint4 rows3164_smem[];
  __shared__ int32_t tile[kChannels][kWarps];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  if (row < N)
    decode3164_row(batch + (size_t)row * L, lens_in[row], L, year,
                   rows3164_smem + warp * stride_vec, &tile[0][warp],
                   threadIdx.x & 31);
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

// channels of the batch, int32 [12, N]
int fg_decode_rfc3164(const void* batch, const void* lens, int year,
                      void* out, int N, int L, void* stream) {
  if (N <= 0) return 0;
  const int stride_vec = (L + 15) / 16;
  const size_t smem = (size_t)kWarps * stride_vec * 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_rfc3164_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  decode_rfc3164_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      year, static_cast<int32_t*>(out), N, L, stride_vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
