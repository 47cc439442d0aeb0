// JSON structural index (simdjson stage 1), one warp per row.
//
// Replaces the JAX package's Pallas kernel structural_index_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:439, pallas_call :481), reached
// through decode_jsonl_pallas (:505), which runs jsonidx.structural_index
// (flowgger_tpu/tpu/jsonidx.py:194) over [256, L] VMEM tiles with the
// compiled-NFA string machine and the manual/sum scan and extract forms;
// and, in its flat mode, the GELF decode's structural index
// (flowgger_tpu/tpu/gelf.py:74 decode_gelf: structural_index(...,
// nested=0)).
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// channels of tpu/jsonidx.py (ok, n_fields, and per field
// key_start/key_end/val_start/val_end/val_type/key_esc/val_esc) written
// channel-major into one int32 [2 + 7F, N] tensor, in one of two modes:
// nested >= 1 (the JSON-lines decode, F = 8 and 24) admits containers
// that many levels below the top object; nested = 0 (the GELF decode,
// F = 8, 16 and 24) is the flat contract — "top level" is "outside a
// string", any '[' or ']' outside a string flags the row, brackets are
// literal bytes to the literal runs, and no value is a container
// (VT_OBJECT / VT_ARRAY never occur, no depth is kept).  The row
// function is shared with the fused gelf -> GELF route
// (structural_index_row.cuh).  Every
// "value at the k-th ordinal" extraction keeps the reference's bit-packed
// sum form (exact per-ordinal sums folded into wrapping 32-bit words,
// several ordinals per word), so a multi-hit ordinal on a malformed row
// carries into its neighbour exactly as it does there, and the kernel
// agrees with the plain PyTorch version on every row — ok and n_fields
// included — not only on accepted rows.
//
// Bound on the H100: bytes (one read of each row's valid bytes plus the
// channel writes; a few dozen integer operations per byte).  What keeps
// it from the bound is latency: every channel hangs on running state
// carried from byte to byte (the string automaton, the depth, the key
// ordinals, the literal runs), so a launch lasts as long as its slowest
// row's chain.  Design, as the RFC5424 decode kernel (decode_rfc5424.cu):
// - One warp per row, eight rows per block.  Each warp stages its row's
//   valid bytes in shared memory with 16-byte loads, then one pass steps
//   over 32 consecutive positions at a time, one byte per lane: a
//   150-byte row is ~5 warp steps, not ~150 thread steps.
// - The string automaton (jsonidx.NFA_TABLE) is the pair (inside,
//   escaped): escaped(i) is the parity of the backslash run ending at
//   i-1, exact and uncapped, and inside(i) the parity of real quotes
//   before i (WarpString below).  A quote after a run of >= ESC_RUN_CAP
//   backslashes still flags the row.
// - Every running value is a ballot scan with a carry from the chunk's
//   last lane: depth (popcounts of the open and close ballots), the key
//   and key-close ordinals, the outside-string whitespace run and the
//   literal runs (__clz of complemented ballots).  The previous position's
//   literal flag is a bit of the literal ballot, and its key ordinal the
//   exclusive one.  The first / last significant byte and its brace tag
//   come from the non-whitespace and brace ballots; row totals are lane
//   sums reduced once at the end.
// - The previous / next significant byte within WS_WINDOW come from a
//   64-bit window over the non-whitespace ballots of the previous, this
//   and the next chunk (the next one is balloted a step ahead), read
//   back from the staged row.
// - The per-ordinal sums are per-warp uint32 words in shared memory,
//   added with atomicAdd (wrapping addition is order-independent, so the
//   packed words are exact), then unpacked one ordinal per lane.
// - Channel values go through a shared [C, 8] tile, so each channel is
//   stored as one 32-byte run of the block's eight rows.
//
// TPU workarounds not carried over: the u8 -> i32 widening, the
// log-shift ladders for scans, reductions and windows, and the f32
// reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "structural_index_row.cuh"

namespace {

using si::kWarps;
constexpr int kThreads = 32 * kWarps;

template <int F, bool FLAT>
__global__ void __launch_bounds__(kThreads)
structural_index_kernel(const uint8_t* __restrict__ batch,
                        const int32_t* __restrict__ lens_in,
                        int32_t* __restrict__ out, int N, int L,
                        int stride_vec, int nested) {
  constexpr int C = si::channels(F);
  extern __shared__ uint4 rows_smem[];
  __shared__ si::RowSums<F> sums[kWarps];
  __shared__ int32_t tile[C][kWarps];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  if (row < N)
    si::index_row<F, FLAT>(batch + (size_t)row * L, lens_in[row], L, nested,
                 rows_smem + warp * stride_vec, sums[warp], &tile[0][warp],
                 threadIdx.x & 31);
  __syncthreads();
  // each channel's eight rows are one contiguous run of [C, N]
  const int rows = N - row0 < kWarps ? N - row0 : kWarps;
  for (int t = threadIdx.x; t < C * kWarps; t += kThreads) {
    const int ch = t / kWarps, r = t % kWarps;
    if (r < rows) out[(size_t)ch * N + row0 + r] = tile[ch][r];
  }
}

template <int F, bool FLAT>
int launch_mode(const void* batch, const void* lens, void* out, int N, int L,
                int nested, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int stride_vec = (L + 15) / 16;
  const size_t smem = (size_t)kWarps * stride_vec * 16;
  auto kern = structural_index_kernel<F, FLAT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, L, stride_vec, nested);
  return (int)cudaGetLastError();
}

// the flat mode for nested = 0, the nested mode otherwise (NESTED: F has
// a nested-mode instantiation)
template <int F, bool NESTED = true>
int launch(const void* batch, const void* lens, void* out, int N, int L,
           int nested, cudaStream_t stream) {
  if (nested == 0)
    return launch_mode<F, true>(batch, lens, out, N, L, 0, stream);
  if (!NESTED || nested < 0) return (int)cudaErrorInvalidValue;
  return launch_mode<F, false>(batch, lens, out, N, L, nested, stream);
}

}  // namespace

extern "C" {

// Packed channel count for the instantiations below: 2 + 7 * F.
int fg_structural_index_f8(const void* batch, const void* lens, void* out,
                           int N, int L, int nested, void* stream) {
  return launch<8>(batch, lens, out, N, L, nested,
                   static_cast<cudaStream_t>(stream));
}

// the flat mode's escalation width (the gelf tier's wide probe): flat
// mode only
int fg_structural_index_f16(const void* batch, const void* lens, void* out,
                            int N, int L, int nested, void* stream) {
  return launch<16, false>(batch, lens, out, N, L, nested,
                           static_cast<cudaStream_t>(stream));
}

int fg_structural_index_f24(const void* batch, const void* lens, void* out,
                            int N, int L, int nested, void* stream) {
  return launch<24>(batch, lens, out, N, L, nested,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
