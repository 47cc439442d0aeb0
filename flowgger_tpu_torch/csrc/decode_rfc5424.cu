// RFC5424 structural decode, one warp per row.
//
// Replaces the JAX package's Pallas kernel decode_rfc5424_pallas
// (flowgger_tpu/tpu/rfc5424.py:1095, pallas_call :1145), which runs the
// vectorized decode_rfc5424 body (:414) over [256, L] VMEM tiles.
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// channels of tpu/rfc5424.py (_KEYS_1D, _KEYS_SD x max_sd, _KEYS_PAIR x
// max_pairs), written channel-major into one int32 [C, N] tensor.  The
// definitions are the reference's data-parallel ones, evaluated as six
// passes over the row: every "k-th masked position" extraction keeps the
// reference's bit-packed sum form (several ordinals per wrapping 32-bit
// word, so multi-hit ordinals on malformed rows carry exactly as they do
// there), and the three packed field words wrap the same way.  So the
// kernel agrees with the plain PyTorch version on every row — ok and
// pair_count included — not only on accepted rows.
//
// Bound on the H100: bytes (one read of each row's valid bytes plus the
// channel writes; a few dozen integer operations per byte).  What keeps
// a decode from it is latency: the passes depend on each other (the
// ']' chain needs the quote state, the pair checks need the SD-ID ends),
// and a launch lasts as long as its slowest row.  Design:
// - One warp per row, eight rows per block.  Each warp stages its row's
//   valid bytes in shared memory with 16-byte loads.
// - Word-parallel passes: lane j owns the 32-position words j, j + 32,
//   ... of the row and builds each word's class bitmasks once, four
//   bytes at a time (SWAR: backslash, '"', space, ']', '=', '>', byte
//   >= 128, not whitespace, SD-name byte), into the warp's shared area
//   past the staged row (slots of decode_rfc5424_row.cuh's MaskSlot; 672
//   bytes a warp at L = 512).  At L <= 1024 that is one round of at most
//   32 words; a longer row takes rounds of 32 words with carries.
// - The escape state needs at most the previous word: a backslash run
//   that reaches past it is longer than the cap (kEscRunCap), so each
//   '"' of a word is a real quote or not from its own word and the one
//   before.  One warp scan of the words' real-quote counts gives the
//   quotes before each word, and a prefix XOR inside the word the parity
//   of every position (the reference's q_excl parity against the rest
//   zone): the "outside" word, kept beside the masks.
// - Each later pass is one round of word-local bit operations: the k-th
//   space or ']' is a scan of popcounts and nth_set_bit inside the word,
//   "first / last position where" is __ffs / __clz, the previous
//   position's flag is a shift with the neighbour word's top bit, and the
//   per-ordinal sums iterate only the set bits of the masked words.
//   Passes 2 and 3 (header fields) need no scan: each lane sums its
//   positions of the header zones and the warp reduces once (pass 1
//   counts the high bytes, the one term of their words that lies past
//   the header).
// - The per-ordinal sums are per-warp uint32 words in shared memory,
//   added with atomicAdd (wrapping addition is order-independent, so the
//   packed words are exact), then unpacked one ordinal per lane.
// - Channel values go through a shared [C, 8] tile, so each channel is
//   stored as one 32-byte run of the block's eight rows.
// Masks hold only positions below the row's length; passes 2-3 read a
// malformed row's PRI or timestamp zone into the padding as zeros.
//
// TPU workarounds not carried over: the u8->i32 widening (bytes stay
// u8), the log-shift scan ladders (warp ballots), and the f32 reductions
// (integer sums).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc5424_row.cuh"

namespace {

using namespace r5;

constexpr int kThreads = 32 * kWarps;

template <int MAX_SD, int MAX_PAIRS>
__global__ void __launch_bounds__(kThreads)
decode_rfc5424_kernel(const uint8_t* __restrict__ batch,
                      const int32_t* __restrict__ lens_in,
                      int32_t* __restrict__ out, int N, int L,
                      int stride_vec) {
  constexpr int C = kN1D + 2 * MAX_SD + 6 * MAX_PAIRS;
  extern __shared__ uint4 rows_smem[];
  __shared__ RowSums<MAX_SD, MAX_PAIRS> sums[kWarps];
  __shared__ int32_t tile[C][kWarps];
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  if (row < N)
    decode_row<MAX_SD, MAX_PAIRS>(batch + (size_t)row * L, lens_in[row], L,
                                  rows_smem + warp * stride_vec, sums[warp],
                                  &tile[0][warp], threadIdx.x & 31);
  __syncthreads();
  // each channel's eight rows are one contiguous run of [C, N]
  const int rows = N - row0 < kWarps ? N - row0 : kWarps;
  for (int t = threadIdx.x; t < C * kWarps; t += kThreads) {
    const int ch = t / kWarps, r = t % kWarps;
    if (r < rows) out[(size_t)ch * N + row0 + r] = tile[ch][r];
  }
}

template <int MAX_SD, int MAX_PAIRS>
int launch(const void* batch, const void* lens, void* out, int N, int L,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  const int stride_vec = stage_bytes(L) / 16;   // row and masks
  const size_t smem = (size_t)kWarps * stride_vec * 16;
  auto kern = decode_rfc5424_kernel<MAX_SD, MAX_PAIRS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, L, stride_vec);
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
