// rfc5424 -> LTSV encode of decoded rows (the split device encode tier for
// LTSV output), one warp per row: kernel OL, a probe and an assemble.
// The row encode itself lives in encode_ltsv_out_row.cuh, shared with the
// fused route FO/ltsv (fused_ltsv_out.cu); this file holds the kernels
// that read K1's [C, N] channels (6 pairs) from global memory.
//
// Replaces the JAX package's jnp device program
// device_ltsv_out._encode_kernel (flowgger_tpu/tpu/device_ltsv_out.py:133,
// elide=True) with device_common's assemble_rows and _compact_kernel: it
// is not the counterpart of a pallas_call.  The reference builds the row
// from ~45 whole-matrix segments with its rotate-assembly and screens the
// rows with [N, L] masks (a tab / newline plane, one name-range plane a
// pair slot).
//
// What it computes, per row of a packed [N, L] uint8 batch, from K1's
// packed int32 [C, N] channels (read in place; tpu/rfc5424.py
// unpack_channels at 4 SD elements and 6 pairs) and the constant bank
// (device_ltsv_out._bank):
// - probe, for the rows below n: the base tier bit (ok, no byte >= 0x80,
//   no tab or newline among the valid bytes, no ':' inside an SD name, no
//   SD value with a backslash), the elided length base_len (pairs first,
//   name ':' value '\t' a pair, then the ltsv_extra blob, "host:" and the
//   host, "\tmessage:" when the message is not empty and the message,
//   the full message, "\tlevel:" and the severity digit, "\tfacility:"
//   and its one or two digits, "\tappname:", "\tprocid:", "\tmsgid:" and
//   their spans; without "\ttime:<stamp>", "\tfull_message:" and the
//   suffix) and gap0 / gap1, the offsets at which the host splices the
//   first two back (int32 [2, N]).  Rows outside the base tier, and rows
//   at or past n, get 0 everywhere.  The width test (base_len <= OW) is
//   the host's: the stamp is not in the device row.
// - assemble: for each row below n with row_off >= 0 (the tier rows the
//   host keeps), its base_len elided bytes at flat[row_off].
//
// Bound on the H100: bytes (each real row's valid bytes, the ~40
// channels it reads, its output; a few integer operations a byte).
// Design: E1's (encode_gelf.cu) without its escape stage and its sort.
// - One warp per row, up to eight rows a block.  A warp past n, or (in
//   the probe) whose row the channels alone put outside the tier, writes
//   its zeros and leaves before it loads the row.
// - The row's valid bytes are staged in shared memory with 16-byte
//   loads; in the probe each lane scans its 16-byte chunks for a tab or
//   a newline, and pair lane p its name span for a ':' (names are
//   short), three ballots decide the tier, and four warp sums give the
//   pair total, the length and the two gaps.
// - The assemble copies the bank right after the staged row, so every
//   output byte has its source in one buffer, and runs E1's staged
//   assemble (encode_gelf_row.cuh assemble_row): lane p < 6 the segments
//   of pair p (name, ':', value, '\t'), lane f < 17 fixed segment f,
//   scanned into (end, source) a segment in shared memory, the output row
//   staged there and stored with aligned 16-byte stores.
//
// TPU workarounds not carried over: the rotate-assembly, the [N, OW]
// output matrix, the group compaction and the [N, L] screen planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_ltsv_out_row.cuh"

namespace {

using namespace olt;

// blocks a multiprocessor keeps resident (E1's cap: 48 registers a thread)
constexpr int kMinBlocks = 5;

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_ltsv_out_kernel(const uint8_t* __restrict__ batch,
                       const int32_t* __restrict__ lens_in,
                       const int32_t* __restrict__ ch,
                       const uint8_t* __restrict__ bank, int bank_len,
                       ConstsO k, int N, int n, int L, int OW,
                       uint8_t* __restrict__ tier_out,
                       int32_t* __restrict__ len_out,
                       int32_t* __restrict__ gaps,
                       const int64_t* __restrict__ row_off,
                       uint8_t* __restrict__ flat) {
  extern __shared__ uint4 ol_smem_v[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;                  // whole warps leave together
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      gaps[row] = 0;
      gaps[(size_t)N + row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;                // not a kept tier row
  }
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0;
  const RowInO in{batch + (size_t)row * L, vec, lens_in[row], L, OW, bank,
                  bank_len};
  const RowOutO out{ASM ? nullptr : tier_out + row,
                    ASM ? nullptr : len_out + row,
                    ASM ? nullptr : gaps + row, N,
                    ASM ? flat + dst0 : nullptr};
  const int stride = ol_smem(L, OW, ASM, bank_len).stride;
  encode_ltsv_out_row<ASM>(
      ChanView{ch + row, N}, in, k,
      reinterpret_cast<uint8_t*>(ol_smem_v) +
          (size_t)(threadIdx.x >> 5) * stride,
      out, lane);
}

template <bool ASM>
int launch(const void* batch, const void* lens, const void* ch,
           const void* bank, const int* consts, int N, int n, int L, int OW,
           void* tier, void* base_len, void* gaps, const void* row_off,
           void* flat, cudaStream_t stream) {
  if (N <= 0) return 0;
  const ConstsO k = enc::const_table<kNumConstO>(consts);
  const int bank_len = enc::bank_bytes(k);
  const int stride = ol_smem(L, OW, ASM, bank_len).stride;
  auto kern = encode_ltsv_out_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, stride, enc::kSmemMax,
                                         &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<int32_t*>(gaps),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// OL probe: base tier bit (uint8 0/1), base_len (int32) and the gaps
// (int32 [2, N]) of every row, zeros for the rows at and past n
int fg_encode_ltsv_out_probe(const void* batch, const void* lens,
                             const void* ch, const int* consts, int N, int n,
                             int L, void* tier, void* base_len, void* gaps,
                             void* stream) {
  return launch<false>(batch, lens, ch, nullptr, consts, N, n, L, 0, tier,
                       base_len, gaps, nullptr, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// OL assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off]
int fg_encode_ltsv_out_assemble(const void* batch, const void* lens,
                                const void* ch, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch<true>(batch, lens, ch, bank, consts, N, n, L, OW, nullptr,
                      nullptr, nullptr, row_off, flat,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
