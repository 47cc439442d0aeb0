// rfc5424 -> Cap'n Proto encode of decoded rows (the split device encode
// tier for capnp output), one warp per row: kernel OC, a probe and an
// assemble, at 6 and 16 pairs.  The row encode lives in
// encode_capnp_row.cuh, shared with the fused route FO/capnp
// (fused_capnp_out.cu); this file holds the kernels that read the
// decode's [C, N] channels from global memory.
//
// Replaces the JAX package's jnp device program device_capnp.
// _encode_kernel (flowgger_tpu/tpu/device_capnp.py:148) with
// elide=True, with device_common's assemble_rows and _compact_kernel: it
// is not the counterpart of a pallas_call.  The reference builds a table
// of 17 + 5 P whole-matrix segments and a byte plane of pointer words a
// row, and gathers them with its rotate-assembly.
//
// What it computes, per row of a packed [N, L] uint8 batch, from K1's
// packed int32 [C, N] channels (tpu/rfc5424.py unpack_channels at 4 SD
// blocks and P pairs) and the capnp_extra blob (device_capnp.
// kernel_consts: the blob's offset and length in the bank, its pair
// count):
// - probe, for the rows below n: the base tier bit (ok, no byte >= 0x80,
//   no escaped value among the first pair_count slots), the elided length
//   base_len (the wire image without its 32-byte head and the framing
//   suffix: 72 bytes of root pointers, the six texts and sd[0]'s id each
//   NUL-padded to words, the pairs' tag word and elements, the pairs'
//   texts, the blob) and fac8 / sev8 (uint8 [2, N]).  Rows outside the
//   base tier get tier 0 and base_len 0; rows at and past n get 0
//   everywhere.
// - assemble: for each row below n with row_off >= 0, its base_len
//   elided bytes at flat[row_off].
// The width test (base_len <= OW) is the host's: the stamp is not in the
// device row.
//
// Bound on the H100: bytes (the ~40 channels a probe reads, and for the
// assemble each kept row's valid bytes and its output).
// Design:
// - One warp per row, up to eight rows a block.  A warp past n writes its
//   zeros and leaves before any load.
// - The probe reads channels only: lane j holds pair j's key and value
//   word counts, a ballot counts sd[0]'s pairs (k0) and a warp scan gives
//   every pair's word cursor, so the word layout is a handful of sums.
// - The assemble stages the row's valid bytes (16-byte loads), zeroes the
//   output row in shared memory, writes the pointer words from registers
//   (lane s the root pointer slot s, lane j pair j's element), copies the
//   texts with the whole warp (the six row texts, the SD id, then each
//   emitted pair's "_" + name and value, broadcast from its lane) and the
//   blob, and stores the row with aligned 16-byte stores.  There is no
//   segment table.
//
// TPU workarounds not carried over: the rotate-assembly, the [N, OW]
// output matrix, the group compaction, the 17 + 5 P segment table and
// the byte plane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_capnp_row.cuh"

namespace {

using namespace ocp;

// blocks a multiprocessor keeps resident: the probe at E1's cap (48
// registers a thread), the assemble at 64 registers
constexpr int kMinBlocks = 5;
constexpr int kAsmBlocks = 4;
constexpr int kSmemMax = enc::kSmemMax;

template <int P, bool ASM>
__global__ void __launch_bounds__(32 * kWarps, ASM ? kAsmBlocks : kMinBlocks)
encode_capnp_kernel(const uint8_t* __restrict__ batch,
                    const int32_t* __restrict__ lens_in,
                    const int32_t* __restrict__ ch,
                    const uint8_t* __restrict__ bank, ConstsC k, int N,
                    int n, int L, int OW, uint8_t* __restrict__ tier_out,
                    int32_t* __restrict__ len_out,
                    uint8_t* __restrict__ small8,
                    const int64_t* __restrict__ row_off,
                    uint8_t* __restrict__ flat) {
  extern __shared__ uint4 oc_smem_v[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;                  // whole warps leave together
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      small8[row] = 0;
      small8[(size_t)N + row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;                // not a kept tier row
  }
  const RowInC in{batch + (size_t)row * L, lens_in[row], L, OW,
                  ASM ? bank + k.blob_off : nullptr, k};
  const RowOutC out{ASM ? nullptr : tier_out + row,
                    ASM ? nullptr : len_out + row,
                    ASM ? nullptr : small8 + row, N,
                    ASM ? flat + dst0 : nullptr};
  uint8_t* base = reinterpret_cast<uint8_t*>(oc_smem_v) +
                  (size_t)(threadIdx.x >> 5) * oc_stride(L, OW, ASM);
  const ChanView C{ch + row, N};
  encode_capnp_row<P, ASM>(C, in, base, out, lane);
}

template <int P, bool ASM>
int launch(const void* batch, const void* lens, const void* ch,
           const void* bank, const int* consts, int N, int n, int L, int OW,
           void* tier, void* base_len, void* small8, const void* row_off,
           void* flat, cudaStream_t stream) {
  if (N <= 0) return 0;
  const ConstsC k = consts_c(consts);
  auto kern = encode_capnp_kernel<P, ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, oc_stride(L, OW, ASM),
                                         kSmemMax, &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(bank), k,
      N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<uint8_t*>(small8),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// OC probe at 6 / 16 pairs: base tier bit (uint8 0/1), base_len (int32)
// and fac8 / sev8 (uint8 [2, N]) of every row, zeros at and past n
int fg_encode_capnp_probe_p6(const void* batch, const void* lens,
                             const void* ch, const int* consts, int N, int n,
                             int L, void* tier, void* base_len, void* small8,
                             void* stream) {
  return launch<6, false>(batch, lens, ch, nullptr, consts, N, n, L, 0, tier,
                          base_len, small8, nullptr, nullptr,
                          static_cast<cudaStream_t>(stream));
}

int fg_encode_capnp_probe_p16(const void* batch, const void* lens,
                              const void* ch, const int* consts, int N,
                              int n, int L, void* tier, void* base_len,
                              void* small8, void* stream) {
  return launch<16, false>(batch, lens, ch, nullptr, consts, N, n, L, 0,
                           tier, base_len, small8, nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// OC assemble at 6 / 16 pairs: the elided bytes of each row below n with
// row_off >= 0 at flat[row_off]
int fg_encode_capnp_assemble_p6(const void* batch, const void* lens,
                                const void* ch, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch<6, true>(batch, lens, ch, bank, consts, N, n, L, OW, nullptr,
                         nullptr, nullptr, row_off, flat,
                         static_cast<cudaStream_t>(stream));
}

int fg_encode_capnp_assemble_p16(const void* batch, const void* lens,
                                 const void* ch, const void* bank,
                                 const int* consts, int N, int n, int L,
                                 int OW, const void* row_off, void* flat,
                                 void* stream) {
  return launch<16, true>(batch, lens, ch, bank, consts, N, n, L, OW,
                          nullptr, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
