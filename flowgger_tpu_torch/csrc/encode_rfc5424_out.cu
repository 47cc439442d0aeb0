// -> RFC5424 encode of decoded rows (the split device encode tier for
// RFC5424 output), one warp per row: kernel O5 (rfc5424 input) and
// O5/3164 (rfc3164 input), a probe and an assemble each.  The row
// encodes live in encode_rfc5424_out_row.cuh, shared with the fused
// routes FO/r5 (fused_rfc5424_out.cu); this file holds the kernels that
// read the decode's [C, N] channels from global memory.
//
// Replaces the JAX package's jnp device programs
// device_rfc5424_out._encode_kernel (flowgger_tpu/tpu/
// device_rfc5424_out.py:220) and _encode_kernel_3164 (:335), both with
// elide=True, with device_common's assemble_rows and _compact_kernel:
// they are not the counterparts of a pallas_call.  The reference builds a
// row from a static table of ~60 whole-matrix segments (every SD block
// times every pair slot) with its rotate-assembly.
//
// What they compute, per row of a packed [N, L] uint8 batch:
// - O5, from K1's packed int32 [C, N] channels (tpu/rfc5424.py
//   unpack_channels at 4 SD blocks and 6 pairs) and the bank
//   (device_rfc5424_out._bank):
//   - probe, for the rows below n: the base tier bit (ok, no byte >=
//     0x80, at most 6 pairs and 4 SD blocks, no pair value with a
//     backslash), the elided length base_len (host, appname, procid and
//     msgid with a space after each; '-' without SD, else per block '['
//     sid, ' ' name '="' value '"' a pair of the block, ']'; a space and
//     the message; without the '<PRI>1 <stamp> ' head and the suffix) and
//     fac8 / sev8 (uint8 [2, N]).  Rows outside the base tier get tier 0
//     and base_len 0; rows at and past n get 0 everywhere.
//   - assemble: for each row below n with row_off >= 0, its base_len
//     elided bytes at flat[row_off].
// - O5/3164, from D3's packed int32 [12, N] channels (tpu/rfc3164.py
//   KEYS): the base tier bit (ok, no byte >= 0x80), the elided length
//   (the host span, then the message from msg_start to the row's length),
//   fac8 / sev8 / pri1 (uint8 [3, N]) and the host length (uint16 [N]);
//   the assemble writes the host and message bytes.
// The width test (base_len <= OW) is the host's: the stamp is not in the
// device row.
//
// Bound on the H100: bytes (the ~50 channels a probe reads, and for the
// assemble each kept row's valid bytes and its output).
// Design: OL's (encode_ltsv_out.cu) without its byte screens.
// - One warp per row, up to eight rows a block.  A warp past n writes its
//   zeros and leaves before any load.
// - The probes read channels only: lane p holds pair p, and a warp sum
//   per SD block gives the block's pair bytes and count, so the blocks'
//   lengths come out in (block, pair) order whatever order pair_sd has.
// - The assemble stages the row's valid bytes (16-byte loads) and the
//   bank in shared memory, writes the row's segment table in output order
//   (lane 0 the head, lane 8 + k block k's brackets and sid, lane p pair
//   p's five segments at its block's start plus the bytes of the block's
//   earlier pairs, found with six shuffles), gathers the output row with
//   a segment cursor a lane and stores it with aligned 16-byte stores.
//   O5/3164's assemble is two spans and needs no table.
//
// TPU workarounds not carried over: the rotate-assembly, the [N, OW]
// output matrix, the group compaction and the static (block x pair)
// segment table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_rfc5424_out_row.cuh"

namespace {

using namespace r5o;

// blocks a multiprocessor keeps resident (E1's cap: 48 registers a thread)
constexpr int kMinBlocks = 5;
constexpr int kSmemMax = enc::kSmemMax;

template <bool ASM, bool R3>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_rfc5424_out_kernel(const uint8_t* __restrict__ batch,
                          const int32_t* __restrict__ lens_in,
                          const int32_t* __restrict__ ch,
                          const uint8_t* __restrict__ bank, int bank_len,
                          ConstsR k, int N, int n, int L, int OW,
                          uint8_t* __restrict__ tier_out,
                          int32_t* __restrict__ len_out,
                          uint8_t* __restrict__ small8,
                          uint16_t* __restrict__ hostl16,
                          const int64_t* __restrict__ row_off,
                          uint8_t* __restrict__ flat) {
  extern __shared__ uint4 r5o_smem_v[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= N) return;                  // whole warps leave together
  const int nsmall = R3 ? 3 : 2;
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      for (int c = 0; c < nsmall; ++c) small8[(size_t)c * N + row] = 0;
      if (R3) hostl16[row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;                // not a kept tier row
  }
  const RowInR in{batch + (size_t)row * L, lens_in[row], L, OW, bank,
                  bank_len};
  const RowOutR out{ASM ? nullptr : tier_out + row,
                    ASM ? nullptr : len_out + row,
                    ASM ? nullptr : small8 + row, N,
                    ASM || !R3 ? nullptr : hostl16 + row,
                    ASM ? flat + dst0 : nullptr};
  const int stride =
      r5_smem(L, OW, ASM, R3 ? 0 : bank_len, R3 ? 2 : kSegs).stride;
  uint8_t* base = reinterpret_cast<uint8_t*>(r5o_smem_v) +
                  (size_t)(threadIdx.x >> 5) * stride;
  const ChanView C{ch + row, N};
  if (R3)
    encode_r3_row<ASM>(C, in, base, out, lane);
  else
    encode_r5_row<ASM>(C, in, k, base, out, lane);
}

template <bool ASM, bool R3>
int launch(const void* batch, const void* lens, const void* ch,
           const void* bank, const int* consts, int N, int n, int L, int OW,
           void* tier, void* base_len, void* small8, void* hostl16,
           const void* row_off, void* flat, cudaStream_t stream) {
  if (N <= 0) return 0;
  const ConstsR k = enc::const_table<kNumConstR>(consts);
  const int bank_len = R3 ? 0 : enc::bank_bytes(k);
  const int stride =
      r5_smem(L, OW, ASM, bank_len, R3 ? 2 : kSegs).stride;
  auto kern = encode_rfc5424_out_kernel<ASM, R3>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, stride, kSmemMax, &grid,
                                         &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<uint8_t*>(small8),
      static_cast<uint16_t*>(hostl16), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// O5 probe: base tier bit (uint8 0/1), base_len (int32) and fac8 / sev8
// (uint8 [2, N]) of every row, zeros for the rows at and past n
int fg_encode_rfc5424_out_probe(const void* batch, const void* lens,
                                const void* ch, const int* consts, int N,
                                int n, int L, void* tier, void* base_len,
                                void* small8, void* stream) {
  return launch<false, false>(batch, lens, ch, nullptr, consts, N, n, L, 0,
                              tier, base_len, small8, nullptr, nullptr,
                              nullptr, static_cast<cudaStream_t>(stream));
}

// O5 assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off]
int fg_encode_rfc5424_out_assemble(const void* batch, const void* lens,
                                   const void* ch, const void* bank,
                                   const int* consts, int N, int n, int L,
                                   int OW, const void* row_off, void* flat,
                                   void* stream) {
  return launch<true, false>(batch, lens, ch, bank, consts, N, n, L, OW,
                             nullptr, nullptr, nullptr, nullptr, row_off,
                             flat, static_cast<cudaStream_t>(stream));
}

// O5/3164 probe: base tier bit, base_len, fac8 / sev8 / pri1 (uint8
// [3, N]) and the host length (uint16 [N]), zeros at and past n
int fg_encode_rfc3164_rfc5424_probe(const void* batch, const void* lens,
                                    const void* ch, const int* consts, int N,
                                    int n, int L, void* tier, void* base_len,
                                    void* small8, void* hostl16,
                                    void* stream) {
  return launch<false, true>(batch, lens, ch, nullptr, consts, N, n, L, 0,
                             tier, base_len, small8, hostl16, nullptr,
                             nullptr, static_cast<cudaStream_t>(stream));
}

// O5/3164 assemble: the host and message bytes of each row below n with
// row_off >= 0 at flat[row_off]
int fg_encode_rfc3164_rfc5424_assemble(const void* batch, const void* lens,
                                       const void* ch, const void* bank,
                                       const int* consts, int N, int n,
                                       int L, int OW, const void* row_off,
                                       void* flat, void* stream) {
  return launch<true, true>(batch, lens, ch, bank, consts, N, n, L, OW,
                            nullptr, nullptr, nullptr, nullptr, row_off,
                            flat, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
