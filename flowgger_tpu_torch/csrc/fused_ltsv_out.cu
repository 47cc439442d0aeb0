// The fused rfc5424 decode -> LTSV encode route FO/ltsv, one warp per
// row: a probe and an assemble.
//
// Replaces the JAX package's fused program _fused_rfc5424_ltsv
// (flowgger_tpu/tpu/fused_routes.py:329: the K1 decode leg, the Pallas
// decode_rfc5424_pallas or the demand-narrowed jnp decode, traced with
// device_ltsv_out._encode_kernel into one jitted program, elide=True).
//
// What it computes, per row of a packed [N, L] uint8 batch: K1's decode
// at 6 pairs and, on its channels, OL's encode (encode_ltsv_out.cu):
// - probe: for the rows below n, OL's base tier bit, elided length and
//   gaps (int32 [2, N]), and the ok, days, sod, off and nanos channels the
//   host formats the stamp from (int32 [5, N], zeros at and past n).  For
//   every row below n whose base tier bit is set it also writes the
//   channels OL's assemble reads (fused_routes._LTSV_OUT_CARRY: the
//   facility, severity, host, appname, procid and msgid spans, the pair
//   count, the full message and message bounds, and the four spans of
//   each of the 6 pairs) to the carried tensor `chan`, row-major, kCarryO
//   = 38 int32 a row that the row's warp stores; other rows of `chan` are
//   not written.
// - assemble: for each row below n with row_off >= 0 (a subset of the
//   probe's tier rows: the wrapper, kernels.fused_ltsv_out_cuda, checks
//   it), its elided LTSV bytes at flat[row_off], from the channels the
//   probe carried: no decode runs again (F1's pattern, fused_gelf.cu).
//
// Design: the probe's warp decodes its row with K1's row function
// (decode_rfc5424_row.cuh, word-parallel over class bitmasks) into the
// block's shared [C, 8] channel tile, staging the row's valid bytes at
// the start of its shared region; OL's row encode then reads the channels
// from the tile and the row from that staging (STAGED), so each row is
// read from global memory once.  The assemble loads a kept row's carried
// channels into the tile and runs OL's assemble, which stages the row
// with its own 16-byte loads.  Shared memory a block: the tile, K1's
// per-warp ordinal sums, and for up to eight warps the larger of OL's
// region and, in the probe, K1's staging and masks.
//
// Padding rows (at and past n) and, in the assemble, rows outside the
// kept tier are left before any load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc5424_row.cuh"
#include "encode_ltsv_out_row.cuh"

namespace {

using fg::kWarps;

constexpr int kC5 = r5::kN1D + 2 * olt::kMaxSd + 6 * olt::kPairs;
constexpr int kSmall = 5;                // ok, days, sod, off, nanos
// blocks a multiprocessor keeps resident: F1's caps
constexpr int kMinBlocks = 5;
constexpr int kProbeBlocks = 4;

// The carried channels: entry j of a row of `chan` is tile channel
// keptO(j): the 14 row channels fused_routes._LTSV_OUT_CARRY names, in
// K1's order, then name_start, name_end, val_start and val_end of the six
// pairs.
constexpr int kCarryO = 38;
__host__ __device__ constexpr int keptO(int j) {
  return j < 2 ? j + 2                   // facility, severity
         : j < 10 ? j + 6                // host .. msgid spans
         : j < 14 ? j + 8                // pair_count .. msg_trim_start
         : olt::C_PAIR0 + (j - 14);      // the pairs' four spans
}
static_assert(keptO(0) == r5::C_FACILITY && keptO(2) == r5::C_HOST_S &&
                  keptO(9) == r5::C_MSGID_E &&
                  keptO(10) == r5::C_PAIR_COUNT &&
                  keptO(13) == r5::C_MSG_TRIM_START &&
                  keptO(kCarryO - 1) == olt::C_PAIR0 + 4 * olt::kPairs - 1,
              "keptO must name the carried channels");

__host__ __device__ inline int stride_fo(int L, int OW, bool asm_mode,
                                         int bank_len) {
  const int e = olt::ol_smem(L, OW, asm_mode, bank_len).stride;
  const int d = asm_mode ? 0 : r5::stage_bytes(L);
  return e > d ? e : d;
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocks)
fused_ltsv_out_kernel(const uint8_t* __restrict__ batch,
                      const int32_t* __restrict__ lens_in,
                      const uint8_t* __restrict__ bank, int bank_len,
                      olt::ConstsO k, int N, int n, int L, int OW,
                      uint8_t* __restrict__ tier_out,
                      int32_t* __restrict__ len_out,
                      int32_t* __restrict__ gaps,
                      int32_t* __restrict__ small,
                      int32_t* __restrict__ chan,
                      const int64_t* __restrict__ row_off,
                      uint8_t* __restrict__ flat) {
  extern __shared__ uint4 fo_smem_v[];
  __shared__ r5::RowSums<olt::kMaxSd, olt::kPairs> sums[kWarps];
  __shared__ int32_t tile[kC5][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= N) return;
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      gaps[row] = 0;
      gaps[(size_t)N + row] = 0;
      for (int c = 0; c < kSmall; ++c) small[(size_t)c * N + row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;
  }
  uint8_t* base = reinterpret_cast<uint8_t*>(fo_smem_v) +
                  (size_t)warp * stride_fo(L, OW, ASM, bank_len);
  const int len = lens_in[row];
  int32_t* col = &tile[0][warp];
  if (ASM) {
    for (int j = lane; j < kCarryO; j += 32)
      col[keptO(j) * kWarps] = chan[(size_t)row * kCarryO + j];
    __syncwarp();
  } else {
    // the decode stages the row at the start of the warp's region
    r5::decode_row<olt::kMaxSd, olt::kPairs, false>(
        batch + (size_t)row * L, len, L, reinterpret_cast<uint4*>(base),
        sums[warp], col, lane);
    __syncwarp();
  }
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0;
  const olt::RowInO in{ASM ? batch + (size_t)row * L : nullptr, ASM && vec,
                       len, L, OW, bank, bank_len};
  const olt::RowOutO out{ASM ? nullptr : tier_out + row,
                         ASM ? nullptr : len_out + row,
                         ASM ? nullptr : gaps + row, N,
                         ASM ? flat + dst0 : nullptr};
  olt::encode_ltsv_out_row<ASM, !ASM>(enc::ChanView{col, kWarps}, in, k,
                                      base, out, lane);
  if (!ASM) {
    const int chans[kSmall] = {r5::C_OK, r5::C_DAYS, r5::C_SOD, r5::C_OFF,
                               r5::C_NANOS};
    if (lane == 0)
      for (int c = 0; c < kSmall; ++c)
        small[(size_t)c * N + row] = col[chans[c] * kWarps];
    // lane 0 wrote the tier bit: its own read of it is ordered
    const int tier =
        __shfl_sync(fg::kFull, lane == 0 ? tier_out[row] : 0, 0);
    if (tier)
      for (int j = lane; j < kCarryO; j += 32)
        chan[(size_t)row * kCarryO + j] = col[keptO(j) * kWarps];
  }
}

// dynamic shared memory a block may take beside the kernel's static tile
// and sums (< 4 KiB)
constexpr int kDynMax = 220 * 1024;

template <bool ASM>
int launch(const void* batch, const void* lens, const void* bank,
           const int* consts, int N, int n, int L, int OW, void* tier,
           void* base_len, void* gaps, void* small, void* chan,
           const void* row_off, void* flat, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 4) return (int)cudaErrorInvalidValue;  // K1's row minimum
  const olt::ConstsO k = enc::const_table<olt::kNumConstO>(consts);
  const int bank_len = enc::bank_bytes(k);
  auto kern = fused_ltsv_out_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N,
                                         stride_fo(L, OW, ASM, bank_len),
                                         kDynMax, &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(bank), bank_len, k, N, n, L, OW,
      static_cast<uint8_t*>(tier), static_cast<int32_t*>(base_len),
      static_cast<int32_t*>(gaps), static_cast<int32_t*>(small),
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 entries a row of the carried tensor
int fg_fused_ltsv_out_carry(int) { return kCarryO; }

// FO/ltsv probe: OL's base tier bit, base_len and gaps of every row, the
// ok / stamp channels (int32 [5, N]) and, for the base tier rows, the
// carried channels (int32 [N, 38]); zeros at and past n
int fg_fused_ltsv_out_probe(const void* batch, const void* lens,
                            const int* consts, int N, int n, int L,
                            void* tier, void* base_len, void* gaps,
                            void* small, void* chan, void* stream) {
  return launch<false>(batch, lens, nullptr, consts, N, n, L, 0, tier,
                       base_len, gaps, small, chan, nullptr, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// FO/ltsv assemble: the elided bytes of each kept probe tier row at
// flat[row_off], from the carried channels
int fg_fused_ltsv_out_assemble(const void* batch, const void* lens,
                               const void* chan, const void* bank,
                               const int* consts, int N, int n, int L,
                               int OW, const void* row_off, void* flat,
                               void* stream) {
  return launch<true>(batch, lens, bank, consts, N, n, L, OW, nullptr,
                      nullptr, nullptr, nullptr, const_cast<void*>(chan),
                      row_off, flat, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
