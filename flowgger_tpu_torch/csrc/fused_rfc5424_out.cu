// The fused decode -> RFC5424 encode routes FO/r5, one warp per row: a
// probe and an assemble for each leg, rfc5424 (K1 + O5) and rfc3164
// (D3 + O5/3164).
//
// Replaces the JAX package's fused programs _fused_rfc5424_rfc5424
// (flowgger_tpu/tpu/fused_routes.py:297: the K1 decode leg with
// DEMAND["rfc5424_rfc5424"] traced with device_rfc5424_out._encode_kernel
// into one jitted program, elide=True) and _fused_rfc3164_rfc5424 (:313:
// decode_rfc3164_jit with _encode_kernel_3164, the year an argument).
//
// What it computes, per row of a packed [N, L] uint8 batch:
// - probe: for the rows below n, the split tier's probe outputs (O5's or
//   O5/3164's: the base tier bit, the elided length, the uint8 small
//   channels and, on the rfc3164 leg, the uint16 host length) on the
//   channels the row's decode produced, and the ok, days, sod, off and
//   nanos channels the host renders the stamp from (int32 [5, N], zeros
//   at and past n).  For every row below n whose base tier bit is set it
//   also writes the channels the leg's assemble reads
//   (fused_routes._OUT_CARRY: rfc5424 the host, appname, procid, msgid
//   and message spans, the SD and pair counts, the SD ids' spans and the
//   pairs' spans and blocks, kCarryR5 = 50 int32; rfc3164 the host span
//   and msg_start, kCarryR3 = 3) to the carried tensor `chan`, row-major;
//   other rows of `chan` are not written.
// - assemble: for each row below n with row_off >= 0 (a subset of the
//   probe's tier rows: the wrapper, kernels.fused_rfc5424_out_cuda,
//   checks it), its elided bytes at flat[row_off], from the channels the
//   probe carried: no decode runs again (F1's pattern, fused_gelf.cu).
//
// Design: the probe's warp decodes its row with K1's row function
// (decode_rfc5424_row.cuh, word-parallel over class bitmasks) or D3's
// (decode_rfc3164_row.cuh) into the block's shared channel tile; the
// leg's row encode (encode_rfc5424_out_row.cuh) then reads its channels
// from the tile: the probes are channel arithmetic, so the staged row is
// not read again.  The assemble loads a kept row's carried channels into
// the tile and runs the leg's assemble, which stages the row with its
// own 16-byte loads.  Shared memory a block: the tile, K1's per-warp
// ordinal sums, and for up to eight warps the larger of the assemble's
// region and, in the probe, the decode's staging.
//
// Padding rows (at and past n) and, in the assemble, rows outside the
// kept tier are left before any load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc3164_row.cuh"
#include "decode_rfc5424_row.cuh"
#include "encode_rfc5424_out_row.cuh"

namespace {

using fg::kWarps;

constexpr int kC5 = r5::kN1D + 2 * r5o::kMaxSd + 6 * r5o::kPairs;
constexpr int kSmall = 5;                // ok, days, sod, off, nanos
constexpr int kMinBlocks = 5;
constexpr int kProbeBlocks = 4;
constexpr int kDynMax = 220 * 1024;

// The carried channels: entry j of a row of `chan` is tile channel
// kept5(j) (rfc5424: the host .. msgid spans, sd_count, pair_count,
// trim_end and msg_trim_start, then the SD ids' spans and the pairs'
// name, value and block channels, without val_has_esc) or kept3(j)
// (rfc3164: host_start, host_end, msg_start).
constexpr int kCarryR5 = 50;
constexpr int kCarryR3 = 3;
__host__ __device__ constexpr int kept5(int j) {
  return j < 8 ? j + 8                   // host .. msgid spans
         : j == 8 ? r5::C_SD_COUNT
         : j == 9 ? r5::C_PAIR_COUNT
         : j == 10 ? r5::C_TRIM_END
         : j == 11 ? r5::C_MSG_TRIM_START
         : j + 11;                       // SD ids, the pairs to pair_sd
}
__host__ __device__ constexpr int kept3(int j) { return r3::C_HOST_S + j; }
static_assert(kept5(0) == r5o::C_HOST_S && kept5(7) == r5o::C_MSGID_E &&
                  kept5(12) == r5o::C_SID_S &&
                  kept5(kCarryR5 - 1) == r5o::C_PAIR_SD + r5o::kPairs - 1,
              "kept5 must name the carried channels");
static_assert(kept3(kCarryR3 - 1) == r3::C_MSG_START,
              "kept3 must name the carried channels");

template <bool R3>
__host__ __device__ inline int stride_fo(int L, int OW, bool asm_mode,
                                         int bank_len) {
  const int e = r5o::r5_smem(L, OW, asm_mode, R3 ? 0 : bank_len,
                             R3 ? 2 : r5o::kSegs).stride;
  const int d = asm_mode ? 0 : R3 ? fg::round16(L) : r5::stage_bytes(L);
  return e > d ? e : d;
}

template <bool ASM, bool R3>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocks)
fused_rfc5424_out_kernel(const uint8_t* __restrict__ batch,
                         const int32_t* __restrict__ lens_in, int year,
                         const uint8_t* __restrict__ bank, int bank_len,
                         r5o::ConstsR k, int N, int n, int L, int OW,
                         uint8_t* __restrict__ tier_out,
                         int32_t* __restrict__ len_out,
                         int32_t* __restrict__ small,
                         uint8_t* __restrict__ small8,
                         uint16_t* __restrict__ hostl16,
                         int32_t* __restrict__ chan,
                         const int64_t* __restrict__ row_off,
                         uint8_t* __restrict__ flat) {
  constexpr int kC = R3 ? r3::kChannels : kC5;
  constexpr int kCarry = R3 ? kCarryR3 : kCarryR5;
  extern __shared__ uint4 fr_smem_v[];
  __shared__ r5::RowSums<r5o::kMaxSd, r5o::kPairs> sums[R3 ? 1 : kWarps];
  __shared__ int32_t tile[kC][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= N) return;
  const int nsmall8 = R3 ? 3 : 2;
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      for (int c = 0; c < kSmall; ++c) small[(size_t)c * N + row] = 0;
      for (int c = 0; c < nsmall8; ++c) small8[(size_t)c * N + row] = 0;
      if (R3) hostl16[row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;
  }
  uint8_t* base = reinterpret_cast<uint8_t*>(fr_smem_v) +
                  (size_t)warp * stride_fo<R3>(L, OW, ASM, bank_len);
  const int len = lens_in[row];
  int32_t* col = &tile[0][warp];
  auto kept = [](int j) { return R3 ? kept3(j) : kept5(j); };
  if (ASM) {
    for (int j = lane; j < kCarry; j += 32)
      col[kept(j) * kWarps] = chan[(size_t)row * kCarry + j];
    __syncwarp();
  } else {
    if (R3)
      r3::decode3164_row<false>(batch + (size_t)row * L, len, L, year,
                                reinterpret_cast<uint4*>(base), col, lane);
    else
      r5::decode_row<r5o::kMaxSd, r5o::kPairs, false>(
          batch + (size_t)row * L, len, L, reinterpret_cast<uint4*>(base),
          sums[R3 ? 0 : warp], col, lane);
    __syncwarp();
  }
  const r5o::RowInR in{batch + (size_t)row * L, len, L, OW, bank,
                       R3 ? 0 : bank_len};
  const r5o::RowOutR out{ASM ? nullptr : tier_out + row,
                         ASM ? nullptr : len_out + row,
                         ASM ? nullptr : small8 + row, N,
                         ASM || !R3 ? nullptr : hostl16 + row,
                         ASM ? flat + dst0 : nullptr};
  const enc::ChanView C{col, kWarps};
  if (R3)
    r5o::encode_r3_row<ASM>(C, in, base, out, lane);
  else
    r5o::encode_r5_row<ASM>(C, in, k, base, out, lane);
  if (!ASM) {
    const int chans[kSmall] = {
        R3 ? (int)r3::C_OK : (int)r5::C_OK,
        R3 ? (int)r3::C_DAYS : (int)r5::C_DAYS,
        R3 ? (int)r3::C_SOD : (int)r5::C_SOD,
        R3 ? (int)r3::C_OFF : (int)r5::C_OFF,
        R3 ? (int)r3::C_NANOS : (int)r5::C_NANOS};
    if (lane == 0)
      for (int c = 0; c < kSmall; ++c)
        small[(size_t)c * N + row] = col[chans[c] * kWarps];
    // lane 0 wrote the tier bit: its own read of it is ordered
    const int tier =
        __shfl_sync(fg::kFull, lane == 0 ? tier_out[row] : 0, 0);
    if (tier)
      for (int j = lane; j < kCarry; j += 32)
        chan[(size_t)row * kCarry + j] = col[kept(j) * kWarps];
  }
}

template <bool ASM, bool R3>
int launch(const void* batch, const void* lens, int year, const void* bank,
           const int* consts, int N, int n, int L, int OW, void* tier,
           void* base_len, void* small, void* small8, void* hostl16,
           void* chan, const void* row_off, void* flat,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 4) return (int)cudaErrorInvalidValue;  // K1's row minimum
  const r5o::ConstsR k = enc::const_table<r5o::kNumConstR>(consts);
  const int bank_len = R3 ? 0 : enc::bank_bytes(k);
  auto kern = fused_rfc5424_out_kernel<ASM, R3>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N,
                                         stride_fo<R3>(L, OW, ASM, bank_len),
                                         kDynMax, &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      year, static_cast<const uint8_t*>(bank), bank_len, k, N, n, L, OW,
      static_cast<uint8_t*>(tier), static_cast<int32_t*>(base_len),
      static_cast<int32_t*>(small), static_cast<uint8_t*>(small8),
      static_cast<uint16_t*>(hostl16), static_cast<int32_t*>(chan),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 entries a row of the carried tensor: route 5424 (rfc5424) or
// 3164 (rfc3164)
int fg_fused_rfc5424_out_carry(int route) {
  return route == 3164 ? kCarryR3 : kCarryR5;
}

// FO/r5 rfc5424 probe: O5's probe outputs, the ok / stamp channels (int32
// [5, N]) and, for the base tier rows, the carried channels (int32
// [N, 50]); zeros at and past n
int fg_fused_rfc5424_rfc5424_probe(const void* batch, const void* lens,
                                   const int* consts, int N, int n, int L,
                                   void* tier, void* base_len, void* small,
                                   void* small8, void* chan, void* stream) {
  return launch<false, false>(batch, lens, 0, nullptr, consts, N, n, L, 0,
                              tier, base_len, small, small8, nullptr, chan,
                              nullptr, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// FO/r5 rfc5424 assemble: the elided bytes of each kept probe tier row at
// flat[row_off], from the carried channels
int fg_fused_rfc5424_rfc5424_assemble(const void* batch, const void* lens,
                                      const void* chan, const void* bank,
                                      const int* consts, int N, int n, int L,
                                      int OW, const void* row_off,
                                      void* flat, void* stream) {
  return launch<true, false>(batch, lens, 0, bank, consts, N, n, L, OW,
                             nullptr, nullptr, nullptr, nullptr, nullptr,
                             const_cast<void*>(chan), row_off, flat,
                             static_cast<cudaStream_t>(stream));
}

// FO/r5 rfc3164 probe: O5/3164's probe outputs, the ok / stamp channels
// and, for the base tier rows, the carried channels (int32 [N, 3]); the
// decode assumes `year`
int fg_fused_rfc3164_rfc5424_probe(const void* batch, const void* lens,
                                   int year, const int* consts, int N, int n,
                                   int L, void* tier, void* base_len,
                                   void* small, void* small8, void* hostl16,
                                   void* chan, void* stream) {
  return launch<false, true>(batch, lens, year, nullptr, consts, N, n, L, 0,
                             tier, base_len, small, small8, hostl16, chan,
                             nullptr, nullptr,
                             static_cast<cudaStream_t>(stream));
}

// FO/r5 rfc3164 assemble: the host and message bytes of each kept probe
// tier row at flat[row_off], from the carried channels
int fg_fused_rfc3164_rfc5424_assemble(const void* batch, const void* lens,
                                      const void* chan, const void* bank,
                                      const int* consts, int N, int n, int L,
                                      int OW, const void* row_off,
                                      void* flat, void* stream) {
  return launch<true, true>(batch, lens, 0, bank, consts, N, n, L, OW,
                            nullptr, nullptr, nullptr, nullptr, nullptr,
                            const_cast<void*>(chan), row_off, flat,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
