// The fused rfc5424 -> Cap'n Proto route FO/capnp, one warp per row: a
// probe and an assemble (K1 + OC).
//
// Replaces the JAX package's fused program _fused_rfc5424_capnp
// (flowgger_tpu/tpu/fused_routes.py:346: the K1 decode leg with
// DEMAND["rfc5424_capnp"] traced with device_capnp._encode_kernel into
// one jitted program, elide=True).
//
// What it computes, per row of a packed [N, L] uint8 batch:
// - probe: for the rows below n, OC's probe outputs (the base tier bit,
//   the elided length, fac8 / sev8) on the channels the row's decode at 4
//   SD blocks and 6 pairs produced, and the ok, days, sod, off and nanos
//   channels the host renders the stamp from (int32 [5, N], zeros at and
//   past n).  For every row below n whose base tier bit is set it also
//   writes the channels OC's assemble reads (fused_routes._OUT_CARRY:
//   the host, appname, procid and msgid spans, the SD and pair counts,
//   full_start, trim_end, msg_trim_start, sd[0]'s id span and the pairs'
//   spans and blocks, kCarryC = 45 int32) to the carried tensor `chan`,
//   row-major; other rows of `chan` are not written.
// - assemble: for each row below n with row_off >= 0 (a subset of the
//   probe's tier rows: the wrapper, kernels.fused_capnp_out_cuda, checks
//   it), its elided bytes at flat[row_off], from the channels the probe
//   carried: no decode runs again (F1's pattern, fused_gelf.cu).
//
// Design: the probe's warp decodes its row with K1's row function
// (decode_rfc5424_row.cuh, word-parallel over class bitmasks) into the
// block's shared channel tile; OC's row encode (encode_capnp_row.cuh)
// then reads its channels from the tile: the probe is channel arithmetic,
// so the staged row is not read again.  The assemble loads a kept row's
// carried channels into the tile and runs OC's assemble, which stages the
// row with its own 16-byte loads.  Shared memory a block: the tile, K1's
// per-warp ordinal sums, and for up to eight warps the larger of the
// assemble's region and, in the probe, the decode's staging.
//
// Padding rows (at and past n) and, in the assemble, rows outside the
// kept tier are left before any load.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc5424_row.cuh"
#include "encode_capnp_row.cuh"

namespace {

using fg::kWarps;

constexpr int kP = 6;                    // the route decodes at 6 pairs
using KC = ocp::ChC<kP>;
constexpr int kC = KC::kChannels;
constexpr int kSmall = 5;                // ok, days, sod, off, nanos
constexpr int kAsmBlocks = 4;           // 64 registers a thread
constexpr int kProbeBlocks = 4;
constexpr int kDynMax = 220 * 1024;

// The carried channels: entry j of a row of `chan` is tile channel
// keptc(j): the host .. msgid spans, sd_count, pair_count, full_start,
// trim_end and msg_trim_start, sd[0]'s sid_start and sid_end, then the
// pairs' name, value and block channels (not val_has_esc).
constexpr int kCarryC = 45;
__host__ __device__ constexpr int keptc(int j) {
  return j < 8 ? j + 8                   // host .. msgid spans
         : j < 13 ? j + 9                // sd_count .. msg_trim_start
         : j == 13 ? KC::SID_S
         : j == 14 ? KC::SID_E
         : KC::PAIR0 + (j - 15);         // the pairs, to pair_sd
}
static_assert(keptc(0) == KC::HOST_S && keptc(7) == KC::MSGID_E &&
                  keptc(8) == KC::SD_COUNT &&
                  keptc(12) == KC::MSG_TRIM_START &&
                  keptc(kCarryC - 1) == KC::PAIR_SD + kP - 1,
              "keptc must name the carried channels");
static_assert(r5::kN1D == KC::SID_S, "the tile holds K1's channels");

__host__ __device__ inline int stride_fc(int L, int OW, bool asm_mode) {
  const int e = ocp::oc_stride(L, OW, asm_mode);
  const int d = asm_mode ? 0 : r5::stage_bytes(L);
  return e > d ? e : d;
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kAsmBlocks : kProbeBlocks)
fused_capnp_kernel(const uint8_t* __restrict__ batch,
                   const int32_t* __restrict__ lens_in,
                   const uint8_t* __restrict__ bank, ocp::ConstsC k, int N,
                   int n, int L, int OW, uint8_t* __restrict__ tier_out,
                   int32_t* __restrict__ len_out,
                   int32_t* __restrict__ small,
                   uint8_t* __restrict__ small8,
                   int32_t* __restrict__ chan,
                   const int64_t* __restrict__ row_off,
                   uint8_t* __restrict__ flat) {
  extern __shared__ uint4 fc_smem_v[];
  __shared__ r5::RowSums<ocp::kMaxSd, kP> sums[ASM ? 1 : kWarps];
  __shared__ int32_t tile[kC][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= N) return;
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
      for (int c = 0; c < kSmall; ++c) small[(size_t)c * N + row] = 0;
      small8[row] = 0;
      small8[(size_t)N + row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;
  }
  uint8_t* base = reinterpret_cast<uint8_t*>(fc_smem_v) +
                  (size_t)warp * stride_fc(L, OW, ASM);
  const int len = lens_in[row];
  int32_t* col = &tile[0][warp];
  if (ASM) {
    for (int j = lane; j < kCarryC; j += 32)
      col[keptc(j) * kWarps] = chan[(size_t)row * kCarryC + j];
  } else {
    r5::decode_row<ocp::kMaxSd, kP, false>(
        batch + (size_t)row * L, len, L, reinterpret_cast<uint4*>(base),
        sums[ASM ? 0 : warp], col, lane);
  }
  __syncwarp();
  const ocp::RowInC in{batch + (size_t)row * L, len, L, OW,
                       ASM ? bank + k.blob_off : nullptr, k};
  const ocp::RowOutC out{ASM ? nullptr : tier_out + row,
                         ASM ? nullptr : len_out + row,
                         ASM ? nullptr : small8 + row, N,
                         ASM ? flat + dst0 : nullptr};
  const enc::ChanView C{col, kWarps};
  ocp::encode_capnp_row<kP, ASM>(C, in, base, out, lane);
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
      for (int j = lane; j < kCarryC; j += 32)
        chan[(size_t)row * kCarryC + j] = col[keptc(j) * kWarps];
  }
}

template <bool ASM>
int launch(const void* batch, const void* lens, const void* bank,
           const int* consts, int N, int n, int L, int OW, void* tier,
           void* base_len, void* small, void* small8, void* chan,
           const void* row_off, void* flat, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 4) return (int)cudaErrorInvalidValue;  // K1's row minimum
  const ocp::ConstsC k = ocp::consts_c(consts);
  auto kern = fused_capnp_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, stride_fc(L, OW, ASM),
                                         kDynMax, &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(bank), k, N, n, L, OW,
      static_cast<uint8_t*>(tier), static_cast<int32_t*>(base_len),
      static_cast<int32_t*>(small), static_cast<uint8_t*>(small8),
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 entries a row of the carried tensor
int fg_fused_capnp_out_carry(void) { return kCarryC; }

// FO/capnp probe: OC's probe outputs, the ok / stamp channels (int32
// [5, N]) and, for the base tier rows, the carried channels (int32
// [N, 45]); zeros at and past n
int fg_fused_rfc5424_capnp_probe(const void* batch, const void* lens,
                                 const int* consts, int N, int n, int L,
                                 void* tier, void* base_len, void* small,
                                 void* small8, void* chan, void* stream) {
  return launch<false>(batch, lens, nullptr, consts, N, n, L, 0, tier,
                       base_len, small, small8, chan, nullptr, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// FO/capnp assemble: the elided bytes of each kept probe tier row at
// flat[row_off], from the carried channels
int fg_fused_rfc5424_capnp_assemble(const void* batch, const void* lens,
                                    const void* chan, const void* bank,
                                    const int* consts, int N, int n, int L,
                                    int OW, const void* row_off, void* flat,
                                    void* stream) {
  return launch<true>(batch, lens, bank, consts, N, n, L, OW, nullptr,
                      nullptr, nullptr, nullptr, const_cast<void*>(chan),
                      row_off, flat, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
