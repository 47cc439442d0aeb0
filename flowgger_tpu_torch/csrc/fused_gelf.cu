// The fused decode -> GELF encode routes, one warp per row: F1 (rfc5424)
// and F3 (rfc3164), a probe and an assemble each.
//
// Replaces the JAX package's fused programs _fused_rfc5424_gelf
// (flowgger_tpu/tpu/fused_routes.py:179: the K1 decode leg, Pallas
// decode_rfc5424_pallas or the demand-narrowed jnp decode, traced with
// device_gelf._encode_kernel into one jitted program, elide=True) and
// _fused_rfc3164_gelf (:197: decode_rfc3164_jit with
// DEMAND["rfc3164_gelf"] and device_rfc3164._encode_kernel).
//
// What it computes, per row of a packed [N, L] uint8 batch: the decode of
// the split route's kernel (K1 at 6 pairs, or D3 for the year given) and,
// on its channels, the encode of the split tier (E1 or E3):
// - probe: for the rows below n, the base tier bit and base_len, as E1's
//   and E3's probes, and the ok, days, sod, off and nanos channels the
//   host formats the timestamp text from (int32 [5, N], zeros at and past
//   n); the reference's fused probe returns the tier with these channels.
// - assemble: for each row below n with row_off >= 0, its elided GELF
//   bytes at flat[row_off], as E1's and E3's assembles.
// Each phase decodes its rows again, as each call of the reference's
// fused program does; the decode channels never reach global memory.
//
// Design: one __global__ a phase and route.  A warp decodes its row with
// the split decode's own row function (decode_rfc5424_row.cuh,
// decode_rfc3164_row.cuh) into the block's shared [C, 8] channel tile,
// writing only the channels the encode reads (fused_routes.DEMAND), and
// stages the row's valid bytes at the start of its encode region; the
// encode (encode_gelf_row.cuh) then reads the channels from the tile and
// the row from that staging, so each row is read from global memory
// once a phase.  Shared memory a block: the tile, K1's per-warp ordinal
// sums (F1), and the encode's per-warp region (E1's or E3's, the row
// staging included) for up to eight warps, within the 227 KiB a block may
// use (about 23 KiB at L = 512 for the assemble).
//
// Padding rows (at and past n) and, in the assemble, rows outside the
// kept tier are left before any load, as in E1 and E3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc3164_row.cuh"
#include "decode_rfc5424_row.cuh"
#include "encode_gelf_row.cuh"

namespace {

using fg::kWarps;

constexpr int kMaxPairs = 6;             // the fused route's pair width
constexpr int kC5 = r5::kN1D + 2 * enc::kMaxSd + 6 * kMaxPairs;
constexpr int kSmall = 5;                // ok, days, sod, off, nanos

// The row a warp works on and whether the phase needs it: rows past N
// leave, padding rows get zeros from the probe, the assemble leaves rows
// that are not kept.
struct FusedRow {
  int row;
  bool live;
  int64_t dst0;
};

template <bool ASM>
__device__ __forceinline__ FusedRow fused_row(int N, int n,
                                              uint8_t* tier_out,
                                              int32_t* len_out,
                                              int32_t* small,
                                              const int64_t* row_off,
                                              int lane) {
  FusedRow r{(int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)),
             false, 0};
  if (r.row >= N) return r;
  if (r.row >= n) {
    if (!ASM && lane == 0) {
      tier_out[r.row] = 0;
      len_out[r.row] = 0;
      for (int c = 0; c < kSmall; ++c) small[(size_t)c * N + r.row] = 0;
    }
    return r;
  }
  if (ASM) {
    r.dst0 = row_off[r.row];
    if (r.dst0 < 0) return r;
  }
  r.live = true;
  return r;
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps)
fused_rfc5424_gelf_kernel(const uint8_t* __restrict__ batch,
                          const int32_t* __restrict__ lens_in,
                          const uint8_t* __restrict__ ts_text,
                          const int32_t* __restrict__ ts_len_in,
                          const uint8_t* __restrict__ bank, int bank_len,
                          enc::Consts5 k, int N, int n, int L, int OW,
                          uint8_t* __restrict__ tier_out,
                          int32_t* __restrict__ len_out,
                          int32_t* __restrict__ small,
                          const int64_t* __restrict__ row_off,
                          uint8_t* __restrict__ flat) {
  extern __shared__ uint4 f1_smem_v[];
  __shared__ r5::RowSums<enc::kMaxSd, kMaxPairs> sums[kWarps];
  __shared__ int32_t tile[kC5][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FusedRow r = fused_row<ASM>(N, n, tier_out, len_out, small, row_off,
                                    lane);
  if (!r.live) return;
  const int stride =
      enc::warp_smem(L, OW, enc::segments5424(kMaxPairs), ASM, bank_len)
          .stride;
  uint8_t* base = reinterpret_cast<uint8_t*>(f1_smem_v) +
                  (size_t)warp * stride;
  const int len = lens_in[r.row];
  // the decode stages the row at the start of the warp's encode region
  r5::decode_row<enc::kMaxSd, kMaxPairs, true>(
      batch + (size_t)r.row * L, len, L, reinterpret_cast<uint4*>(base),
      sums[warp], &tile[0][warp], lane);
  __syncwarp();
  const enc::ChanView C{&tile[0][warp], kWarps};
  if (!ASM && lane == 0) {
    const int chans[kSmall] = {r5::C_OK, r5::C_DAYS, r5::C_SOD, r5::C_OFF,
                               r5::C_NANOS};
    for (int c = 0; c < kSmall; ++c)
      small[(size_t)c * N + r.row] = C(chans[c]);
  }
  const enc::RowIn in{nullptr, true, len, L, OW, bank, bank_len,
                      ASM ? ts_text + (size_t)r.row * enc::kTsW : nullptr,
                      ASM ? ts_len_in[r.row] : 0};
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  enc::encode5424_row<kMaxPairs, ASM, true>(C, in, k, enc::kMaxSd, base,
                                            out, lane);
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps)
fused_rfc3164_gelf_kernel(const uint8_t* __restrict__ batch,
                          const int32_t* __restrict__ lens_in, int year,
                          const uint8_t* __restrict__ ts_text,
                          const int32_t* __restrict__ ts_len_in,
                          const uint8_t* __restrict__ bank, int bank_len,
                          enc::Consts3 k, int N, int n, int L, int OW,
                          uint8_t* __restrict__ tier_out,
                          int32_t* __restrict__ len_out,
                          int32_t* __restrict__ small,
                          const int64_t* __restrict__ row_off,
                          uint8_t* __restrict__ flat) {
  extern __shared__ uint4 f3_smem_v[];
  __shared__ int32_t tile[r3::kChannels][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FusedRow r = fused_row<ASM>(N, n, tier_out, len_out, small, row_off,
                                    lane);
  if (!r.live) return;
  const int stride =
      enc::warp_smem(L, OW, enc::kFixed3, ASM, bank_len).stride;
  uint8_t* base = reinterpret_cast<uint8_t*>(f3_smem_v) +
                  (size_t)warp * stride;
  const int len = lens_in[r.row];
  r3::decode3164_row<true>(batch + (size_t)r.row * L, len, L, year,
                           reinterpret_cast<uint4*>(base), &tile[0][warp],
                           lane);
  __syncwarp();
  const enc::ChanView C{&tile[0][warp], kWarps};
  if (!ASM && lane == 0) {
    const int chans[kSmall] = {r3::C_OK, r3::C_DAYS, r3::C_SOD, r3::C_OFF,
                               r3::C_NANOS};
    for (int c = 0; c < kSmall; ++c)
      small[(size_t)c * N + r.row] = C(chans[c]);
  }
  const enc::RowIn in{nullptr, true, len, L, OW, bank, bank_len,
                      ASM ? ts_text + (size_t)r.row * enc::kTsW : nullptr,
                      ASM ? ts_len_in[r.row] : 0};
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  enc::encode3164_row<ASM, true>(C, in, k, base, out, lane);
}

// dynamic shared memory a block may take beside the kernels' static
// tile and sums (< 4 KiB)
constexpr int kDynMax = 220 * 1024;

template <bool ASM>
int launch5424(const void* batch, const void* lens, const void* ts_text,
               const void* ts_len, const void* bank, const int* consts,
               int N, int n, int L, int OW, void* tier, void* base_len,
               void* small, const void* row_off, void* flat,
               cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 4) return (int)cudaErrorInvalidValue;  // K1's row minimum
  const enc::Consts5 k = enc::const_table<enc::kNumConst>(consts);
  const int bank_len = enc::bank_bytes(k);
  // the decode stages the row in the encode region's first round16(L)
  // bytes: every region has them
  const int stride =
      enc::warp_smem(L, OW, enc::segments5424(kMaxPairs), ASM, bank_len)
          .stride;
  auto kern = fused_rfc5424_gelf_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, stride, kDynMax, &grid,
                                         &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<int32_t*>(small),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <bool ASM>
int launch3164(const void* batch, const void* lens, int year,
               const void* ts_text, const void* ts_len, const void* bank,
               const int* consts, int N, int n, int L, int OW, void* tier,
               void* base_len, void* small, const void* row_off, void* flat,
               cudaStream_t stream) {
  if (N <= 0) return 0;
  const enc::Consts3 k = enc::const_table<enc::kNumConst3>(consts);
  const int bank_len = enc::bank_bytes(k);
  const int stride =
      enc::warp_smem(L, OW, enc::kFixed3, ASM, bank_len).stride;
  auto kern = fused_rfc3164_gelf_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N, stride, kDynMax, &grid,
                                         &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      year, static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<int32_t*>(small),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// F1 probe: base tier bit (uint8) and base_len (int32) of every row, and
// the int32 [5, N] ok / days / sod / off / nanos channels; zeros for the
// rows at and past n
int fg_fused_rfc5424_gelf_probe(const void* batch, const void* lens,
                                const int* consts, int N, int n, int L,
                                void* tier, void* base_len, void* small,
                                void* stream) {
  return launch5424<false>(batch, lens, nullptr, nullptr, nullptr, consts, N,
                           n, L, 0, tier, base_len, small, nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// F1 assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off]
int fg_fused_rfc5424_gelf_assemble(const void* batch, const void* lens,
                                   const void* ts_text, const void* ts_len,
                                   const void* bank, const int* consts, int N,
                                   int n, int L, int OW, const void* row_off,
                                   void* flat, void* stream) {
  return launch5424<true>(batch, lens, ts_text, ts_len, bank, consts, N, n, L,
                          OW, nullptr, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

// F3 probe, for the year given
int fg_fused_rfc3164_gelf_probe(const void* batch, const void* lens, int year,
                                const int* consts, int N, int n, int L,
                                void* tier, void* base_len, void* small,
                                void* stream) {
  return launch3164<false>(batch, lens, year, nullptr, nullptr, nullptr,
                           consts, N, n, L, 0, tier, base_len, small, nullptr,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// F3 assemble, for the year given
int fg_fused_rfc3164_gelf_assemble(const void* batch, const void* lens,
                                   int year, const void* ts_text,
                                   const void* ts_len, const void* bank,
                                   const int* consts, int N, int n, int L,
                                   int OW, const void* row_off, void* flat,
                                   void* stream) {
  return launch3164<true>(batch, lens, year, ts_text, ts_len, bank, consts, N,
                          n, L, OW, nullptr, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
