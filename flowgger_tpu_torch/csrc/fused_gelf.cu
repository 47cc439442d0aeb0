// The fused decode -> GELF encode routes, one warp per row: F1 (rfc5424),
// F3 (rfc3164), FL (ltsv) and FG (gelf), a probe and an assemble each.
//
// Replaces the JAX package's fused programs _fused_rfc5424_gelf
// (flowgger_tpu/tpu/fused_routes.py:179: the K1 decode leg, Pallas
// decode_rfc5424_pallas or the demand-narrowed jnp decode, traced with
// device_gelf._encode_kernel into one jitted program, elide=True) and
// _fused_rfc3164_gelf (:197: decode_rfc3164_jit with
// DEMAND["rfc3164_gelf"] and device_rfc3164._encode_kernel) and
// _fused_ltsv_gelf (:215: decode_ltsv_jit with DEMAND["ltsv_gelf"] and
// device_ltsv._encode_kernel at 6 pairs; its probe hands the host the
// narrowed timestamp channels of _ltsv_small_fetch :243) and
// _fused_gelf_gelf (:276: decode_gelf_jit, the flat structural index at 8
// fields, with device_gelf_gelf._encode_kernel; its probe returns the
// encode's timestamp parse with the decode's ok, :284-288).
//
// What it computes, per row of a packed [N, L] uint8 batch: the decode of
// the split route's kernel (K1 at 6 pairs, D3 for the year given, or L1)
// and, on its channels, the encode of the split tier (E1, E3 or EL at 6
// pairs):
// - probe: for the rows below n, the base tier bit and base_len, as E1's
//   and E3's probes, and the ok, days, sod, off and nanos channels the
//   host formats the timestamp text from (int32 [5, N], zeros at and past
//   n); the reference's fused probe returns the tier with these channels.
//   For every row below n whose base tier bit is set it also writes the
//   channels the encode reads (fused_routes.DEMAND) to the carried
//   tensor `chan`, row-major: kCarry5 = 56 int32 a row for F1 (6 pairs,
//   4 SD elements), kCarry3 = 11 for F3, one contiguous run a row that
//   the row's warp stores (224 or 44 bytes).  FL carries what EL's
//   assemble reads after the pair selection and the sort, not the
//   24-part table: kCarryL = 31 int32 (the pair count, the escaped host
//   and message spans, whether a message is present, the level, and the
//   four escaped span ends of each of the 6 sorted pairs; 124 bytes), so
//   its assemble selects and sorts nothing again.  FG likewise carries
//   what EG's assemble reads after special routing and the sort:
//   kCarryG = 49 int32 (the pair count, the presence flags, the spans of
//   full_message, host, the level digit and short_message, and each of
//   the 8 sorted fields' name and value spans with its value class and
//   '_' flag; 196 bytes), and its small channels are EG's stamp parse
//   (int32 [3, N]: ts_hi, ts_lo, ts_meta, zeros off the tier).  FL's small
//   channels are the reference's narrowed ones, one 25 N-byte buffer
//   (encode_ltsv_row.cuh SmallL: days, sod, nanos, ts_hi, ts_lo int32,
//   off / 60 int16, ok, ts_kind, ts_meta & 255 uint8), so a row's stamp
//   crosses in fewer bytes than the constants the encode leaves out.
//   Other rows of `chan` are not written.
// - assemble: for each row below n with row_off >= 0 (a subset of the
//   probe's tier rows: the wrapper, kernels.fused_gelf_cuda, checks it),
//   its elided GELF bytes at flat[row_off], as E1's and E3's assembles,
//   from the channels the probe carried.
//
// One decode per taken batch.  Each call of the reference's fused program
// is whole, so its assemble decodes the batch again; here the probe keeps
// its decode in `chan` and the assemble runs no decode: it loads a kept
// row's channels into the block's shared tile with one coalesced load
// and runs the split tier's row encode (encode_gelf_row.cuh) on them,
// staging the row with the encode's own 16-byte loads, as E1 does.  That
// departs from the reference's structure, not from its output: the
// channels are the same function of the same batch, so every byte is the
// same.
//
// Design: one __global__ a phase and route.  In the probe a warp decodes
// its row with the split decode's own row function
// (decode_rfc5424_row.cuh, decode_rfc3164_row.cuh) into the block's
// shared [C, 8] channel tile, writing only the channels the encode reads,
// and stages the row's valid bytes at the start of its encode region;
// the encode then reads the channels from the tile and the row from that
// staging, so each row is read from global memory once.  F1's decode is
// word-parallel (decode_rfc5424.cu has its notes): after staging, lane j
// builds the class bitmasks of positions 32j..32j+31 once, in the warp's
// shared area just past the staged row; the passes read those words.
// Shared memory a block: the tile, K1's per-warp ordinal sums (F1), and
// for up to eight warps the larger of the encode's region (E1's or E3's,
// the row staging included) and, in F1's probe, the decode's staging and
// masks, within the 227 KiB a block may use.
//
// Hopper specifics, and why they stop there: the redesign uses shared
// memory (the masks and the tile) and warp-level bit parallelism.  TMA or
// cp.async would hide a load that the warp does not wait on for long: a
// row is staged once with 16-byte loads and the chain after it is
// compute latency; they would also leave the subset of CUDA that the
// tests' g++ emulation runs.  Tensor cores have no work in byte
// classification.
//
// Padding rows (at and past n) and, in the assemble, rows outside the
// kept tier are left before any load, as in E1 and E3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_ltsv_row.cuh"
#include "decode_rfc3164_row.cuh"
#include "decode_rfc5424_row.cuh"
#include "encode_gelf_gelf_row.cuh"
#include "encode_gelf_row.cuh"
#include "encode_ltsv_row.cuh"
#include "structural_index_row.cuh"

namespace {

using fg::kWarps;

constexpr int kMaxPairs = 6;             // the fused route's pair width
constexpr int kC5 = r5::kN1D + 2 * enc::kMaxSd + 6 * kMaxPairs;
constexpr int kSmall = 5;                // ok, days, sod, off, nanos
// blocks a multiprocessor keeps resident: in the assembles E1's cap (48
// registers a thread); in the probes the caps that ran fastest on the
// H100 (kernel_variants.py probe-bounds; F1: 64 registers, no spills; F3:
// 40 registers, 4 bytes of spills).  A minimum of one block let nvcc take
// 94 and 84 registers, and both probes ran slower.
constexpr int kMinBlocks = 5;
constexpr int kProbeBlocks5 = 4;
constexpr int kProbeBlocks3 = 6;
constexpr int kProbeBlocksL = 4;
constexpr int kProbeBlocksG = 4;
constexpr int kFieldsG = 8;              // the fused gelf route's field width

// The carried channels: entry j of a row of `chan` is tile channel
// kept5(j) (F1) or kept3(j) (F3), the channels fused_routes.DEMAND names.
// F1 drops bom, facility, the msgid span and msg_start of the 23 row
// channels (18 kept), keeps the SD spans (8) and drops pair_sd of the six
// pair channels (30 kept); F3 drops facility.
constexpr int kCarry5 = 56;
constexpr int kCarry3 = r3::kChannels - 1;

__host__ __device__ constexpr int kept5(int j) {
  return j == 0 ? r5::C_OK : j == 1 ? r5::C_SEVERITY
         : j < 12 ? j + 2 : j < 50 ? j + 5 : j + 11;
}
__host__ __device__ constexpr int kept3(int j) {
  return j < r3::C_FACILITY ? j : j + 1;
}
static_assert(kept5(2) == r5::C_DAYS && kept5(11) == r5::C_PROC_E &&
                  kept5(12) == r5::C_SD_COUNT &&
                  kept5(17) == r5::C_HAS_HIGH && kept5(18) == r5::kN1D &&
                  kept5(49) == r5::kN1D + 2 * enc::kMaxSd + 4 * kMaxPairs - 1 &&
                  kept5(kCarry5 - 1) == kC5 - 1,
              "kept5 must name the DEMAND channels");
static_assert(kept3(kCarry3 - 1) == r3::kChannels - 1,
              "kept3 must name the DEMAND channels");

// The row a warp works on and whether the phase needs it: rows past N
// leave, padding rows get zeros from the probe, the assemble leaves rows
// that are not kept.
struct FusedRow {
  int row;
  bool live;
  int64_t dst0;
};

template <bool ASM, int NSMALL = kSmall>
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
      for (int c = 0; c < NSMALL; ++c) small[(size_t)c * N + r.row] = 0;
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

// The probe's tail, after the row's encode: the small channels, and for
// a row of the base tier its carried channels, one run of C a row.
template <int C, class Kept>
__device__ __forceinline__ void probe_store(const int32_t* tile_col,
                                            const int (&chans)[kSmall],
                                            Kept kept, int N, int row,
                                            const uint8_t* tier_out,
                                            int32_t* small, int32_t* chan,
                                            int lane) {
  if (lane == 0)
    for (int c = 0; c < kSmall; ++c)
      small[(size_t)c * N + row] = tile_col[chans[c] * kWarps];
  // lane 0 wrote the tier bit: its own read of it is ordered
  const int tier = __shfl_sync(fg::kFull, lane == 0 ? tier_out[row] : 0, 0);
  if (tier)
    for (int j = lane; j < C; j += 32)
      chan[(size_t)row * C + j] = tile_col[kept(j) * kWarps];
}

// The assemble's head: a kept row's carried channels into the tile.
template <int C, class Kept>
__device__ __forceinline__ void load_carried(int32_t* tile_col, Kept kept,
                                             const int32_t* chan, int row,
                                             int lane) {
  for (int j = lane; j < C; j += 32)
    tile_col[kept(j) * kWarps] = chan[(size_t)row * C + j];
  __syncwarp();
}

// The encode's row input: the assemble loads the row itself (16-byte
// loads where L and the batch allow), the probe reads the decode's
// staging.
template <bool ASM>
__device__ __forceinline__ enc::RowIn row_in(const uint8_t* batch,
                                             int row, int len, int L, int OW,
                                             const uint8_t* bank,
                                             int bank_len,
                                             const uint8_t* ts_text,
                                             const int32_t* ts_len_in) {
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0;
  return enc::RowIn{ASM ? batch + (size_t)row * L : nullptr, ASM && vec,
                    len, L, OW, bank, bank_len,
                    ASM ? ts_text + (size_t)row * enc::kTsW : nullptr,
                    ASM ? ts_len_in[row] : 0};
}

// F1's per-warp shared bytes: the encode's region, and in the probe at
// least the decode's staging and masks (r5::stage_bytes).
__host__ __device__ inline int stride5424(int L, int OW, bool asm_mode,
                                          int bank_len) {
  const int e = enc::warp_smem(L, OW, enc::segments5424(kMaxPairs), asm_mode,
                               bank_len).stride;
  const int d = asm_mode ? 0 : r5::stage_bytes(L);
  return e > d ? e : d;
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocks5)
fused_rfc5424_gelf_kernel(const uint8_t* __restrict__ batch,
                          const int32_t* __restrict__ lens_in,
                          const uint8_t* __restrict__ ts_text,
                          const int32_t* __restrict__ ts_len_in,
                          const uint8_t* __restrict__ bank, int bank_len,
                          enc::Consts5 k, int N, int n, int L, int OW,
                          uint8_t* __restrict__ tier_out,
                          int32_t* __restrict__ len_out,
                          int32_t* __restrict__ small,
                          int32_t* __restrict__ chan,
                          const int64_t* __restrict__ row_off,
                          uint8_t* __restrict__ flat) {
  extern __shared__ uint4 f1_smem_v[];
  __shared__ r5::RowSums<enc::kMaxSd, kMaxPairs> sums[kWarps];
  __shared__ int32_t tile[kC5][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FusedRow r = fused_row<ASM>(N, n, tier_out, len_out, small, row_off,
                                    lane);
  if (!r.live) return;
  uint8_t* base = reinterpret_cast<uint8_t*>(f1_smem_v) +
                  (size_t)warp * stride5424(L, OW, ASM, bank_len);
  const int len = lens_in[r.row];
  int32_t* col = &tile[0][warp];
  auto kept = [](int j) { return kept5(j); };
  if (ASM) {
    load_carried<kCarry5>(col, kept, chan, r.row, lane);
  } else {
    // the decode stages the row at the start of the warp's encode region
    r5::decode_row<enc::kMaxSd, kMaxPairs, true>(
        batch + (size_t)r.row * L, len, L, reinterpret_cast<uint4*>(base),
        sums[warp], col, lane);
    __syncwarp();
  }
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  enc::encode5424_row<kMaxPairs, ASM, !ASM>(
      enc::ChanView{col, kWarps},
      row_in<ASM>(batch, r.row, len, L, OW, bank, bank_len, ts_text,
                  ts_len_in),
      k, enc::kMaxSd, base, out, lane);
  if (!ASM) {
    const int chans[kSmall] = {r5::C_OK, r5::C_DAYS, r5::C_SOD, r5::C_OFF,
                               r5::C_NANOS};
    probe_store<kCarry5>(col, chans, kept, N, r.row, tier_out, small, chan,
                         lane);
  }
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocks3)
fused_rfc3164_gelf_kernel(const uint8_t* __restrict__ batch,
                          const int32_t* __restrict__ lens_in, int year,
                          const uint8_t* __restrict__ ts_text,
                          const int32_t* __restrict__ ts_len_in,
                          const uint8_t* __restrict__ bank, int bank_len,
                          enc::Consts3 k, int N, int n, int L, int OW,
                          uint8_t* __restrict__ tier_out,
                          int32_t* __restrict__ len_out,
                          int32_t* __restrict__ small,
                          int32_t* __restrict__ chan,
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
  int32_t* col = &tile[0][warp];
  auto kept = [](int j) { return kept3(j); };
  if (ASM) {
    load_carried<kCarry3>(col, kept, chan, r.row, lane);
  } else {
    r3::decode3164_row<true>(batch + (size_t)r.row * L, len, L, year,
                             reinterpret_cast<uint4*>(base), col, lane);
    __syncwarp();
  }
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  enc::encode3164_row<ASM, !ASM>(
      enc::ChanView{col, kWarps},
      row_in<ASM>(batch, r.row, len, L, OW, bank, bank_len, ts_text,
                  ts_len_in),
      k, base, out, lane);
  if (!ASM) {
    const int chans[kSmall] = {r3::C_OK, r3::C_DAYS, r3::C_SOD, r3::C_OFF,
                               r3::C_NANOS};
    probe_store<kCarry3>(col, chans, kept, N, r.row, tier_out, small, chan,
                         lane);
  }
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocksL)
fused_ltsv_gelf_kernel(const uint8_t* __restrict__ batch,
                       const int32_t* __restrict__ lens_in,
                       const uint8_t* __restrict__ ts_text,
                       const int32_t* __restrict__ ts_len_in,
                       const uint8_t* __restrict__ bank, int bank_len,
                       enc::ConstsL k, int N, int n, int L, int OW,
                       uint8_t* __restrict__ tier_out,
                       int32_t* __restrict__ len_out,
                       int32_t* __restrict__ small,
                       int32_t* __restrict__ chan,
                       const int64_t* __restrict__ row_off,
                       uint8_t* __restrict__ flat) {
  extern __shared__ uint4 fl_smem_v[];
  __shared__ int32_t tile[ASM ? 1 : lt::kChannels][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FusedRow r = fused_row<ASM, 0>(N, n, tier_out, len_out, nullptr,
                                       row_off, lane);
  const enc::SmallL sm{reinterpret_cast<uint8_t*>(small), N};
  if (!ASM && !r.live && r.row < N && lane == 0)
    enc::store_small_ltsv(sm, r.row, 0, 0, 0, 0, 0, 0, 0, 0, 0);  // padding
  if (!r.live) return;
  const int stride = enc::warp_smem(L, OW, enc::segments_ltsv(kMaxPairs),
                                    ASM, bank_len).stride;
  uint8_t* base = reinterpret_cast<uint8_t*>(fl_smem_v) +
                  (size_t)warp * stride;
  const int len = lens_in[r.row];
  int32_t* col = &tile[0][warp];
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  const enc::RowIn in = row_in<ASM>(batch, r.row, len, L, OW, bank, bank_len,
                                    ts_text, ts_len_in);
  int32_t* carried = chan + (size_t)r.row * enc::kCarryL;
  if (ASM) {
    // the probe's selection: no decode, no pair selection, no sort
    enc::encode_ltsv_row<kMaxPairs, true, false, true>(
        enc::ChanView{col, kWarps}, carried, in, k, base, out, lane);
    return;
  }
  // the decode stages the row at the start of the warp's encode region
  lt::decode_ltsv_row<true>(batch + (size_t)r.row * L, len, L,
                            reinterpret_cast<uint4*>(base), col, lane);
  __syncwarp();
  enc::encode_ltsv_row<kMaxPairs, false, true, false>(
      enc::ChanView{col, kWarps}, nullptr, in, k, base, out, lane, carried,
      sm, r.row);
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps,
                                  ASM ? kMinBlocks : kProbeBlocksG)
fused_gelf_gelf_kernel(const uint8_t* __restrict__ batch,
                       const int32_t* __restrict__ lens_in,
                       const uint8_t* __restrict__ ts_text,
                       const int32_t* __restrict__ ts_len_in,
                       const uint8_t* __restrict__ bank, int bank_len,
                       enc::ConstsG k, int N, int n, int L, int OW,
                       uint8_t* __restrict__ tier_out,
                       int32_t* __restrict__ len_out,
                       int32_t* __restrict__ small,
                       int32_t* __restrict__ chan,
                       const int64_t* __restrict__ row_off,
                       uint8_t* __restrict__ flat) {
  extern __shared__ uint4 fgg_smem_v[];
  __shared__ int32_t tile[ASM ? 1 : si::channels(kFieldsG)][kWarps];
  __shared__ si::RowSums<kFieldsG> sums[ASM ? 1 : kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FusedRow r = fused_row<ASM, 0>(N, n, tier_out, len_out, nullptr,
                                       row_off, lane);
  const enc::SmallG sm{small, N};
  if (!ASM && !r.live && r.row < N && lane == 0)
    enc::store_small_gg(sm, r.row, 0, 0, 0);  // padding
  if (!r.live) return;
  const int stride = enc::gg_smem(L, OW, kFieldsG, ASM, bank_len).stride;
  uint8_t* base = reinterpret_cast<uint8_t*>(fgg_smem_v) +
                  (size_t)warp * stride;
  const int len = lens_in[r.row];
  int32_t* col = &tile[0][warp];
  const enc::RowOut out{ASM ? nullptr : tier_out + r.row,
                        ASM ? nullptr : len_out + r.row,
                        ASM ? flat + r.dst0 : nullptr};
  const enc::RowIn in = row_in<ASM>(batch, r.row, len, L, OW, bank, bank_len,
                                    ts_text, ts_len_in);
  int32_t* carried = chan + (size_t)r.row * enc::kCarryG;
  if (ASM) {
    // the probe's selection: no decode, no special routing, no sort
    enc::encode_gg_row<kFieldsG, true, false, true>(
        enc::ChanView{col, kWarps}, carried, in, k, base, out, lane);
    return;
  }
  // K5's flat row index stages the row at the start of the warp's encode
  // region and writes the channels to the block's tile
  si::index_row<kFieldsG, true>(batch + (size_t)r.row * L, len, L, 0,
                          reinterpret_cast<uint4*>(base), sums[warp], col,
                          lane);
  __syncwarp();
  enc::encode_gg_row<kFieldsG, false, true, false>(
      enc::ChanView{col, kWarps}, nullptr, in, k, base, out, lane, carried,
      sm, r.row);
}

// dynamic shared memory a block may take beside the kernels' static
// tile and sums (< 4 KiB)
constexpr int kDynMax = 220 * 1024;

template <bool ASM>
int launch5424(const void* batch, const void* lens, const void* ts_text,
               const void* ts_len, const void* bank, const int* consts,
               int N, int n, int L, int OW, void* tier, void* base_len,
               void* small, void* chan, const void* row_off, void* flat,
               cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 4) return (int)cudaErrorInvalidValue;  // K1's row minimum
  const enc::Consts5 k = enc::const_table<enc::kNumConst>(consts);
  const int bank_len = enc::bank_bytes(k);
  auto kern = fused_rfc5424_gelf_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = enc::warp_rows_geometry(kern, N,
                                         stride5424(L, OW, ASM, bank_len),
                                         kDynMax, &grid, &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(base_len), static_cast<int32_t*>(small),
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <bool ASM>
int launch3164(const void* batch, const void* lens, int year,
               const void* ts_text, const void* ts_len, const void* bank,
               const int* consts, int N, int n, int L, int OW, void* tier,
               void* base_len, void* small, void* chan, const void* row_off,
               void* flat, cudaStream_t stream) {
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
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <bool ASM>
int launch_ltsv(const void* batch, const void* lens, const void* ts_text,
                const void* ts_len, const void* bank, const int* consts,
                int N, int n, int L, int OW, void* tier, void* base_len,
                void* small, void* chan, const void* row_off, void* flat,
                cudaStream_t stream) {
  if (N <= 0) return 0;
  const enc::ConstsL k = enc::const_table<enc::kNumConstL>(consts);
  const int bank_len = enc::bank_bytes(k);
  const int stride = enc::warp_smem(L, OW, enc::segments_ltsv(kMaxPairs),
                                    ASM, bank_len).stride;
  auto kern = fused_ltsv_gelf_kernel<ASM>;
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
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <bool ASM>
int launch_gg(const void* batch, const void* lens, const void* ts_text,
              const void* ts_len, const void* bank, const int* consts, int N,
              int n, int L, int OW, void* tier, void* base_len, void* small,
              void* chan, const void* row_off, void* flat,
              cudaStream_t stream) {
  if (N <= 0) return 0;
  const enc::ConstsG k = enc::const_table<enc::kNumConstG>(consts);
  const int bank_len = enc::bank_bytes(k);
  const int stride = enc::gg_smem(L, OW, kFieldsG, ASM, bank_len).stride;
  auto kern = fused_gelf_gelf_kernel<ASM>;
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
      static_cast<int32_t*>(chan), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 entries a row of the carried channel tensor: F1 (route 5424), F3
// (route 3164), FL (route 76, 'L') or FG (route 71, 'G')
int fg_fused_gelf_carry(int route) {
  return route == 5424 ? kCarry5 : route == 3164 ? kCarry3
         : route == 76 ? enc::kCarryL : route == 71 ? enc::kCarryG : -1;
}

// F1 probe: base tier bit (uint8) and base_len (int32) of every row, the
// int32 [5, N] ok / days / sod / off / nanos channels (zeros for the rows
// at and past n), and the carried channels of each base tier row (int32
// [N, 56])
int fg_fused_rfc5424_gelf_probe(const void* batch, const void* lens,
                                const int* consts, int N, int n, int L,
                                void* tier, void* base_len, void* small,
                                void* chan, void* stream) {
  return launch5424<false>(batch, lens, nullptr, nullptr, nullptr, consts, N,
                           n, L, 0, tier, base_len, small, chan, nullptr,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// F1 assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off], from the probe's carried channels
int fg_fused_rfc5424_gelf_assemble(const void* batch, const void* lens,
                                   const void* chan, const void* ts_text,
                                   const void* ts_len, const void* bank,
                                   const int* consts, int N, int n, int L,
                                   int OW, const void* row_off, void* flat,
                                   void* stream) {
  return launch5424<true>(batch, lens, ts_text, ts_len, bank, consts, N, n, L,
                          OW, nullptr, nullptr, nullptr,
                          const_cast<void*>(chan), row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

// F3 probe, for the year given (carried channels: int32 [N, 11])
int fg_fused_rfc3164_gelf_probe(const void* batch, const void* lens, int year,
                                const int* consts, int N, int n, int L,
                                void* tier, void* base_len, void* small,
                                void* chan, void* stream) {
  return launch3164<false>(batch, lens, year, nullptr, nullptr, nullptr,
                           consts, N, n, L, 0, tier, base_len, small, chan,
                           nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// F3 assemble, from the probe's carried channels (the year is in them)
int fg_fused_rfc3164_gelf_assemble(const void* batch, const void* lens,
                                   const void* chan, const void* ts_text,
                                   const void* ts_len, const void* bank,
                                   const int* consts, int N, int n, int L,
                                   int OW, const void* row_off, void* flat,
                                   void* stream) {
  return launch3164<true>(batch, lens, 0, ts_text, ts_len, bank, consts, N,
                          n, L, OW, nullptr, nullptr, nullptr,
                          const_cast<void*>(chan), row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

// FL probe: base tier bit (uint8) and base_len (int32) of every ltsv row,
// the narrowed stamp channels (25 N bytes, zeros for the rows at and past
// n), and the carried selection of each base tier row (int32 [N, 31])
int fg_fused_ltsv_gelf_probe(const void* batch, const void* lens,
                             const int* consts, int N, int n, int L,
                             void* tier, void* base_len, void* small,
                             void* chan, void* stream) {
  return launch_ltsv<false>(batch, lens, nullptr, nullptr, nullptr, consts, N,
                            n, L, 0, tier, base_len, small, chan, nullptr,
                            nullptr, static_cast<cudaStream_t>(stream));
}

// FL assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off], from the probe's carried selection
int fg_fused_ltsv_gelf_assemble(const void* batch, const void* lens,
                                const void* chan, const void* ts_text,
                                const void* ts_len, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch_ltsv<true>(batch, lens, ts_text, ts_len, bank, consts, N, n,
                           L, OW, nullptr, nullptr, nullptr,
                           const_cast<void*>(chan), row_off, flat,
                           static_cast<cudaStream_t>(stream));
}

// FG probe: base tier bit (uint8) and base_len (int32) of every gelf row,
// the int32 [3, N] ts_hi / ts_lo / ts_meta channels of its tier rows
// (zeros elsewhere and for the rows at and past n), and the carried
// selection of each base tier row (int32 [N, 49])
int fg_fused_gelf_gelf_probe(const void* batch, const void* lens,
                             const int* consts, int N, int n, int L,
                             void* tier, void* base_len, void* small,
                             void* chan, void* stream) {
  return launch_gg<false>(batch, lens, nullptr, nullptr, nullptr, consts, N,
                          n, L, 0, tier, base_len, small, chan, nullptr,
                          nullptr, static_cast<cudaStream_t>(stream));
}

// FG assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off], from the probe's carried selection
int fg_fused_gelf_gelf_assemble(const void* batch, const void* lens,
                                const void* chan, const void* ts_text,
                                const void* ts_len, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch_gg<true>(batch, lens, ts_text, ts_len, bank, consts, N, n, L,
                         OW, nullptr, nullptr, nullptr,
                         const_cast<void*>(chan), row_off, flat,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
