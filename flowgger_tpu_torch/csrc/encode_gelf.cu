// GELF encode of decoded rows (the split device encode tier), one warp
// per row: E1 for rfc5424 rows and, beside it, E3 for rfc3164 rows and EL
// for ltsv rows.  The row encodes themselves live in encode_gelf_row.cuh
// and encode_ltsv_row.cuh, shared with the fused routes (fused_gelf.cu);
// this file holds the kernels that read the decode kernels' [C, N]
// channels from global memory.
//
// E1, rfc5424 -> GELF.
// Replaces the JAX package's jnp device code device_gelf._encode_kernel
// (flowgger_tpu/tpu/device_gelf.py:141) with device_common's
// escape_stage (:476), sort_pairs_by_key8 (:776), assemble_rows (:520)
// and _compact_kernel (:557).  It is not the counterpart of a
// pallas_call: the reference builds the encode from whole-matrix jnp
// passes that avoid gathers (an MSB-first barrel shifter for the escape
// map, a rotate-assembly over ~48 segments in a lax.scan, an LSB-first
// group barrel for the compaction), hundreds of [N, OW] passes a batch.
//
// What it computes, per row of a packed [N, L] uint8 batch, from the
// decode kernel's packed int32 [C, N] channels (read in place; layout of
// tpu/rfc5424.py unpack_channels), the row's timestamp text and the
// constant bank:
// - probe (ASM = false), for the rows below n (the batch's real rows):
//   the base tier bit and base_len, the length of the row's GELF bytes
//   without the head, timestamp-label and tail constants (the
//   reference's elide=True) and without the timestamp text.  The base
//   bit is the reference's tier rule before its width test: ok, no byte
//   >= 0x80, no control byte but \b \t \n \f \r, at most E_CAP escapes,
//   pair_count <= P, sd_count <= max_sd, no SD value with a backslash,
//   SD names that the 8-byte key orders.  A row's length is base_len
//   plus its timestamp text's length, so the host applies the width test
//   (base_len + ts_len <= OW) itself: at TS_W for the decline rule, with
//   the real lengths for the offsets, from one probe.  A row that is not
//   in the base tier, or lies at or past n, gets bit 0 and length 0.
// - assemble (ASM = true): for each row with row_off >= 0 (the tier
//   rows the host keeps), its bytes (base_len + ts_len of them) at
//   flat[row_off], so the host fetches exactly the tier rows' bytes.
//
// Batch contract: a row's bytes at and past its length are zero (both
// producers of a batch write them so: tpu/pack.py _finish and the gather
// kernel, frame_gather.cu).  So the kernel loads only a row's valid
// bytes, and a name-key byte at or past the length reads as 0 without a
// load, as the plain version's gather of that byte gives.
//
// Bound on the H100: bytes (each real row's valid bytes, the channels it
// reads, its timestamp text and its output; a few integer operations a
// byte).  What keeps a row from it is its chain of dependent steps: the
// escape scan, then the pair keys and the sort, then the segments.
// Design:
// - One warp per row, up to eight rows a block.  A warp past n, or (in
//   the probe) whose row the channels alone put outside the tier, writes
//   its zeros and leaves before it loads the row.
// - The row's valid bytes, rounded up to 16, are staged in shared memory
//   with one 16-byte load a lane (a byte path where L is not a multiple
//   of 16); the lane classifies its 16 bytes in registers, a warp scan
//   of their escape counts gives each 16-byte chunk its escapes before
//   it, and (escapes before, escape mask) goes to a shared word a chunk,
//   so the escaped offset of any raw offset is one load and a popcount.
//   The assemble writes the escaped row to shared memory in the same
//   pass, and copies the constant bank and the row's timestamp text
//   beside it, so every output byte has its source in one buffer.
// - The pair table is held across lanes: lane p holds pair p (its key
//   words hi, lo and name length, its four escaped offsets) and loads its
//   channels only if p < pair_count.  A bitonic network over 8 lanes (6
//   pairs and two absent) or 16 sorts (key, index) with __shfl_xor_sync;
//   the spans follow by index.  The index breaks ties, so any two lanes
//   agree on every exchange; fully tied keys are ambiguous and leave the
//   tier, so the order among them never reaches an output.
// - The row's segments are one table: lane p < P the five of pair p,
//   lane f < 16 fixed segment f (the timestamp text last).  The probe
//   sums their lengths with one warp reduction.  The assemble scans them
//   into destination offsets, writes (end, source) a segment to shared
//   memory, stages the output row there (each lane its bytes 32 apart, a
//   segment cursor each, one shared load a byte), and stores it with
//   aligned 16-byte stores, byte stores only at its unaligned head and
//   tail.
//
// TPU workarounds not carried over: the barrel shifters, the rotate
// assembly, the [N, OW] output matrix and the group compaction.
//
// E3, rfc3164 -> GELF.  Replaces the JAX package's jnp device code
// device_rfc3164._encode_kernel (flowgger_tpu/tpu/device_rfc3164.py:100)
// with device_common's escape_stage (:476) and assemble_rows (:520): the
// same probe and assemble contract as E1 over the rfc3164 decode's
// channels (tpu/rfc3164.py KEYS).  A row has no pairs: ten fixed
// segments, one a lane (the whole line as full_message, the host span,
// the level pair gated on has_pri and the short_message constant picked
// by it, the message span to the row's end, the timestamp text), with
// the 3164 constant bank (device_rfc3164.KERNEL_CONSTS).  It reuses E1's
// escape pass and staged 16-byte assemble; its tier rule is ok, no byte
// >= 0x80, no control byte but \b \t \n \f \r, at most E_CAP escapes.
//
// EL, ltsv -> GELF, at 6 and 16 pairs.  Replaces the JAX package's jnp
// device code device_ltsv._encode_kernel (flowgger_tpu/tpu/device_ltsv.py
// :127) with device_common's escape_stage, sort_pairs_by_key8 and
// assemble_rows: the probe and assemble contract of E1 over the ltsv
// decode's channels (L1's [94, N], tpu/ltsv.py KEYS_1D and KEYS_PART).
// The pairs are the parts whose start is none of the four special keys'
// (last-occurrence) positions: lane j < 24 tests part j, a ballot gives
// the pair mask, and lane p loads pair p's spans from part
// nth_set_bit(mask, p); E1's key sort and ambiguity test order them.  The
// reference's repeated-special screen is lane j matching the four keys at
// part j's start (a popcount of the ballot > 1 leaves the tier).  Thirteen
// fixed segments, one a lane (the line as full_message, host or
// "unknown", the level pair gated on a level, the short_message constant
// picked by it, the quoted message or "-", the timestamp text), with the
// ltsv bank (device_ltsv.KERNEL_CONSTS).  Its tier rule, beside E1's
// escape rules: ok, an RFC3339 stamp or an unsigned unix float of at most
// 16 digits within 2**53, no colon-less part, at most P pairs, no
// repeated special name, names the 8-byte key orders.  A row that fails
// the rules its channels alone decide leaves before its bytes are loaded.
//
// EG, gelf -> GELF, at 8 and 16 fields.  Replaces the JAX package's jnp
// device code device_gelf_gelf._encode_kernel (flowgger_tpu/tpu/
// device_gelf_gelf.py:99) with device_common's sort_pairs_by_key8 (fed
// the fields in raw order, slot_valid) and assemble_rows: the probe and
// assemble contract of E1 over K5's flat-mode channels (ok, n_fields,
// then seven [F] field channels, tpu/jsonidx.py KEYS_F).  The tier is
// escape-free: the raw row is the source of every span, so there is no
// escape pass, and a row with a control byte, a byte >= 0x80 or an
// escaped key or string value leaves it.  Lane f holds field f: its
// special id, the quoted name ("timestamp" with both quotes, so the
// closing quote pins the length) matched at the key's opening quote; its
// point bytes (the key's first byte, the value's bytes 0, 1, 2 and last)
// and span counts (dots, non-digits, fraction characters: popcounts over
// three class-mask words a 32-position word, built once a row with
// ballots, then folded three fields a word, ten bits each, as the
// reference's packed sums give them back); the canonical-number screens
// of the host tier.  A ballot a special id gives its (last) field and its
// repeats; its values reach every lane by shuffle.  The pair fields'
// keys (the final name: a leading '_' stripped) sort across lanes with
// E1's bitonic network, the other fields keyed last.  The timestamp
// (at most 24 bytes on the tier) is parsed exactly as split integers,
// lane r its byte r: ts_hi and ts_lo nine digits each by warp sums,
// ts_meta the fraction digits, the digit count and the sign in bit 16;
// the probe writes them for its tier rows (int32 [3, N], zeros
// elsewhere) and the host combines them in float64
// (device_gelf_gelf.ts_vals_gelf).  Segments: five a pair (the seven of
// the reference folded: '"' or '"_', the name, '":"' or '":', the value
// span or true / false / null, '",' or ','), thirteen fixed (full_message
// gated on its presence, host or "unknown", the level digit gated on
// its presence, short_message or "-", the timestamp text), with the
// gelf bank (device_gelf_gelf.KERNEL_CONSTS).  A row the channels alone
// put outside the tier (not ok, an escaped key) leaves before its bytes
// are loaded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_gelf_gelf_row.cuh"
#include "encode_gelf_row.cuh"
#include "encode_ltsv_row.cuh"

namespace {

using namespace enc;

// blocks a multiprocessor keeps resident: caps registers at 48 a thread
// (without the cap nvcc gave the probe 52 and spilled in the 6-pair
// assemble; a cap of 6 blocks spilled too)
constexpr int kMinBlocks = 5;

// The per-row arguments of the split tier's kernels: the row in the
// batch, its channels in the decode's [C, N] output, its outputs.
struct SplitRow {
  int row;
  bool live;                             // a real row the phase works on
  RowIn in;
  RowOut out;
};

template <bool ASM>
__device__ __forceinline__ SplitRow split_row(
    const uint8_t* batch, const int32_t* lens_in, const uint8_t* ts_text,
    const int32_t* ts_len_in, const uint8_t* bank, int bank_len, int N,
    int n, int L, int OW, uint8_t* tier_out, int32_t* len_out,
    const int64_t* row_off, uint8_t* flat, int lane) {
  SplitRow r;
  r.row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  r.live = false;
  if (r.row >= N) return r;              // whole warps leave together
  if (r.row >= n) {                      // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[r.row] = 0;
      len_out[r.row] = 0;
    }
    return r;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[r.row];
    if (dst0 < 0) return r;              // not a kept tier row
  }
  r.live = true;
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0;
  r.in = RowIn{batch + (size_t)r.row * L, vec, lens_in[r.row], L, OW,
               bank, bank_len,
               ASM ? ts_text + (size_t)r.row * kTsW : nullptr,
               ASM ? ts_len_in[r.row] : 0};
  r.out = RowOut{ASM ? nullptr : tier_out + r.row,
                 ASM ? nullptr : len_out + r.row,
                 ASM ? flat + dst0 : nullptr};
  return r;
}

template <int P, bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_gelf_kernel(const uint8_t* __restrict__ batch,
                   const int32_t* __restrict__ lens_in,
                   const int32_t* __restrict__ ch,
                   const uint8_t* __restrict__ ts_text,
                   const int32_t* __restrict__ ts_len_in,
                   const uint8_t* __restrict__ bank, int bank_len,
                   Consts5 k, int N, int n, int L, int max_sd, int OW,
                   uint8_t* __restrict__ tier_out,
                   int32_t* __restrict__ len_out,
                   const int64_t* __restrict__ row_off,
                   uint8_t* __restrict__ flat) {
  extern __shared__ uint4 enc_smem_v[];
  uint8_t* enc_smem = reinterpret_cast<uint8_t*>(enc_smem_v);
  const int lane = threadIdx.x & 31;
  const SplitRow r = split_row<ASM>(batch, lens_in, ts_text, ts_len_in, bank,
                                    bank_len, N, n, L, OW, tier_out, len_out,
                                    row_off, flat, lane);
  if (!r.live) return;
  const int stride =
      warp_smem(L, OW, segments5424(P), ASM, bank_len).stride;
  encode5424_row<P, ASM>(ChanView{ch + r.row, N}, r.in, k, max_sd,
                         enc_smem + (size_t)(threadIdx.x >> 5) * stride,
                         r.out, lane);
}

template <bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_gelf3164_kernel(const uint8_t* __restrict__ batch,
                       const int32_t* __restrict__ lens_in,
                       const int32_t* __restrict__ ch,
                       const uint8_t* __restrict__ ts_text,
                       const int32_t* __restrict__ ts_len_in,
                       const uint8_t* __restrict__ bank, int bank_len,
                       Consts3 k, int N, int n, int L, int OW,
                       uint8_t* __restrict__ tier_out,
                       int32_t* __restrict__ len_out,
                       const int64_t* __restrict__ row_off,
                       uint8_t* __restrict__ flat) {
  extern __shared__ uint4 enc3_smem_v[];
  uint8_t* enc_smem = reinterpret_cast<uint8_t*>(enc3_smem_v);
  const int lane = threadIdx.x & 31;
  const SplitRow r = split_row<ASM>(batch, lens_in, ts_text, ts_len_in, bank,
                                    bank_len, N, n, L, OW, tier_out, len_out,
                                    row_off, flat, lane);
  if (!r.live) return;
  const int stride = warp_smem(L, OW, kFixed3, ASM, bank_len).stride;
  encode3164_row<ASM>(ChanView{ch + r.row, N}, r.in, k,
                      enc_smem + (size_t)(threadIdx.x >> 5) * stride, r.out,
                      lane);
}

template <int P, bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_gelf_ltsv_kernel(const uint8_t* __restrict__ batch,
                        const int32_t* __restrict__ lens_in,
                        const int32_t* __restrict__ ch,
                        const uint8_t* __restrict__ ts_text,
                        const int32_t* __restrict__ ts_len_in,
                        const uint8_t* __restrict__ bank, int bank_len,
                        ConstsL k, int N, int n, int L, int OW,
                        uint8_t* __restrict__ tier_out,
                        int32_t* __restrict__ len_out,
                        uint8_t* __restrict__ small,
                        const int64_t* __restrict__ row_off,
                        uint8_t* __restrict__ flat) {
  extern __shared__ uint4 encl_smem_v[];
  uint8_t* enc_smem = reinterpret_cast<uint8_t*>(encl_smem_v);
  const int lane = threadIdx.x & 31;
  const SplitRow r = split_row<ASM>(batch, lens_in, ts_text, ts_len_in, bank,
                                    bank_len, N, n, L, OW, tier_out, len_out,
                                    row_off, flat, lane);
  const SmallL sm{small, N};
  if (!ASM && !r.live && r.row < N && lane == 0)
    store_small_ltsv(sm, r.row, 0, 0, 0, 0, 0, 0, 0, 0, 0);  // padding
  if (!r.live) return;
  const int stride = warp_smem(L, OW, segments_ltsv(P), ASM, bank_len).stride;
  encode_ltsv_row<P, ASM>(ChanView{ch + r.row, N}, nullptr, r.in, k,
                          enc_smem + (size_t)(threadIdx.x >> 5) * stride,
                          r.out, lane, nullptr, sm, r.row);
}

template <int F, bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_gelf_gelf_kernel(const uint8_t* __restrict__ batch,
                        const int32_t* __restrict__ lens_in,
                        const int32_t* __restrict__ ch,
                        const uint8_t* __restrict__ ts_text,
                        const int32_t* __restrict__ ts_len_in,
                        const uint8_t* __restrict__ bank, int bank_len,
                        ConstsG k, int N, int n, int L, int OW,
                        uint8_t* __restrict__ tier_out,
                        int32_t* __restrict__ len_out,
                        int32_t* __restrict__ small,
                        const int64_t* __restrict__ row_off,
                        uint8_t* __restrict__ flat) {
  extern __shared__ uint4 encg_smem_v[];
  uint8_t* enc_smem = reinterpret_cast<uint8_t*>(encg_smem_v);
  const int lane = threadIdx.x & 31;
  const SplitRow r = split_row<ASM>(batch, lens_in, ts_text, ts_len_in, bank,
                                    bank_len, N, n, L, OW, tier_out, len_out,
                                    row_off, flat, lane);
  const SmallG sm{small, N};
  if (!ASM && !r.live && r.row < N && lane == 0)
    store_small_gg(sm, r.row, 0, 0, 0);  // padding
  if (!r.live) return;
  const int stride = gg_smem(L, OW, F, ASM, bank_len).stride;
  encode_gg_row<F, ASM>(ChanView{ch + r.row, N}, nullptr, r.in, k,
                        enc_smem + (size_t)(threadIdx.x >> 5) * stride,
                        r.out, lane, nullptr, sm, r.row);
}

template <int P, bool ASM>
int launch(const void* batch, const void* lens, const void* ch,
           const void* ts_text, const void* ts_len, const void* bank,
           const int* consts, int N, int n, int L, int max_sd, int OW,
           void* tier, void* out_len, const void* row_off, void* flat,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  const Consts5 k = const_table<kNumConst>(consts);
  const int bank_len = bank_bytes(k);
  const int stride = warp_smem(L, OW, segments5424(P), ASM, bank_len).stride;
  auto kern = encode_gelf_kernel<P, ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = warp_rows_geometry(kern, N, stride, kSmemMax, &grid,
                                    &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, max_sd, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <bool ASM>
int launch3164(const void* batch, const void* lens, const void* ch,
               const void* ts_text, const void* ts_len, const void* bank,
               const int* consts, int N, int n, int L, int OW, void* tier,
               void* out_len, const void* row_off, void* flat,
               cudaStream_t stream) {
  if (N <= 0) return 0;
  const Consts3 k = const_table<kNumConst3>(consts);
  const int bank_len = bank_bytes(k);
  const int stride = warp_smem(L, OW, kFixed3, ASM, bank_len).stride;
  auto kern = encode_gelf3164_kernel<ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = warp_rows_geometry(kern, N, stride, kSmemMax, &grid,
                                    &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <int P, bool ASM>
int launch_ltsv(const void* batch, const void* lens, const void* ch,
                const void* ts_text, const void* ts_len, const void* bank,
                const int* consts, int N, int n, int L, int OW, void* tier,
                void* out_len, void* small, const void* row_off, void* flat,
                cudaStream_t stream) {
  if (N <= 0) return 0;
  const ConstsL k = const_table<kNumConstL>(consts);
  const int bank_len = bank_bytes(k);
  const int stride = warp_smem(L, OW, segments_ltsv(P), ASM, bank_len).stride;
  auto kern = encode_gelf_ltsv_kernel<P, ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = warp_rows_geometry(kern, N, stride, kSmemMax, &grid,
                                    &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<uint8_t*>(small),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

template <int F, bool ASM>
int launch_gg(const void* batch, const void* lens, const void* ch,
              const void* ts_text, const void* ts_len, const void* bank,
              const int* consts, int N, int n, int L, int OW, void* tier,
              void* out_len, void* small, const void* row_off, void* flat,
              cudaStream_t stream) {
  if (N <= 0) return 0;
  const ConstsG k = const_table<kNumConstG>(consts);
  const int bank_len = bank_bytes(k);
  const int stride = gg_smem(L, OW, F, ASM, bank_len).stride;
  auto kern = encode_gelf_gelf_kernel<F, ASM>;
  int grid = 0, threads = 0;
  size_t smem = 0;
  const int rc = warp_rows_geometry(kern, N, stride, kSmemMax, &grid,
                                    &threads, &smem);
  if (rc != 0) return rc;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<int32_t*>(small),
      static_cast<const int64_t*>(row_off), static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// probe: base tier bit (uint8 0/1) and base_len (int32) of every row, 0
// and 0 for the rows at and past n
int fg_encode_gelf_probe_p6(const void* batch, const void* lens,
                            const void* ch, const int* consts, int N, int n,
                            int L, int max_sd, void* tier, void* base_len,
                            void* stream) {
  return launch<6, false>(batch, lens, ch, nullptr, nullptr, nullptr, consts,
                          N, n, L, max_sd, 0, tier, base_len, nullptr,
                          nullptr, static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_probe_p16(const void* batch, const void* lens,
                             const void* ch, const int* consts, int N, int n,
                             int L, int max_sd, void* tier, void* base_len,
                             void* stream) {
  return launch<16, false>(batch, lens, ch, nullptr, nullptr, nullptr,
                           consts, N, n, L, max_sd, 0, tier, base_len,
                           nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off]
int fg_encode_gelf_assemble_p6(const void* batch, const void* lens,
                               const void* ch, const void* ts_text,
                               const void* ts_len, const void* bank,
                               const int* consts, int N, int n, int L,
                               int OW, const void* row_off, void* flat,
                               void* stream) {
  return launch<6, true>(batch, lens, ch, ts_text, ts_len, bank, consts, N,
                         n, L, kMaxSd, OW, nullptr, nullptr, row_off, flat,
                         static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_assemble_p16(const void* batch, const void* lens,
                                const void* ch, const void* ts_text,
                                const void* ts_len, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch<16, true>(batch, lens, ch, ts_text, ts_len, bank, consts, N,
                          n, L, kMaxSd, OW, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

// E3 probe: base tier bit and base_len of every rfc3164 row, 0 and 0 for
// the rows at and past n
int fg_encode_gelf3164_probe(const void* batch, const void* lens,
                             const void* ch, const int* consts, int N, int n,
                             int L, void* tier, void* base_len,
                             void* stream) {
  return launch3164<false>(batch, lens, ch, nullptr, nullptr, nullptr,
                           consts, N, n, L, 0, tier, base_len, nullptr,
                           nullptr, static_cast<cudaStream_t>(stream));
}

// E3 assemble: the elided bytes of each row below n with row_off >= 0 at
// flat[row_off]
int fg_encode_gelf3164_assemble(const void* batch, const void* lens,
                                const void* ch, const void* ts_text,
                                const void* ts_len, const void* bank,
                                const int* consts, int N, int n, int L,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch3164<true>(batch, lens, ch, ts_text, ts_len, bank, consts, N,
                          n, L, OW, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

// EL probe at 6 and 16 pairs: base tier bit and base_len of every ltsv
// row from L1's [94, N] channels, 0 and 0 for the rows at and past n, and
// the narrowed stamp channels (25 N bytes, zeros past n)
int fg_encode_gelf_ltsv_probe_p6(const void* batch, const void* lens,
                                 const void* ch, const int* consts, int N,
                                 int n, int L, void* tier, void* base_len,
                                 void* small, void* stream) {
  return launch_ltsv<6, false>(batch, lens, ch, nullptr, nullptr, nullptr,
                               consts, N, n, L, 0, tier, base_len, small,
                               nullptr, nullptr,
                               static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_ltsv_probe_p16(const void* batch, const void* lens,
                                  const void* ch, const int* consts, int N,
                                  int n, int L, void* tier, void* base_len,
                                  void* small, void* stream) {
  return launch_ltsv<16, false>(batch, lens, ch, nullptr, nullptr, nullptr,
                                consts, N, n, L, 0, tier, base_len, small,
                                nullptr, nullptr,
                                static_cast<cudaStream_t>(stream));
}

// EL assemble at 6 and 16 pairs: the elided bytes of each row below n
// with row_off >= 0 at flat[row_off]
int fg_encode_gelf_ltsv_assemble_p6(const void* batch, const void* lens,
                                    const void* ch, const void* ts_text,
                                    const void* ts_len, const void* bank,
                                    const int* consts, int N, int n, int L,
                                    int OW, const void* row_off, void* flat,
                                    void* stream) {
  return launch_ltsv<6, true>(batch, lens, ch, ts_text, ts_len, bank, consts,
                              N, n, L, OW, nullptr, nullptr, nullptr, row_off,
                              flat, static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_ltsv_assemble_p16(const void* batch, const void* lens,
                                     const void* ch, const void* ts_text,
                                     const void* ts_len, const void* bank,
                                     const int* consts, int N, int n, int L,
                                     int OW, const void* row_off, void* flat,
                                     void* stream) {
  return launch_ltsv<16, true>(batch, lens, ch, ts_text, ts_len, bank,
                               consts, N, n, L, OW, nullptr, nullptr, nullptr,
                               row_off, flat,
                               static_cast<cudaStream_t>(stream));
}

// EG probe at 8 and 16 fields: base tier bit and base_len of every gelf
// row from K5's flat-mode [2 + 7F, N] channels, 0 and 0 for the rows at
// and past n, and the ts_hi / ts_lo / ts_meta channels of the tier rows
// (int32 [3, N], zeros elsewhere)
int fg_encode_gelf_gelf_probe_f8(const void* batch, const void* lens,
                                 const void* ch, const int* consts, int N,
                                 int n, int L, void* tier, void* base_len,
                                 void* small, void* stream) {
  return launch_gg<8, false>(batch, lens, ch, nullptr, nullptr, nullptr,
                             consts, N, n, L, 0, tier, base_len, small,
                             nullptr, nullptr,
                             static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_gelf_probe_f16(const void* batch, const void* lens,
                                  const void* ch, const int* consts, int N,
                                  int n, int L, void* tier, void* base_len,
                                  void* small, void* stream) {
  return launch_gg<16, false>(batch, lens, ch, nullptr, nullptr, nullptr,
                              consts, N, n, L, 0, tier, base_len, small,
                              nullptr, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// EG assemble at 8 and 16 fields: the elided bytes of each row below n
// with row_off >= 0 at flat[row_off]
int fg_encode_gelf_gelf_assemble_f8(const void* batch, const void* lens,
                                    const void* ch, const void* ts_text,
                                    const void* ts_len, const void* bank,
                                    const int* consts, int N, int n, int L,
                                    int OW, const void* row_off, void* flat,
                                    void* stream) {
  return launch_gg<8, true>(batch, lens, ch, ts_text, ts_len, bank, consts,
                            N, n, L, OW, nullptr, nullptr, nullptr, row_off,
                            flat, static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_gelf_assemble_f16(const void* batch, const void* lens,
                                     const void* ch, const void* ts_text,
                                     const void* ts_len, const void* bank,
                                     const int* consts, int N, int n, int L,
                                     int OW, const void* row_off, void* flat,
                                     void* stream) {
  return launch_gg<16, true>(batch, lens, ch, ts_text, ts_len, bank, consts,
                             N, n, L, OW, nullptr, nullptr, nullptr, row_off,
                             flat, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
