// RFC5424 -> GELF encode of decoded rows (the device encode tier), one
// warp per row.
//
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
// - probe (ASM = false): the tier bit and out_len, the length of the
//   row's GELF bytes without the head, timestamp-label and tail
//   constants (the reference's elide=True), with the reference's tier
//   rule: ok, no byte >= 0x80, no control byte but \b \t \n \f \r, at
//   most E_CAP escapes, pair_count <= P, sd_count <= max_sd, no SD value
//   with a backslash, SD names that the 8-byte key orders, and
//   out_len <= OW;
// - assemble (ASM = true): for each row with row_off >= 0 (the tier
//   rows the host keeps), those bytes at flat[row_off], so the host
//   fetches exactly the tier rows' bytes.  The offsets are an exclusive
//   scan of the gated lengths, taken between the two launches.
//
// Bound on the H100: bytes (each row's valid bytes, the channels it
// reads, its timestamp text and its output; a few integer operations a
// byte).  What keeps a row from it is its chain of dependent steps: the
// escape scan, then the pair keys and the sort, then the segment walk.
// Design:
// - One warp per row, eight rows a block, as the decode kernel.  The
//   warp stages its row in shared memory; the escape scan steps over 32
//   positions at a time with a ballot, and each position's escape count
//   (an exclusive prefix: the carry plus the popcount of the ballot
//   below the lane) goes to a shared table, so the escaped offset of any
//   raw offset is one load.  In assemble mode the same pass writes the
//   escaped row to shared memory, and every span segment is a copy.
// - Per-row values (channels, keys, the sort, the segment table) are
//   computed by every lane alike: the channel loads are broadcasts, the
//   pair table lives in registers, and the sorting network (the
//   reference's 12 comparators at 6 pairs, Batcher's 63 at 16) is
//   unrolled with constant indices.  No lane diverges on them, so the
//   warp stays converged for its ballots.
// - Segments are walked once: the probe adds their lengths, the assemble
//   copies each one lane-parallel to its destination.
//
// TPU workarounds not carried over: the barrel shifters, the rotate
// assembly, the [N, OW] output matrix and the group compaction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // rows per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSd = 4;                // SD width of the decode channels
constexpr int kECap = 56;                // E_CAP: escapes a tier row may hold
constexpr int kTsW = 32;                 // TS_W: timestamp text slot width
constexpr int kAmbigLen = 8;
constexpr int kBig = 0x7FFFFFFF;         // sort key of an absent pair
constexpr int kN1D = 23;

// channel rows of the packed decode output (order of _KEYS_1D)
enum Ch {
  C_OK = 0, C_SEVERITY = 3, C_HOST_S = 8, C_HOST_E = 9, C_APP_S = 10,
  C_APP_E = 11, C_PROC_S = 12, C_PROC_E = 13, C_SD_COUNT = 17,
  C_PAIR_COUNT = 18, C_FULL_START = 19, C_TRIM_END = 20,
  C_MSG_TRIM_START = 21, C_HAS_HIGH = 22
};

// the bank constants a row reads (device_gelf.KERNEL_CONSTS)
enum Const {
  K_P0, K_P1, K_P2, K_APP, K_FULL, K_HOST, K_LEVEL, K_PROC, K_P6X, K_SDID,
  K_SHORT, K_UNKNOWN, K_DASH, K_SEVD, kNumConst
};

struct Consts {
  int off[kNumConst];
  int len[kNumConst];
};

struct Pair {
  int hi, lo, nl, ns, ne, vs, ve;
};

__device__ __forceinline__ void cmp_swap(Pair& a, Pair& b) {
  const bool swap = b.hi < a.hi ||
                    (b.hi == a.hi && (b.lo < a.lo ||
                                      (b.lo == a.lo && b.nl < a.nl)));
  if (swap) {
    const Pair t = a;
    a = b;
    b = t;
  }
}

#define CS(i, j) cmp_swap(p[i], p[j])

// device_common._sort_network(6)
__device__ __forceinline__ void sort_net6(Pair* p) {
  CS(0, 5); CS(1, 3); CS(2, 4); CS(1, 2); CS(3, 4); CS(0, 3); CS(2, 5);
  CS(0, 1); CS(2, 3); CS(4, 5); CS(1, 2); CS(3, 4);
}

// device_common._sort_network(16)
__device__ __forceinline__ void sort_net16(Pair* p) {
  CS(0, 1); CS(2, 3); CS(4, 5); CS(6, 7); CS(8, 9); CS(10, 11);
  CS(12, 13); CS(14, 15); CS(0, 2); CS(1, 3); CS(4, 6); CS(5, 7);
  CS(8, 10); CS(9, 11); CS(12, 14); CS(13, 15); CS(1, 2); CS(5, 6);
  CS(9, 10); CS(13, 14); CS(0, 4); CS(1, 5); CS(2, 6); CS(3, 7);
  CS(8, 12); CS(9, 13); CS(10, 14); CS(11, 15); CS(2, 4); CS(3, 5);
  CS(10, 12); CS(11, 13); CS(1, 2); CS(3, 4); CS(5, 6); CS(9, 10);
  CS(11, 12); CS(13, 14); CS(0, 8); CS(1, 9); CS(2, 10); CS(3, 11);
  CS(4, 12); CS(5, 13); CS(6, 14); CS(7, 15); CS(4, 8); CS(5, 9);
  CS(6, 10); CS(7, 11); CS(2, 4); CS(3, 5); CS(6, 8); CS(7, 9);
  CS(10, 12); CS(11, 13); CS(1, 2); CS(3, 4); CS(5, 6); CS(7, 8);
  CS(9, 10); CS(11, 12); CS(13, 14);
}

#undef CS

__device__ __forceinline__ int escape_letter(int b) {
  return b == 8 ? 'b' : b == 9 ? 't' : b == 10 ? 'n' : b == 12 ? 'f'
         : b == 13 ? 'r' : b;
}

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

template <int P, bool ASM>
__global__ void __launch_bounds__(kThreads)
encode_gelf_kernel(const uint8_t* __restrict__ batch,
                   const int32_t* __restrict__ lens_in,
                   const int32_t* __restrict__ ch,
                   const uint8_t* __restrict__ ts_text,
                   const int32_t* __restrict__ ts_len_in,
                   const uint8_t* __restrict__ bank, Consts k, int N, int L,
                   int max_sd, int OW, int stride,
                   uint8_t* __restrict__ tier_out,
                   int32_t* __restrict__ len_out,
                   const int64_t* __restrict__ row_off,
                   uint8_t* __restrict__ flat) {
  extern __shared__ uint8_t enc_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= N) return;                  // whole warps leave together
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;                // not a kept tier row
  }
  const int EW = L + kECap;
  uint8_t* rowb = enc_smem + (size_t)warp * stride;
  uint16_t* ecnt = reinterpret_cast<uint16_t*>(rowb + round16(L));
  uint8_t* escb = rowb + round16(L) + round16(2 * (L + 1));

  const uint8_t* src = batch + (size_t)row * L;
  for (int j = lane; j < L; j += 32) rowb[j] = src[j];
  __syncwarp();

  // ---- escape scan: per-position escape counts, the escaped row --------
  const int len = lens_in[row];
  const int vlen = len < 0 ? 0 : (len > L ? L : len);
  int carry = 0;
  bool bad_any = false;
  for (int base = 0; base < vlen; base += 32) {
    const int j = base + lane;
    const int b = j < vlen ? rowb[j] : 0;
    const bool two = b == 8 || b == 9 || b == 10 || b == 12 || b == 13;
    const bool esc = j < vlen && (b == 34 || b == 92 || two);
    const bool bad = j < vlen && b < 32 && !two;
    const unsigned m = __ballot_sync(kFull, esc);
    const int before = carry + __popc(m & ((1u << lane) - 1u));
    if (j < vlen) {
      ecnt[j] = static_cast<uint16_t>(before);
      if (ASM) {
        const int d = j + before;
        if (esc) {
          if (d < EW) escb[d] = '\\';
          if (d + 1 < EW) escb[d + 1] = static_cast<uint8_t>(escape_letter(b));
        } else if (d < EW) {
          escb[d] = static_cast<uint8_t>(b);
        }
      }
    }
    bad_any |= __ballot_sync(kFull, bad) != 0;
    carry += __popc(m);
  }
  const int ne_total = carry;
  for (int j = vlen + lane; j <= L; j += 32)
    ecnt[j] = static_cast<uint16_t>(ne_total);
  if (ASM)
    for (int j = vlen + ne_total + lane; j < EW; j += 32) escb[j] = 0;
  __syncwarp();

  auto C = [&](int c) { return ch[(size_t)c * N + row]; };
  // escaped offset of raw offset a: a plus the escapes before it
  auto dmap = [&](int a) {
    const int c = a < 0 ? 0 : (a > L ? L : a);
    return a + static_cast<int>(ecnt[c]);
  };

  // ---- SD pairs: 8-byte name keys, escaped spans, sorting network ------
  const int pb = kN1D + 2 * kMaxSd;      // first pair channel
  const int pc = C(C_PAIR_COUNT);
  Pair pr[P];
  bool val_esc_any = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ns_r = C(pb + p), ne_r = C(pb + P + p);
    const bool pv = p < pc;
    val_esc_any |= pv && C(pb + 5 * P + p) != 0;
    unsigned hi = 0, lo = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int pos = ns_r + q;
      const unsigned z =
          (pos >= 0 && pos < L && pos < ne_r) ? rowb[pos] : 0u;
      if (q < 4)
        hi |= z << (24 - 8 * q);
      else
        lo |= z << (56 - 8 * q);
    }
    pr[p].hi = pv ? static_cast<int>(hi) : kBig;
    pr[p].lo = pv ? static_cast<int>(lo) : kBig;
    pr[p].nl = pv ? ne_r - ns_r : kBig;
    pr[p].ns = dmap(ns_r);
    pr[p].ne = dmap(ne_r);
    pr[p].vs = dmap(C(pb + 2 * P + p));
    pr[p].ve = dmap(C(pb + 3 * P + p));
  }
  if constexpr (P == 6) {
    sort_net6(pr);
  } else {
    static_assert(P == 16, "encode_gelf is instantiated at 6 and 16 pairs");
    sort_net16(pr);
  }
  bool ambig = false;
#pragma unroll
  for (int p = 0; p + 1 < P; ++p) {
    const bool keq = pr[p].hi == pr[p + 1].hi && pr[p].lo == pr[p + 1].lo &&
                     pr[p].hi != kBig;
    const int la = pr[p].nl, lb = pr[p + 1].nl;
    ambig |= keq && (la == lb || (la > kAmbigLen && lb > kAmbigLen));
  }

  // ---- fixed fields ----------------------------------------------------
  const int sdc = C(C_SD_COUNT);
  const bool nsd = sdc > 0;
  int sid_s = 0, sid_e = 0;
#pragma unroll
  for (int s = 0; s < kMaxSd; ++s)
    if (sdc - 1 == s) {
      sid_s = C(kN1D + s);
      sid_e = C(kN1D + kMaxSd + s);
    }
  sid_s = dmap(sid_s);
  sid_e = dmap(sid_e);
  const int app_s = dmap(C(C_APP_S)), app_e = dmap(C(C_APP_E));
  const int proc_s = dmap(C(C_PROC_S)), proc_e = dmap(C(C_PROC_E));
  const int host_s = dmap(C(C_HOST_S)), host_e = dmap(C(C_HOST_E));
  const int full_s = dmap(C(C_FULL_START));
  const int trim_e = dmap(C(C_TRIM_END));
  const int msg_s = dmap(C(C_MSG_TRIM_START));
  const int sev = C(C_SEVERITY);
  const int tsl = ts_len_in[row];
  const uint8_t* tsrow = ASM ? ts_text + (size_t)row * kTsW : nullptr;

  // ---- segment walk: lengths (probe) or bytes at their offsets --------
  int out = 0;
  // kind 0: escaped row, 1: constant bank, 2: timestamp text
  auto emit = [&](int kind, int from, int n) {
    if (ASM && n > 0) {
      const uint8_t* s = kind == 0 ? escb + from
                         : kind == 1 ? bank + from : tsrow + from;
      uint8_t* d = flat + dst0 + out;
      for (int i = lane; i < n; i += 32) d[i] = s[i];
    }
    out += n;
  };
  auto cst = [&](int id, bool gate) {
    emit(1, k.off[id], gate ? k.len[id] : 0);
  };
  auto span = [&](int s, int e, bool gate) {
    emit(0, s, gate && e > s ? e - s : 0);
  };
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool pv = p < pc;
    cst(K_P0, pv);
    span(pr[p].ns, pr[p].ne, pv);
    cst(K_P1, pv);
    span(pr[p].vs, pr[p].ve, pv);
    cst(K_P2, pv);
  }
  cst(K_APP, true);
  span(app_s, app_e, true);
  cst(K_FULL, true);
  span(full_s, trim_e, true);
  cst(K_HOST, true);
  if (host_e <= host_s)
    cst(K_UNKNOWN, true);
  else
    emit(0, host_s, host_e - host_s);
  cst(K_LEVEL, true);
  emit(1, k.off[K_SEVD] + sev, 1);
  cst(K_PROC, true);
  span(proc_s, proc_e, true);
  cst(K_P6X, true);
  cst(K_SDID, nsd);
  span(sid_s, sid_e, nsd);
  cst(K_SHORT, true);
  if (trim_e <= msg_s)
    cst(K_DASH, true);
  else
    emit(0, msg_s, trim_e - msg_s);
  emit(2, 0, tsl);

  if (!ASM && lane == 0) {
    const bool tier = C(C_OK) != 0 && C(C_HAS_HIGH) == 0 && !bad_any &&
                      ne_total <= kECap && pc <= P && sdc <= max_sd &&
                      !val_esc_any && !ambig && out <= OW;
    tier_out[row] = tier ? 1 : 0;
    len_out[row] = out;
  }
}

// shared memory a warp stages: the row, its escape counts (uint16, L + 1)
// and its escaped row (L + E_CAP), each padded to 16 bytes
inline int warp_stride(int L) {
  auto r16 = [](int v) { return (v + 15) & ~15; };
  return r16(L) + r16(2 * (L + 1)) + r16(L + kECap);
}

template <int P, bool ASM>
int launch(const void* batch, const void* lens, const void* ch,
           const void* ts_text, const void* ts_len, const void* bank,
           const int* consts, int N, int L, int max_sd, int OW, void* tier,
           void* out_len, const void* row_off, void* flat,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  Consts k;
  for (int i = 0; i < kNumConst; ++i) {
    k.off[i] = consts[i];
    k.len[i] = consts[kNumConst + i];
  }
  const int stride = warp_stride(L);
  const size_t smem = (size_t)kWarps * stride;
  auto kern = encode_gelf_kernel<P, ASM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kWarps - 1) / kWarps;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      k, N, L, max_sd, OW, stride, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// probe: tier (uint8 0/1) and out_len (int32) of every row
int fg_encode_gelf_probe_p6(const void* batch, const void* lens,
                            const void* ch, const void* ts_len,
                            const void* bank, const int* consts, int N,
                            int L, int max_sd, int OW, void* tier,
                            void* out_len, void* stream) {
  return launch<6, false>(batch, lens, ch, nullptr, ts_len, bank, consts, N,
                          L, max_sd, OW, tier, out_len, nullptr, nullptr,
                          static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_probe_p16(const void* batch, const void* lens,
                             const void* ch, const void* ts_len,
                             const void* bank, const int* consts, int N,
                             int L, int max_sd, int OW, void* tier,
                             void* out_len, void* stream) {
  return launch<16, false>(batch, lens, ch, nullptr, ts_len, bank, consts,
                           N, L, max_sd, OW, tier, out_len, nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

// assemble: the elided bytes of each row with row_off >= 0 at
// flat[row_off]
int fg_encode_gelf_assemble_p6(const void* batch, const void* lens,
                               const void* ch, const void* ts_text,
                               const void* ts_len, const void* bank,
                               const int* consts, int N, int L, int max_sd,
                               int OW, const void* row_off, void* flat,
                               void* stream) {
  return launch<6, true>(batch, lens, ch, ts_text, ts_len, bank, consts, N,
                         L, max_sd, OW, nullptr, nullptr, row_off, flat,
                         static_cast<cudaStream_t>(stream));
}

int fg_encode_gelf_assemble_p16(const void* batch, const void* lens,
                                const void* ch, const void* ts_text,
                                const void* ts_len, const void* bank,
                                const int* consts, int N, int L, int max_sd,
                                int OW, const void* row_off, void* flat,
                                void* stream) {
  return launch<16, true>(batch, lens, ch, ts_text, ts_len, bank, consts, N,
                          L, max_sd, OW, nullptr, nullptr, row_off, flat,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
