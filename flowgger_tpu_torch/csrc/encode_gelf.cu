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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // rows per block, one warp each
// blocks a multiprocessor keeps resident: caps registers at 48 a thread
// (without the cap nvcc gave the probe 52 and spilled in the 6-pair
// assemble; a cap of 6 blocks spilled too)
constexpr int kMinBlocks = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSd = 4;                // SD width of the decode channels
constexpr int kECap = 56;                // E_CAP: escapes a tier row may hold
constexpr int kAmbigLen = 8;
constexpr int kBig = 0x7FFFFFFF;         // sort key of an absent pair
constexpr int kN1D = 23;
constexpr int kFixed = 16;               // fixed segments after the pairs
constexpr int kSmemMax = 227 * 1024;     // dynamic shared memory a block
constexpr int kTsW = 32;                 // TS_W: timestamp text slot width

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

// The fixed segments, in output order, one a lane: a constant, a span
// of the escaped row, or the timestamp text (device_gelf.encode_rows
// builds the same list).
enum Fixed {
  F_APP_C, F_APP, F_FULL_C, F_FULL, F_HOST_C, F_HOST, F_LEVEL_C, F_SEV,
  F_PROC_C, F_PROC, F_P6X_C, F_SDID_C, F_SID, F_SHORT_C, F_MSG, F_TS
};
static_assert(F_TS + 1 == kFixed, "one fixed segment a lane, 16 lanes");

__device__ __forceinline__ int escape_letter(int b) {
  return b == 8 ? 'b' : b == 9 ? 't' : b == 10 ? 'n' : b == 12 ? 'f'
         : b == 13 ? 'r' : b;
}

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Four bytes at a time (SWAR): 0x80 in each byte of the result where
// the byte of x is below c (c <= 0x80; (x | 0x80) - c never borrows
// across bytes), or equal to c.
__device__ __forceinline__ uint32_t bytes_below(uint32_t x, uint32_t c) {
  return ~((x | 0x80808080u) - c * 0x01010101u) & ~x & 0x80808080u;
}

__device__ __forceinline__ uint32_t bytes_equal(uint32_t x, uint32_t c) {
  const uint32_t y = x ^ (c * 0x01010101u);
  return ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y | 0x7F7F7F7Fu);
}

// the four flag bits (bits 7, 15, 23, 31) of a SWAR result as a nibble
__device__ __forceinline__ unsigned nibble(uint32_t f) {
  return ((f >> 7) * 0x10204080u) >> 28;
}

// (hi, lo, nl, idx) of lane a before that of lane b: the key order of
// device_common.sort_pairs_by_key8, the pair index last
__device__ __forceinline__ bool key_less(int ah, int al, int an, int ai,
                                         int bh, int bl, int bn, int bi) {
  if (ah != bh) return ah < bh;
  if (al != bl) return al < bl;
  if (an != bn) return an < bn;
  return ai < bi;
}

// Shared memory of one warp: the staged row, a word per 16-byte chunk
// (escapes before the chunk << 16 | the chunk's escape mask), and for the
// assemble the sources of its segments in one buffer (the escaped row in
// L + E_CAP bytes, the constant bank, the timestamp text), the segment
// table (end, source) and the output row with room for its 16-byte
// skew.
struct WarpSmem {
  int row, etab, src, seg, out, stride;
};

__host__ __device__ inline WarpSmem warp_smem(int L, int OW, int P,
                                              bool asm_mode, int bank_len) {
  WarpSmem s;
  s.row = 0;
  s.etab = round16(L);
  s.src = s.etab + round16(4 * ((L + 15) / 16));
  s.seg = s.src + (asm_mode ? round16(L + kECap + bank_len + kTsW) : 0);
  s.out = s.seg + (asm_mode ? round16(8 * (5 * P + kFixed)) : 0);
  s.stride = s.out + (asm_mode ? round16(OW) + 16 : 0);
  return s;
}

template <int P, bool ASM>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
encode_gelf_kernel(const uint8_t* __restrict__ batch,
                   const int32_t* __restrict__ lens_in,
                   const int32_t* __restrict__ ch,
                   const uint8_t* __restrict__ ts_text,
                   const int32_t* __restrict__ ts_len_in,
                   const uint8_t* __restrict__ bank, int bank_len,
                   Consts k, int N, int n, int L, int max_sd, int OW,
                   uint8_t* __restrict__ tier_out,
                   int32_t* __restrict__ len_out,
                   const int64_t* __restrict__ row_off,
                   uint8_t* __restrict__ flat) {
  constexpr int W = P <= 8 ? 8 : 16;     // lanes of the sorting network
  static_assert(P <= W && W <= 16, "encode_gelf sorts at most 16 pairs");
  constexpr int S = 5 * P + kFixed;      // segments a row
  extern __shared__ uint4 enc_smem_v[];
  uint8_t* enc_smem = reinterpret_cast<uint8_t*>(enc_smem_v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= N) return;                  // whole warps leave together
  if (row >= n) {                        // padding: no loads at all
    if (!ASM && lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
    }
    return;
  }
  int64_t dst0 = 0;
  if (ASM) {
    dst0 = row_off[row];
    if (dst0 < 0) return;                // not a kept tier row
  }
  auto C = [&](int c) { return ch[(size_t)c * N + row]; };

  // ---- the channels: every lane the row's, lane f fixed segment f's ----
  const int ok = C(C_OK), high = C(C_HAS_HIGH);
  const int pc = C(C_PAIR_COUNT), sdc = C(C_SD_COUNT);
  int cs = -1, ce = -1;
  switch (lane) {
    case F_APP: cs = C_APP_S; ce = C_APP_E; break;
    case F_FULL: cs = C_FULL_START; ce = C_TRIM_END; break;
    case F_HOST: cs = C_HOST_S; ce = C_HOST_E; break;
    case F_SEV: cs = C_SEVERITY; break;
    case F_PROC: cs = C_PROC_S; ce = C_PROC_E; break;
    case F_SID:
      // the last SD element's id span (none: 0, 0)
      if (sdc >= 1 && sdc <= kMaxSd) {
        cs = kN1D + sdc - 1;
        ce = kN1D + kMaxSd + sdc - 1;
      }
      break;
    case F_MSG: cs = C_MSG_TRIM_START; ce = C_TRIM_END; break;
    default: break;
  }
  const int fs_raw = cs >= 0 ? C(cs) : 0, fe_raw = ce >= 0 ? C(ce) : 0;
  if (!ASM && (ok == 0 || high != 0 || pc > P || sdc > max_sd)) {
    // outside the tier on its channels alone
    if (lane == 0) {
      tier_out[row] = 0;
      len_out[row] = 0;
    }
    return;
  }
  // lane p: pair p's raw name span, escaped value span and escape flag
  const int pb = kN1D + 2 * kMaxSd;      // first pair channel
  const bool pv_own = lane < P && lane < pc;
  int ns_r = 0, ne_r = 0, vs_r = 0, ve_r = 0, vesc = 0;
  if (pv_own) {
    ns_r = C(pb + lane);
    ne_r = C(pb + P + lane);
    vs_r = C(pb + 2 * P + lane);
    ve_r = C(pb + 3 * P + lane);
    if (!ASM) vesc = C(pb + 5 * P + lane);
  }

  // ---- stage the row, escape scan ---------------------------------------
  const WarpSmem sm = warp_smem(L, OW, P, ASM, bank_len);
  uint8_t* base = enc_smem + (size_t)warp * sm.stride;
  uint8_t* rowb = base + sm.row;
  uint32_t* etab = reinterpret_cast<uint32_t*>(base + sm.etab);
  // the sources: escaped row at 0, bank at EW, timestamp text at ts_at
  uint8_t* srcb = base + sm.src;
  const int EW = L + kECap, ts_at = EW + bank_len;
  const int len = lens_in[row];
  const int vlen = len < 0 ? 0 : (len > L ? L : len);
  const int nch = (vlen + 15) >> 4;      // 16-byte chunks of valid bytes
  const uint8_t* src = batch + (size_t)row * L;
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0;
  int carry = 0;
  bool bad_any = false;
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    const int j0 = 16 * c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (c < nch) {
      if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + j0);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        for (int i = 0; i < 16 && j0 + i < vlen; ++i)
          w[i >> 2] |= (uint32_t)src[j0 + i] << (8 * (i & 3));
      }
      uint4 v;
      v.x = w[0];
      v.y = w[1];
      v.z = w[2];
      v.w = w[3];
      *reinterpret_cast<uint4*>(rowb + j0) = v;
    }
    const int nvalid = vlen - j0;        // <= 0 past the valid chunks
    // escapes (", \\, \b \t \n \f \r) and other control bytes, four
    // bytes a step
    unsigned m = 0;
    uint32_t bad_bits = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nv = nvalid - 4 * q;
      const uint32_t valid =
          nv >= 4 ? 0x80808080u
                  : nv <= 0 ? 0u : 0x80808080u & ((1u << (8 * nv)) - 1u);
      const uint32_t x = w[q];
      const uint32_t two = bytes_below(x, 14) & ~bytes_below(x, 8) &
                           ~bytes_equal(x, 11);
      const uint32_t esc =
          (bytes_equal(x, 34) | bytes_equal(x, 92) | two) & valid;
      bad_bits |= bytes_below(x, 32) & ~two & valid;
      m |= nibble(esc) << (4 * q);
    }
    const bool bad = bad_bits != 0;
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    const int before = carry + incl - cnt;
    if (c < nch) {
      etab[c] = (uint32_t)before << 16 | m;
      if (ASM) {
        // the chunk's bytes at their escaped offsets
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int b = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
          const int d = j0 + i + before + __popc(m & ((1u << i) - 1u));
          if (i >= nvalid) {
          } else if (m >> i & 1u) {
            if (d < EW) srcb[d] = '\\';
            if (d + 1 < EW)
              srcb[d + 1] = static_cast<uint8_t>(escape_letter(b));
          } else if (d < EW) {
            srcb[d] = static_cast<uint8_t>(b);
          }
        }
      }
    }
    carry += __shfl_sync(kFull, incl, 31);
    bad_any |= __ballot_sync(kFull, bad) != 0;
  }
  const int ne_total = carry;
  if (ASM) {
    for (int i = lane; i < bank_len; i += 32) srcb[EW + i] = bank[i];
    srcb[ts_at + lane] = ts_text[(size_t)row * kTsW + lane];
  }
  __syncwarp();

  // escaped offset of raw offset a: a plus the escapes before it (every
  // escape of the row at and past the length)
  auto dmap = [&](int a) {
    if (a <= 0) return a;
    if (a >= vlen) return a + ne_total;
    const uint32_t t = etab[a >> 4];
    return a + (int)(t >> 16) + __popc(t & ((1u << (a & 15)) - 1u));
  };

  // ---- SD pairs: keys across lanes, bitonic sort, ambiguity -------------
  int hi = kBig, lo = kBig, nl = kBig, idx = lane;
  if (pv_own) {
    unsigned h = 0, l = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int pos = ns_r + q;
      const unsigned z =
          (pos >= 0 && pos < vlen && pos < ne_r) ? rowb[pos] : 0u;
      if (q < 4)
        h |= z << (24 - 8 * q);
      else
        l |= z << (56 - 8 * q);
    }
    hi = static_cast<int>(h);
    lo = static_cast<int>(l);
    nl = ne_r - ns_r;
  }
  const int ns_e = dmap(ns_r), ne_e = dmap(ne_r);
  const int vs_e = dmap(vs_r), ve_e = dmap(ve_r);
#pragma unroll
  for (int kk = 2; kk <= W; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const int oh = __shfl_xor_sync(kFull, hi, j);
      const int ol = __shfl_xor_sync(kFull, lo, j);
      const int on = __shfl_xor_sync(kFull, nl, j);
      const int oi = __shfl_xor_sync(kFull, idx, j);
      // the lower lane of an ascending pair keeps the smaller
      const bool keep_min = ((lane & j) == 0) == ((lane & kk) == 0);
      if (key_less(oh, ol, on, oi, hi, lo, nl, idx) == keep_min) {
        hi = oh;
        lo = ol;
        nl = on;
        idx = oi;
      }
    }
  }
  bool ambig = false, val_esc_any = false;
  if (!ASM) {
    const int nh = __shfl_down_sync(kFull, hi, 1);
    const int nlo = __shfl_down_sync(kFull, lo, 1);
    const int nn = __shfl_down_sync(kFull, nl, 1);
    const bool keq = lane + 1 < W && hi == nh && lo == nlo && hi != kBig;
    ambig = __ballot_sync(kFull,
                          keq && (nl == nn || (nl > kAmbigLen &&
                                               nn > kAmbigLen))) != 0;
    val_esc_any = __ballot_sync(kFull, vesc != 0) != 0;
  }
  // sorted slot `lane`: its pair's escaped spans, by index
  const int src_lane = idx & 31;
  const int ns = __shfl_sync(kFull, ns_e, src_lane);
  const int ne = __shfl_sync(kFull, ne_e, src_lane);
  const int vs = __shfl_sync(kFull, vs_e, src_lane);
  const int ve = __shfl_sync(kFull, ve_e, src_lane);

  // ---- the segments ------------------------------------------------------
  // fixed segment `lane`: (source, length), a span of the escaped row
  // unless the lane's case makes it a constant or the timestamp text
  const int fs = dmap(fs_raw), fe = dmap(fe_raw);
  int f_src = fs, f_len = fe > fs ? fe - fs : 0;
  auto cst = [&](int id, bool gate) {
    f_src = EW + k.off[id];
    f_len = gate ? k.len[id] : 0;
  };
  switch (lane) {
    case F_APP_C: cst(K_APP, true); break;
    case F_FULL_C: cst(K_FULL, true); break;
    case F_HOST_C: cst(K_HOST, true); break;
    case F_HOST: if (fe <= fs) cst(K_UNKNOWN, true); break;
    case F_LEVEL_C: cst(K_LEVEL, true); break;
    case F_SEV:
      f_src = EW + k.off[K_SEVD] + fs_raw;
      f_len = 1;
      break;
    case F_PROC_C: cst(K_PROC, true); break;
    case F_P6X_C: cst(K_P6X, true); break;
    case F_SDID_C: cst(K_SDID, sdc > 0); break;
    case F_SHORT_C: cst(K_SHORT, true); break;
    case F_MSG: if (fe <= fs) cst(K_DASH, true); break;
    case F_TS:
      f_src = ts_at;
      f_len = ASM ? ts_len_in[row] : 0;
      break;
    case F_APP: case F_FULL: case F_PROC: case F_SID: break;
    default: f_len = 0; break;           // lanes past the fixed segments
  }
  const int p0 = k.len[K_P0], p1 = k.len[K_P1], p2 = k.len[K_P2];
  // sorted pair `lane`: p0, name, p1, value, p2
  const bool pv = lane < P && lane < pc;
  const int n_len = pv && ne > ns ? ne - ns : 0;
  const int v_len = pv && ve > vs ? ve - vs : 0;
  const int pair_len = pv ? p0 + n_len + p1 + v_len + p2 : 0;

  if (!ASM) {
    const int out = (int)__reduce_add_sync(kFull, pair_len + f_len);
    if (lane == 0) {
      const bool tier = !bad_any && ne_total <= kECap && !val_esc_any &&
                        !ambig;
      tier_out[row] = tier ? 1 : 0;
      len_out[row] = tier ? out : 0;
    }
    return;
  }

  // ---- assemble: destination offsets, the table, the staged row --------
  int pair_x = pair_len, fix_x = f_len;  // inclusive scans
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(kFull, pair_x, d);
    const int b = __shfl_up_sync(kFull, fix_x, d);
    if (lane >= d) {
      pair_x += a;
      fix_x += b;
    }
  }
  const int pairs_total = __shfl_sync(kFull, pair_x, 31);
  const int out_len = pairs_total + __shfl_sync(kFull, fix_x, 31);
  int* seg_end = reinterpret_cast<int*>(base + sm.seg);
  int* seg_adj = seg_end + S;            // source offset - destination
  if (lane < P) {
    int at = pair_x - pair_len;
    const int srcs[5] = {EW + k.off[K_P0], ns, EW + k.off[K_P1], vs,
                         EW + k.off[K_P2]};
    const int lens[5] = {pv ? p0 : 0, n_len, pv ? p1 : 0, v_len,
                         pv ? p2 : 0};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      seg_adj[5 * lane + i] = srcs[i] - at;
      at += lens[i];
      seg_end[5 * lane + i] = at;
    }
  }
  if (lane < kFixed) {
    const int at = pairs_total + fix_x - f_len;
    seg_adj[5 * P + lane] = f_src - at;
    seg_end[5 * P + lane] = at + f_len;
  }
  __syncwarp();

  uint8_t* outb = base + sm.out;
  uint8_t* dst = flat + dst0;
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int ol = out_len < OW ? out_len : OW;
  const int src_last = ts_at + kTsW - 1;
  int seg = 0;                           // this lane's segment cursor
  for (int o = lane; o < ol; o += 32) {
    while (seg_end[seg] <= o) ++seg;
    const int v = seg_adj[seg] + o;
    outb[skew + o] = srcb[v < 0 ? 0 : v > src_last ? src_last : v];
  }
  __syncwarp();
  // the row's bytes [0, ol) sit at outb[skew:], dst - skew is 16-aligned
  uint8_t* d0 = dst - skew;
  const int span = skew + ol;
  for (int a = 16 * lane; a < span; a += 16 * 32) {
    if (a >= skew && a + 16 <= span) {
      *reinterpret_cast<uint4*>(d0 + a) =
          *reinterpret_cast<const uint4*>(outb + a);
    } else {
      for (int i = a < skew ? skew - a : 0; i < 16 && a + i < span; ++i)
        d0[a + i] = outb[a + i];
    }
  }
}

template <int P, bool ASM>
int launch(const void* batch, const void* lens, const void* ch,
           const void* ts_text, const void* ts_len, const void* bank,
           const int* consts, int N, int n, int L, int max_sd, int OW,
           void* tier, void* out_len, const void* row_off, void* flat,
           cudaStream_t stream) {
  if (N <= 0) return 0;
  Consts k;
  for (int i = 0; i < kNumConst; ++i) {
    k.off[i] = consts[i];
    k.len[i] = consts[kNumConst + i];
  }
  // the bank bytes the kernel reads: up to the end of its last constant
  int bank_len = 0;
  for (int i = 0; i < kNumConst; ++i)
    if (k.off[i] + k.len[i] > bank_len) bank_len = k.off[i] + k.len[i];
  const int stride = warp_smem(L, OW, P, ASM, bank_len).stride;
  // up to eight rows a block, as many as the shared memory holds
  const int warps = kSmemMax / stride < kWarps ? kSmemMax / stride : kWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * stride;
  auto kern = encode_gelf_kernel<P, ASM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + warps - 1) / warps;
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(ch), static_cast<const uint8_t*>(ts_text),
      static_cast<const int32_t*>(ts_len), static_cast<const uint8_t*>(bank),
      bank_len, k, N, n, L, max_sd, OW, static_cast<uint8_t*>(tier),
      static_cast<int32_t*>(out_len), static_cast<const int64_t*>(row_off),
      static_cast<uint8_t*>(flat));
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

}  // extern "C"
