// The GELF row encodes of kernels E1 (rfc5424) and E3 (rfc3164), one
// warp a row: the device functions shared by encode_gelf.cu and the
// fused routes (fused_gelf.cu).  The design notes are at the top of
// encode_gelf.cu.
//
// A row encode reads its decode channels through a ChanView (a column of
// a channel-major table: the decode kernel's [C, N] output in global
// memory for the split tier, the block's [C, 8] shared tile for a fused
// route), stages and escapes the row (escape_stage), builds its segment
// table, and either sums the lengths (the probe) or writes the bytes
// (assemble_row).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace enc {

using namespace fg;

constexpr int kMaxSd = 4;                // SD width of the decode channels
constexpr int kECap = 56;                // E_CAP: escapes a tier row may hold
constexpr int kAmbigLen = 8;
constexpr int kBig = 0x7FFFFFFF;         // sort key of an absent pair
constexpr int kSmemMax = 227 * 1024;     // dynamic shared memory a block
constexpr int kTsW = 32;                 // TS_W: timestamp text slot width

// A row's column of a channel-major table.
struct ChanView {
  const int32_t* p;
  int stride;
  __device__ __forceinline__ int operator()(int c) const {
    return p[(size_t)c * stride];
  }
};

// Offsets then lengths of a route's bank constants (its KERNEL_CONSTS).
template <int K>
struct ConstTable {
  int off[K];
  int len[K];
};

// The table from its host form: K offsets, then K lengths.
template <int K>
inline ConstTable<K> const_table(const int* consts) {
  ConstTable<K> k;
  for (int i = 0; i < K; ++i) {
    k.off[i] = consts[i];
    k.len[i] = consts[K + i];
  }
  return k;
}

// The bank bytes a kernel reads: up to the end of its last constant.
template <int K>
__host__ __device__ inline int bank_bytes(const ConstTable<K>& k) {
  int b = 0;
  for (int i = 0; i < K; ++i)
    if (k.off[i] + k.len[i] > b) b = k.off[i] + k.len[i];
  return b;
}

// A launch of one warp a row: up to eight rows a block, as many as
// `smem_max` bytes of dynamic shared memory hold at `stride` bytes a
// warp.  Returns 0 with the grid, block and shared bytes set, or a CUDA
// error.
template <class Kern>
inline int warp_rows_geometry(Kern kern, int N, int stride, int smem_max,
                              int* grid, int* threads, size_t* smem) {
  const int warps = smem_max / stride < kWarps ? smem_max / stride : kWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  *smem = (size_t)warps * stride;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  *grid = (N + warps - 1) / warps;
  *threads = 32 * warps;
  return 0;
}

__device__ __forceinline__ int escape_letter(int b) {
  return b == 8 ? 'b' : b == 9 ? 't' : b == 10 ? 'n' : b == 12 ? 'f'
         : b == 13 ? 'r' : b;
}

// Shared memory of one warp: the staged row, a word per 16-byte chunk
// (escapes before the chunk << 16 | the chunk's escape mask), and for the
// assemble the sources of its S segments in one buffer (the escaped row
// in L + E_CAP bytes, the constant bank, the timestamp text), the segment
// table (end, source) and the output row with room for its 16-byte
// skew.
struct WarpSmem {
  int row, etab, src, seg, out, stride;
};

__host__ __device__ inline WarpSmem warp_smem(int L, int OW, int S,
                                              bool asm_mode, int bank_len) {
  WarpSmem s;
  s.row = 0;
  s.etab = round16(L);
  s.src = s.etab + round16(4 * ((L + 15) / 16));
  s.seg = s.src + (asm_mode ? round16(L + kECap + bank_len + kTsW) : 0);
  s.out = s.seg + (asm_mode ? round16(8 * S) : 0);
  s.stride = s.out + (asm_mode ? round16(OW) + 16 : 0);
  return s;
}

// The escaped offset of a raw offset: the offset plus the escapes before
// it (every escape of the row at and past the length).
struct Dmap {
  const uint32_t* etab;
  int vlen, ne_total;
  __device__ __forceinline__ int operator()(int a) const {
    if (a <= 0) return a;
    if (a >= vlen) return a + ne_total;
    const uint32_t t = etab[a >> 4];
    return a + (int)(t >> 16) + __popc(t & ((1u << (a & 15)) - 1u));
  }
};

struct EscOut {
  int ne_total;
  bool bad_any;                          // a control byte needing \u00XX
};

// Stages the row's vlen valid bytes at rowb (16 a lane; a 16-byte load
// where `vec`; nothing when STAGED, the row already at rowb: a fused
// route's decode staged it), classifies them (escapes ", \\, \b \t \n \f
// \r; other control bytes), fills etab and, when assembling, writes the
// escaped row to srcb[0, EW).
template <bool ASM, bool STAGED>
__device__ __forceinline__ EscOut escape_stage(
    const uint8_t* __restrict__ src, bool vec, int vlen, uint8_t* rowb,
    uint32_t* etab, uint8_t* srcb, int EW, int lane) {
  const int nch = (vlen + 15) >> 4;      // 16-byte chunks of valid bytes
  const uint8_t* from = STAGED ? rowb : src;
  vec = vec || STAGED;
  int carry = 0;
  bool bad_any = false;
  for (int c0 = 0; c0 < nch; c0 += 32) {
    const int c = c0 + lane;
    const int j0 = 16 * c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (c < nch) {
      if (vec) {
        const uint4 v = *reinterpret_cast<const uint4*>(from + j0);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        // a fixed trip count, so w's indices are constants and w stays
        // in registers
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (j0 + i < vlen)
            w[i >> 2] |= (uint32_t)from[j0 + i] << (8 * (i & 3));
      }
      if (!STAGED) {
        uint4 v;
        v.x = w[0];
        v.y = w[1];
        v.z = w[2];
        v.w = w[3];
        *reinterpret_cast<uint4*>(rowb + j0) = v;
      }
    }
    const int nvalid = vlen - j0;        // <= 0 past the valid chunks
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
  return {carry, bad_any};
}

// Copies the bank and the row's timestamp text beside the escaped row
// (sources at EW and EW + bank_len).
__device__ __forceinline__ void stage_sources(uint8_t* srcb, int EW,
                                              const uint8_t* bank,
                                              int bank_len,
                                              const uint8_t* ts_text_row,
                                              int lane) {
  for (int i = lane; i < bank_len; i += 32) srcb[EW + i] = bank[i];
  srcb[EW + bank_len + lane] = ts_text_row[lane];
}

// The assemble of one row from its segment table: lane p < P holds pair
// p's five segments (pair_seg(i, &source, &length) gives segment i, of
// pair_len bytes in all), lane f < NF fixed segment f (f_src, f_len).
// Scans them into destination offsets, writes (end, source) a segment to
// shared memory, stages the output row there (each lane its bytes 32
// apart, a segment cursor each, one shared load a byte) and stores it at
// dst with aligned 16-byte stores, bytes only at its unaligned head and
// tail.  The pair segments are asked for only after the scans, so their
// sources are not live across them.
template <int P, int NF, class PairSeg>
__device__ __forceinline__ void assemble_row(
    int pair_len, PairSeg pair_seg, int f_src, int f_len, uint8_t* base,
    const WarpSmem& sm, const uint8_t* srcb, int src_last, int OW,
    uint8_t* dst, int lane) {
  constexpr int S = 5 * P + NF;
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
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      int src = 0, len = 0;
      pair_seg(i, src, len);
      seg_adj[5 * lane + i] = src - at;
      at += len;
      seg_end[5 * lane + i] = at;
    }
  }
  if (lane < NF) {
    const int at = pairs_total + fix_x - f_len;
    seg_adj[5 * P + lane] = f_src - at;
    seg_end[5 * P + lane] = at + f_len;
  }
  __syncwarp();

  uint8_t* outb = base + sm.out;
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int ol = out_len < OW ? out_len : OW;
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

// Where a row's encode writes: the probe's tier bit and base length, or
// the assemble's destination.
struct RowOut {
  uint8_t* tier;                         // probe
  int32_t* base_len;                     // probe
  uint8_t* dst;                          // assemble
};

// What a row's encode reads besides its channels.
struct RowIn {
  const uint8_t* src;                    // the row in global memory
  bool vec;                              // 16-byte loads of src
  int len, L, OW;
  const uint8_t* bank;
  int bank_len;
  const uint8_t* ts_text;                // the row's TS_W bytes
  int ts_len;
};

// ===========================================================================
// E1: rfc5424 -> GELF
// ===========================================================================

// channel rows of the rfc5424 decode's packed output (_KEYS_1D order)
constexpr int kN1D = 23;
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
using Consts5 = ConstTable<kNumConst>;

// The fixed segments, in output order, one a lane: a constant, a span
// of the escaped row, or the timestamp text (device_gelf.encode_rows
// builds the same list).
enum Fixed5424 {
  F_APP_C, F_APP, F_FULL_C, F_FULL, F_HOST_C, F_HOST, F_LEVEL_C, F_SEV,
  F_PROC_C, F_PROC, F_P6X_C, F_SDID_C, F_SID, F_SHORT_C, F_MSG, F_TS,
  kFixed
};

__host__ __device__ constexpr int segments5424(int P) { return 5 * P + kFixed; }

// (hi, lo, nl, idx) of lane a before that of lane b: the key order of
// device_common.sort_pairs_by_key8, the pair index last
__device__ __forceinline__ bool key_less(int ah, int al, int an, int ai,
                                         int bh, int bl, int bn, int bi) {
  if (ah != bh) return ah < bh;
  if (al != bl) return al < bl;
  if (an != bn) return an < bn;
  return ai < bi;
}

// STAGED: the row's valid bytes are already at the start of `base` (a
// fused route's decode staged them), so in.src is not read.
template <int P, bool ASM, bool STAGED = false>
__device__ __forceinline__ void encode5424_row(const ChanView& C,
                                               const RowIn& in,
                                               const Consts5& k, int max_sd,
                                               uint8_t* base, RowOut out,
                                               int lane) {
  constexpr int W = P <= 8 ? 8 : 16;     // lanes of the sorting network
  static_assert(P <= W && W <= 16, "encode_gelf sorts at most 16 pairs");
  constexpr int S = segments5424(P);

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
      *out.tier = 0;
      *out.base_len = 0;
    }
    return;
  }
  // lane p: pair p's raw name span, escaped value span and escape flag
  const int pb = kN1D + 2 * kMaxSd;     // first pair channel
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
  const WarpSmem sm = warp_smem(in.L, in.OW, S, ASM, in.bank_len);
  uint8_t* rowb = base + sm.row;
  uint32_t* etab = reinterpret_cast<uint32_t*>(base + sm.etab);
  // the sources: escaped row at 0, bank at EW, timestamp text at ts_at
  uint8_t* srcb = base + sm.src;
  const int EW = in.L + kECap, ts_at = EW + in.bank_len;
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  const EscOut es = escape_stage<ASM, STAGED>(in.src, in.vec, vlen, rowb, etab,
                                              srcb, EW, lane);
  const int ne_total = es.ne_total;
  if (ASM) stage_sources(srcb, EW, in.bank, in.bank_len, in.ts_text, lane);
  __syncwarp();
  const Dmap dmap{etab, vlen, ne_total};

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
      f_len = ASM ? in.ts_len : 0;
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
    const int total = (int)__reduce_add_sync(kFull, pair_len + f_len);
    if (lane == 0) {
      const bool tier = !es.bad_any && ne_total <= kECap && !val_esc_any &&
                        !ambig;
      *out.tier = tier ? 1 : 0;
      *out.base_len = tier ? total : 0;
    }
    return;
  }
  // pair `lane`'s five segments, in the order above
  auto pair_seg = [&](int i, int& src, int& len) {
    switch (i) {
      case 0: src = EW + k.off[K_P0]; len = pv ? p0 : 0; break;
      case 1: src = ns; len = n_len; break;
      case 2: src = EW + k.off[K_P1]; len = pv ? p1 : 0; break;
      case 3: src = vs; len = v_len; break;
      default: src = EW + k.off[K_P2]; len = pv ? p2 : 0; break;
    }
  };
  assemble_row<P, kFixed>(pair_len, pair_seg, f_src, f_len, base, sm, srcb,
                          ts_at + kTsW - 1, in.OW, out.dst, lane);
}

// ===========================================================================
// E3: rfc3164 -> GELF
// ===========================================================================

// channel rows of the rfc3164 decode's packed output (tpu/rfc3164.py KEYS)
enum Ch3164Enc {
  C3_OK = 0, C3_HAS_PRI = 1, C3_HAS_HIGH = 2, C3_SEVERITY = 4,
  C3_HOST_S = 9, C3_HOST_E = 10, C3_MSG_START = 11
};

// the bank constants a row reads (device_rfc3164.KERNEL_CONSTS)
enum Const3164 {
  K3_HOST, K3_HL, K3_LEVEL, K3_SEVD, K3_L2A, K3_L2B, K3_SHORT_P,
  K3_SHORT_N, kNumConst3
};
using Consts3 = ConstTable<kNumConst3>;

// The fixed segments, in output order, one a lane (device_rfc3164.
// encode_rows builds the same list): the whole escaped line as
// full_message, the host span, the level pair gated on has_pri, the
// short_message span from msg_start to the row's end, the timestamp text.
enum Fixed3164 {
  G_FULL, G_HOST_C, G_HOST, G_HL_C, G_LEVEL_C, G_SEV, G_L2_C, G_SHORT_C,
  G_MSG, G_TS, kFixed3
};

template <bool ASM, bool STAGED = false>
__device__ __forceinline__ void encode3164_row(const ChanView& C,
                                               const RowIn& in,
                                               const Consts3& k,
                                               uint8_t* base, RowOut out,
                                               int lane) {
  const int ok = C(C3_OK), high = C(C3_HAS_HIGH);
  if (!ASM && (ok == 0 || high != 0)) {
    // outside the tier on its channels alone
    if (lane == 0) {
      *out.tier = 0;
      *out.base_len = 0;
    }
    return;
  }
  const bool has_pri = C(C3_HAS_PRI) != 0;
  int cs = -1, ce = -1;
  switch (lane) {
    case G_HOST: cs = C3_HOST_S; ce = C3_HOST_E; break;
    case G_SEV: cs = C3_SEVERITY; break;
    case G_MSG: cs = C3_MSG_START; break;
    default: break;
  }
  const int fs_raw = cs >= 0 ? C(cs) : 0, fe_raw = ce >= 0 ? C(ce) : 0;

  const WarpSmem sm = warp_smem(in.L, in.OW, kFixed3, ASM, in.bank_len);
  uint8_t* rowb = base + sm.row;
  uint32_t* etab = reinterpret_cast<uint32_t*>(base + sm.etab);
  uint8_t* srcb = base + sm.src;
  const int EW = in.L + kECap, ts_at = EW + in.bank_len;
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  const EscOut es = escape_stage<ASM, STAGED>(in.src, in.vec, vlen, rowb, etab,
                                              srcb, EW, lane);
  if (ASM) stage_sources(srcb, EW, in.bank, in.bank_len, in.ts_text, lane);
  __syncwarp();
  const Dmap dmap{etab, vlen, es.ne_total};
  const int row_e = in.len + es.ne_total;  // the escaped row's end

  int f_src = 0, f_len = 0;
  auto cst = [&](int id, bool gate) {
    f_src = EW + k.off[id];
    f_len = gate ? k.len[id] : 0;
  };
  switch (lane) {
    case G_FULL: f_len = row_e; break;
    case G_HOST_C: cst(K3_HOST, true); break;
    case G_HOST: {
      const int hs = dmap(fs_raw), he = dmap(fe_raw);
      f_src = hs;
      f_len = he > hs ? he - hs : 0;
      break;
    }
    case G_HL_C: cst(K3_HL, true); break;
    case G_LEVEL_C: cst(K3_LEVEL, has_pri); break;
    case G_SEV:
      f_src = EW + k.off[K3_SEVD] + fs_raw;
      f_len = has_pri ? 1 : 0;
      break;
    // the after-number or the string-close variant (constant indices,
    // so the table stays in the parameter space)
    case G_L2_C:
      if (has_pri) cst(K3_L2A, true); else cst(K3_L2B, true);
      break;
    case G_SHORT_C:
      if (has_pri) cst(K3_SHORT_P, true); else cst(K3_SHORT_N, true);
      break;
    case G_MSG: {
      const int ms = dmap(fs_raw);
      f_src = ms;
      f_len = row_e > ms ? row_e - ms : 0;
      break;
    }
    case G_TS:
      f_src = ts_at;
      f_len = ASM ? in.ts_len : 0;
      break;
    default: break;                      // lanes past the fixed segments
  }

  if (!ASM) {
    const int total = (int)__reduce_add_sync(kFull, f_len);
    if (lane == 0) {
      const bool tier = !es.bad_any && es.ne_total <= kECap;
      *out.tier = tier ? 1 : 0;
      *out.base_len = tier ? total : 0;
    }
    return;
  }
  auto no_pairs = [](int, int&, int&) {};
  assemble_row<0, kFixed3>(0, no_pairs, f_src, f_len, base, sm, srcb,
                           ts_at + kTsW - 1, in.OW, out.dst, lane);
}

}  // namespace enc
