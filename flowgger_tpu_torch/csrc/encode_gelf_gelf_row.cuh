// The GELF -> GELF row encode of kernel EG, one warp a row: the device
// function shared by encode_gelf.cu (the split tier, reading K5's
// flat-mode [2 + 7F, N] channels) and fused_gelf.cu (FG: its probe reads
// the block's channel tile, its assemble the selection the probe
// carried).  The design notes are at the top of encode_gelf.cu.
//
// It reuses E1's pieces (encode_gelf_row.cuh): the 8-byte key bitonic
// sort across lanes with its ambiguity test and the staged assemble.  What
// is the gelf tier's own (device_gelf_gelf.py): it is escape-free (the
// raw row is the source of every span), special keys are routed by their
// quoted names, numbers are screened by point bytes and span counts, and
// the timestamp is parsed exactly as split integers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_gelf_row.cuh"

namespace enc {

// the bank constants a row reads (device_gelf_gelf.KERNEL_CONSTS).  A
// pair's seven segments fold into five: '"' is the first byte of KG_KPRE
// ('"_'), '":"' is KG_COLON ('":') and the quote opening KG_QC after it
// in the bank, ',' is the second byte of KG_QC ('",');
// device_gelf_gelf.kernel_consts checks the bank holds them so
enum ConstGG {
  KG_KPRE, KG_COLON, KG_QC, KG_TRUE, KG_FALSE, KG_NULL, KG_FULL, KG_HOST,
  KG_LVL, KG_SHORT, KG_UNKNOWN, KG_DASH, kNumConstG
};
using ConstsG = ConstTable<kNumConstG>;

// The fixed segments, in output order, one a lane (device_gelf_gelf.
// segments builds the same list): full_message gated on its presence,
// the host span (or "unknown"), the level digit gated on its presence,
// the short_message span (or "-"), the timestamp text.
enum FixedGG {
  J_FULL_C, J_FULL, J_QC1, J_HOST_C, J_HOST, J_QC2, J_LVL_C, J_LVL, J_COMMA,
  J_SHORT_C, J_SHORT, J_QC3, J_TS, kFixedG
};

__host__ __device__ constexpr int segments_gg(int F) {
  return 5 * F + kFixedG;
}

// value classes (jsonidx VT_*) and special key ids
enum { GV_STRING = 0, GV_NUMBER, GV_TRUE, GV_FALSE, GV_NULL };
enum { SP_TS = 1, SP_HOST, SP_SHORT, SP_FULL, SP_VER, SP_LVL };
constexpr int kTsSpan = 24;              // _TSW: longer stamps take the oracle

// What the assemble reads after special routing and the sort: the row's
// values (every lane) and, in lane p, sorted pair p's spans and
// vt | us << 3 (0 past the pair count).  FG's probe carries it to its
// assemble as kCarryG int32 a row: the nine row values, then ns, ne, vs,
// ve, vtus of each of the 8 fields (fused_routes.carried_columns).
struct GelfSel {
  int pc, flags, full_a, full_b, host_a, host_b, lvl_a, short_a, short_b;
  int ns, ne, vs, ve, vtus;
};
constexpr int kSelRowG = 9;
constexpr int kCarryG = kSelRowG + 5 * 8;

// Shared memory of one warp: the staged row, then in the probe the class
// masks (dot, non-digit, fraction character: three words a 32-position
// word), in the assemble the bank and the timestamp text right after the
// row (one source buffer), the segment table and the output row.
__host__ __device__ inline WarpSmem gg_smem(int L, int OW, int F,
                                            bool asm_mode, int bank_len) {
  WarpSmem s;
  s.row = 0;
  s.src = 0;
  s.etab = asm_mode ? round16(L + bank_len + kTsW)
                    : round16(L);                    // the masks
  s.seg = s.etab + (asm_mode ? 0 : round16(12 * ((L + 31) / 32)));
  s.out = s.seg + (asm_mode ? round16(8 * segments_gg(F)) : 0);
  s.stride = s.out + (asm_mode ? round16(OW) + 16 : 0);
  return s;
}

// The probe's stamp channels, int32 [3, N]: ts_hi, ts_lo, ts_meta.
struct SmallG {
  int32_t* p;
  int N;
};

__device__ __forceinline__ void store_small_gg(const SmallG& s, int row,
                                               int hi, int lo, int meta) {
  s.p[row] = hi;
  s.p[(size_t)s.N + row] = lo;
  s.p[2 * (size_t)s.N + row] = meta;
}

// count of the set bits of the mask words w (one a 32-position word) in
// positions [a, b)
__device__ __forceinline__ int mask_count(const uint32_t* w, int a, int b) {
  int c = 0;
  for (int p = a; p < b;) {
    const int wi = p >> 5, lo = p & 31;
    const int hi = b - (wi << 5) < 32 ? b - (wi << 5) : 32;
    const uint32_t m = (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) &
                       ~((1u << lo) - 1u);
    c += __popc(w[3 * wi] & m);
    p = (wi + 1) << 5;
  }
  return c;
}

// The reference's span counts as its packed words give them back: three
// fields a word (lanes 3g, 3g+1, 3g+2), ten bits each, `& 1023` (a count
// of 1024 or more carries into the next slot there).  c is 0 on lanes
// at and past F.
template <int F>
__device__ __forceinline__ int packed10(int c, int lane) {
  const int g = lane - lane % 3;
  const uint32_t c0 = (uint32_t)__shfl_sync(kFull, c, g & 31);
  const uint32_t c1 = (uint32_t)__shfl_sync(kFull, c, (g + 1) & 31);
  const uint32_t c2 = (uint32_t)__shfl_sync(kFull, c, (g + 2) & 31);
  const uint32_t word = c0 + (g + 1 < F ? c1 << 10 : 0u) +
                        (g + 2 < F ? c2 << 20 : 0u);
  return (int)((word >> (10 * (lane - g))) & 1023u);
}

// the JSON number grammar -?(0|[1-9][0-9]*)(\.[0-9]+)? over a span of ln
// bytes from its bytes 0, 1, 2 and last and its dot and non-digit counts
// (device_gelf_gelf.analyze canonical)
__device__ __forceinline__ bool canonical_number(int ln, int c0, int c1,
                                                 int c2, int clast, int dots,
                                                 int nondig) {
  const int neg = c0 == '-' ? 1 : 0;
  const int dfirst = neg ? c1 : c0, dsecond = neg ? c2 : c1;
  bool ok = ln > neg && nondig == neg + dots;
  ok = ok && dots <= 1 && dfirst != '.' && clast != '.';
  ok = ok && (dfirst != '0' || ln - neg == 1 || dsecond == '.');
  ok = ok && !(neg && dfirst == '0' && dots == 0);
  return ok;
}

// CARRIED: the selection comes from `carried` (FG's assemble), not from
// channels.  STAGED: the row's valid bytes are already at the start of
// `base` (FG's probe: K5's row index staged them).  carry_out (FG's
// probe): where a base tier row's selection is written.  small (the
// probes): where row `row`'s stamp channels go (0 off the tier).
template <int F, bool ASM, bool STAGED = false, bool CARRIED = false>
__device__ __forceinline__ void encode_gg_row(
    const ChanView& C, const int32_t* __restrict__ carried, const RowIn& in,
    const ConstsG& k, uint8_t* base, RowOut out, int lane,
    int32_t* __restrict__ carry_out = nullptr, SmallG small = {nullptr, 0},
    int row = 0) {
  static_assert(F == 8 || F == 16, "EG sorts 8 or 16 fields");
  static_assert(!CARRIED || F == 8, "FG carries 8 fields");
  const WarpSmem sm = gg_smem(in.L, in.OW, F, ASM, in.bank_len);
  uint8_t* rowb = base + sm.row;
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  const int EW = in.L, ts_at = EW + in.bank_len;

  auto reject = [&]() {
    if (lane == 0) {
      *out.tier = 0;
      *out.base_len = 0;
      if (small.p != nullptr) store_small_gg(small, row, 0, 0, 0);
    }
  };

  // ---- the channels: lane f holds field f --------------------------------
  const int nf_raw = CARRIED ? 0 : C(1);
  const bool ok = CARRIED || C(0) != 0;
  if (!ASM && !ok) {                     // outside the tier on its channels
    reject();
    return;
  }
  const int nf = nf_raw < F ? nf_raw : F;
  const bool jm = !CARRIED && lane < F && lane < nf;
  int ks = 0, ke = 0, vs = 0, ve = 0, vt = -1, kesc = 0, vesc = 0;
  if (jm) {
    ks = C(2 + lane);
    ke = C(2 + F + lane);
    vs = C(2 + 2 * F + lane);
    ve = C(2 + 3 * F + lane);
    vt = C(2 + 4 * F + lane);
    kesc = C(2 + 5 * F + lane);
    vesc = C(2 + 6 * F + lane);
  }
  if (!ASM && __ballot_sync(kFull, jm && kesc != 0) != 0) {
    reject();                            // an escaped key
    return;
  }

  // ---- stage the row; the class masks and the byte screen ----------------
  if (!STAGED) stage_row(in.src, vlen, in.L, reinterpret_cast<uint4*>(rowb),
                         lane);
  if (ASM) stage_sources(rowb, EW, in.bank, in.bank_len, in.ts_text, lane);
  __syncwarp();
  auto at = [&](int p) -> int { return p >= 0 && p < vlen ? rowb[p] : 0; };
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + sm.etab);
  if (!ASM) {
    bool bad = false;
    const int nw = (in.L + 31) >> 5;
    for (int w = 0; w < nw; ++w) {
      const int p = 32 * w + lane;
      const int b = at(p);
      const bool valid = p < vlen;
      bad = bad || (valid && (b >= 128 || b < 32));
      const unsigned dot = __ballot_sync(kFull, b == '.');
      const unsigned nondig =
          __ballot_sync(kFull, valid && (b < '0' || b > '9'));
      const unsigned fracc =
          __ballot_sync(kFull, b == '.' || b == 'e' || b == 'E');
      if (lane == 0) {
        masks[3 * w] = dot;
        masks[3 * w + 1] = nondig;
        masks[3 * w + 2] = fracc;
      }
    }
    if (__ballot_sync(kFull, bad) != 0) {  // control bytes or non-ASCII
      reject();
      return;
    }
    __syncwarp();
  }

  GelfSel s;
  bool ambig = false;
  int ts_hi = 0, ts_lo = 0, ts_meta = 0;
  if (CARRIED) {
    s.pc = carried[0];
    s.flags = carried[1];
    s.full_a = carried[2];
    s.full_b = carried[3];
    s.host_a = carried[4];
    s.host_b = carried[5];
    s.lvl_a = carried[6];
    s.short_a = carried[7];
    s.short_b = carried[8];
    const int q = lane < F ? lane : 0;
    s.ns = carried[kSelRowG + 5 * q];
    s.ne = carried[kSelRowG + 5 * q + 1];
    s.vs = carried[kSelRowG + 5 * q + 2];
    s.ve = carried[kSelRowG + 5 * q + 3];
    s.vtus = carried[kSelRowG + 5 * q + 4];
  } else {
    // ---- special ids: the quoted names at the key's opening quote -------
    int spid = 0;
    if (jm) {
      const char* names[6] = {"timestamp", "host", "short_message",
                              "full_message", "version", "level"};
      const int nlen[6] = {9, 4, 13, 12, 7, 5};
      const int kopen = ks - 1;
      for (int id = 0; id < 6 && spid == 0; ++id) {
        bool m = at(kopen) == '"' && at(kopen + nlen[id] + 1) == '"';
        for (int i = 0; i < nlen[id] && m; ++i)
          m = at(kopen + 1 + i) == names[id][i];
        if (m) spid = id + 1;
      }
    }
    // ---- point bytes and span counts ---------------------------------------
    const int kfirst = at(ks);
    const int v0 = at(vs), v1 = at(vs + 1), v2 = at(vs + 2);
    const int vlast = at(ve - 1);
    int dots = 0, nondig = 0, fracc = 0;
    if (!ASM && lane < F) {
      const int a = vs < 0 ? 0 : (vs > in.L ? in.L : vs);
      const int b = ve < 0 ? 0 : (ve > in.L ? in.L : ve);
      if (ve > vs) {
        dots = mask_count(masks, a, b);
        nondig = mask_count(masks + 1, a, b);
        fracc = mask_count(masks + 2, a, b);
      }
    }
    if (!ASM) {
      dots = packed10<F>(dots, lane);
      nondig = packed10<F>(nondig, lane);
      fracc = packed10<F>(fracc, lane);
    }
    const int vln = ve - vs;

    // ---- specials: the (last) field of each, repeats ------------------------
    int last[7];
    bool rep = false;
#pragma unroll
    for (int id = 1; id <= 6; ++id) {
      const unsigned m = __ballot_sync(kFull, jm && spid == id);
      rep = rep || __popc(m) > 1;
      last[id] = m ? 31 - __clz((int)m) : -1;
    }
    auto get = [&](int id, int v) -> int {
      const int t = last[id];
      const int x = __shfl_sync(kFull, v, t < 0 ? 0 : t);
      return t < 0 ? 0 : x;
    };
    const bool has_ts = last[SP_TS] >= 0, has_host = last[SP_HOST] >= 0;
    const bool has_short = last[SP_SHORT] >= 0;
    const bool has_full = last[SP_FULL] >= 0, has_ver = last[SP_VER] >= 0;
    const bool has_lvl = last[SP_LVL] >= 0;
    s.host_a = get(SP_HOST, vs);
    s.host_b = get(SP_HOST, ve);
    s.full_a = get(SP_FULL, vs);
    s.full_b = get(SP_FULL, ve);
    s.short_a = get(SP_SHORT, vs);
    s.short_b = get(SP_SHORT, ve);
    s.lvl_a = get(SP_LVL, vs);
    s.flags = (has_full ? 1 : 0) | (has_lvl ? 2 : 0) | (has_short ? 4 : 0);

    // ---- pairs: validation, keys across lanes, bitonic sort ------------------
    const bool isp = jm && spid == 0;
    const bool str = vt == GV_STRING;
    bool pair_bad = false;
    if (!ASM) {
      const int neg = v0 == '-' ? 1 : 0;
      const bool int_ok = vt == GV_NUMBER && fracc == 0 && vln - neg <= 18 &&
                          canonical_number(vln, v0, v1, v2, vlast, dots,
                                           nondig) &&
                          !(v0 == '0' && vln > 1) && !(neg && v1 == '0');
      const bool p_ok = (str && vesc == 0) || vt == GV_TRUE ||
                        vt == GV_FALSE || vt == GV_NULL || int_ok;
      pair_bad = __ballot_sync(kFull, isp && !p_ok) != 0;
    }
    const unsigned pm = __ballot_sync(kFull, isp);
    s.pc = __popc(pm);
    const int us = kfirst == '_' ? 1 : 0;
    int hi = kBig, lo = kBig, nl = kBig, idx = lane;
    if (isp) {
      unsigned h = 0, l = 0;
      const int ns_k = ks + us;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int pos = ns_k + q;
        const unsigned z = pos < ke && pos < in.L ? (unsigned)at(pos) : 0u;
        if (q < 4)
          h |= z << (24 - 8 * q);
        else
          l |= z << (56 - 8 * q);
      }
      hi = static_cast<int>(h);
      lo = static_cast<int>(l);
      nl = ke - ns_k;
    }
#pragma unroll
    for (int kk = 2; kk <= F; kk <<= 1) {
#pragma unroll
      for (int j = kk >> 1; j > 0; j >>= 1) {
        const int oh = __shfl_xor_sync(kFull, hi, j);
        const int ol = __shfl_xor_sync(kFull, lo, j);
        const int on = __shfl_xor_sync(kFull, nl, j);
        const int oi = __shfl_xor_sync(kFull, idx, j);
        const bool keep_min = ((lane & j) == 0) == ((lane & kk) == 0);
        if (key_less(oh, ol, on, oi, hi, lo, nl, idx) == keep_min) {
          hi = oh;
          lo = ol;
          nl = on;
          idx = oi;
        }
      }
    }
    if (!ASM) {
      const int nh = __shfl_down_sync(kFull, hi, 1);
      const int nlo = __shfl_down_sync(kFull, lo, 1);
      const int nn = __shfl_down_sync(kFull, nl, 1);
      const bool keq = lane + 1 < F && hi == nh && lo == nlo && hi != kBig;
      ambig = __ballot_sync(kFull,
                            keq && (nl == nn || (nl > kAmbigLen &&
                                                 nn > kAmbigLen))) != 0;
    }
    // sorted slot `lane`: its pair's spans, by index
    const int src_lane = idx & 31;
    s.ns = __shfl_sync(kFull, ks, src_lane);
    s.ne = __shfl_sync(kFull, ke, src_lane);
    s.vs = __shfl_sync(kFull, vs, src_lane);
    s.ve = __shfl_sync(kFull, ve, src_lane);
    s.vtus = __shfl_sync(kFull, (vt & 7) | us << 3, src_lane);

    if (!ASM) {
      // ---- the tier rule of the specials ----------------------------------
      const int ts_a = get(SP_TS, vs), ts_ln = get(SP_TS, ve) - ts_a;
      const int ts_v0 = get(SP_TS, v0);
      bool ts_ok = has_ts && get(SP_TS, vt) == GV_NUMBER &&
                   canonical_number(ts_ln, ts_v0, get(SP_TS, v1),
                                    get(SP_TS, v2), get(SP_TS, vlast),
                                    get(SP_TS, dots), get(SP_TS, nondig)) &&
                   ts_ln <= kTsSpan;
      const bool host_ok = has_host && get(SP_HOST, vt) == GV_STRING &&
                           get(SP_HOST, vesc) == 0;
      const bool short_ok = !has_short || (get(SP_SHORT, vt) == GV_STRING &&
                                           get(SP_SHORT, vesc) == 0);
      const bool full_ok = !has_full || (get(SP_FULL, vt) == GV_STRING &&
                                         get(SP_FULL, vesc) == 0);
      const int ver_v2 = get(SP_VER, v2);
      const bool ver_ok =
          !has_ver || (get(SP_VER, vt) == GV_STRING &&
                       get(SP_VER, vesc) == 0 && get(SP_VER, vln) == 3 &&
                       get(SP_VER, v0) == '1' && get(SP_VER, v1) == '.' &&
                       (ver_v2 == '0' || ver_v2 == '1'));
      const int lvl_v0 = get(SP_LVL, v0);
      const bool lvl_ok = !has_lvl || (get(SP_LVL, vt) == GV_NUMBER &&
                                       get(SP_LVL, vln) == 1 &&
                                       lvl_v0 >= '0' && lvl_v0 <= '7');
      // ---- the timestamp's exact split-integer parse (<= 24 bytes) ------
      if (ts_ok) {
        const int neg = ts_v0 == '-' ? 1 : 0;
        const int r = lane;
        const int b = r < ts_ln ? at(ts_a + r) : 0;
        const unsigned dm = __ballot_sync(kFull, r < ts_ln && b == '.');
        const int dot_r = dm ? __ffs((int)dm) - 1 : 1 << 20;
        const int has_dot = get(SP_TS, dots) == 1 ? 1 : 0;
        const int nd = ts_ln - neg - has_dot;
        const int frac = has_dot ? ts_ln - 1 - dot_r : 0;
        const bool dig = r < ts_ln && b >= '0' && b <= '9' && r >= neg &&
                         r != dot_r;
        const int place = nd - 1 - (r - neg - (r > dot_r ? 1 : 0));
        unsigned p10 = 1;
        const int e = place >= 9 ? place - 9 : place;
        for (int q = 0; q < e && q < 8; ++q) p10 *= 10u;
        const unsigned d = dig ? (unsigned)(b - '0') : 0u;
        const unsigned lo_c = place >= 0 && place <= 8 ? d * p10 : 0u;
        const unsigned hi_c = place >= 9 && place <= 17 ? d * p10 : 0u;
        ts_lo = (int)__reduce_add_sync(kFull, lo_c);
        ts_hi = (int)__reduce_add_sync(kFull, hi_c);
        ts_meta = (frac < 0 ? 0 : (frac > 255 ? 255 : frac)) |
                  (nd < 0 ? 0 : (nd > 255 ? 255 : nd)) << 8 | neg << 16;
        const bool f16 = ts_hi < 9007199 ||
                         (ts_hi == 9007199 && ts_lo <= 254740992);
        ts_ok = nd <= 15 || (nd == 16 && f16);
      }
      if (rep || !ts_ok || !host_ok || !short_ok || !full_ok || !ver_ok ||
          !lvl_ok || pair_bad || ambig) {
        reject();
        return;
      }
    }
  }

  // ---- the segments --------------------------------------------------------
  const bool has_full = s.flags & 1, has_lvl = s.flags & 2;
  const bool has_short = s.flags & 4;
  int f_src = 0, f_len = 0;
  auto cst = [&](int id, bool gate) {
    f_src = EW + k.off[id];
    f_len = gate ? k.len[id] : 0;
  };
  switch (lane) {
    case J_FULL_C: cst(KG_FULL, has_full); break;
    case J_FULL:
      f_src = s.full_a;
      f_len = has_full ? s.full_b - s.full_a : 0;
      break;
    case J_QC1: cst(KG_QC, has_full); break;
    case J_HOST_C: cst(KG_HOST, true); break;
    case J_HOST:
      if (s.host_b - s.host_a <= 0) {
        cst(KG_UNKNOWN, true);
      } else {
        f_src = s.host_a;
        f_len = s.host_b - s.host_a;
      }
      break;
    case J_QC2: cst(KG_QC, true); break;
    case J_LVL_C: cst(KG_LVL, has_lvl); break;
    case J_LVL:
      f_src = s.lvl_a;
      f_len = has_lvl ? 1 : 0;
      break;
    case J_COMMA:
      f_src = EW + k.off[KG_QC] + 1;
      f_len = has_lvl ? 1 : 0;
      break;
    case J_SHORT_C: cst(KG_SHORT, true); break;
    case J_SHORT:
      if (has_short) {
        f_src = s.short_a;
        f_len = s.short_b - s.short_a;
      } else {
        cst(KG_DASH, true);
      }
      break;
    case J_QC3: cst(KG_QC, true); break;
    case J_TS:
      f_src = ts_at;
      f_len = ASM ? in.ts_len : 0;
      break;
    default: break;                      // lanes past the fixed segments
  }
  // sorted pair `lane`: '"' or '"_', name, '":"' or '":', value, '",' or ','
  const bool pv = lane < F && lane < s.pc;
  const int pvt = s.vtus & 7;
  const bool pus = (s.vtus >> 3) & 1, pstr = pvt == GV_STRING;
  const bool span = pstr || pvt == GV_NUMBER;
  const int n_len = pv ? s.ne - s.ns : 0;
  const int v_len = !pv ? 0 : span ? s.ve - s.vs : pvt == GV_FALSE ? 5 : 4;
  const int pair_len =
      pv ? (pus ? 1 : 2) + n_len + (pstr ? 3 : 2) + v_len + (pstr ? 2 : 1)
         : 0;

  if (!ASM) {
    const int total = (int)__reduce_add_sync(kFull, pair_len + f_len);
    if (lane == 0) {
      *out.tier = 1;
      *out.base_len = total;
      if (small.p != nullptr) store_small_gg(small, row, ts_hi, ts_lo,
                                             ts_meta);
    }
    if (carry_out != nullptr) {
      // the selection of a base tier row, one run of kCarryG int32
      if (lane < kSelRowG)
        carry_out[lane] = lane == 0 ? s.pc : lane == 1 ? s.flags
                          : lane == 2 ? s.full_a : lane == 3 ? s.full_b
                          : lane == 4 ? s.host_a : lane == 5 ? s.host_b
                          : lane == 6 ? s.lvl_a : lane == 7 ? s.short_a
                          : s.short_b;
      if (lane < F) {
        int32_t* cp = carry_out + kSelRowG + 5 * lane;
        cp[0] = pv ? s.ns : 0;
        cp[1] = pv ? s.ne : 0;
        cp[2] = pv ? s.vs : 0;
        cp[3] = pv ? s.ve : 0;
        cp[4] = pv ? s.vtus : 0;
      }
    }
    return;
  }
  // pair `lane`'s five segments, in the order above
  auto pair_seg = [&](int i, int& src, int& len) {
    switch (i) {
      case 0: src = EW + k.off[KG_KPRE]; len = pv ? (pus ? 1 : 2) : 0; break;
      case 1: src = s.ns; len = n_len; break;
      case 2: src = EW + k.off[KG_COLON]; len = pv ? (pstr ? 3 : 2) : 0; break;
      case 3:
        src = span ? s.vs
                   : EW + k.off[pvt == GV_TRUE    ? KG_TRUE
                                : pvt == GV_FALSE ? KG_FALSE
                                                  : KG_NULL];
        len = v_len;
        break;
      default:
        src = EW + k.off[KG_QC] + (pstr ? 0 : 1);
        len = pv ? (pstr ? 2 : 1) : 0;
        break;
    }
  };
  assemble_row<F, kFixedG>(pair_len, pair_seg, f_src, f_len, base, sm, rowb,
                           ts_at + kTsW - 1, in.OW, out.dst, lane);
}

}  // namespace enc
