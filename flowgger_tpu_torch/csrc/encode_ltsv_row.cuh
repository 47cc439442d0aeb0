// The LTSV -> GELF row encode of kernel EL, one warp a row: the device
// function shared by encode_gelf.cu (the split tier, reading L1's [C, N]
// channels) and fused_gelf.cu (FL: its probe reads the block's channel
// tile, its assemble the channels the probe carried).  The design notes
// are at the top of encode_gelf.cu.
//
// It reuses E1's pieces (encode_gelf_row.cuh): the escape pass, the
// 8-byte key bitonic sort across lanes with its ambiguity test, and the
// staged assemble; what is the ltsv tier's own is the pair selection over
// the part axis (device_ltsv.py:151-177), the repeated-special-name screen
// at part starts (:143-149), the stamp gate and the segment table
// (:211-264, elide=True).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_ltsv_row.cuh"
#include "encode_gelf_row.cuh"

namespace enc {

// the bank constants a row reads (device_ltsv.KERNEL_CONSTS)
enum ConstLtsv {
  KL_P0, KL_P1, KL_P2, KL_FULL, KL_HOST, KL_HL, KL_LEVEL, KL_SEVD, KL_L2A,
  KL_L2B, KL_SHORT_L, KL_SHORT, KL_DASH, KL_UNKNOWN, kNumConstL
};
using ConstsL = ConstTable<kNumConstL>;

// The fixed segments, in output order, one a lane (device_ltsv.
// encode_rows builds the same list): the whole escaped line as
// full_message, the host span (or "unknown"), the level pair gated on a
// level, the short_message constant picked by it, the message span in
// quotes (or "-"), the timestamp text.
enum FixedLtsv {
  H_FULL_C, H_FULL, H_HOST_C, H_HOST, H_HL_C, H_LEVEL_C, H_SEV, H_L2_C,
  H_SHORT_C, H_Q1, H_MSG, H_Q2, H_TS, kFixedL
};

__host__ __device__ constexpr int segments_ltsv(int P) {
  return 5 * P + kFixedL;
}

// What the assemble reads after pair selection and the sort: the row's
// values (every lane) and, in lane p, sorted pair p's escaped spans (0
// past the pair count).  FL's probe carries it to its assemble as
// kCarryL int32 a row: the seven row values, then ns, ne, vs, ve of each
// of the 6 pairs (fused_routes.carried_columns).
struct LtsvSel {
  int pc, host_s, host_e, msg_s, msg_e, has_msg, level;
  int ns, ne, vs, ve;
};
constexpr int kSelRow = 7;
constexpr int kCarryL = kSelRow + 4 * 6;

// The probes' narrowed stamp channels, one byte buffer of kSmallBytes a
// row for N rows (the reference fused program's narrowed probe outputs,
// fused_routes._fused_ltsv_gelf): int32 days, sod, nanos, ts_hi, ts_lo
// [5, N] at 0, int16 off / 60 [N] at 20 N (offsets are whole minutes),
// uint8 ok, ts_kind, ts_meta & 255 [3, N] at 22 N
// (device_ltsv.small_pack lays out the same).
constexpr int kSmallBytes = 25;
struct SmallL {
  uint8_t* p;
  int N;
};

__device__ __forceinline__ void store_small_ltsv(const SmallL& s, int row,
                                                 int ok, int kind, int days,
                                                 int sod, int off, int nanos,
                                                 int hi, int lo, int meta) {
  const size_t N = (size_t)s.N;
  int32_t* i32 = reinterpret_cast<int32_t*>(s.p);
  i32[row] = days;
  i32[N + row] = sod;
  i32[2 * N + row] = nanos;
  i32[3 * N + row] = hi;
  i32[4 * N + row] = lo;
  reinterpret_cast<int16_t*>(s.p + 20 * N)[row] =
      static_cast<int16_t>(off / 60);
  uint8_t* u8 = s.p + 22 * N;
  u8[row] = static_cast<uint8_t>(ok);
  u8[N + row] = static_cast<uint8_t>(kind);
  u8[2 * N + row] = static_cast<uint8_t>(meta & 255);
}

// CARRIED: the selection comes from `carried` (FL's assemble), not from
// channels.  STAGED: the row's valid bytes are already at the start of
// `base` (FL's probe: L1's row decode staged them).  carry_out (FL's
// probe): where a base tier row's selection is written.  small (the
// probes): where row `row`'s narrowed stamp channels go.
template <int P, bool ASM, bool STAGED = false, bool CARRIED = false>
__device__ __forceinline__ void encode_ltsv_row(
    const ChanView& C, const int32_t* __restrict__ carried, const RowIn& in,
    const ConstsL& k, uint8_t* base, RowOut out, int lane,
    int32_t* __restrict__ carry_out = nullptr, SmallL small = {nullptr, 0},
    int row = 0) {
  constexpr int W = P <= 8 ? 8 : 16;     // lanes of the sorting network
  static_assert(P <= W && W <= 16 && (!CARRIED || P == 6),
                "encode_ltsv sorts at most 16 pairs; FL carries 6");
  constexpr int S = segments_ltsv(P);

  // ---- the channels: pair selection over the part axis -------------------
  int pc = 0, ns_r = 0, ne_r = 0, vs_r = 0, ve_r = 0, ps_j = -1;
  int host_sr = 0, host_er = 0, msg_sr = 0, msg_er = 0, level = -1;
  bool has_msg = false;
  int np = 0;
  if (!CARRIED) {
    np = C(lt::C_N_PARTS);
    const int sp0 = C(lt::C_TIME_POS), sp1 = C(lt::C_HOST_POS);
    const int sp2 = C(lt::C_MSG_POS), sp3 = C(lt::C_LEVEL_POS);
    bool isp = false, cl = false;
    if (lane < lt::kParts && lane < np) {
      ps_j = C(lt::C_PART_START + lane);
      cl = C(lt::C_COLON + lane) < 0;
      isp = !((sp0 >= 0 && ps_j == sp0) || (sp1 >= 0 && ps_j == sp1) ||
              (sp2 >= 0 && ps_j == sp2) || (sp3 >= 0 && ps_j == sp3));
    }
    const unsigned pm = __ballot_sync(kFull, isp);
    pc = __popc(pm);
    if (!ASM) {
      // the tier's gates on the channels alone: ok (24 parts at most, time
      // and host present, level and stamp parsed), ASCII, the stamp
      // forms the tier formats, no colon-less part, at most P pairs
      const int kind = C(lt::C_TS_KIND), meta = C(lt::C_TS_META);
      const int hi = C(lt::C_TS_HI), lo = C(lt::C_TS_LO);
      if (small.p != nullptr && lane == 0)
        store_small_ltsv(small, row, C(lt::C_OK), kind, C(lt::C_DAYS),
                         C(lt::C_SOD), C(lt::C_OFF), C(lt::C_NANOS), hi, lo,
                         meta);
      const int ndig = (meta >> 8) & 255;
      const bool f16 = hi < 9007199 || (hi == 9007199 && lo <= 254740992);
      const bool float_dev = kind == 1 && ((meta >> 16) & 1) == 0 &&
                             (ndig <= 15 || (ndig == 16 && f16));
      const bool colonless = __ballot_sync(kFull, cl) != 0;
      if (C(lt::C_OK) == 0 || C(lt::C_HAS_HIGH) != 0 ||
          !(kind == 0 || float_dev) || sp1 < 0 || colonless || pc > P) {
        if (lane == 0) {
          *out.tier = 0;
          *out.base_len = 0;
        }
        return;
      }
    }
    if (lane < P && lane < pc) {
      const int j = nth_set_bit(pm, lane);
      ns_r = C(lt::C_PART_START + j);
      ne_r = C(lt::C_COLON + j);
      vs_r = ne_r + 1;
      ve_r = C(lt::C_PART_END + j);
    }
    host_sr = C(lt::C_HOST_S);
    host_er = C(lt::C_HOST_E);
    msg_sr = C(lt::C_MSG_S);
    msg_er = C(lt::C_MSG_E);
    has_msg = C(lt::C_MSG_POS) >= 0;
    level = C(lt::C_LEVEL_VAL);
  }

  // ---- stage the row, escape scan ---------------------------------------
  const WarpSmem sm = warp_smem(in.L, in.OW, S, ASM, in.bank_len);
  uint8_t* rowb = base + sm.row;
  uint32_t* etab = reinterpret_cast<uint32_t*>(base + sm.etab);
  uint8_t* srcb = base + sm.src;
  const int EW = in.L + kECap, ts_at = EW + in.bank_len;
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  const EscOut es = escape_stage<ASM, STAGED>(in.src, in.vec, vlen, rowb, etab,
                                              srcb, EW, lane);
  const int ne_total = es.ne_total;
  if (ASM) stage_sources(srcb, EW, in.bank, in.bank_len, in.ts_text, lane);
  __syncwarp();
  const Dmap dmap{etab, vlen, ne_total};
  auto byte_at = [&](int p) -> unsigned {
    return (p >= 0 && p < vlen) ? rowb[p] : 0u;
  };

  LtsvSel s;
  bool ambig = false, rep_special = false;
  if (CARRIED) {
    s.pc = carried[0];
    s.host_s = carried[1];
    s.host_e = carried[2];
    s.msg_s = carried[3];
    s.msg_e = carried[4];
    s.has_msg = carried[5];
    s.level = carried[6];
    const int q = lane < 6 ? lane : 0;
    s.ns = carried[kSelRow + 4 * q];
    s.ne = carried[kSelRow + 4 * q + 1];
    s.vs = carried[kSelRow + 4 * q + 2];
    s.ve = carried[kSelRow + 4 * q + 3];
  } else {
    if (!ASM) {
      // a special name at more than one part start (every part start is
      // in the table: ok holds at most 24 parts)
      const char* keys[4] = {"time:", "host:", "message:", "level:"};
      const int klen[4] = {5, 5, 8, 6};
      for (int kk = 0; kk < 4; ++kk) {
        bool m = ps_j >= 0;
        for (int q = 0; q < klen[kk] && m; ++q)
          m = byte_at(ps_j + q) == (unsigned)keys[kk][q];
        rep_special = rep_special || __popc(__ballot_sync(kFull, m)) > 1;
      }
    }
    // ---- pairs: keys across lanes, bitonic sort, ambiguity -------------
    const bool pv_own = lane < P && lane < pc;
    int hi = kBig, lo = kBig, nl = kBig, idx = lane;
    if (pv_own) {
      unsigned h = 0, l = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int pos = ns_r + q;
        const unsigned z = pos < ne_r ? byte_at(pos) : 0u;
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
      const bool keq = lane + 1 < W && hi == nh && lo == nlo && hi != kBig;
      ambig = __ballot_sync(kFull,
                            keq && (nl == nn || (nl > kAmbigLen &&
                                                 nn > kAmbigLen))) != 0;
    }
    // sorted slot `lane`: its pair's escaped spans, by index
    const int src_lane = idx & 31;
    s.ns = __shfl_sync(kFull, ns_e, src_lane);
    s.ne = __shfl_sync(kFull, ne_e, src_lane);
    s.vs = __shfl_sync(kFull, vs_e, src_lane);
    s.ve = __shfl_sync(kFull, ve_e, src_lane);
    s.pc = pc;
    s.host_s = dmap(host_sr);
    s.host_e = dmap(host_er);
    s.msg_s = dmap(msg_sr);
    s.msg_e = dmap(msg_er);
    s.has_msg = has_msg ? 1 : 0;
    s.level = level;
  }

  // ---- the segments ------------------------------------------------------
  const bool has_level = s.level >= 0, hmsg = s.has_msg != 0;
  const int qsrc = EW + k.off[KL_P1] + 2;  // a '"' inside the '":"' const
  int f_src = 0, f_len = 0;
  auto cst = [&](int id, bool gate) {
    f_src = EW + k.off[id];
    f_len = gate ? k.len[id] : 0;
  };
  switch (lane) {
    case H_FULL_C: cst(KL_FULL, true); break;
    case H_FULL: f_len = in.len + ne_total; break;
    case H_HOST_C: cst(KL_HOST, true); break;
    case H_HOST:
      if (s.host_e <= s.host_s) {
        cst(KL_UNKNOWN, true);
      } else {
        f_src = s.host_s;
        f_len = s.host_e - s.host_s;
      }
      break;
    case H_HL_C: cst(KL_HL, true); break;
    case H_LEVEL_C: cst(KL_LEVEL, has_level); break;
    case H_SEV:
      f_src = EW + k.off[KL_SEVD] + (s.level > 0 ? s.level : 0);
      f_len = has_level ? 1 : 0;
      break;
    // the after-number or the string-close variant (constant indices,
    // so the table stays in the parameter space)
    case H_L2_C:
      if (has_level) cst(KL_L2A, true); else cst(KL_L2B, true);
      break;
    case H_SHORT_C:
      if (has_level) cst(KL_SHORT_L, true); else cst(KL_SHORT, true);
      break;
    case H_Q1:
      if (hmsg) {
        f_src = qsrc;
        f_len = 1;
      } else {
        cst(KL_DASH, true);
      }
      break;
    case H_MSG:
      f_src = s.msg_s;
      f_len = hmsg ? s.msg_e - s.msg_s : 0;
      break;
    case H_Q2:
      f_src = qsrc;
      f_len = hmsg ? 1 : 0;
      break;
    case H_TS:
      f_src = ts_at;
      f_len = ASM ? in.ts_len : 0;
      break;
    default: break;                      // lanes past the fixed segments
  }
  const int p0 = k.len[KL_P0], p1 = k.len[KL_P1], p2 = k.len[KL_P2];
  // sorted pair `lane`: p0, name, p1, value, p2
  const bool pv = lane < P && lane < s.pc;
  const int n_len = pv ? s.ne - s.ns : 0;
  const int v_len = pv ? s.ve - s.vs : 0;
  const int pair_len = pv ? p0 + n_len + p1 + v_len + p2 : 0;

  if (!ASM) {
    const int total = (int)__reduce_add_sync(kFull, pair_len + f_len);
    const bool tier = !es.bad_any && ne_total <= kECap && !rep_special &&
                      !ambig;
    if (lane == 0) {
      *out.tier = tier ? 1 : 0;
      *out.base_len = tier ? total : 0;
    }
    if (carry_out != nullptr && tier) {
      // the selection of a base tier row, one run of kCarryL int32
      if (lane < kSelRow)
        carry_out[lane] = lane == 0 ? s.pc : lane == 1 ? s.host_s
                          : lane == 2 ? s.host_e : lane == 3 ? s.msg_s
                          : lane == 4 ? s.msg_e : lane == 5 ? s.has_msg
                          : s.level;
      if (lane < 6) {
        int32_t* cp = carry_out + kSelRow + 4 * lane;
        cp[0] = pv ? s.ns : 0;
        cp[1] = pv ? s.ne : 0;
        cp[2] = pv ? s.vs : 0;
        cp[3] = pv ? s.ve : 0;
      }
    }
    return;
  }
  // pair `lane`'s five segments, in the order above
  auto pair_seg = [&](int i, int& src, int& len) {
    switch (i) {
      case 0: src = EW + k.off[KL_P0]; len = pv ? p0 : 0; break;
      case 1: src = s.ns; len = n_len; break;
      case 2: src = EW + k.off[KL_P1]; len = pv ? p1 : 0; break;
      case 3: src = s.vs; len = v_len; break;
      default: src = EW + k.off[KL_P2]; len = pv ? p2 : 0; break;
    }
  };
  assemble_row<P, kFixedL>(pair_len, pair_seg, f_src, f_len, base, sm, srcb,
                           ts_at + kTsW - 1, in.OW, out.dst, lane);
}

}  // namespace enc
