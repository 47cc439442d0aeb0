// The rfc5424 -> LTSV row encode of kernel OL, one warp a row: the device
// function shared by encode_ltsv_out.cu (the split tier, channels in the
// decode's [C, N] output) and fused_ltsv_out.cu (FO/ltsv, channels in the
// block's tile).  The design notes are at the top of encode_ltsv_out.cu.
//
// There is no escape stage: the tier takes only rows whose spans re-emit
// verbatim, so the sources of a row's segments are its raw staged bytes
// and the constant bank.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_gelf_row.cuh"
#include "warp_common.cuh"

namespace olt {

using namespace fg;
using enc::ChanView;
using enc::ConstTable;
using enc::WarpSmem;

constexpr int kPairs = 6;                // the tier reads K1's 6-pair decode
constexpr int kMaxSd = enc::kMaxSd;

// channel rows of the rfc5424 decode's packed output (_KEYS_1D order)
enum ChO {
  C_OK = 0, C_FACILITY = 2, C_SEVERITY = 3, C_HOST_S = 8, C_HOST_E = 9,
  C_APP_S = 10, C_APP_E = 11, C_PROC_S = 12, C_PROC_E = 13, C_MSGID_S = 14,
  C_MSGID_E = 15, C_PAIR_COUNT = 18, C_FULL_START = 19, C_TRIM_END = 20,
  C_MSG_TRIM_START = 21, C_HAS_HIGH = 22, kN1D = 23,
  // the first pair channel: name_start, then name_end, val_start,
  // val_end, pair_sd and val_has_esc, kPairs rows each
  C_PAIR0 = kN1D + 2 * kMaxSd
};

// the bank constants a row reads (device_ltsv_out.KERNEL_CONSTS)
enum ConstO {
  K_COL, K_TAB, K_EXTRA, K_HOST, K_MSGL, K_LVL, K_FAC, K_APP, K_PROC,
  K_MSGID, K_DEC, kNumConstO
};
using ConstsO = ConstTable<kNumConstO>;

// The fixed segments, in output order, one a lane (device_ltsv_out.
// encode_rows builds the same list); "\ttime:<stamp>", "\tfull_message:"
// and the suffix are elided.
enum FixedO {
  F_EXTRA, F_HOST_C, F_HOST, F_MSG_C, F_MSG, F_FULL, F_LVL_C, F_SEV,
  F_FAC_C, F_FAC10, F_FAC1, F_APP_C, F_APP, F_PROC_C, F_PROC, F_MSGID_C,
  F_MSGID, kFixedO
};

// segments of a row: five a pair lane (name, ':', value, '\t' and an
// empty one: enc::assemble_row's pair shape), then the fixed ones
constexpr int kSegs = 5 * kPairs + kFixedO;

// Shared memory of one warp: the staged row (its raw bytes at their
// offsets) and, for the assemble, the bank right after it (at
// round16(L)), the segment table and the output row with room for its
// 16-byte skew.
__host__ __device__ inline WarpSmem ol_smem(int L, int OW, bool asm_mode,
                                            int bank_len) {
  WarpSmem s;
  s.row = 0;
  s.src = 0;
  s.etab = 0;
  s.seg = round16(L) + (asm_mode ? round16(bank_len) : 0);
  s.out = s.seg + (asm_mode ? round16(8 * kSegs) : 0);
  s.stride = s.out + (asm_mode ? round16(OW) + 16 : 0);
  return s;
}

// Where a row's encode writes: the probe's tier bit, elided length and
// gaps (gap0 at gaps[0], gap1 at gaps[gap_stride]), or the assemble's
// destination.
struct RowOutO {
  uint8_t* tier;
  int32_t* base_len;
  int32_t* gaps;
  int gap_stride;
  uint8_t* dst;
};

// What a row's encode reads besides its channels.
struct RowInO {
  const uint8_t* src;                    // the row in global memory
  bool vec;                              // 16-byte loads of src
  int len, L, OW;
  const uint8_t* bank;
  int bank_len;
};

__device__ __forceinline__ void probe_out(const RowOutO& out, bool tier,
                                          int len, int gap0, int gap1) {
  *out.tier = tier ? 1 : 0;
  *out.base_len = tier ? len : 0;
  out.gaps[0] = tier ? gap0 : 0;
  out.gaps[out.gap_stride] = tier ? gap1 : 0;
}

// STAGED: the row's valid bytes are already at the start of `base` (a
// fused route's decode staged them), so in.src is not read.
template <bool ASM, bool STAGED = false>
__device__ __forceinline__ void encode_ltsv_out_row(const ChanView& C,
                                                    const RowInO& in,
                                                    const ConstsO& k,
                                                    uint8_t* base,
                                                    RowOutO out, int lane) {
  const int ok = C(C_OK), high = C(C_HAS_HIGH), pc = C(C_PAIR_COUNT);
  if (!ASM && (ok == 0 || high != 0 || pc > kPairs)) {
    // outside the tier on its channels alone
    if (lane == 0) probe_out(out, false, 0, 0, 0);
    return;
  }
  // lane p: pair p's spans and escape flag
  const bool pv = lane < kPairs && lane < pc;
  int ns = 0, ne = 0, vs = 0, ve = 0, vesc = 0;
  if (pv) {
    ns = C(C_PAIR0 + lane);
    ne = C(C_PAIR0 + kPairs + lane);
    vs = C(C_PAIR0 + 2 * kPairs + lane);
    ve = C(C_PAIR0 + 3 * kPairs + lane);
    if (!ASM) vesc = C(C_PAIR0 + 5 * kPairs + lane);
  }
  // lane f: fixed segment f's channel span
  int cs = -1, ce = -1;
  switch (lane) {
    case F_HOST: cs = C_HOST_S; ce = C_HOST_E; break;
    case F_MSG: cs = C_MSG_TRIM_START; ce = C_TRIM_END; break;
    case F_FULL: cs = C_FULL_START; ce = C_TRIM_END; break;
    case F_SEV: cs = C_SEVERITY; break;
    case F_FAC10: case F_FAC1: cs = C_FACILITY; break;
    case F_APP: cs = C_APP_S; ce = C_APP_E; break;
    case F_PROC: cs = C_PROC_S; ce = C_PROC_E; break;
    case F_MSGID: cs = C_MSGID_S; ce = C_MSGID_E; break;
    default: break;
  }
  const int fs = cs >= 0 ? C(cs) : 0, fe = ce >= 0 ? C(ce) : 0;
  // the message's presence, for its label (lane F_MSG_C)
  const int msg_l = __shfl_sync(kFull, fe > fs ? fe - fs : 0, F_MSG);

  // ---- stage the row -----------------------------------------------------
  const WarpSmem sm = ol_smem(in.L, in.OW, ASM, in.bank_len);
  uint8_t* rowb = base + sm.row;
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  if (!STAGED) stage_row(in.src, vlen, in.L, reinterpret_cast<uint4*>(rowb),
                         lane);
  const int RB = round16(in.L);          // the bank's offset in the sources
  if (ASM)
    for (int i = lane; i < in.bank_len; i += 32) rowb[RB + i] = in.bank[i];
  __syncwarp();

  // ---- the segments ------------------------------------------------------
  int f_src = fs, f_len = fe > fs ? fe - fs : 0;
  auto cst = [&](int id, bool gate) {
    f_src = RB + k.off[id];
    f_len = gate ? k.len[id] : 0;
  };
  switch (lane) {
    case F_EXTRA: cst(K_EXTRA, true); break;
    case F_HOST_C: cst(K_HOST, true); break;
    case F_MSG_C: cst(K_MSGL, msg_l > 0); break;
    case F_LVL_C: cst(K_LVL, true); break;
    case F_SEV:
      f_src = RB + k.off[K_DEC] + fs;
      f_len = 1;
      break;
    case F_FAC_C: cst(K_FAC, true); break;
    case F_FAC10:
      f_src = RB + k.off[K_DEC] + (fs / 10) % 10;
      f_len = fs >= 10 ? 1 : 0;
      break;
    case F_FAC1:
      f_src = RB + k.off[K_DEC] + fs % 10;
      f_len = 1;
      break;
    case F_APP_C: cst(K_APP, true); break;
    case F_PROC_C: cst(K_PROC, true); break;
    case F_MSGID_C: cst(K_MSGID, true); break;
    case F_HOST: case F_MSG: case F_FULL: case F_APP: case F_PROC:
    case F_MSGID: break;
    default: f_len = 0; break;           // lanes past the fixed segments
  }
  const int n_len = pv && ne > ns ? ne - ns : 0;
  const int v_len = pv && ve > vs ? ve - vs : 0;
  const int pair_len = pv ? n_len + v_len + 2 : 0;

  if (!ASM) {
    // the screens: a tab or newline among the valid bytes, a ':' in an SD
    // name, an SD value with a backslash
    bool esc = false;
    for (int j0 = 16 * lane; j0 < vlen; j0 += 16 * 32) {
      const int m = vlen - j0 < 16 ? vlen - j0 : 16;
      for (int i = 0; i < m; ++i) {
        const int b = rowb[j0 + i];
        esc |= b == 9 || b == 10;
      }
    }
    bool colon = false;
    for (int p = ns; pv && p < ne; ++p) colon |= rowb[p] == ':';
    const bool tier = !warp_any(esc) && !warp_any(colon) &&
                      !warp_any(vesc != 0);
    const int pairs_total = (int)__reduce_add_sync(kFull, (unsigned)pair_len);
    const int head = (int)__reduce_add_sync(
        kFull, (unsigned)(lane <= F_HOST ? f_len : 0));
    const int to_full = (int)__reduce_add_sync(
        kFull, (unsigned)(lane <= F_MSG ? f_len : 0));
    const int total = (int)__reduce_add_sync(
        kFull, (unsigned)(pair_len + f_len));
    if (lane == 0)
      probe_out(out, tier, total, pairs_total + head,
                pairs_total + to_full);
    return;
  }
  const int cl = k.len[K_COL], tl = k.len[K_TAB];
  // pair `lane`'s five segments: name, ':', value, '\t', none
  auto pair_seg = [&](int i, int& src, int& len) {
    switch (i) {
      case 0: src = ns; len = n_len; break;
      case 1: src = RB + k.off[K_COL]; len = pv ? cl : 0; break;
      case 2: src = vs; len = v_len; break;
      case 3: src = RB + k.off[K_TAB]; len = pv ? tl : 0; break;
      default: src = 0; len = 0; break;
    }
  };
  enc::assemble_row<kPairs, kFixedO>(pair_len, pair_seg, f_src, f_len, base,
                                     sm, rowb, RB + in.bank_len - 1, in.OW,
                                     out.dst, lane);
}

}  // namespace olt
