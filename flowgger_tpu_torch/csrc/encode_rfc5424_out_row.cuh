// The -> RFC5424 row encodes of kernels O5 (rfc5424 input) and O5/3164
// (rfc3164 input), one warp a row: the device functions shared by
// encode_rfc5424_out.cu (the split tier, channels in the decode's [C, N]
// output) and fused_rfc5424_out.cu (FO/r5, channels in the block's tile).
// The design notes are at the top of encode_rfc5424_out.cu.
//
// RFC5424 output never escapes: the sources of a row's segments are its
// raw staged bytes and the constant bank.  Both probes read channels
// only (the tier screens and the lengths are channel arithmetic), so
// only the assembles stage the row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_rfc3164_row.cuh"
#include "encode_gelf_row.cuh"
#include "warp_common.cuh"

namespace r5o {

using namespace fg;
using enc::ChanView;
using enc::ConstTable;

constexpr int kPairs = 6;                // the tier reads K1's 6-pair decode
constexpr int kMaxSd = enc::kMaxSd;      // and its 4 SD blocks

// channel rows of the rfc5424 decode's packed output (_KEYS_1D order,
// then sid_start and sid_end kMaxSd rows each, then name_start,
// name_end, val_start, val_end, pair_sd and val_has_esc kPairs rows each)
enum ChR {
  C_OK = 0, C_FACILITY = 2, C_SEVERITY = 3, C_HOST_S = 8, C_HOST_E = 9,
  C_APP_S = 10, C_APP_E = 11, C_PROC_S = 12, C_PROC_E = 13, C_MSGID_S = 14,
  C_MSGID_E = 15, C_SD_COUNT = 17, C_PAIR_COUNT = 18, C_TRIM_END = 20,
  C_MSG_TRIM_START = 21, C_HAS_HIGH = 22, kN1D = 23,
  C_SID_S = kN1D, C_SID_E = kN1D + kMaxSd, C_PAIR0 = kN1D + 2 * kMaxSd,
  C_NAME_S = C_PAIR0, C_NAME_E = C_PAIR0 + kPairs,
  C_VAL_S = C_PAIR0 + 2 * kPairs, C_VAL_E = C_PAIR0 + 3 * kPairs,
  C_PAIR_SD = C_PAIR0 + 4 * kPairs, C_VAL_ESC = C_PAIR0 + 5 * kPairs
};

// the bank constants a row reads (device_rfc5424_out.KERNEL_CONSTS)
enum ConstR { K_SP, K_EQQ, K_Q, K_LB, K_RB, K_DASH, kNumConstR };
using ConstsR = ConstTable<kNumConstR>;

// segments of an rfc5424 row, in output order: host ' ' app ' ' proc ' '
// msgid ' ' (8), '-' (1), per SD block '[' sid ... ']' (3), per pair
// ' ' name '="' value '"' (5), ' ' msg (2)
constexpr int kSegs = 8 + 1 + 3 * kMaxSd + 5 * kPairs + 2;

// Shared memory of one warp (assemble): the staged row (its raw bytes at
// their offsets), the bank right after it (at round16(L)), the segment
// table (end, source - destination) and the output row with room for
// its 16-byte skew.  A probe needs none: 16 bytes keep the launch
// geometry's division whole.
struct R5Smem {
  int seg, out, stride;
};
__host__ __device__ inline R5Smem r5_smem(int L, int OW, bool asm_mode,
                                          int bank_len, int segs) {
  R5Smem s;
  s.seg = round16(L) + round16(bank_len);
  s.out = s.seg + round16(8 * segs);
  s.stride = asm_mode ? s.out + round16(OW) + 16 : 16;
  return s;
}

// Where a row's encode writes: the probe's tier bit, elided length and
// small channels (fac8 at small8[0], sev8 at small8[stride], pri1 at
// small8[2 * stride]; the rfc3164 leg's host length at *hostl16), or the
// assemble's destination.
struct RowOutR {
  uint8_t* tier;
  int32_t* base_len;
  uint8_t* small8;
  int small_stride;
  uint16_t* hostl16;
  uint8_t* dst;
};

// What a row's encode reads besides its channels.
struct RowInR {
  const uint8_t* src;                    // the row in global memory
  int len, L, OW;
  const uint8_t* bank;
  int bank_len;
};

__device__ __forceinline__ int span_len(int s, int e) {
  return e > s ? e - s : 0;
}

// The warp's staging of an assemble: the row's valid bytes at `base`,
// the bank at round16(L).
__device__ __forceinline__ void stage_for_assemble(const RowInR& in,
                                                   uint8_t* base, int lane) {
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  stage_row(in.src, vlen, in.L, reinterpret_cast<uint4*>(base), lane);
  const int RB = round16(in.L);
  for (int i = lane; i < in.bank_len; i += 32) base[RB + i] = in.bank[i];
  __syncwarp();
}

// The output row staged at outb[skew:] (skew = dst & 15), stored with
// aligned 16-byte words where whole and bytes at the two ends.
__device__ __forceinline__ void store_row(const uint8_t* outb, int ol,
                                          uint8_t* dst, int lane) {
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
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

// The bytes of a row from its segment table (nseg segments in output
// order, seg_end ascending, the last ending at out_len): each lane walks
// the output positions lane, lane + 32, ... with a segment cursor, then
// the row is stored.
__device__ __forceinline__ void gather_row(const int* seg_end,
                                           const int* seg_adj,
                                           const uint8_t* srcb, int src_last,
                                           int out_len, int OW,
                                           uint8_t* outb_base, uint8_t* dst,
                                           int lane) {
  const int skew = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int ol = out_len < OW ? out_len : OW;
  int seg = 0;
  for (int o = lane; o < ol; o += 32) {
    while (seg_end[seg] <= o) ++seg;
    const int v = seg_adj[seg] + o;
    outb_base[skew + o] = srcb[v < 0 ? 0 : v > src_last ? src_last : v];
  }
  __syncwarp();
  store_row(outb_base, ol, dst, lane);
}

// ===========================================================================
// O5: rfc5424 -> RFC5424
// ===========================================================================

// One row: the probe writes its tier bit before the width test (ok, no
// byte >= 0x80, at most kPairs pairs and kMaxSd SD blocks, no pair value
// with a backslash), its elided length and fac8 / sev8; the assemble
// writes its elided bytes at out.dst.  A pair is in block k when its
// pair_sd is k and k < sd_count: the blocks in order, each block's
// pairs in pair order, whatever order pair_sd comes in.
template <bool ASM>
__device__ __forceinline__ void encode_r5_row(const ChanView& C,
                                              const RowInR& in,
                                              const ConstsR& k,
                                              uint8_t* base, RowOutR out,
                                              int lane) {
  const int sdc = C(C_SD_COUNT), pc = C(C_PAIR_COUNT);
  if (!ASM) {
    if (lane == 0) {
      out.small8[0] = (uint8_t)C(C_FACILITY);
      out.small8[out.small_stride] = (uint8_t)C(C_SEVERITY);
    }
    bool outside = C(C_OK) == 0 || C(C_HAS_HIGH) != 0 || pc > kPairs ||
                   sdc > kMaxSd;
    if (!outside)
      outside = warp_any(lane < pc && C(C_VAL_ESC + lane) != 0);
    if (outside) {
      if (lane == 0) {
        *out.tier = 0;
        *out.base_len = 0;
      }
      return;
    }
  }
  const int nblk = sdc < kMaxSd ? (sdc > 0 ? sdc : 0) : kMaxSd;
  // lane p < kPairs: pair p, emitted when its block exists
  const bool pv = lane < kPairs && lane < pc;
  int ns = 0, ne = 0, vs = 0, ve = 0, psd = -1;
  if (pv) {
    ns = C(C_NAME_S + lane);
    ne = C(C_NAME_E + lane);
    vs = C(C_VAL_S + lane);
    ve = C(C_VAL_E + lane);
    psd = C(C_PAIR_SD + lane);
  }
  const bool em = pv && psd >= 0 && psd < nblk;
  const int nl = em ? span_len(ns, ne) : 0, vl = em ? span_len(vs, ve) : 0;
  const int plen = em ? nl + vl + 4 : 0;
  // per block: its pairs' bytes and count, its length and first segment
  int blen[kMaxSd], bseg[kMaxSd], bcnt[kMaxSd], bsid[kMaxSd], bsl[kMaxSd];
  int sd_bytes = 0, sd_segs = 0;
#pragma unroll
  for (int b = 0; b < kMaxSd; ++b) {
    const bool in_b = em && psd == b;
    const int bp = (int)__reduce_add_sync(kFull, in_b ? (unsigned)plen : 0u);
    bcnt[b] = (int)__reduce_add_sync(kFull, in_b ? 1u : 0u);
    bsid[b] = C(C_SID_S + b);
    bsl[b] = b < nblk ? span_len(bsid[b], C(C_SID_E + b)) : 0;
    blen[b] = b < nblk ? 2 + bsl[b] + bp : 0;
    bseg[b] = sd_segs;
    sd_bytes += blen[b];
    sd_segs += b < nblk ? 3 + 5 * bcnt[b] : 0;
  }
  const int hs = C(C_HOST_S), as = C(C_APP_S), ps = C(C_PROC_S),
            ms = C(C_MSGID_S), gs = C(C_MSG_TRIM_START);
  const int hl = span_len(hs, C(C_HOST_E)), al = span_len(as, C(C_APP_E)),
            pl = span_len(ps, C(C_PROC_E)), il = span_len(ms, C(C_MSGID_E)),
            gl = span_len(gs, C(C_TRIM_END));
  const int head = hl + al + pl + il + 4;
  const int dash = nblk > 0 ? 0 : 1;
  const int total = head + dash + sd_bytes + 1 + gl;
  if (!ASM) {
    if (lane == 0) {
      *out.tier = 1;
      *out.base_len = total;
    }
    return;
  }

  // ---- the segment table ---------------------------------------------------
  stage_for_assemble(in, base, lane);
  const R5Smem sm = r5_smem(in.L, in.OW, true, in.bank_len, kSegs);
  int* seg_end = reinterpret_cast<int*>(base + sm.seg);
  int* seg_adj = seg_end + kSegs;
  const int RB = round16(in.L);
  auto put = [&](int i, int dst, int src, int len) {
    seg_adj[i] = src - dst;
    seg_end[i] = dst + len;
  };
  // the SD region's first byte and first segment
  const int sd0 = head + dash, sdi0 = 9;
  if (lane == 0) {
    int at = 0;
    put(0, at, hs, hl); at += hl;
    put(1, at, RB + k.off[K_SP], 1); at += 1;
    put(2, at, as, al); at += al;
    put(3, at, RB + k.off[K_SP], 1); at += 1;
    put(4, at, ps, pl); at += pl;
    put(5, at, RB + k.off[K_SP], 1); at += 1;
    put(6, at, ms, il); at += il;
    put(7, at, RB + k.off[K_SP], 1); at += 1;
    put(8, at, RB + k.off[K_DASH], dash);
  }
  int bstart[kMaxSd];
  {
    int at = sd0;
#pragma unroll
    for (int b = 0; b < kMaxSd; ++b) {
      bstart[b] = at;
      at += blen[b];
    }
  }
  // lane 8 + b: block b's brackets and sid (selected with constant
  // indices, so the per-block values stay in registers)
#pragma unroll
  for (int b = 0; b < kMaxSd; ++b) {
    if (lane == 8 + b && b < nblk) {
      const int i = sdi0 + bseg[b];
      put(i, bstart[b], RB + k.off[K_LB], 1);
      put(i + 1, bstart[b] + 1, bsid[b], bsl[b]);
      put(i + 2 + 5 * bcnt[b], bstart[b] + blen[b] - 1, RB + k.off[K_RB],
          1);
    }
  }
  // a pair's place inside its block: the emitted pairs before it there
  int w = 0, woff = 0;
  for (int q = 0; q < kPairs; ++q) {
    const int eq = __shfl_sync(kFull, em ? 1 : 0, q);
    const int sq = __shfl_sync(kFull, psd, q);
    const int lq = __shfl_sync(kFull, plen, q);
    if (q < lane && eq && sq == psd) {
      ++w;
      woff += lq;
    }
  }
  if (em) {
    int bs = 0, bi = 0, sl = 0;
#pragma unroll
    for (int b = 0; b < kMaxSd; ++b)
      if (b == psd) {
        bs = bstart[b];
        bi = sdi0 + bseg[b];
        sl = bsl[b];
      }
    int at = bs + 1 + sl + woff;
    const int i = bi + 2 + 5 * w;
    put(i, at, RB + k.off[K_SP], 1); at += 1;
    put(i + 1, at, ns, nl); at += nl;
    put(i + 2, at, RB + k.off[K_EQQ], 2); at += 2;
    put(i + 3, at, vs, vl); at += vl;
    put(i + 4, at, RB + k.off[K_Q], 1);
  }
  const int tail_i = sdi0 + sd_segs;
  if (lane == 31) {
    const int at = sd0 + sd_bytes;
    put(tail_i, at, RB + k.off[K_SP], 1);
    put(tail_i + 1, at + 1, gs, gl);
  }
  __syncwarp();
  gather_row(seg_end, seg_adj, base, RB + in.bank_len - 1, total, in.OW,
             base + sm.out, out.dst, lane);
}

// ===========================================================================
// O5/3164: rfc3164 -> RFC5424
// ===========================================================================

// One row: the probe writes its tier bit before the width test (ok, no
// byte >= 0x80), its elided length (the host span and the message,
// max(len - msg_start, 0)), fac8 / sev8 / pri1 and the host length; the
// assemble writes the host and message bytes at out.dst.
template <bool ASM>
__device__ __forceinline__ void encode_r3_row(const ChanView& C,
                                              const RowInR& in,
                                              uint8_t* base, RowOutR out,
                                              int lane) {
  const int hs = C(r3::C_HOST_S), ms = C(r3::C_MSG_START);
  const int hl = span_len(hs, C(r3::C_HOST_E));
  const int ml = in.len - ms > 0 ? in.len - ms : 0;
  if (!ASM) {
    if (lane == 0) {
      const bool tier = C(r3::C_OK) != 0 && C(r3::C_HAS_HIGH) == 0;
      *out.tier = tier ? 1 : 0;
      *out.base_len = tier ? hl + ml : 0;
      out.small8[0] = (uint8_t)C(r3::C_FACILITY);
      out.small8[out.small_stride] = (uint8_t)C(r3::C_SEVERITY);
      out.small8[2 * out.small_stride] = (uint8_t)C(r3::C_HAS_PRI);
      *out.hostl16 = (uint16_t)hl;
    }
    return;
  }
  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  stage_row(in.src, vlen, in.L, reinterpret_cast<uint4*>(base), lane);
  __syncwarp();
  const R5Smem sm = r5_smem(in.L, in.OW, true, 0, 2);
  uint8_t* outb = base + sm.out;
  const int skew = (int)(reinterpret_cast<uintptr_t>(out.dst) & 15);
  const int total = hl + ml;
  const int ol = total < in.OW ? total : in.OW;
  const int last = in.L > 0 ? in.L - 1 : 0;
  for (int o = lane; o < ol; o += 32) {
    const int v = o < hl ? hs + o : ms + (o - hl);
    outb[skew + o] = base[v < 0 ? 0 : v > last ? last : v];
  }
  __syncwarp();
  store_row(outb, ol, out.dst, lane);
}

}  // namespace r5o
