// The rfc5424 -> Cap'n Proto row encode of kernel OC, one warp a row: the
// device functions shared by encode_capnp.cu (the split tier, channels in
// the decode's [C, N] output) and fused_capnp_out.cu (FO/capnp, channels
// in the block's tile).  The design notes are at the top of
// encode_capnp.cu.
//
// Capnp output never escapes: a row's texts are its raw staged bytes,
// and everything else in its wire image is a pointer word computed from
// span lengths, zero padding or the constant capnp_extra blob.  The probe
// reads channels only, so only the assemble stages the row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_gelf_row.cuh"
#include "encode_rfc5424_out_row.cuh"
#include "warp_common.cuh"

namespace ocp {

using namespace fg;
using enc::ChanView;

constexpr int kMaxSd = enc::kMaxSd;      // the decode's SD width

// channel rows of the rfc5424 decode's packed output at P pairs
// (_KEYS_1D order, then sid_start and sid_end kMaxSd rows each, then
// name_start, name_end, val_start, val_end, pair_sd and val_has_esc P
// rows each)
template <int P>
struct ChC {
  static constexpr int OK = 0, FAC = 2, SEV = 3, HOST_S = 8, HOST_E = 9,
                       APP_S = 10, APP_E = 11, PROC_S = 12, PROC_E = 13,
                       MSGID_S = 14, MSGID_E = 15, SD_COUNT = 17,
                       PAIR_COUNT = 18, FULL_START = 19, TRIM_END = 20,
                       MSG_TRIM_START = 21, HAS_HIGH = 22, SID_S = 23,
                       SID_E = SID_S + kMaxSd, PAIR0 = SID_S + 2 * kMaxSd,
                       NAME_S = PAIR0, NAME_E = PAIR0 + P,
                       VAL_S = PAIR0 + 2 * P, VAL_E = PAIR0 + 3 * P,
                       PAIR_SD = PAIR0 + 4 * P, VAL_ESC = PAIR0 + 5 * P,
                       kChannels = PAIR0 + 6 * P;
};

// The consts table (device_capnp.kernel_consts): the capnp_extra blob's
// offset and length in the bank, and its pair count.
struct ConstsC {
  int blob_off, blob_len, n_extra;
};
inline ConstsC consts_c(const int* t) { return ConstsC{t[0], t[1], t[2]}; }

// What a row's encode reads besides its channels.
struct RowInC {
  const uint8_t* src;                    // the row in global memory
  int len, L, OW;
  const uint8_t* blob;                   // the capnp_extra blob
  ConstsC k;
};

// Where a row's encode writes: the probe's tier bit, elided length and
// fac8 / sev8 (sev8 at small8[small_stride]), or the assemble's
// destination.
struct RowOutC {
  uint8_t* tier;
  int32_t* base_len;
  uint8_t* small8;
  int small_stride;
  uint8_t* dst;
};

// Shared memory of one warp: the staged row, then the output row with
// room for its 16-byte skew (the assemble).  A probe needs none: 16 bytes
// keep the launch geometry's division whole.
__host__ __device__ inline int oc_stride(int L, int OW, bool asm_mode) {
  return asm_mode ? round16(L) + round16(OW) + 16 : 16;
}

__device__ __forceinline__ int span_c(int s, int e) { return e > s ? e - s : 0; }

// words a NUL-terminated text of b bytes occupies
__device__ __forceinline__ int text_words(int b) { return (b + 8) >> 3; }

// A list pointer in word `at` to word `target`: offset << 2 | 1 in the
// low half, elem | count << 3 in the high half.
__device__ __forceinline__ unsigned long long list_ptr(int at, int target,
                                                       int count, int elem) {
  const uint32_t lo = ((uint32_t)(target - at - 1) << 2) | 1u;
  const uint32_t hi = (uint32_t)elem | ((uint32_t)count << 3);
  return (unsigned long long)lo | ((unsigned long long)hi << 32);
}

// The eight little-endian bytes of w at o[b] when they lie below ol, as
// two 32-bit stores: every word of a row is 8-byte aligned in its staging
// (a row is whole words long, so the assemble's row_off, an exclusive sum
// of row lengths, is a multiple of 8, and so is the row's skew).
__device__ __forceinline__ void put_word(uint8_t* o, int b,
                                         unsigned long long w, int ol) {
  if (b + 8 > ol) return;
  uint32_t* p = reinterpret_cast<uint32_t*>(o + b);
  p[0] = (uint32_t)w;
  p[1] = (uint32_t)(w >> 32);
}

// The warp copies len bytes of the staged row from src to o[dst], kept
// below ol.
__device__ __forceinline__ void copy_span(uint8_t* o, int dst,
                                          const uint8_t* row, int last,
                                          int src, int len, int ol,
                                          int lane) {
  for (int i = lane; i < len; i += 32) {
    const int b = dst + i, v = src + i;
    if (b < ol) o[b] = row[v < 0 ? 0 : v > last ? last : v];
  }
}

// One row.  The probe writes fac8 / sev8, its tier bit before the width
// test (ok, no byte >= 0x80, no escaped value among the first pair_count
// slots: the reference counts every SD block's) and its elided length;
// the assemble writes its elided wire image at out.dst.  Byte b of the
// elided row is byte 8 * 3 + b of the message: the segment table and the
// root struct's data words are the host's.
template <int P, bool ASM>
__device__ __forceinline__ void encode_capnp_row(const ChanView& C,
                                                 const RowInC& in,
                                                 uint8_t* base, RowOutC out,
                                                 int lane) {
  using K = ChC<P>;
  const int pc = C(K::PAIR_COUNT);
  if (!ASM) {
    if (lane == 0) {
      out.small8[0] = (uint8_t)C(K::FAC);
      out.small8[out.small_stride] = (uint8_t)C(K::SEV);
    }
    bool outside = C(K::OK) == 0 || C(K::HAS_HIGH) != 0;
    if (!outside)
      outside = warp_any(lane < P && lane < pc && C(K::VAL_ESC + lane) != 0);
    if (outside) {
      if (lane == 0) {
        *out.tier = 0;
        *out.base_len = 0;
      }
      return;
    }
  }
  // lane j < P: pair j, emitted when it is sd[0]'s (a prefix of the slots)
  const bool pv = lane < P && lane < pc && C(K::PAIR_SD + lane) == 0;
  int ns = 0, nl = 0, vs = 0, vl = 0;
  if (pv) {
    ns = C(K::NAME_S + lane);
    nl = span_c(ns, C(K::NAME_E + lane));
    vs = C(K::VAL_S + lane);
    vl = span_c(vs, C(K::VAL_E + lane));
  }
  const int kw = pv ? text_words(nl + 1) : 0;  // "_" + name
  const int vw = pv ? text_words(vl) : 0;
  const unsigned pvm = __ballot_sync(kFull, pv);
  const int k0 = __popc(pvm);
  const int kv_incl = warp_incl_scan(kw + vw, lane);
  const int kv_sum = __shfl_sync(kFull, kv_incl, 31);

  // lane t < 7: text t of the root pointer slots 0-6 (hostname, appname,
  // procid, msgid, msg, full_msg, sd[0]'s id): its span, and whether it
  // is written (msg when not empty, the id when the row has SD)
  const bool has_sd = C(K::SD_COUNT) > 0;
  int ts = 0, tl = 0;
  bool ton = false;
  if (lane < 7) {
    int sc, ec;
    switch (lane) {
      case 0: sc = K::HOST_S; ec = K::HOST_E; break;
      case 1: sc = K::APP_S; ec = K::APP_E; break;
      case 2: sc = K::PROC_S; ec = K::PROC_E; break;
      case 3: sc = K::MSGID_S; ec = K::MSGID_E; break;
      case 4: sc = K::MSG_TRIM_START; ec = K::TRIM_END; break;
      case 5: sc = K::FULL_START; ec = K::TRIM_END; break;
      default: sc = K::SID_S; ec = K::SID_E; break;
    }
    ts = C(sc);
    tl = span_c(ts, C(ec));
    ton = lane == 4 ? tl > 0 : lane == 6 ? has_sd : true;
  }
  // message word of each text: from word 12 (after the root pointer and
  // the root struct's 2 data and 9 pointer words), in slot order
  const int tw = ton ? text_words(tl) : 0;
  const int tw_incl = warp_incl_scan(tw, lane);
  const int w_t = 12 + tw_incl - tw;
  const int w_pairs = 12 + __shfl_sync(kFull, tw_incl, 6);
  // the pair texts' first byte (after the tag word and the k0 elements),
  // then the blob's, in the reference's segment order
  const int pt0 = 8 * (w_pairs - 3) + (has_sd ? 8 + 32 * k0 : 0);
  const int bd = pt0 + 8 * kv_sum;
  const int total = bd + in.k.blob_len;
  if (!ASM) {
    if (lane == 0) {
      *out.tier = 1;
      *out.base_len = total;
    }
    return;
  }

  const int vlen = in.len < 0 ? 0 : (in.len > in.L ? in.L : in.len);
  stage_row(in.src, vlen, in.L, reinterpret_cast<uint4*>(base), lane);
  uint8_t* outb = base + round16(in.L);
  const int skew = (int)(reinterpret_cast<uintptr_t>(out.dst) & 15);
  const int ol = total < in.OW ? total : in.OW;
  // zeros: the NUL padding, the null pointers, the elements' data words
  uint4 zero4;
  zero4.x = zero4.y = zero4.z = zero4.w = 0u;
  for (int v = lane; v < (skew + ol + 15) >> 4; v += 32)
    reinterpret_cast<uint4*>(outb)[v] = zero4;
  __syncwarp();
  uint8_t* o = outb + skew;
  const int last = in.L > 0 ? in.L - 1 : 0;

  // lane s < 9: root pointer slot s (word 3 + s)
  if (lane < 9) {
    int target = w_t, count = tl + 1, elem = 2;
    bool on = ton;
    if (lane == 7) {
      target = w_pairs; count = 4 * k0; elem = 7; on = has_sd;
    } else if (lane == 8) {
      target = w_pairs + (has_sd ? 1 + 4 * k0 + kv_sum : 0);
      count = 4 * in.k.n_extra; elem = 7; on = in.k.blob_len > 0;
    }
    if (on) put_word(o, 8 * lane, list_ptr(3 + lane, target, count, elem), ol);
  }
  // the tag word and lane j's element (j < k0): its key and value pointers
  const int kt = w_pairs + 1 + 4 * k0 + (kv_incl - kw - vw);
  if (has_sd) {
    if (lane == 0)
      put_word(o, 8 * (w_pairs - 3),
               (unsigned long long)(uint32_t)(k0 << 2) |
                   ((unsigned long long)(2u | (2u << 16)) << 32),
               ol);
    if (pv && lane < k0) {
      const int e = w_pairs + 1 + 4 * lane;
      put_word(o, 8 * (e - 1), list_ptr(e + 2, kt, nl + 2, 2), ol);
      put_word(o, 8 * e, list_ptr(e + 3, kt + kw, vl + 1, 2), ol);
    }
  }
  // the texts, each copied by the whole warp from its lane's span
  for (int t = 0; t < 7; ++t) {
    const int d = __shfl_sync(kFull, 8 * (w_t - 3), t),
              st = __shfl_sync(kFull, ts, t),
              l = __shfl_sync(kFull, ton ? tl : 0, t);
    copy_span(o, d, base, last, st, l, ol, lane);
  }
  // each emitted pair's "_" + name and value, in pair order
  const int kd = pt0 + 8 * (kv_incl - kw - vw);
  unsigned m = pvm;
  while (m) {
    const int q = __ffs((int)m) - 1;
    m &= m - 1u;
    const int d = __shfl_sync(kFull, kd, q), s = __shfl_sync(kFull, ns, q),
              l = __shfl_sync(kFull, nl, q), kq = __shfl_sync(kFull, kw, q),
              vsq = __shfl_sync(kFull, vs, q),
              vlq = __shfl_sync(kFull, vl, q);
    if (lane == 0 && d < ol) o[d] = '_';
    copy_span(o, d + 1, base, last, s, l, ol, lane);
    copy_span(o, d + 8 * kq, base, last, vsq, vlq, ol, lane);
  }
  for (int i = lane; i < in.k.blob_len; i += 32)
    if (bd + i < ol) o[bd + i] = in.blob[i];
  __syncwarp();
  r5o::store_row(outb, ol, out.dst, lane);
}

}  // namespace ocp
