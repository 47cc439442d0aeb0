// The JSON structural index of one row, one warp a row: the row function
// of kernel K5 (structural_index.cu, whose notes describe the design),
// shared with the fused gelf -> GELF route FG (fused_gelf.cu), whose probe
// indexes its row in the flat mode before EG's probe reads the channels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_common.cuh"

namespace si {

using fg::kFull;
using fg::kWarps;
using fg::lanemask_lt;

// int32 channels of the packed output at F fields: ok, n_fields, then
// key_start, key_end, val_start, val_end, val_type, key_esc, val_esc of
// each field (tpu/jsonidx.py unpack_channels)
__host__ __device__ constexpr int channels(int F) { return 2 + 7 * F; }

constexpr int kEscRunCap = 16;
constexpr int kWsWindow = 8;
// value classes + 1 (jsonidx VT_* + 1; 0 = no value token)
enum { C_NONE = 0, C_STRING, C_NUMBER, C_TRUE, C_FALSE, C_NULL, C_OBJECT,
       C_ARRAY };

__device__ __forceinline__ int bit_length(int v) {
  return v <= 0 ? 0 : 32 - __clz(v);
}

// extract_by_ord / extract_counts_by_ord "sum": ordinal k's slot after
// the per-ordinal sums of its group (30 / sb ordinals per wrapping word,
// sb bits each) are folded into one word.
__device__ __forceinline__ uint32_t unpack_slot(const uint32_t* sums, int K,
                                                int k, int sb) {
  int slots = 30 / sb;
  if (slots < 1) slots = 1;
  const int base = k - k % slots;
  uint32_t word = 0;
  for (int s = 0; s < slots && base + s < K; ++s)
    word += sums[base + s] << (sb * s);
  return (word >> (sb * (k - base))) & ((1u << sb) - 1u);
}

// value + 1 clipped to a slot of sb bits (extract_by_ord's v1)
__device__ __forceinline__ uint32_t slot_v1(int v, int sb) {
  const int hi = (1 << sb) - 2;
  return (uint32_t)((v < 0 ? 0 : (v > hi ? hi : v)) + 1);
}

__device__ __forceinline__ bool is_ws(int c) {
  return c == 32 || c == 9 || c == 10 || c == 13;
}

// The string automaton's exclusive state over one 32-position chunk a
// step: bs_run is the backslash run ending at i-1 (uncapped, so its
// parity is escaped(i)), real_q a quote that run does not escape, and
// outside the parity of the real quotes before i.  Lanes past the row
// pass c = 0, which is neither a backslash nor a quote.
struct WarpString {
  int run = 0;        // backslash run ending at the previous chunk's end
  int q = 0;          // real quotes before this chunk
  int bs_run = 0;
  bool real_q = false;
  bool outside = true;
  __device__ __forceinline__ void step(int c, int lane) {
    const unsigned bs = __ballot_sync(kFull, c == 92);
    const unsigned lt = lanemask_lt(lane);
    const unsigned nb = ~bs & lt;   // non-backslash positions below the lane
    bs_run = nb ? lane - 32 + __clz((int)nb) : lane + run;
    real_q = c == 34 && (bs_run & 1) == 0;
    const unsigned qb = __ballot_sync(kFull, real_q);
    outside = ((q + __popc(qb & lt)) & 1) == 0;
    run = ~bs ? __clz((int)~bs) : run + 32;
    q += __popc(qb);
  }
};

// One warp's per-ordinal sums (extract_by_ord's operands).
template <int F>
struct RowSums {
  uint32_t ko[F], kc[F], vs[F], vc[F], le[F], cc[F], vt[F], ec[F];
};

// Indexes one row with the calling warp and writes its channel values
// to col[ch * kWarps] (the block's channel tile).  FLAT = false admits
// containers `nested` (>= 1) levels below the top object; FLAT = true is
// the flat mode, nested = 0 (the GELF decode): "top level" is "outside a
// string", there is no depth, any '[' or ']' outside a string flags the
// row, brackets are literal bytes to the literal runs, and no value is a
// container.  A template parameter, so each mode compiles to its own
// code.  Every lane of the warp calls it.
template <int F, bool FLAT>
__device__ __forceinline__ void index_row(
    const uint8_t* __restrict__ src, const int len_raw, const int L,
    const int nested, uint4* __restrict__ stage, RowSums<F>& S,
    int32_t* __restrict__ col, const int lane) {
  static_assert(F <= 32, "one field per lane");
  const int n = len_raw < 0 ? 0 : (len_raw > L ? L : len_raw);
  constexpr bool flat = FLAT;

  // ---- stage the valid bytes; zero the ordinal sums ------------------------
  if ((L & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int v = lane; v < (n + 15) >> 4; v += 32) stage[v] = s4[v];
  } else {
    uint8_t* d = reinterpret_cast<uint8_t*>(stage);
    for (int j = lane; j < n; j += 32) d[j] = src[j];
  }
  {
    uint32_t* w = reinterpret_cast<uint32_t*>(&S);
    for (int j = lane; j < (int)(sizeof(S) / 4); j += 32) w[j] = 0;
  }
  __syncwarp();
  const uint8_t* b = reinterpret_cast<const uint8_t*>(stage);
  // bytes past the row's length read as 0, as the reference masks them
  auto at = [&](int p) -> int { return p < n ? (int)b[p] : 0; };
  const int sb = bit_length(L + 1) > 10 ? bit_length(L + 1) : 10;
  const int pbits = sb;            // value-start position field
  const int sb_vs = pbits + 3;     // position + 3-bit class per slot
  auto add = [](uint32_t* arr, int ord, uint32_t v) {
    if (ord >= 1 && ord <= F) atomicAdd(&arr[ord - 1], v);
  };

  // running state carried from one chunk to the next (warp-uniform)
  WarpString qs;
  int ws_run = 0;          // outside-string whitespace run at the chunk's end
  int depth0 = 0;          // depth after the previous chunk
  int key0 = 0, kc0 = 0;   // key / key-close ordinals after it
  bool lit_carry = false;  // is the previous chunk's last position literal
  unsigned nw_prev = 0;    // non-whitespace ballots of the previous chunk,
  unsigned nw_cur =        // this one and (in the loop) the next one
      __ballot_sync(kFull, lane < n && !is_ws(b[lane]));
  // first / last non-whitespace position as 2 i + (not '{' / is '}')
  int wf = 2 * L + 2, wl = -1;
  // this lane's share of the row checks
  bool viol = false;
  unsigned braces = 0;            // top-level '{' | final '}' << 16
  unsigned seps = 0;              // top-level ':' | ',' << 16

  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    const int c = valid ? b[i] : 0;
    const bool next_valid = i + 32 < n;
    const int c_next = next_valid ? b[i + 32] : 0;
    const unsigned nw_next = __ballot_sync(kFull, next_valid && !is_ws(c_next));
    const unsigned lt = lanemask_lt(lane), le = lt | (1u << lane);

    qs.step(c, lane);
    const bool outside = qs.outside;
    const bool real_q = qs.real_q;
    const bool ws = is_ws(c);
    const bool bs = c == 92;
    if (c == 34 && qs.bs_run >= kEscRunCap) viol = true;

    // previous / next non-whitespace byte within WS_WINDOW (0 if none)
    int ptb = 0, ntb = 0;
    {
      const unsigned long long back =
          ((unsigned long long)nw_cur << 32) | nw_prev;
      const unsigned mb = (unsigned)(back >> (24 + lane)) & 0xFFu;
      if (mb) ptb = b[i - 8 + 31 - __clz((int)mb)];
      const unsigned long long ahead =
          ((unsigned long long)nw_next << 32) | nw_cur;
      const unsigned ma = (unsigned)(ahead >> (lane + 1)) & 0xFFu;
      if (ma) ntb = b[i + __ffs((int)ma)];
    }

    // an outside-string whitespace run longer than WS_WINDOW
    const bool wo_here = ws && outside;
    const unsigned wo = __ballot_sync(kFull, wo_here);
    if (wo_here) {
      const unsigned gaps = ~wo & lt;
      const int run = gaps ? lane - 31 + __clz((int)gaps) : lane + 1 + ws_run;
      if (run >= kWsWindow + 1) viol = true;
    }
    ws_run = ~wo ? __clz((int)~wo) : ws_run + 32;

    // inclusive depth of outside-string brackets
    const bool lb = c == '{' && outside, rb = c == '}' && outside;
    const bool lsb = c == '[' && outside, rsb = c == ']' && outside;
    const bool open_br = lb || lsb, close_br = rb || rsb;
    const unsigned ob = __ballot_sync(kFull, open_br);
    const unsigned cb = __ballot_sync(kFull, close_br);
    const unsigned braces_b = __ballot_sync(kFull, lb || rb);
    const int depth = depth0 + __popc(ob & le) - __popc(cb & le);
    depth0 += __popc(ob) - __popc(cb);
    // the reference's row max of the depth (its padding's 0 is within
    // any nested >= 1)
    if (!flat && valid && (depth < 0 || depth > 1 + nested)) viol = true;
    if (nw_cur) {
      const int h = 31 - __clz((int)nw_cur);
      wl = 2 * (base + h) + (int)(((braces_b & cb) >> h) & 1u);
      if (wf > 2 * L) {
        const int f = __ffs((int)nw_cur) - 1;
        wf = 2 * (base + f) + (int)((~(braces_b & ob) >> f) & 1u);
      }
    }
    const bool top = flat ? outside : depth == 1;
    const bool rb_end = rb && (flat || depth == 0);
    if (flat ? (lsb || rsb) : (lsb && top)) viol = true;
    const bool nested_close = !flat && close_br && top && !rb_end;
    if (nested_close && ntb != ',' && ntb != '}') viol = true;
    const bool cont_start = !flat && open_br && depth == 2;
    const bool is_cont_val = cont_start && ptb == ':';
    if (cont_start && !is_cont_val) viol = true;

    // token roles (top level only; flat: a close quote is inside its own
    // string, so it is top level with no depth to ask)
    const bool open_q = real_q && outside, close_q = real_q && !outside;
    const bool top_open_q = open_q && top;
    if (!flat && open_q && !top && depth < 2) viol = true;
    const bool is_key_open = top_open_q && (ptb == '{' || ptb == ',');
    const bool is_val_open = top_open_q && ptb == ':';
    if (top_open_q && !is_key_open && !is_val_open) viol = true;
    const bool top_close_q = close_q && (flat || top);
    const bool is_key_close = top_close_q && ntb == ':';
    const bool is_val_close = top_close_q && !is_key_close;
    if (is_val_close && ntb != ',' && ntb != '}') viol = true;
    const bool colon_out = c == ':' && top;
    const bool comma_out = c == ',' && top;
    if (comma_out && ntb != '"') viol = true;
    braces += (lb && top ? 1u : 0u) + (rb_end ? 1u << 16 : 0u);
    seps += (colon_out ? 1u : 0u) + (comma_out ? 1u << 16 : 0u);

    // inclusive ordinals; key_prev is the key ordinal at i-1
    const unsigned kob = __ballot_sync(kFull, is_key_open);
    const unsigned kcb = __ballot_sync(kFull, is_key_close);
    const int key_prev = key0 + __popc(kob & lt);
    const int key_ord = key_prev + (is_key_open ? 1 : 0);
    const int kc_ord = kc0 + __popc(kcb & le);
    key0 += __popc(kob);
    kc0 += __popc(kcb);

    // literal / number runs
    const bool structural = colon_out || comma_out || lb || rb || real_q ||
                            (!flat && (lsb || rsb));
    const bool is_lit = valid && !ws && outside && top && !structural;
    const unsigned litb = __ballot_sync(kFull, is_lit);
    const bool prev_lit = lane ? ((litb >> (lane - 1)) & 1u) != 0 : lit_carry;
    lit_carry = (litb >> 31) != 0;
    const bool lit_start = is_lit && !prev_lit;
    // the literal run that ended at i-1
    if (prev_lit && !is_lit) add(S.le, key_prev, slot_v1(i - 1, sb));
    if (is_lit && key_ord == 0) viol = true;
    if (bs && outside) viol = true;

    const bool is_lit_val = lit_start && ptb == ':';
    if (is_val_open || is_lit_val || is_cont_val) {
      int vclass;
      if (is_val_open) {
        vclass = C_STRING;
      } else if (is_cont_val) {
        vclass = c == '{' ? C_OBJECT : C_ARRAY;
      } else {
        // the next four bytes as one word (uint32: the reference's int32
        // wraps for bytes >= 128, which never match an ASCII literal)
        const uint32_t w4 = ((uint32_t)at(i) << 24) |
                            ((uint32_t)at(i + 1) << 16) |
                            ((uint32_t)at(i + 2) << 8) | (uint32_t)at(i + 3);
        if (w4 == 0x74727565u)                           // "true"
          vclass = C_TRUE;
        else if (w4 == 0x66616c73u && at(i + 4) == 'e')  // "fals" "e"
          vclass = C_FALSE;
        else if (w4 == 0x6e756c6cu)                      // "null"
          vclass = C_NULL;
        else if ((c >= 48 && c <= 57) || c == '-')
          vclass = C_NUMBER;
        else
          vclass = C_NONE;
      }
      add(S.vs, key_ord, slot_v1(i | (vclass << pbits), sb_vs));
    }
    if (is_key_open) add(S.ko, key_ord, slot_v1(i, sb));
    if (is_key_close) add(S.kc, kc_ord, slot_v1(i, sb));
    if (is_val_close) add(S.vc, key_ord, slot_v1(i, sb));
    if (is_val_close || lit_start || is_cont_val) add(S.vt, key_ord, 1);
    if (bs && !outside) add(S.ec, key_ord, 1);
    if (nested_close) add(S.cc, key_ord, slot_v1(i, sb));

    nw_prev = nw_cur;
    nw_cur = nw_next;
  }
  // a literal run reaching the row's end
  if (lit_carry && lane == 0) add(S.le, key0, slot_v1(n - 1, sb));

  // ---- row checks -----------------------------------------------------------
  const int n_keys = key0;
  const bool any_viol = fg::warp_any(viol);
  braces = __reduce_add_sync(kFull, braces);
  seps = __reduce_add_sync(kFull, seps);
  const int n_colons = (int)(seps & 0xFFFFu), n_commas = (int)(seps >> 16);
  bool ok = !any_viol;
  ok = ok && (wf & 1) == 0 && (wl & 1) == 1 && (wf >> 1) < (wl >> 1);
  ok = ok && (flat || depth0 == 0);    // as many closes as opens
  ok = ok && (qs.q & 1) == 0;          // every string closed
  ok = ok && braces == (1u | (1u << 16));
  ok = ok && kc0 == n_keys && n_keys <= F && n_colons == n_keys;
  ok = ok && n_commas == (n_keys > 1 ? n_keys - 1 : 0);
  __syncwarp();

  // ---- packed-sum extraction, field k on lane k -----------------------------
  const int k = lane < F ? lane : 0;
  auto pos = [&](uint32_t v) -> int { return v == 0 ? L : (int)v - 1; };
  const int kop = pos(unpack_slot(S.ko, F, k, sb));
  const int kcp = pos(unpack_slot(S.kc, F, k, sb));
  const int vs_word = pos(unpack_slot(S.vs, F, k, sb_vs));
  const int vsp = vs_word & ((1 << pbits) - 1);
  const int cls1 = vs_word >> pbits;
  const int vcp = pos(unpack_slot(S.vc, F, k, sb));
  const int lep = pos(unpack_slot(S.le, F, k, sb));
  const int ccp = pos(unpack_slot(S.cc, F, k, sb));
  const int vtok = (int)unpack_slot(S.vt, F, k, sb);
  const uint32_t ec = unpack_slot(S.ec, F, k, sb);
  const bool fv = k < n_keys;
  bool bad = fv ? vtok != 1 : vtok != 0;
  if (fv && cls1 < 1) bad = true;
  const int vtype = fv ? cls1 - 1 : -1;
  if (fv && !(kop < kcp && kcp < vsp)) bad = true;
  const bool is_string = vtype == C_STRING - 1;
  const bool is_cont = vtype == C_OBJECT - 1 || vtype == C_ARRAY - 1;
  int vend = is_string ? vcp : (is_cont ? ccp + 1 : lep + 1);
  if (vend > len_raw) vend = len_raw;
  if (fv && is_cont && !(ccp > vsp)) bad = true;
  const int lit_len = vtype == C_TRUE - 1    ? 4
                      : vtype == C_FALSE - 1 ? 5
                      : vtype == C_NULL - 1  ? 4
                                             : -1;
  if (fv && lit_len > 0 && vend - vsp != lit_len) bad = true;
  if (fv && is_string && !(vcp > vsp)) bad = true;
  ok = ok && !fg::warp_any(lane < F && bad);

  // ---- channel values into the block's tile ---------------------------------
  auto put = [&](int ch, int v) { col[ch * kWarps] = v; };
  if (lane < F) {
    const bool esc = ec > 0 && fv;
    put(2 + k, kop + 1);                            // key_start
    put(2 + F + k, kcp);                            // key_end
    put(2 + 2 * F + k, is_string ? vsp + 1 : vsp);  // val_start
    put(2 + 3 * F + k, vend);                       // val_end
    put(2 + 4 * F + k, vtype);                      // val_type
    put(2 + 5 * F + k, esc ? 1 : 0);                // key_esc
    put(2 + 6 * F + k, esc && is_string ? 1 : 0);   // val_esc
  }
  if (lane == 0) {
    put(0, ok ? 1 : 0);
    put(1, n_keys);
  }
}

}  // namespace si
