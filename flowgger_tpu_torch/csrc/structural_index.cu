// JSON structural index (simdjson stage 1), one CUDA thread per row.
//
// Replaces the JAX package's Pallas kernel structural_index_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:439, pallas_call :481), reached
// through decode_jsonl_pallas (:505), which runs jsonidx.structural_index
// (flowgger_tpu/tpu/jsonidx.py:194) over [256, L] VMEM tiles with the
// compiled-NFA string machine and the manual/sum scan and extract forms.
//
// What it computes: for every row of a packed [N, L] uint8 batch, the
// JSON-lines channels of tpu/jsonidx.py at nested > 0 (ok, n_fields, and
// per field key_start/key_end/val_start/val_end/val_type/key_esc/val_esc)
// written channel-major into one int32 [2 + 7F, N] tensor, so each
// channel store is coalesced across the warp.  The reference's
// definitions are planes over the row; here they are evaluated in one
// sequential pass per row:
//
// - the string/escape automaton (jsonidx.NFA_TABLE) is stepped byte by
//   byte, which gives the same exclusive states as the reference's
//   log-shift composition of transition functions;
// - the escape-cap plane (a quote after a run of >= ESC_RUN_CAP
//   backslashes flags the row) is a running backslash count;
// - the previous-significant-byte lookaround is the last non-whitespace
//   byte if it lies within WS_WINDOW; the next one is read ahead from
//   shared memory only where a token role needs it;
// - every "value at the k-th ordinal" extraction keeps the reference's
//   bit-packed sum form: exact per-ordinal sums are folded into wrapping
//   32-bit words (several ordinals per word), so a multi-hit ordinal on a
//   malformed row carries into its neighbour exactly as it does there;
// - the next-four-bytes literal word is built in uint32 (the reference's
//   int32 wraps for bytes >= 128, which never matches an ASCII literal
//   either way).
//
// So the kernel agrees with the plain PyTorch version on every row —
// ok and n_fields included — not only on accepted rows.
//
// Bound on the H100: bytes (one read of the batch, the channel writes;
// a few dozen integer operations per byte).  Design as the RFC5424
// decode kernel: a block stages 32 rows in shared memory with coalesced
// loads (row stride padded to an odd word count so the 32 threads reading
// byte i of their own rows hit different banks), then each thread walks
// its row.  The per-ordinal sums live in local memory (8 x F words).
// One thread per row leaves the card latency-bound; see PERF.md.
//
// TPU workarounds not carried over: the u8 -> i32 widening, the
// log-shift ladders for scans, reductions and windows, and the f32
// reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kEscRunCap = 16;
constexpr int kWsWindow = 8;
// jsonidx.NFA_TABLE: a byte class's state->state map, 2 bits per state
constexpr uint32_t kNfaOther = 0xA0;   // (0, 0, 2, 2)
constexpr uint32_t kNfaQuote = 0x82;   // (2, 0, 0, 2)
constexpr uint32_t kNfaBs = 0xB1;      // (1, 0, 3, 2)
// value classes + 1 (jsonidx VT_* + 1; 0 = no value token)
enum { C_NONE = 0, C_STRING, C_NUMBER, C_TRUE, C_FALSE, C_NULL, C_OBJECT,
       C_ARRAY };

__device__ __forceinline__ int bit_length(int v) {
  return v <= 0 ? 0 : 32 - __clz(v);
}

// Fold exact per-ordinal sums into the reference's packed wrapping
// words (30 / sb ordinals per word, sb bits each) and read the slots
// back: extract_by_ord / extract_counts_by_ord in their "sum" form.
template <int K>
__device__ __forceinline__ void unpack_slots(const uint32_t* sums,
                                             uint32_t* vals, int sb) {
  int slots = 30 / sb;
  if (slots < 1) slots = 1;
  const uint32_t mask = (1u << sb) - 1u;
  for (int base = 0; base < K; base += slots) {
    uint32_t word = 0;
    for (int s = 0; s < slots && base + s < K; ++s)
      word += sums[base + s] << (sb * s);
    for (int s = 0; s < slots && base + s < K; ++s)
      vals[base + s] = (word >> (sb * s)) & mask;
  }
}

// value + 1 clipped to a slot of sb bits (extract_by_ord's v1)
__device__ __forceinline__ uint32_t slot_v1(int v, int sb) {
  const int hi = (1 << sb) - 2;
  return (uint32_t)((v < 0 ? 0 : (v > hi ? hi : v)) + 1);
}

__device__ __forceinline__ bool is_ws(int c) {
  return c == 32 || c == 9 || c == 10 || c == 13;
}

template <int F>
__global__ void __launch_bounds__(kRowsPerBlock)
structural_index_kernel(const uint8_t* __restrict__ batch,
                        const int32_t* __restrict__ lens_in,
                        int32_t* __restrict__ out, int N, int L,
                        int stride_words, int nested) {
  extern __shared__ uint32_t smem[];
  const int row0 = blockIdx.x * kRowsPerBlock;
  // cooperative, coalesced staging of this block's rows
  for (int r = 0; r < kRowsPerBlock && row0 + r < N; ++r) {
    const uint8_t* src = batch + (size_t)(row0 + r) * L;
    uint8_t* dst = reinterpret_cast<uint8_t*>(smem + r * stride_words);
    for (int j = threadIdx.x; j < L; j += blockDim.x) dst[j] = src[j];
  }
  __syncthreads();
  const int row = row0 + threadIdx.x;
  if (row >= N) return;
  const uint8_t* b =
      reinterpret_cast<const uint8_t*>(smem + threadIdx.x * stride_words);
  const int len_raw = lens_in[row];
  const int len = len_raw < 0 ? 0 : (len_raw > L ? L : len_raw);
  // bytes past the row's length read as 0, as the reference masks them
  auto at = [&](int p) -> int { return p < len ? (int)b[p] : 0; };
  // next non-whitespace byte within WS_WINDOW after i (0 if none)
  auto ntb = [&](int i) -> int {
    for (int q = i + 1; q <= i + kWsWindow && q < len; ++q)
      if (!is_ws(b[q])) return b[q];
    return 0;
  };
  const int sb = bit_length(L + 1) > 10 ? bit_length(L + 1) : 10;
  const int pbits = sb;            // value-start position field
  const int sb_vs = pbits + 3;     // position + 3-bit class per slot

  uint32_t s_ko[F], s_kc[F], s_vs[F], s_vc[F], s_le[F], s_cc[F], s_vt[F],
      s_ec[F];
  for (int k = 0; k < F; ++k)
    s_ko[k] = s_kc[k] = s_vs[k] = s_vc[k] = s_le[k] = s_cc[k] = s_vt[k] =
        s_ec[k] = 0;
  auto add = [](uint32_t* arr, int ord, uint32_t v) {
    if (ord >= 1 && ord <= F) arr[ord - 1] += v;
  };

  int st = 0;              // automaton state before the current byte
  int bs_run = 0;          // backslash run ending at the previous byte
  int last_nw_pos = -(kWsWindow + 2), last_nw_byte = 0;
  int ws_run = 0;
  int depth = 0;
  int max_depth = len < L ? 0 : -2147483647 - 1;
  int first_nw = -1, last_nw = -1;
  bool first_is_lb = false, last_is_rb = false;
  int key_ord = 0, kc_ord = 0;
  int n_quotes = 0, lbc = 0, rbc = 0, n_colons = 0, n_commas = 0,
      n_open = 0, n_close = 0;
  bool viol = false, cap_viol = false;
  bool prev_is_lit = false;
  int prev_key_ord = 0;

  for (int i = 0; i < len; ++i) {
    const int c = b[i];
    const bool ws = is_ws(c);
    const bool bs = c == 92;
    const bool qt = c == 34;
    const bool outside = st < 2;
    const bool escaped = (st & 1) != 0;
    if (qt && bs_run >= kEscRunCap) cap_viol = true;
    bs_run = bs ? bs_run + 1 : 0;
    const uint32_t fn = qt ? kNfaQuote : (bs ? kNfaBs : kNfaOther);
    const int st_next = (int)((fn >> (2 * st)) & 3u);

    const bool real_q = qt && !escaped;
    const bool open_q = real_q && outside;
    const bool close_q = real_q && !outside;
    const int ptb = last_nw_pos >= i - kWsWindow ? last_nw_byte : 0;

    if (ws && outside) {
      if (++ws_run >= kWsWindow + 1) viol = true;
    } else {
      ws_run = 0;
    }

    const bool lb = c == '{' && outside, rb = c == '}' && outside;
    const bool lsb = c == '[' && outside, rsb = c == ']' && outside;
    const bool open_br = lb || lsb, close_br = rb || rsb;
    depth += (open_br ? 1 : 0) - (close_br ? 1 : 0);
    if (depth < 0) viol = true;
    if (depth > max_depth) max_depth = depth;
    const bool top = depth == 1;
    const bool rb_end = rb && depth == 0;
    if (lsb && top) viol = true;
    const bool nested_close = close_br && top && !rb_end;
    if (nested_close) {
      const int n = ntb(i);
      if (n != ',' && n != '}') viol = true;
    }
    const bool cont_start = open_br && depth == 2;
    const bool is_cont_val = cont_start && ptb == ':';
    if (cont_start && !is_cont_val) viol = true;
    if (!ws) {
      if (first_nw < 0) {
        first_nw = i;
        first_is_lb = lb;
      }
      last_nw = i;
      last_is_rb = rb;
    }

    const bool top_open_q = open_q && top;
    const bool top_close_q = close_q && depth == 1;
    if (open_q && !top && depth < 2) viol = true;
    const bool is_key_open = top_open_q && (ptb == '{' || ptb == ',');
    const bool is_val_open = top_open_q && ptb == ':';
    if (top_open_q && !is_key_open && !is_val_open) viol = true;
    bool is_key_close = false, is_val_close = false;
    if (top_close_q) {
      const int n = ntb(i);
      is_key_close = n == ':';
      is_val_close = !is_key_close;
      if (is_val_close && n != ',' && n != '}') viol = true;
    }
    const bool colon_out = c == ':' && top;
    const bool comma_out = c == ',' && top;
    if (comma_out && ntb(i) != '"') viol = true;

    key_ord += is_key_open ? 1 : 0;
    kc_ord += is_key_close ? 1 : 0;
    n_quotes += real_q ? 1 : 0;
    lbc += (lb && top) ? 1 : 0;
    rbc += rb_end ? 1 : 0;
    n_colons += colon_out ? 1 : 0;
    n_commas += comma_out ? 1 : 0;
    n_open += open_br ? 1 : 0;
    n_close += close_br ? 1 : 0;

    const bool structural =
        colon_out || comma_out || lb || rb || real_q || lsb || rsb;
    const bool is_lit = !ws && outside && top && !structural;
    const bool lit_start = is_lit && !prev_is_lit;
    // the literal run that ended at i-1
    if (prev_is_lit && !is_lit) add(s_le, prev_key_ord, slot_v1(i - 1, sb));
    if (is_lit && key_ord == 0) viol = true;
    if (bs && outside) viol = true;

    const bool is_lit_val = lit_start && ptb == ':';
    if (is_val_open || is_lit_val || is_cont_val) {
      int vclass;
      if (is_val_open) {
        vclass = C_STRING;
      } else {
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
      if (is_cont_val) vclass = c == '{' ? C_OBJECT : C_ARRAY;
      add(s_vs, key_ord, slot_v1(i | (vclass << pbits), sb_vs));
    }
    if (is_key_open) add(s_ko, key_ord, slot_v1(i, sb));
    if (is_key_close) add(s_kc, kc_ord, slot_v1(i, sb));
    if (is_val_close) add(s_vc, key_ord, slot_v1(i, sb));
    if (is_val_close || lit_start || is_cont_val) add(s_vt, key_ord, 1);
    if (bs && !outside) add(s_ec, key_ord, 1);
    if (nested_close) add(s_cc, key_ord, slot_v1(i, sb));

    prev_is_lit = is_lit;
    prev_key_ord = key_ord;
    if (!ws) {
      last_nw_pos = i;
      last_nw_byte = c;
    }
    st = st_next;
  }
  if (prev_is_lit) add(s_le, prev_key_ord, slot_v1(len - 1, sb));

  // ---- row checks -------------------------------------------------------
  const int n_keys = key_ord;
  bool ok = !cap_viol && !viol;
  ok = ok && max_depth <= 1 + nested;
  ok = ok && first_nw >= 0 && first_is_lb && last_is_rb && first_nw < last_nw;
  ok = ok && n_open == n_close;
  ok = ok && (n_quotes & 1) == 0;
  ok = ok && lbc == 1 && rbc == 1;
  ok = ok && kc_ord == n_keys && n_keys <= F && n_colons == n_keys;
  ok = ok && n_commas == (n_keys > 1 ? n_keys - 1 : 0);

  // ---- packed-sum extraction -----------------------------------------------
  uint32_t ko[F], kc[F], vs[F], vc[F], le[F], cc[F], vt[F], ec[F];
  unpack_slots<F>(s_ko, ko, sb);
  unpack_slots<F>(s_kc, kc, sb);
  unpack_slots<F>(s_vs, vs, sb_vs);
  unpack_slots<F>(s_vc, vc, sb);
  unpack_slots<F>(s_le, le, sb);
  unpack_slots<F>(s_cc, cc, sb);
  unpack_slots<F>(s_vt, vt, sb);
  unpack_slots<F>(s_ec, ec, sb);
  auto pos = [&](uint32_t v) -> int { return v == 0 ? L : (int)v - 1; };

  auto put = [&](int ch, int v) { out[(size_t)ch * N + row] = v; };
  for (int k = 0; k < F; ++k) {
    const bool fv = k < n_keys;
    const int kop = pos(ko[k]), kcp = pos(kc[k]);
    const int vs_word = pos(vs[k]);
    const int vsp = vs_word & ((1 << pbits) - 1);
    const int cls1 = vs_word >> pbits;
    const int vcp = pos(vc[k]), lep = pos(le[k]), ccp = pos(cc[k]);
    const int vtok = (int)vt[k];
    if (fv ? vtok != 1 : vtok != 0) ok = false;
    if (fv && cls1 < 1) ok = false;
    const int vtype = fv ? cls1 - 1 : -1;
    if (fv && !(kop < kcp && kcp < vsp)) ok = false;
    const bool is_string = vtype == C_STRING - 1;
    const bool is_cont = vtype == C_OBJECT - 1 || vtype == C_ARRAY - 1;
    int vend = is_string ? vcp : (is_cont ? ccp + 1 : lep + 1);
    if (vend > len_raw) vend = len_raw;
    if (fv && is_cont && !(ccp > vsp)) ok = false;
    const int lit_len = vtype == C_TRUE - 1    ? 4
                        : vtype == C_FALSE - 1 ? 5
                        : vtype == C_NULL - 1  ? 4
                                               : -1;
    if (fv && lit_len > 0 && vend - vsp != lit_len) ok = false;
    if (fv && is_string && !(vcp > vsp)) ok = false;
    const bool esc = ec[k] > 0 && fv;
    put(2 + k, kop + 1);                         // key_start
    put(2 + F + k, kcp);                         // key_end
    put(2 + 2 * F + k, is_string ? vsp + 1 : vsp);  // val_start
    put(2 + 3 * F + k, vend);                    // val_end
    put(2 + 4 * F + k, vtype);                   // val_type
    put(2 + 5 * F + k, esc ? 1 : 0);             // key_esc
    put(2 + 6 * F + k, esc && is_string ? 1 : 0);  // val_esc
  }
  put(0, ok ? 1 : 0);
  put(1, n_keys);
}

template <int F>
int launch(const void* batch, const void* lens, void* out, int N, int L,
           int nested, cudaStream_t stream) {
  if (N <= 0) return 0;
  const int stride_words = (((L + 3) / 4) | 1);
  const size_t smem = (size_t)kRowsPerBlock * stride_words * 4;
  auto kern = structural_index_kernel<F>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  kern<<<grid, kRowsPerBlock, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), N, L, stride_words, nested);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Packed channel count for the instantiations below: 2 + 7 * F.
int fg_structural_index_f8(const void* batch, const void* lens, void* out,
                           int N, int L, int nested, void* stream) {
  return launch<8>(batch, lens, out, N, L, nested,
                   static_cast<cudaStream_t>(stream));
}

int fg_structural_index_f24(const void* batch, const void* lens, void* out,
                            int N, int L, int nested, void* stream) {
  return launch<24>(batch, lens, out, N, L, nested,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
