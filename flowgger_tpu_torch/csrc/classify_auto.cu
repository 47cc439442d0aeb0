// The auto-detect classifier, one warp per row: kernel AC.
//
// Replaces the JAX package's jnp device program classify_device
// (flowgger_tpu/tpu/autodetect.py:97; jitted :150, called from
// classify_packed :211), which is not a pallas_call: the reference builds
// the BOM-shifted [N, L] batch, picks the '>' offset and the two bytes
// after it with where-chains, and reduces two [N, L] planes for the tab
// and the colon.
//
// What it computes: for each of the first n rows of a packed [N, L]
// uint8 batch, one int8 class code, over the row's valid bytes
// (min(lens[r], L); every byte past them reads as 0):
//   - a UTF-8 BOM (EF BB BF, lens >= 3) is skipped: G = the row from
//     byte 3 on, else the row;
//   - G[0] == '{'                                   -> 3 (GELF);
//   - G[0] == '<', the first '>' among G[2..5] at g, G[1..g-1] digits,
//     G[g+1] == '1' and G[g+2] == ' '               -> 0 (RFC5424);
//   - any other G[0] == '<'                         -> 1 (RFC3164);
//   - a tab and a colon among the row's valid bytes -> 2 (LTSV);
//   - else                                          -> 1 (RFC3164).
// With the dns flag (the template parameter DNS, for
// input.auto_extra_formats = ["dns"]) it also computes the reference's
// dns overlay (autodetect._extras_adjust :159-191, numpy on the host
// there): a row whose class above is 2 or 1, whose first byte (not
// BOM-stripped) is not '<' or '{', with exactly five tabs among its valid
// bytes and a non-empty head (the bytes before the first tab) of digits
// and at most one dot, not at either edge of the head, is 5 (dns).
// Equal to the plain version (tpu/autodetect.py classify_plain, with
// dns) on every row.
//
// Bound on the H100: bytes (a row's valid bytes up to where both a tab
// and a colon were seen, its length and one output byte; a few integer
// operations a byte).  Design:
// - One warp per row, kWarps rows a block; rows at and past n return at
//   once (warp-uniform).
// - The header: lane k loads byte k of the row (0 past the valid
//   bytes), so the BOM-shifted G[j] is one __shfl_sync from lane j + 3
//   or j; the '>' search is one ballot over lanes 2-5 (its lowest set
//   bit), the digit check one ballot over lanes 1 to g-1, and G[g+1],
//   G[g+2] two shuffles.  The shift is done by index, with no shifted
//   copy of the row.
// - The tab/colon scan walks the valid bytes 512 a step, 16 a lane (one
//   16-byte load where rows are 16-byte aligned, else byte loads), bytes
//   at or past the row's length masked; after each step two ballots
//   tell the warp whether both were seen, and it stops there.  With DNS
//   the scan also sums the tabs (a warp sum a step) and takes their
//   first position (a warp min), and goes on until it has seen a tab, a
//   colon and more than five tabs, or the row's end; a row that can be
//   dns then checks its head 32 bytes a step, one byte a lane, with two
//   ballots and a warp sum.
//
// TPU workarounds not carried over: the BOM-shifted copy of the whole
// batch, the where-chains over the '>' offsets, and the full [N, L]
// reductions that cannot stop early.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 32 * 16;   // bytes a warp scans a step

template <bool DNS>
__global__ void __launch_bounds__(kThreads)
classify_auto_kernel(const uint8_t* __restrict__ batch,
                     const int32_t* __restrict__ lens, int8_t* __restrict__ out,
                     int n, int L, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const uint8_t* r = batch + (size_t)row * L;
  int len = lens[row];
  len = len < 0 ? 0 : (len > L ? L : len);

  // the header: lane k holds byte k (0 past the valid bytes)
  const int hb = lane < len ? r[lane] : 0;
  const int b0 = __shfl_sync(kFull, hb, 0);
  const int b1 = __shfl_sync(kFull, hb, 1);
  const int b2 = __shfl_sync(kFull, hb, 2);
  const int sh = (len >= 3 && b0 == 0xEF && b1 == 0xBB && b2 == 0xBF) ? 3 : 0;
  // lane j holds G[j] (lanes j + sh >= 32 are never read)
  const int g = __shfl_sync(kFull, hb, (lane + sh) & 31);
  const int g0 = __shfl_sync(kFull, g, 0);
  const unsigned gts =
      __ballot_sync(kFull, lane >= 2 && lane <= 5 && g == '>');
  const int gt = gts ? __ffs((int)gts) - 1 : 0;
  const unsigned bad = __ballot_sync(
      kFull, lane >= 1 && lane < gt && !(g >= '0' && g <= '9'));
  const int v1 = __shfl_sync(kFull, g, gt + 1);
  const int v2 = __shfl_sync(kFull, g, gt + 2);
  const bool is5424 =
      g0 == '<' && gt >= 2 && bad == 0 && v1 == '1' && v2 == ' ';

  // the tab/colon scan over the valid bytes, stopping once both are seen
  // (with DNS: and more than five tabs)
  bool tab = false, col = false;
  unsigned tabs = 0, cols = 0;
  int ntab = 0, ft = len;        // DNS: the tabs and the first one
  for (int base = 0; base < len; base += kStep) {
    const int p = base + lane * 16;
    int my_tabs = 0, my_first = len;
    if (p < len) {
      const int m = len - p < 16 ? len - p : 16;  // valid bytes here
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (vec) {
        const uint4 w = *reinterpret_cast<const uint4*>(r + p);
        words[0] = w.x;
        words[1] = w.y;
        words[2] = w.z;
        words[3] = w.w;
      } else {
        for (int k = 0; k < m; ++k)
          words[k >> 2] |= (uint32_t)r[p + k] << (8 * (k & 3));
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t c = (words[k >> 2] >> (8 * (k & 3))) & 0xffu;
        const bool is_tab = k < m && c == 9u;
        tab |= is_tab;
        col |= k < m && c == 58u;
        if (DNS && is_tab) {
          ++my_tabs;
          if (my_first == len) my_first = p + k;
        }
      }
    }
    tabs = __ballot_sync(kFull, tab);
    cols = __ballot_sync(kFull, col);
    if (DNS) {
      ntab += (int)__reduce_add_sync(kFull, (unsigned)my_tabs);
      int f = my_first;
      for (int o = 16; o > 0; o >>= 1) {
        const int g2 = __shfl_xor_sync(kFull, f, o);
        f = g2 < f ? g2 : f;
      }
      ft = f < ft ? f : ft;
    }
    if (tabs && cols && (!DNS || ntab > 5)) break;
  }

  int cls = 1;
  if (tabs && cols) cls = 2;
  if (g0 == '<') cls = 1;
  if (is5424) cls = 0;
  if (g0 == '{') cls = 3;
  if (DNS && ntab == 5 && ft >= 1 && (cls == 1 || cls == 2) && b0 != '<' &&
      b0 != '{') {
    // the head [0, ft): digits and at most one dot, at neither edge
    bool junk = false, edge = false;
    int dots = 0;
    for (int base = 0; base < ft; base += 32) {
      const int p = base + lane;
      const int c = p < ft ? r[p] : '0';
      const bool dot = c == '.';
      junk |= !dot && !(c >= '0' && c <= '9');
      edge |= dot && (p == 0 || p == ft - 1);
      dots += dot ? 1 : 0;
    }
    if (!__ballot_sync(kFull, junk) && !__ballot_sync(kFull, edge) &&
        __reduce_add_sync(kFull, (unsigned)dots) <= 1u)
      cls = 5;
  }
  if (lane == 0) out[row] = (int8_t)cls;
}

}  // namespace

extern "C" {

// class codes of rows [0, n) of the batch, int8 [n]; dns != 0 adds the
// dns overlay
int fg_classify_auto(const void* batch, const void* lens, void* out, int n,
                     int L, int dns, void* stream) {
  if (n <= 0) return 0;
  // 16-byte loads where every row starts on a 16-byte boundary
  const int vec =
      (L % 16 == 0 && (reinterpret_cast<uintptr_t>(batch) & 15) == 0) ? 1 : 0;
  const int grid = (n + kWarps - 1) / kWarps;
  auto kern = dns ? classify_auto_kernel<true> : classify_auto_kernel<false>;
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lens),
      static_cast<int8_t*>(out), n, L, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
