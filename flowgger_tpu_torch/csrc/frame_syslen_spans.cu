// RFC5425 / RFC6587 octet-counted framing spans over a raw region.
//
// Replaces the JAX package's Pallas kernel frame_syslen_spans_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:343, body _syslen_kernel :267),
// which builds next-space / next-non-digit / digit-value lookahead planes
// over one VMEM-resident region (1 MiB cap) and then walks the frame
// chain ncap + 1 hops as a scalar loop over them.
//
// What it computes (framing.frame_syslen_spans_jit's contract): frames
// are "<decimal> <body>" back to back from offset 0.  For each complete
// frame k, starts[k] = its body start and lens[k] = its length; slots
// past n are 0.  meta = (n, consumed, err, decline): consumed is the
// start of the first incomplete frame (or rlen), err says the stop
// holds a malformed prefix (a space is reachable but the bytes before
// it are not all digits, or the prefix is empty), decline says a
// reachable prefix has more than kMaxPrefixDigits digits or there are
// more than ncap frames — the caller then re-frames on the host, which
// owns the > 2^31-1 error.  Positions at or past rlen are non-digits and
// non-spaces.  Where decline is 0 the outputs equal the reference's.
//
// Bound on the H100: the chain is inherently sequential (each frame's
// start depends on the previous frame's length), so the time is n hops
// of dependent latency, far above the bytes bound.  Design: one block
// stages a window of the region (up to kWindow bytes) in shared memory
// with 16-byte loads, and one warp walks the chain from it.  At each head
// the 32 lanes read the 32 bytes from there; a ballot of non-digits
// gives the prefix length, a ballot of spaces whether a space ends it,
// and each lane below the prefix length weighs its digit by its power of
// ten (a shuffle from the lane that holds it) before one warp sum gives
// the frame length.  So a hop is a few shared-memory and warp operations
// instead of a round trip to device memory per prefix byte.  The hop's
// latency is its dependency chain (byte load, ballot, bit scan, shuffle,
// warp sum, add), so every outcome of a hop is computed and one branch
// leaves the loop; a digit run of 32 or more bytes (never a frame: it
// declines or stops the chain) leaves it too and is measured from device
// memory afterwards.  When a head comes within 32 bytes of the window's
// end, the block refills the window from that head, so any region size
// works (a syslen flush region fits one window).  The walker writes each
// span as it goes; afterwards the block zeroes the slots [n, ncap) and,
// only when the stop holds a non-digit, searches the rest of the region
// for a space (the err rule) in parallel.  A shorter chain (a per-window
// next-head table, or speculative per-tile walks stitched across tiles)
// is later work; see ROADMAP.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPrefixDigits = 9;
constexpr int kLook = 32;             // bytes a hop reads, one per lane
constexpr int kWindow = 200 * 1024;   // most region bytes a window stages
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_digit(int c) { return c >= 48 && c <= 57; }

// region[ws, ws + wbytes) into win; bytes at or past rlen are staged as
// 0 (a non-digit, non-space).  ws and wbytes are multiples of 16.
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ region,
                                            int rlen, int ws, int wbytes,
                                            uint8_t* __restrict__ win) {
  const bool aligned = (reinterpret_cast<uintptr_t>(region) & 15) == 0;
  uint4* w4 = reinterpret_cast<uint4*>(win);
  for (int v = threadIdx.x; v < wbytes >> 4; v += blockDim.x) {
    const int p = ws + 16 * v;
    if (aligned && p + 16 <= rlen) {
      w4[v] = *reinterpret_cast<const uint4*>(region + p);
    } else {
      for (int b = 0; b < 16; ++b)
        win[16 * v + b] = p + b < rlen ? region[p + b] : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
syslen_spans_kernel(const uint8_t* __restrict__ region, int rlen, int ncap,
                    int wbytes, int32_t* __restrict__ starts,
                    int32_t* __restrict__ lens, int32_t* __restrict__ meta) {
  extern __shared__ uint4 win_smem[];
  __shared__ int sh_ws;     // window start (a multiple of 16)
  __shared__ int sh_done;   // the chain has stopped
  __shared__ int sh_n;
  __shared__ int sh_from;
  __shared__ int sh_found;
  __shared__ int sh_err;
  uint8_t* win = reinterpret_cast<uint8_t*>(win_smem);
  const int lane = threadIdx.x & 31;
  // the walker warp's state, the same on each of its lanes
  int pos = 0, n = 0, decline = 0;
  int q = 0;   // first non-digit at or after pos (rlen if none)
  int pow10 = 1;   // 10^lane for lanes below kMaxPrefixDigits
  for (int t = 0; t < lane && t < kMaxPrefixDigits; ++t) pow10 *= 10;
  if (threadIdx.x == 0) {
    sh_ws = 0;
    sh_done = 0;
  }
  __syncthreads();
  while (true) {
    load_window(region, rlen, sh_ws, wbytes, win);
    __syncthreads();
    if (threadIdx.x < 32) {
      const int ws = sh_ws;
      bool done = false;
      while (pos - ws + kLook <= wbytes) {
        // one hop: every outcome is computed, then one branch leaves
        const int c = win[pos - ws + lane];
        const unsigned dg = __ballot_sync(kFull, is_digit(c));
        const unsigned spb = __ballot_sync(kFull, c == ' ');
        // digits at pos (kLook: at least that many, resolved below)
        const int d = dg != kFull ? __ffs((int)~dg) - 1 : kLook;
        const bool space_after = d < kLook && ((spb >> (d & 31)) & 1u);
        // the prefix value (meaningful for d <= kMaxPrefixDigits, where it
        // stays below 10^9 and nxt below 2^32)
        const unsigned w = __shfl_sync(kFull, pow10, (d - 1 - lane) & 31);
        const unsigned val = __reduce_add_sync(
            kFull, lane < d ? (unsigned)(c - 48) * w : 0u);
        const unsigned nxt = (unsigned)(pos + d) + 1u + val;
        const bool prefix_ok = space_after && d > 0;
        const bool in_cap = d <= kMaxPrefixDigits;
        const bool whole = nxt <= (unsigned)rlen;
        if (!(prefix_ok && in_cap && whole && n < ncap)) {
          q = pos + d;
          decline = prefix_ok && (!in_cap || (whole && n >= ncap));
          done = true;
          break;
        }
        if (lane == 0) {
          starts[n] = pos + d + 1;
          lens[n] = (int)val;
        }
        ++n;
        pos = (int)nxt;
      }
      if (lane == 0) {
        sh_done = done;
        if (!done) sh_ws = pos & ~15;   // refill from the next head
      }
    }
    __syncthreads();
    if (sh_done) break;
  }
  // pos is the chain's stop (consumed) and q its first non-digit
  if (threadIdx.x == 0) {
    if (q - pos == kLook) {
      // a digit run past the hop's look: too long for a prefix, so the
      // chain stops here; it declines if a space ends the run
      while (q < rlen && is_digit(region[q])) ++q;
      decline = q < rlen && region[q] == ' ';
    }
    meta[0] = n;
    meta[1] = pos;
    meta[3] = decline;
    sh_n = n;
    sh_found = 0;
    sh_from = rlen;
    sh_err = 0;
    if (pos < rlen) {
      if (q < rlen && region[q] == ' ')
        sh_err = q == pos;       // the space heads an empty prefix
      else if (q < rlen)
        sh_from = q + 1;         // err iff a space follows the non-digit
    }
  }
  __syncthreads();
  for (int i = sh_n + (int)threadIdx.x; i < ncap; i += blockDim.x) {
    starts[i] = 0;
    lens[i] = 0;
  }
  for (int p = sh_from + (int)threadIdx.x; p < rlen; p += blockDim.x) {
    if (region[p] == ' ') {
      sh_found = 1;
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) meta[2] = sh_err | sh_found;
}

}  // namespace

extern "C" {

// starts/lens int32 [ncap], meta int32 [4] = (n, consumed, err, decline).
int fg_frame_syslen_spans(const void* region, int rlen, int ncap,
                          void* starts, void* lens, void* meta,
                          void* stream) {
  // one window holds the whole region and the look past its end when
  // that fits; otherwise kWindow bytes, refilled as the walk goes
  int wbytes = (int)((((long long)rlen + kLook + 15) / 16) * 16);
  wbytes = wbytes < kWindow ? wbytes : kWindow;
  if (wbytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        syslen_spans_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWindow);
    if (e != cudaSuccess) return (int)e;
  }
  syslen_spans_kernel<<<1, kThreads, wbytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(region), rlen, ncap, wbytes,
      static_cast<int32_t*>(starts), static_cast<int32_t*>(lens),
      static_cast<int32_t*>(meta));
  return (int)cudaGetLastError();
}

}  // extern "C"
