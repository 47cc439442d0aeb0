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
// start depends on the previous frame's length), so the walk is one
// thread hopping from head to head and its time is about n dependent
// memory round trips, far above the bytes bound.  The block's other
// threads zero the span arrays first and, only when the stop position
// holds a non-digit, search the rest of the region for a space (the
// err analysis) in parallel.  There is no lookahead plane and no region
// size cap: the walk reads only each frame's prefix.  A faster chain
// (pointer doubling across the card, or a speculative per-tile walk)
// is later work; see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPrefixDigits = 9;

__device__ __forceinline__ bool is_digit(int c) { return c >= 48 && c <= 57; }

__global__ void __launch_bounds__(kThreads)
syslen_spans_kernel(const uint8_t* __restrict__ region, int rlen, int ncap,
                    int32_t* __restrict__ starts, int32_t* __restrict__ lens,
                    int32_t* __restrict__ meta) {
  __shared__ int sh_from;
  __shared__ int sh_found;
  __shared__ int sh_err;
  for (int i = threadIdx.x; i < ncap; i += blockDim.x) {
    starts[i] = 0;
    lens[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int pos = 0, n = 0, decline = 0;
    int q = 0;   // first non-digit at or after pos (rlen if none)
    for (int k = 0; k <= ncap; ++k) {
      q = pos;
      while (q < rlen && is_digit(region[q])) ++q;
      const bool prefix_ok = q < rlen && region[q] == ' ' && q > pos;
      if (!prefix_ok) break;
      if (q - pos > kMaxPrefixDigits) {
        decline = 1;
        break;
      }
      int val = 0;
      for (int p = pos; p < q; ++p) val = val * 10 + (region[p] - 48);
      const long long nxt = (long long)q + 1 + val;
      if (nxt > rlen) break;
      if (k >= ncap) {
        decline = 1;
        break;
      }
      starts[k] = q + 1;
      lens[k] = val;
      ++n;
      pos = (int)nxt;
    }
    // pos is the chain's stop (consumed) and q its first non-digit
    meta[0] = n;
    meta[1] = pos;
    meta[3] = decline;
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
  syslen_spans_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(region), rlen, ncap,
      static_cast<int32_t*>(starts), static_cast<int32_t*>(lens),
      static_cast<int32_t*>(meta));
  return (int)cudaGetLastError();
}

}  // extern "C"
