// Probe of frame_sep_spans.cu's decoupled look-back: one warp runs
// lookback() over hand-made status words (a mix of aggregate and
// inclusive words) for each queried tile and records the exclusive
// prefix it returns.  The kernel itself, run block after block by the
// host emulation, only ever meets an inclusive word one tile back, so
// this is where a window without an inclusive word, or one with several,
// is checked.  Compiled only for the host emulation.

#include "frame_sep_spans.cu"

namespace {

__global__ void lookback_probe_kernel(const uint64_t* __restrict__ status,
                                      const int32_t* __restrict__ tiles,
                                      int n, uint32_t* __restrict__ out) {
  for (int q = 0; q < n; ++q) {
    unsigned count, last1;
    lookback(status, tiles[q], &count, &last1);
    if (threadIdx.x == 0) {
      out[2 * q] = count;
      out[2 * q + 1] = last1;
    }
  }
}

}  // namespace

extern "C" {

// status uint64 [ntiles]; tiles int32 [n], each in [1, ntiles); out
// uint32 [n, 2] = (count, last + 1) of the tiles before each.
int fg_probe_lookback(const void* status, const void* tiles, int n,
                      void* out) {
  lookback_probe_kernel<<<1, 32, 0, nullptr>>>(
      static_cast<const uint64_t*>(status),
      static_cast<const int32_t*>(tiles), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
