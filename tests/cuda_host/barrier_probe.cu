// Probe of the barrier checks of cuda_runtime.h: two warps of one block
// exchange values, and with mode > 0 one lane breaks the rule that every
// lane of a warp reaches each warp intrinsic and barrier at the same call
// site.  The emulation must fail such a launch with a message, never
// hang.  Compiled only for the host emulation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// mode 0: every lane follows the rule; 1: lane 37 skips a shuffle and
// meets its warp at the next one; 2: lane 37 skips __syncthreads and
// waits at a shuffle the rest of its warp reaches only after it; 3: lane
// 37 returns early (allowed: it leaves its warp's barriers)
__global__ void barrier_probe_kernel(int mode, int32_t* __restrict__ out) {
  const int t = threadIdx.x, lane = t & 31;
  int v = t;
  if (mode == 3 && t == 37) return;
  if (!(mode == 1 && t == 37)) v = __shfl_xor_sync(kFull, v, 1);
  v += __shfl_down_sync(kFull, v, 1);
  if (!(mode == 2 && t == 37)) __syncthreads();
  v += __shfl_xor_sync(kFull, v, 0);
  out[t] = lane == 31 ? -v : v;
}

}  // namespace

extern "C" {

// out int32 [64]
int fg_probe_barriers(int mode, void* out) {
  barrier_probe_kernel<<<1, 64, 0, nullptr>>>(mode,
                                             static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
