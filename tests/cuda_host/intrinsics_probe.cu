// Probe of the warp intrinsics, atomics and fence that cuda_runtime.h
// emulates: two warps of one block record what each intrinsic returns for
// the values in[t], and tests/test_torch_kernel_sources.py checks every
// record against the intrinsic's definition.  Compiled only for the
// host emulation; no kernel of the package uses it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRecords = 12;
constexpr unsigned kFull = 0xffffffffu;

__global__ void probe_kernel(const int32_t* __restrict__ in,
                             int32_t* __restrict__ out,
                             uint32_t* __restrict__ acc) {
  __shared__ int32_t slot[kThreads];
  __shared__ uint32_t sums[4];
  __shared__ int32_t message;
  __shared__ int32_t flag;
  const int t = threadIdx.x, lane = t & 31;
  const int v = in[t];
  int32_t* o = out + t * kRecords;
  o[0] = __shfl_sync(kFull, v, (lane * 7 + 3) & 31);
  o[1] = __shfl_up_sync(kFull, v, 3);
  o[2] = __shfl_down_sync(kFull, v, 5);
  o[3] = __shfl_xor_sync(kFull, v, 6);
  o[4] = (int32_t)__ballot_sync(kFull, v & 1);
  o[5] = (int32_t)__reduce_add_sync(kFull, (unsigned)v);
  o[6] = __popc((unsigned)v);
  o[7] = __ffs(v);
  o[8] = __clz(v);
  o[10] = (int32_t)__reduce_max_sync(kFull, (unsigned)v);
  // __syncwarp orders one lane's shared store before another's load
  slot[t] = v;
  __syncwarp();
  o[9] = slot[(t & ~31) | ((lane + 1) & 31)];
  if (t < 4) sums[t] = 0;
  if (t == 0) flag = 0;
  __syncthreads();
  atomicAdd(&sums[t & 3], (unsigned)v);
  // __threadfence orders a store before a later flag store: thread 32
  // publishes its value behind a flag that thread 0 waits for with
  // volatile loads; every other thread records its own value
  o[11] = v;
  if (t == kThreads / 2) {
    message = v;
    __threadfence();
    *reinterpret_cast<volatile int32_t*>(&flag) = 1;
  } else if (t == 0) {
    while (*reinterpret_cast<volatile int32_t*>(&flag) == 0) {
    }
    __threadfence();
    o[11] = *reinterpret_cast<volatile int32_t*>(&message);
  }
  __syncthreads();
  if (t < 4) acc[t] = sums[t];
}

}  // namespace

extern "C" {

// in int32 [64]; out int32 [64, 12]; acc uint32 [4].
int fg_probe_intrinsics(const void* in, void* out, void* acc) {
  probe_kernel<<<1, kThreads, 0, nullptr>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out),
      static_cast<uint32_t*>(acc));
  return (int)cudaGetLastError();
}

}  // extern "C"
