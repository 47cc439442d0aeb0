// Host emulation of the CUDA runtime subset the port's kernels use, so
// their sources compile with g++ and run on the CPU in the tests.
//
// Each CUDA thread of a block runs as one std::thread; blocks run one
// after another.  __syncthreads is a block-wide std::barrier, warp
// shuffles exchange through a shared slot array between two warp-wide
// barriers, and __shared__ variables become statics (one block at a
// time, so one copy suffices).  tests/cuda_host/build.py rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` into emu_launch(...) and
// `extern __shared__ T name[]` into a pointer at the dynamic buffer.
// This checks the kernels' logic and indexing, not their speed or any
// property of the GPU's memory model.
#pragma once

#include <stdint.h>
#include <stddef.h>

#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;

inline int __clz(int v) {
  return v == 0 ? 32 : __builtin_clz(static_cast<unsigned>(v));
}

inline std::vector<unsigned char> g_dyn_smem;
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bars;
inline std::vector<long long> g_shfl_slots;

inline void __syncthreads() { g_block_bar->arrive_and_wait(); }

template <class T>
inline T __shfl_up_sync(unsigned, T v, int delta) {
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  std::barrier<>& wb = *g_warp_bars[tid >> 5];
  g_shfl_slots[tid] = static_cast<long long>(v);
  wb.arrive_and_wait();
  T out = lane >= delta ? static_cast<T>(g_shfl_slots[tid - delta]) : v;
  wb.arrive_and_wait();
  return out;
}

template <class K, class... A>
inline void emu_launch(K kern, dim3 grid, dim3 block, size_t smem,
                       cudaStream_t, A... args) {
  const int nt = static_cast<int>(block.x);
  g_dyn_smem.assign(smem + 16, 0);
  g_shfl_slots.assign(nt, 0);
  gridDim = grid;
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(nt);
    g_block_bar = &bar;
    g_warp_bars.clear();
    for (int w = 0; w * 32 < nt; ++w)
      g_warp_bars.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) {
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        kern(args...);
        // a thread that returns early must not hold up later barriers
        g_warp_bars[t >> 5]->arrive_and_drop();
        bar.arrive_and_drop();
      });
    }
    for (auto& th : ts) th.join();
  }
}
