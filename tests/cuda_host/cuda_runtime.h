// Host emulation of the CUDA runtime subset the port's kernels use, so
// their sources compile with g++ and run on the CPU in the tests.
//
// Each CUDA thread of a block runs as one std::thread; blocks run one
// after another.  __syncthreads is a block-wide std::barrier.  Warp
// intrinsics (shuffles, ballots, reductions) exchange through a shared
// slot array: every lane publishes its value, the warp meets at a
// warp-wide barrier, each lane reads what it needs.  Two slot arrays
// alternate, so a lane that runs ahead to the next exchange cannot
// overwrite a slot another lane is still reading (it would first have to
// pass the next barrier, which that lane has not reached).  __syncwarp is
// the warp barrier alone.  So every lane of a warp must call each warp
// intrinsic, as the kernels do (they launch whole warps and keep every
// warp intrinsic under warp-uniform control): a partial warp would wait
// at the warp barrier for ever.  The mask argument is not read.
// atomicAdd goes through std::atomic_ref, __threadfence is a sequentially
// consistent std::atomic_thread_fence, and volatile loads and stores are
// the compiler's own.  __shared__ variables become
// statics (one block at a time, so one copy suffices); the dynamic
// shared memory starts each launch filled with 0xA5, not zeros.
// tests/cuda_host/build.py rewrites `kernel<<<grid, block, smem,
// stream>>>(args)` into emu_launch(...) and `extern __shared__ T name[]`
// into a pointer at the dynamic buffer.  This checks the kernels' logic
// and indexing, not their speed or any property of the GPU's memory
// model.
#pragma once

#include <stdint.h>
#include <stddef.h>

#include <algorithm>
#include <atomic>
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

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

inline unsigned atomicAdd(unsigned* addr, unsigned v) {
  return std::atomic_ref<unsigned>(*addr).fetch_add(v);
}

inline std::vector<unsigned char> g_dyn_smem;
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bars;
inline std::vector<long long> g_shfl_slots;

inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

inline void __syncthreads() { g_block_bar->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  g_warp_bars[threadIdx.x >> 5]->arrive_and_wait();
}

inline thread_local int g_slot_phase;

// Publishes v for the warp, then returns read(slots of this warp, lane).
template <class R>
inline auto warp_exchange(long long v, R read) {
  const int tid = static_cast<int>(threadIdx.x);
  long long* slots = &g_shfl_slots[g_slot_phase * blockDim.x];
  g_slot_phase ^= 1;
  slots[tid] = v;
  g_warp_bars[tid >> 5]->arrive_and_wait();
  return read(slots + (tid & ~31), tid & 31);
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int) {
                         return static_cast<T>(s[src & 31]);
                       });
}

template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return lane >= static_cast<int>(delta)
                                    ? static_cast<T>(s[lane - delta]) : v;
                       });
}

template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return lane + static_cast<int>(delta) < 32
                                    ? static_cast<T>(s[lane + delta]) : v;
                       });
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return static_cast<T>(s[(lane ^ lane_mask) & 31]);
                       });
}

inline unsigned __ballot_sync(unsigned, int pred) {
  return warp_exchange(pred != 0, [](const long long* s, int) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= s[l] ? 1u << l : 0u;
    return m;
  });
}

inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return warp_exchange(v, [](const long long* s, int) {
    unsigned t = 0;
    for (int l = 0; l < 32; ++l) t += static_cast<unsigned>(s[l]);
    return t;
  });
}

inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return warp_exchange(v, [](const long long* s, int) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m = std::max(m, static_cast<unsigned>(s[l]));
    return m;
  });
}

template <class K, class... A>
inline void emu_launch(K kern, dim3 grid, dim3 block, size_t smem,
                       cudaStream_t, A... args) {
  const int nt = static_cast<int>(block.x);
  // the card leaves shared memory as the last block left it: fill it
  // with a pattern, so a read of a byte no thread wrote shows
  g_dyn_smem.assign(smem + 16, 0xA5);
  g_shfl_slots.assign(2 * nt, 0);
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
        g_slot_phase = 0;
        kern(args...);
        // a thread that returns early must not hold up later barriers
        g_warp_bars[t >> 5]->arrive_and_drop();
        bar.arrive_and_drop();
      });
    }
    for (auto& th : ts) th.join();
  }
}
