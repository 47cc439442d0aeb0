// Host emulation of the CUDA runtime subset the port's kernels use, so
// their sources compile with g++ and run on the CPU in the tests.
//
// Blocks run one after another.  Each warp of a block runs on one OS
// thread (warp 0 on the caller's), and each CUDA thread of the warp as a
// cooperative fiber on its own stack: a lane runs until it meets a
// barrier, then the next ready lane of the warp takes over.  Warp
// intrinsics (shuffles, ballots, reductions) exchange through a shared
// slot array: every lane publishes its value, the warp meets at its warp
// barrier, each lane reads what it needs.  Two slot arrays alternate, so
// a lane that runs ahead to the next exchange cannot overwrite a slot
// another lane is still reading (it would first have to pass the next
// barrier, which that lane has not reached).  __syncwarp is the warp
// barrier alone.  __syncthreads gathers the warp's lanes, then the warps
// meet at a block-wide std::barrier.  So the warps of a block run
// concurrently (a thread may wait for another warp's store with volatile
// loads), while the lanes of one warp take turns.
//
// Every lane of a warp must reach each warp intrinsic and each barrier at
// the same call site, as the kernels do (they launch whole warps and
// keep every warp intrinsic under warp-uniform control); a lane that
// returns early leaves its warp's and its block's barriers, as on the
// card.  Each barrier records its call site (std::source_location, a
// defaulted argument), and a lane that arrives at another site than the
// lanes before it, or a warp whose lanes all wait at barriers that can
// never open, fails the launch with a message on stderr:
// cudaGetLastError() returns cudaErrorLaunchFailure and the kernel's
// later launches in the entry point are skipped.  A watchdog ends the
// process with a message when no barrier of the launch has opened for
// kWatchdogSeconds (a warp that spins for ever, or waits at a block
// barrier another warp never reaches).  The mask argument is not read.
// atomicAdd goes through std::atomic_ref, __threadfence is a sequentially
// consistent std::atomic_thread_fence, and volatile loads and stores are
// the compiler's own.  __shared__ variables become statics (one block at
// a time, so one copy suffices); the dynamic shared memory starts each
// launch filled with 0xA5, not zeros.  tests/cuda_host/build.py rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` into emu_launch(...) and
// `extern __shared__ T name[]` into a pointer at the dynamic buffer.
// This checks the kernels' logic and indexing, not their speed or any
// property of the GPU's memory model.
#pragma once

#include <stdint.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <source_location>
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchFailure = 719 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// set by a launch that failed its barrier checks; read and cleared here
inline std::atomic<int> g_emu_error{cudaSuccess};

inline cudaError_t cudaGetLastError() { return g_emu_error.exchange(0); }

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

inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

// ---------------------------------------------------------------------------
// fibers: one a CUDA thread, scheduled cooperatively within its warp
// ---------------------------------------------------------------------------

constexpr int kWatchdogSeconds = 120;
constexpr size_t kFiberStack = 256 * 1024;

enum EmuWait { kReady = 0, kAtWarp = 1, kAtBlock = 2, kDone = 3 };

struct EmuSite {
  unsigned line = 0, column = 0;
  const char* what = "";
  bool operator!=(const EmuSite& o) const {
    return line != o.line || column != o.column;
  }
};

struct EmuFiber {
  ucontext_t ctx;
  int tid = 0;
  int state = kReady;
  long gen = 0;        // the barrier generation it waits to pass
  int slot_phase = 0;
  EmuSite site;        // where it waits
};

struct EmuWarp {
  int w = 0, n = 0, live = 0;
  EmuFiber f[32];
  char* stacks = nullptr;
  size_t stack_bytes = 0;
  int cur = -1;
  ucontext_t sched;
  // the warp barrier: lanes arrived in this phase, its generation and
  // the site the first lane arrived at
  int w_arrived = 0;
  long w_gen = 0;
  EmuSite w_site;
  // the warp's part of the block barrier
  int b_arrived = 0;
  long b_gen = 0;
  EmuSite b_site;
  bool failed = false;
  void (*body)(void*) = nullptr;
  void* body_ctx = nullptr;

  ~EmuWarp() {
    if (stacks) munmap(stacks, stack_bytes);
  }
};

inline thread_local EmuWarp* g_warp = nullptr;
inline std::vector<unsigned char> g_dyn_smem;
inline std::vector<long long> g_shfl_slots;
inline std::barrier<>* g_block_bar = nullptr;
// barriers opened in the current launch (the watchdog's progress mark)
inline std::atomic<long> g_progress{0};

inline void emu_fail(EmuWarp* wp, const char* msg, int lane_a,
                     const EmuSite& a, int lane_b, const EmuSite& b) {
  fprintf(stderr,
          "cuda_host emulation: block %u warp %d: %s: thread %d at %s "
          "(line %u col %u), thread %d at %s (line %u col %u)\n",
          blockIdx.x, wp->w, msg, 32 * wp->w + lane_a, a.what, a.line,
          a.column, 32 * wp->w + lane_b, b.what, b.line, b.column);
  fflush(stderr);
  wp->failed = true;
  g_emu_error.store(cudaErrorLaunchFailure);
}

inline void emu_switch_to_sched(EmuWarp* wp, EmuFiber* f) {
  swapcontext(&f->ctx, &wp->sched);
}

inline bool emu_ready(const EmuWarp* wp, const EmuFiber& f) {
  switch (f.state) {
    case kReady: return true;
    case kAtWarp: return f.gen != wp->w_gen;
    case kAtBlock: return f.gen != wp->b_gen;
    default: return false;
  }
}

// the calling lane waits: hand the warp to the scheduler until the lane
// is ready again
inline void emu_wait(EmuWarp* wp) {
  EmuFiber* f = &wp->f[wp->cur];
  emu_switch_to_sched(wp, f);
  threadIdx = dim3(f->tid);
}

inline void emu_warp_barrier(const char* what, const std::source_location& loc) {
  EmuWarp* wp = g_warp;
  EmuFiber& f = wp->f[wp->cur];
  EmuSite s{loc.line(), loc.column(), what};
  if (wp->w_arrived == 0) {
    wp->w_site = s;
  } else if (wp->w_site != s) {
    int first = 0;
    for (int i = 0; i < wp->n; ++i)
      if (wp->f[i].state == kAtWarp && wp->f[i].gen == wp->w_gen) first = i;
    emu_fail(wp, "lanes of a warp at different warp barriers", first,
             wp->w_site, wp->cur, s);
    f.state = kAtWarp;
    f.gen = wp->w_gen;
    f.site = s;
    emu_wait(wp);  // never resumed: the launch has failed
  }
  if (++wp->w_arrived == wp->live) {
    wp->w_arrived = 0;
    ++wp->w_gen;
    g_progress.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  f.state = kAtWarp;
  f.gen = wp->w_gen;
  f.site = s;
  emu_wait(wp);
  f.state = kReady;
}

inline void __syncthreads(
    const std::source_location loc = std::source_location::current()) {
  EmuWarp* wp = g_warp;
  EmuFiber& f = wp->f[wp->cur];
  EmuSite s{loc.line(), loc.column(), "__syncthreads"};
  if (wp->b_arrived == 0) {
    wp->b_site = s;
  } else if (wp->b_site != s) {
    emu_fail(wp, "lanes of a warp at different block barriers", 0,
             wp->b_site, wp->cur, s);
  }
  ++wp->b_arrived;
  f.state = kAtBlock;
  f.gen = wp->b_gen;
  f.site = s;
  emu_wait(wp);
  f.state = kReady;
}

inline void __syncwarp(
    unsigned = 0xffffffffu,
    const std::source_location loc = std::source_location::current()) {
  emu_warp_barrier("__syncwarp", loc);
}

// Publishes v for the warp, then returns read(slots of this warp, lane).
template <class R>
inline auto warp_exchange(long long v, R read, const char* what,
                          const std::source_location& loc) {
  EmuWarp* wp = g_warp;
  EmuFiber& f = wp->f[wp->cur];
  const int tid = f.tid;
  long long* slots = &g_shfl_slots[f.slot_phase * blockDim.x];
  f.slot_phase ^= 1;
  slots[tid] = v;
  emu_warp_barrier(what, loc);
  return read(slots + (tid & ~31), tid & 31);
}

template <class T>
inline T __shfl_sync(
    unsigned, T v, int src,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int) {
                         return static_cast<T>(s[src & 31]);
                       }, "__shfl_sync", loc);
}

template <class T>
inline T __shfl_up_sync(
    unsigned, T v, unsigned delta,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return lane >= static_cast<int>(delta)
                                    ? static_cast<T>(s[lane - delta]) : v;
                       }, "__shfl_up_sync", loc);
}

template <class T>
inline T __shfl_down_sync(
    unsigned, T v, unsigned delta,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return lane + static_cast<int>(delta) < 32
                                    ? static_cast<T>(s[lane + delta]) : v;
                       }, "__shfl_down_sync", loc);
}

template <class T>
inline T __shfl_xor_sync(
    unsigned, T v, int lane_mask,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(static_cast<long long>(v),
                       [&](const long long* s, int lane) {
                         return static_cast<T>(s[(lane ^ lane_mask) & 31]);
                       }, "__shfl_xor_sync", loc);
}

inline unsigned __ballot_sync(
    unsigned, int pred,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(pred != 0, [](const long long* s, int) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= s[l] ? 1u << l : 0u;
    return m;
  }, "__ballot_sync", loc);
}

inline unsigned __reduce_add_sync(
    unsigned, unsigned v,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(v, [](const long long* s, int) {
    unsigned t = 0;
    for (int l = 0; l < 32; ++l) t += static_cast<unsigned>(s[l]);
    return t;
  }, "__reduce_add_sync", loc);
}

inline unsigned __reduce_max_sync(
    unsigned, unsigned v,
    const std::source_location loc = std::source_location::current()) {
  return warp_exchange(v, [](const long long* s, int) {
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m = std::max(m, static_cast<unsigned>(s[l]));
    return m;
  }, "__reduce_max_sync", loc);
}

// a fiber's first frame: run the kernel as this lane, leave the warp's
// barriers, hand the warp back for good
inline void emu_fiber_main() {
  EmuWarp* wp = g_warp;
  EmuFiber* f = &wp->f[wp->cur];
  threadIdx = dim3(f->tid);
  wp->body(wp->body_ctx);
  f->state = kDone;
  --wp->live;
  if (wp->w_arrived > 0 && wp->w_arrived == wp->live) {
    wp->w_arrived = 0;
    ++wp->w_gen;
  }
  for (;;) emu_switch_to_sched(wp, f);
}

inline void emu_start_fiber(EmuWarp* wp, int i) {
  EmuFiber& f = wp->f[i];
  char* lo = wp->stacks + i * (kFiberStack + 4096) + 4096;  // guard below
  getcontext(&f.ctx);
  f.ctx.uc_stack.ss_sp = lo;
  f.ctx.uc_stack.ss_size = kFiberStack;
  f.ctx.uc_link = nullptr;
  makecontext(&f.ctx, emu_fiber_main, 0);
}

inline void emu_resume(EmuWarp* wp, int i) {
  wp->cur = i;
  threadIdx = dim3(wp->f[i].tid);
  swapcontext(&wp->sched, &wp->f[i].ctx);
}

// runs one warp of the current block to its end on the calling thread
inline void emu_run_warp(EmuWarp* wp) {
  g_warp = wp;
  wp->live = wp->n;
  wp->w_arrived = wp->b_arrived = 0;
  wp->failed = false;
  for (int i = 0; i < wp->n; ++i) {
    wp->f[i] = EmuFiber();
    wp->f[i].tid = 32 * wp->w + i;
    emu_start_fiber(wp, i);
  }
  int next = 0;
  for (;;) {
    int pick = -1;
    for (int k = 0; k < wp->n; ++k) {
      int i = (next + k) % wp->n;
      if (emu_ready(wp, wp->f[i])) {
        pick = i;
        break;
      }
    }
    if (pick >= 0 && !wp->failed) {
      emu_resume(wp, pick);
      next = pick + 1;
      continue;
    }
    if (wp->failed) break;
    if (wp->live == 0) break;
    if (wp->b_arrived == wp->live) {
      // every live lane is at the block barrier: the warp arrives there
      g_block_bar->arrive_and_wait();
      g_progress.fetch_add(1, std::memory_order_relaxed);
      wp->b_arrived = 0;
      ++wp->b_gen;
      next = 0;
      continue;
    }
    int a = -1, b = -1;
    for (int i = 0; i < wp->n; ++i) {
      if (wp->f[i].state == kAtWarp) a = a < 0 ? i : a;
      if (wp->f[i].state == kAtBlock) b = b < 0 ? i : b;
    }
    emu_fail(wp, "lanes wait at a warp barrier the others never reach",
             a, wp->f[a < 0 ? 0 : a].site, b < 0 ? a : b,
             wp->f[b < 0 ? (a < 0 ? 0 : a) : b].site);
    break;
  }
  // a warp that ends (or fails) leaves the block barrier
  g_block_bar->arrive_and_drop();
  g_warp = nullptr;
}

inline EmuWarp* emu_new_warp(int w, int n) {
  EmuWarp* wp = new EmuWarp();
  wp->w = w;
  wp->n = n;
  wp->stack_bytes = static_cast<size_t>(n) * (kFiberStack + 4096);
  void* m = mmap(nullptr, wp->stack_bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (m == MAP_FAILED) {
    fprintf(stderr, "cuda_host emulation: no memory for fiber stacks\n");
    abort();
  }
  wp->stacks = static_cast<char*>(m);
  for (int i = 0; i < n; ++i)  // a guard page under each stack
    mprotect(wp->stacks + i * (kFiberStack + 4096), 4096, PROT_NONE);
  return wp;
}

template <class K, class... A>
inline void emu_launch(K kern, dim3 grid, dim3 block, size_t smem,
                       cudaStream_t, A... args) {
  if (g_emu_error.load() != cudaSuccess) return;
  const int nt = static_cast<int>(block.x);
  const int nw = (nt + 31) / 32;
  // the card leaves shared memory as the last block left it: fill it
  // with a pattern, so a read of a byte no thread wrote shows
  g_dyn_smem.assign(smem + 16, 0xA5);
  g_shfl_slots.assign(2 * nt, 0);
  gridDim = grid;
  blockDim = block;
  auto body = [&]() { kern(args...); };
  using Body = decltype(body);
  std::vector<std::unique_ptr<EmuWarp>> warps;
  for (int w = 0; w < nw; ++w) {
    warps.emplace_back(emu_new_warp(w, std::min(32, nt - 32 * w)));
    warps.back()->body = [](void* c) { (*static_cast<Body*>(c))(); };
    warps.back()->body_ctx = &body;
  }
  // the watchdog: no barrier opened for kWatchdogSeconds ends the process
  std::mutex wd_m;
  std::condition_variable wd_cv;
  bool done = false;
  std::thread watchdog([&] {
    std::unique_lock<std::mutex> l(wd_m);
    long seen = g_progress.load();
    auto since = std::chrono::steady_clock::now();
    while (!done) {
      wd_cv.wait_for(l, std::chrono::seconds(1));
      long now = g_progress.load();
      if (now != seen) {
        seen = now;
        since = std::chrono::steady_clock::now();
      } else if (std::chrono::steady_clock::now() - since >
                 std::chrono::seconds(kWatchdogSeconds)) {
        fprintf(stderr,
                "cuda_host emulation: no barrier of block %u opened for "
                "%d s: a thread spins for ever or a warp waits at a "
                "barrier another warp never reaches\n",
                blockIdx.x, kWatchdogSeconds);
        fflush(stderr);
        abort();
      }
    }
  });
  for (unsigned b = 0; b < grid.x && g_emu_error.load() == cudaSuccess;
       ++b) {
    blockIdx = dim3(b);
    std::barrier<> bar(nw);
    g_block_bar = &bar;
    std::vector<std::thread> ts;
    for (int w = 1; w < nw; ++w)
      ts.emplace_back([&, w] { emu_run_warp(warps[w].get()); });
    emu_run_warp(warps[0].get());
    for (auto& th : ts) th.join();
    g_block_bar = nullptr;
  }
  {
    std::lock_guard<std::mutex> l(wd_m);
    done = true;
  }
  wd_cv.notify_all();
  watchdog.join();
}
