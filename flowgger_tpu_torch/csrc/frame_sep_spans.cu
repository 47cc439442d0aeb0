// Line / NUL record spans over a raw region.
//
// Replaces the JAX package's Pallas kernel frame_sep_spans_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:237, body _sep_kernel :194), which
// builds a next-separator plane with a reverse cummin ladder and then
// walks the record chain sequentially inside one VMEM block.
//
// What it computes, for region[0:rlen) and separator byte `sep`:
// the k-th record (k < ncap) starts one past the (k-1)-th separator
// (0 for k = 0) and ends at the k-th separator, minus one trailing CR
// when strip_cr and the record is non-empty; slots k >= n are zero;
// meta = {n, consumed (one past the last recorded separator), overflow
// (n > ncap), 0}.
//
// Bound on the H100: bytes (one read of the region, 8 bytes written per
// record): ~0.8 us for the main path's 2.7 MB region, less than one
// launch's latency, so the design spends one launch and one read of the
// region.  Design: the single-pass prefix scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA NVR-2016-002), one kernel per call:
//   1. a block takes its tile from an atomic ticket (blocks are not
//      scheduled in index order; a tile's predecessors then always hold
//      a ticket, so the look-back cannot wait on a block that never
//      runs);
//   2. it loads its 16 KiB tile once, 32 contiguous bytes a thread in
//      two 16-byte loads, and turns them into separator and CR bit masks
//      four bytes at a time (a zero-byte test on the word xor the byte);
//   3. warp scans of the threads' counts and last separators give the
//      tile's aggregate (count, last separator);
//   4. it publishes the aggregate in the tile's 64-bit status word;
//   5. one warp looks back over the predecessors' words, 32 at a time,
//      summing counts and taking the max of the last positions until it
//      meets an inclusive prefix;
//   6. it publishes its own inclusive prefix;
//   7. every separator writes its record from the registers: its
//      ordinal (tile prefix, warps before, lanes before) is the slot,
//      the previous separator the start.
// A status word is flag (2 bits: 0 not ready, 1 aggregate, 2 inclusive)
// | count (31 bits) | last + 1 (31 bits), since rlen < 2^31; it is
// published with one 64-bit store and read with volatile loads.  The
// word carries all that a reader takes from it, so no fence precedes
// the store.  The tile with the highest index closes the scan: it
// writes n, overflow and (when n <= ncap) consumed, and zero-fills
// slots [n, ncap); when n > ncap the thread that writes slot ncap - 1
// writes consumed.  No 1 MiB single-block cap (PALLAS_MAX_REGION)
// applies.
//
// Scratch: two uint32 counters (the ticket and the count of blocks done
// with the scratch) and one status word per tile, all zero at entry.
// The kernel leaves them zero: a block counts itself done once it has
// published its inclusive prefix (after a __threadfence(), so that store
// lands first), and the last block to count clears the status words and
// both counters while the others write their records.  So a caller
// zeroes the scratch once, when it allocates it, and reuses it for every
// launch on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 32;
constexpr int kTile = kThreads * kBytesPerThread;  // 16 KiB a block
constexpr unsigned kFull = 0xffffffffu;

constexpr uint64_t kFlagAggregate = 1ull << 62;
constexpr uint64_t kFlagInclusive = 2ull << 62;
constexpr uint64_t kField = (1ull << 31) - 1;

__device__ __forceinline__ uint64_t status_word(uint64_t flag,
                                                unsigned count,
                                                unsigned last1) {
  return flag | ((uint64_t)count << 31) | last1;
}

__device__ __forceinline__ int warp_incl_sum(int v) {
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, v, o);
    if ((threadIdx.x & 31) >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ int warp_incl_max(int v) {
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, v, o);
    if ((threadIdx.x & 31) >= o) v = max(v, t);
  }
  return v;
}

// The exclusive prefix of tile t > 0 as (count, last + 1), read by one
// whole warp from the status words of tiles [0, t): a window of 32
// words (lane 31 reads the nearest) is read until every word is
// published, then summed from the nearest inclusive word up, or whole
// when it holds none, and the window moves 32 words back.  Tile 0
// always publishes an inclusive word, so the walk ends.
__device__ void lookback(const uint64_t* status, int t, unsigned* count,
                         unsigned* last1) {
  const int lane = threadIdx.x & 31;
  unsigned c = 0, l = 0;
  for (int hi = t - 1;; hi -= 32) {
    const int i = hi - 31 + lane;
    uint64_t w;
    do {
      w = i >= 0 ? *reinterpret_cast<const volatile uint64_t*>(status + i)
                 : kFlagInclusive;
    } while (__ballot_sync(kFull, (w >> 62) != 0) != kFull);
    const unsigned incl = __ballot_sync(kFull, (w >> 62) == 2);
    const int from = incl ? 31 - __clz((int)incl) : 0;
    const bool use = lane >= from;
    c += __reduce_add_sync(kFull, use ? (unsigned)((w >> 31) & kField) : 0u);
    l = max(l, __reduce_max_sync(kFull, use ? (unsigned)(w & kField) : 0u));
    if (incl) break;
  }
  *count = c;
  *last1 = l;
}

// bit i set where byte i of x is zero (i < 4)
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  const unsigned t = ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (((t >> 7) * 0x00204081u) >> 21) & 0xfu;
}

__global__ void __launch_bounds__(kThreads)
sep_spans_kernel(const uint8_t* __restrict__ region, int rlen, int sep,
                 int strip_cr, int ncap, unsigned* counters,
                 uint64_t* status, int32_t* __restrict__ starts,
                 int32_t* __restrict__ lens, int32_t* __restrict__ meta) {
  __shared__ int s_tile;
  __shared__ int s_wsum[kWarps], s_wmax[kWarps];
  // tile prefix (count, last + 1) and tile aggregate (count, last + 1)
  __shared__ unsigned s_prefix[4];
  __shared__ bool s_last;
  const int ntiles = gridDim.x;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(&counters[0], 1u);
  __syncthreads();
  const int t = s_tile;

  // this thread's 32 bytes: two 16-byte loads, or bytes at the region's
  // end or from an unaligned region; bytes at or past rlen are masked
  const int base = t * kTile + threadIdx.x * kBytesPerThread;
  unsigned w[8];
  const bool aligned = (reinterpret_cast<uintptr_t>(region) & 15) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p0 = base + 16 * h;
    if (aligned && p0 + 16 <= rlen) {
      const uint4 v = *reinterpret_cast<const uint4*>(region + p0);
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    } else {
      for (int j = 0; j < 4; ++j) {
        unsigned x = 0;
        for (int k = 0; k < 4; ++k) {
          const int p = p0 + 4 * j + k;
          if (p < rlen) x |= (unsigned)region[p] << (8 * k);
        }
        w[4 * h + j] = x;
      }
    }
  }
  const int nvalid = rlen - base;
  const unsigned valid = nvalid >= 32 ? kFull
                         : nvalid <= 0 ? 0u : (1u << nvalid) - 1;
  const unsigned sep4 = 0x01010101u * (unsigned)sep;
  unsigned sepm = 0, crm = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sepm |= zero_bytes(w[j] ^ sep4) << (4 * j);
    crm |= zero_bytes(w[j] ^ 0x0d0d0d0du) << (4 * j);
  }
  sepm &= valid;
  const int cnt = __popc(sepm);
  const int last = sepm ? base + 31 - __clz((int)sepm) : -1;

  // warp scans now; the tile's aggregate from the warp totals, so it is
  // published before the block's own exclusive offsets are formed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int is = warp_incl_sum(cnt);
  const int im = warp_incl_max(last);
  if (lane == 31) {
    s_wsum[warp] = is;
    s_wmax[warp] = im;
  }
  __syncthreads();

  // publish the aggregate, look back, publish the inclusive prefix
  if (warp == 0) {
    const unsigned tot = __reduce_add_sync(
        kFull, lane < kWarps ? (unsigned)s_wsum[lane] : 0u);
    const unsigned tl1 = __reduce_max_sync(
        kFull, lane < kWarps ? (unsigned)(s_wmax[lane] + 1) : 0u);
    unsigned pc = 0, pl = 0;
    if (t > 0) {
      if (lane == 0)
        *reinterpret_cast<volatile uint64_t*>(status + t) =
            status_word(kFlagAggregate, tot, tl1);
      lookback(status, t, &pc, &pl);
    }
    if (lane == 0) {
      *reinterpret_cast<volatile uint64_t*>(status + t) =
          status_word(kFlagInclusive, pc + tot, max(pl, tl1));
      s_prefix[0] = pc;
      s_prefix[1] = pl;
      s_prefix[2] = tot;
      s_prefix[3] = tl1;
      // this block is done with the scratch: its look-back reads are
      // complete and the fence orders its last status store before the
      // count, so the last block to count may clear it
      __threadfence();
      s_last = atomicAdd(&counters[1], 1u) == (unsigned)(ntiles - 1);
    }
  }
  __syncthreads();
  if (s_last) {
    for (int j = threadIdx.x; j < ntiles; j += kThreads) status[j] = 0;
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }

  // each separator writes its record: its ordinal from the tile prefix,
  // the warps before and the lanes before; the previous separator
  // likewise
  int k = (int)s_prefix[0] + is - cnt;
  int prev = __shfl_up_sync(kFull, im, 1);
  if (lane == 0) prev = -1;
  prev = max(prev, (int)s_prefix[1] - 1);
  for (int v = 0; v < warp; ++v) {
    k += s_wsum[v];
    prev = max(prev, s_wmax[v]);
  }
  for (unsigned m = sepm; m && k < ncap; m &= m - 1, ++k) {
    const int bit = __ffs((int)m) - 1;
    const int p = base + bit;
    const int start = prev + 1;
    int ln = p - start;
    if (strip_cr && ln > 0) {
      const bool cr = bit > 0 ? (crm >> (bit - 1)) & 1u : region[p - 1] == 13;
      ln -= cr ? 1 : 0;
    }
    starts[k] = start;
    lens[k] = ln;
    if (k == ncap - 1) meta[1] = p + 1;
    prev = p;
  }

  // the closing tile: n, overflow, consumed when n <= ncap, empty slots
  if (t == ntiles - 1) {
    const int n = (int)(s_prefix[0] + s_prefix[2]);
    if (threadIdx.x == 0) {
      meta[0] = n;
      if (n <= ncap) meta[1] = (int)max(s_prefix[1], s_prefix[3]);
      meta[2] = n > ncap ? 1 : 0;
      meta[3] = 0;
    }
    for (int j = n + threadIdx.x; j < ncap; j += kThreads) {
      starts[j] = 0;
      lens[j] = 0;
    }
  }
}

}  // namespace

extern "C" {

// region: u8[B] (B >= rlen); counters: u32[2] and status: u64[ntiles],
// ntiles = max(1, ceil(rlen / 16384)), zero at entry and left zero;
// starts/lens: i32[ncap]; meta: i32[4].
int fg_frame_sep_spans(const void* region, int rlen, int sep, int strip_cr,
                       int ncap, void* counters, void* status, void* starts,
                       void* lens, void* meta, void* stream) {
  int ntiles = (rlen + kTile - 1) / kTile;
  if (ntiles < 1) ntiles = 1;
  sep_spans_kernel<<<ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(region), rlen, sep, strip_cr, ncap,
      static_cast<unsigned*>(counters), static_cast<uint64_t*>(status),
      static_cast<int32_t*>(starts), static_cast<int32_t*>(lens),
      static_cast<int32_t*>(meta));
  return (int)cudaGetLastError();
}

int fg_frame_sep_tile_bytes() { return kTile; }

}  // extern "C"
