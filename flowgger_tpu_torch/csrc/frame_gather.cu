// Dense [rows, max_len] batch from record spans in a raw region.
//
// Replaces the JAX package's Pallas kernel frame_gather_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:399, body _gather_kernel :384),
// which copies dynamic slices of a VMEM-resident region eight rows per
// grid step (_GATHER_ROWG) after padding the region by max_len.
//
// What it computes: out[r, j] = region[starts[r] + j] for
// j < min(lens[r], max_len), else 0; lens_c[r] = min(lens[r], max_len).
// Reads never leave region[0:B): a byte past either end reads as zero,
// the same answer the reference's max_len padding gives, without the
// copy.
//
// Bound on the H100: bytes (each record's bytes read once, rows *
// max_len bytes written once); at the main path's [16384, 512] that is
// ~11 MB, ~3.3 us at 3.35 TB/s, so the launch must move bytes in wide
// accesses and spend nothing on block scheduling or per-byte tests.
// Design: one warp per row, kWarps rows a block.  Lane l owns the
// 16-byte-aligned output words l, l + 32, ... of its row: at max_len =
// 512 the warp writes the whole row with one 16-byte store a lane.  A
// lane's 16 source bytes start at any byte offset, so it loads the one or
// two 16-byte-aligned words that cover them and shifts them into place
// with 64-bit funnel shifts.  Lanes at or past the row's length load
// nothing and store zeros; the lane that straddles it masks the rest of
// its word.  The edges the vector path does not take, each handled in the
// kernel: an aligned source word that is not wholly inside region[0:B)
// (a region whose size is not a multiple of 16, or whose address is not
// 16-byte aligned) is read byte by byte, bytes outside reading 0; when
// rows are not 16-byte aligned (max_len not a multiple of 16, or an
// unaligned output pointer) the words stay aligned to the output and
// only each row's first and last word, which it shares with its
// neighbours, is stored byte by byte; rows past `rows` in the last block
// return at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows a block
constexpr int kThreads = 32 * kWarps;

// bytes [k, k + 8) of the 16-byte little-endian pair (lo, hi), k < 8
__device__ __forceinline__ uint64_t shr_pair(uint64_t lo, uint64_t hi,
                                             int k) {
  return k == 0 ? lo : (lo >> (8 * k)) | (hi << (64 - 8 * k));
}

// The aligned 16-byte word at region offset a (a % 16 == the region
// address's misalignment), as two little-endian 64-bit halves.  A word
// wholly inside region[0:B) is one vector load; any other is read byte
// by byte, the bytes outside region[0:B) reading 0.
__device__ __forceinline__ void load_word(const uint8_t* __restrict__ region,
                                          long long B, long long a,
                                          uint64_t* lo, uint64_t* hi) {
  if (a >= 0 && a + 16 <= B) {
    const uint4 v = *reinterpret_cast<const uint4*>(region + a);
    *lo = (uint64_t)v.x | ((uint64_t)v.y << 32);
    *hi = (uint64_t)v.z | ((uint64_t)v.w << 32);
    return;
  }
  uint64_t w[2] = {0, 0};
  for (int k = 0; k < 16; ++k) {
    const long long p = a + k;
    if (p >= 0 && p < B) w[k >> 3] |= (uint64_t)region[p] << (8 * (k & 7));
  }
  *lo = w[0];
  *hi = w[1];
}

// bytes [0, n) of a little-endian 64-bit word set, n clamped to [0, 8]
__device__ __forceinline__ uint64_t low_bytes(int n) {
  return n >= 8 ? ~0ull : n <= 0 ? 0ull : (1ull << (8 * n)) - 1;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* __restrict__ region, long long B,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ lens, int rows, int max_len,
              uint8_t* __restrict__ out, int32_t* __restrict__ lens_c) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const long long s = starts[r];
  const int lc = lens[r] < max_len ? lens[r] : max_len;
  const int ln = lc > 0 ? lc : 0;
  if (lane == 0) lens_c[r] = lc;
  uint8_t* dst = out + (size_t)r * max_len;
  // The warp walks the 16-byte-aligned output words that overlap the
  // row: word q holds row bytes [j, j + 16), j = 16 q - d, where d is the
  // row's misalignment (0 for every row when max_len is a multiple of 16
  // and the output is aligned).  Only a row's first and last words can
  // reach into its neighbours; those are stored byte by byte.
  const int d = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  // misalignment of the region's address: source word boundaries sit at
  // region offsets congruent to -mis mod 16
  const int mis = (int)(reinterpret_cast<uintptr_t>(region) & 15);
  for (int j = lane * 16 - d; j < max_len; j += 32 * 16) {
    const int first = j < 0 ? -j : 0;             // first byte of the row
    const int need = ln - j < 16 ? ln - j : 16;   // past its last source byte
    uint64_t lo = 0, hi = 0;
    if (need > first) {
      const long long src = s + j;
      const int off = (int)((src + mis) & 15);    // byte offset in its word
      const long long a0 = src - off;
      uint64_t l0, h0, l1 = 0, h1 = 0;
      load_word(region, B, a0, &l0, &h0);
      if (off + need > 16) load_word(region, B, a0 + 16, &l1, &h1);
      if (off < 8) {
        lo = shr_pair(l0, h0, off);
        hi = shr_pair(h0, l1, off);
      } else {
        lo = shr_pair(h0, l1, off - 8);
        hi = shr_pair(l1, h1, off - 8);
      }
      // zero the bytes at and past the row's length (bytes before
      // `first` belong to the row before and are not stored)
      lo &= low_bytes(need);
      hi &= low_bytes(need - 8);
    }
    const int end = max_len - j < 16 ? max_len - j : 16;
    if (first == 0 && end == 16) {
      uint4 v;
      v.x = (unsigned)lo;
      v.y = (unsigned)(lo >> 32);
      v.z = (unsigned)hi;
      v.w = (unsigned)(hi >> 32);
      *reinterpret_cast<uint4*>(dst + j) = v;
    } else {
      for (int k = first; k < end; ++k)
        dst[j + k] = (uint8_t)((k < 8 ? lo : hi) >> (8 * (k & 7)));
    }
  }
}

}  // namespace

extern "C" {

int fg_frame_gather(const void* region, long long B, const void* starts,
                    const void* lens, int rows, int max_len, void* out,
                    void* lens_c, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(region), B,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      rows, max_len, static_cast<uint8_t*>(out),
      static_cast<int32_t*>(lens_c));
  return (int)cudaGetLastError();
}

}  // extern "C"
