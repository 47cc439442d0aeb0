// Dense [rows, max_len] batch from record spans in a raw region.
//
// Replaces the JAX package's Pallas kernel frame_gather_pallas
// (flowgger_tpu/tpu/pallas_kernels.py:399, body _gather_kernel :384),
// which copies dynamic slices of a VMEM-resident region eight rows per
// grid step (_GATHER_ROWG) after padding the region by max_len.
//
// What it computes: out[r, j] = region[starts[r] + j] for
// j < min(lens[r], max_len), else 0; lens_c[r] = min(lens[r], max_len).
// Reads never leave region[0:B): a byte past the end reads as zero, the
// same answer the reference's max_len padding gives, without the copy.
//
// Bound on the H100: bytes (the region bytes of the records, written
// once as rows * max_len bytes).  Design: one block per row; threads
// stride the row so neighbouring threads touch neighbouring bytes on
// both the read and the write side.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* __restrict__ region, long long B,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ lens, int max_len,
              uint8_t* __restrict__ out, int32_t* __restrict__ lens_c) {
  const int r = blockIdx.x;
  const long long s = starts[r];
  const int lc = lens[r] < max_len ? lens[r] : max_len;
  const int ln = lc > 0 ? lc : 0;
  uint8_t* dst = out + (size_t)r * max_len;
  for (int j = threadIdx.x; j < max_len; j += blockDim.x) {
    long long p = s + j;
    dst[j] = (j < ln && p >= 0 && p < B) ? region[p] : 0;
  }
  if (threadIdx.x == 0) lens_c[r] = lc;
}

}  // namespace

extern "C" {

int fg_frame_gather(const void* region, long long B, const void* starts,
                    const void* lens, int rows, int max_len, void* out,
                    void* lens_c, void* stream) {
  if (rows <= 0) return 0;
  gather_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(region), B,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(lens),
      max_len, static_cast<uint8_t*>(out), static_cast<int32_t*>(lens_c));
  return (int)cudaGetLastError();
}

}  // extern "C"
