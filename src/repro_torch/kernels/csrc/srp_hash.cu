// Fused SRP hashing -- projection, sign test and bit packing -- for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/srp_hash.py::srp_hash (body
// _srp_kernel): code[i, w] bit j = (x[i] . proj[:, 32 w + j] >= 0), with
// x (n, d) f32 and proj (d, B) f32 row-major, B % 32 == 0 -> (n, B / 32)
// 32-bit words.
//
// What bounds it on an H100: float32 arithmetic outside the tensor cores.
// At the build shape (17,920 x 101) x (101 x 128) the products are 463 MFLOP,
// 7 us at 67 TFLOP/s, against 7.6 MB of traffic (2.3 us at 3.35 TB/s). At
// the per-chunk query shape (256 x 100) x (100 x 128) it is launch bound.
// The sign must be decided in full float32 (a TF32 product would move bits),
// so the tensor cores are not used.
//
// Design: one block per row, one warp per 32-bit output word. The row is
// staged in shared memory once; lane j of warp w keeps one running fmaf sum
// over i = 0..d-1 of x[i] * proj[i, 32 w + j] (the 32 lanes read 32
// neighbouring proj floats, one 128-byte line per step, and proj, 52 KB,
// stays in L1/L2 across rows). __ballot_sync of (s >= 0) is the packed word,
// written by lane 0: -0.0 >= 0 is true and NaN >= 0 is false, as in the
// reference. The summation order differs from a GEMM's, so a bit may differ
// from torch.matmul where x . proj lies within rounding of 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void srp_kernel(const float* __restrict__ x,
                           const float* __restrict__ proj,
                           uint32_t* __restrict__ out, int d, int b) {
  extern __shared__ float row[];  // (d,)
  const int64_t r = blockIdx.x;
  const float* xr = x + r * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) row[i] = xr[i];
  __syncthreads();

  const int col = threadIdx.x;  // blockDim.x == b
  float s = 0.f;
  for (int i = 0; i < d; ++i)
    s = fmaf(row[i], proj[static_cast<int64_t>(i) * b + col], s);
  const unsigned word = __ballot_sync(0xffffffffu, s >= 0.f);
  if ((threadIdx.x & 31) == 0) out[r * (b / 32) + (col >> 5)] = word;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
// Requires b % 32 == 0 and b <= 1024 (one thread per output bit).
extern "C" int srp_hash_launch(const void* x, const void* proj, void* out,
                               int n, int d, int b, void* stream) {
  if (n > 0) {
    const size_t smem = sizeof(float) * static_cast<size_t>(d);
    srp_kernel<<<n, b, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(proj),
        static_cast<uint32_t*>(out), d, b);
  }
  return static_cast<int>(cudaGetLastError());
}
