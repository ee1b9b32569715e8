// Exact inner products reduced to each item tile's top-k, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ip_topk.py::ip_topk_tiles
// (body _ip_topk_kernel): for a tile of kBq queries and kBn items, scores =
// Q @ C^T, reduced inside the block to each query's k best (value, global
// id), the lower id first among equal values. The output is (q, n_tiles, k)
// values and ids; kernels/ops.py merges the tiles with a stable descending
// sort, as the reference's ops._merge_topk merges outside its kernel.
//
// Scores are summed term by term in index order with __fmul_rn / __fadd_rn,
// so they equal the scores of kernels/ref.py::ip_topk bit for bit; an FMA
// chain or a GEMM rounds differently and can swap near-equal items.
//
// What bounds it on an H100: at the main-path shape (4,096 x 100) x
// (17,770 x 100), 2 q n d = 14.6 GFLOP at 67 TFLOP/s float32 = 0.22 ms; the
// function's bytes (8.8 MB in, 0.3 MB of top-10 out) take 3 us, and the
// per-tile winners this kernel writes for the merge (46 MB) 14 us. Operations
// bound it. This kernel runs on the SIMT units and issues a separate multiply
// and add (no FMA), so it can reach half that rate at best; the tensor cores
// (TF32) would move bits of the ranking values.
//
// Design: grid (n tiles, q tiles) of 256 threads. A block stages its query
// tile and item tile in shared memory 32 dimensions at a time (rows padded to
// 33 floats: no bank conflicts); thread (ty, tx) = (warp, lane) keeps in
// registers the 4 x 4 scores of queries 4 ty .. 4 ty + 3 and items tx + 32 m.
// Each warp then owns its 4 query rows: k rounds of argmax, in which each
// lane takes the best of its 4 columns and a butterfly shuffle keeps the
// (larger value, lower column) pair, and the winning lane retires its column
// (NaN marks a retired column or one past n). A tile with fewer than k live
// columns pads its output with (-inf, -1); with finite inputs and k <= n the
// merge never selects those.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 32;        // queries per block: 8 warps x 4 rows
constexpr int kBn = 128;       // items per block: 32 lanes x 4 columns
constexpr int kKc = 32;        // dimensions staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ip_topk_kernel(const float* __restrict__ q, const float* __restrict__ items,
               float* __restrict__ vals, int32_t* __restrict__ ids, int nq,
               int n, int d, int k) {
  __shared__ float qs[kBq][kKc + 1];
  __shared__ float cs[kBn][kKc + 1];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int j0 = tile * kBn;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;

  for (int c0 = 0; c0 < d; c0 += kKc) {
    const int kc = min(kKc, d - c0);
    __syncthreads();  // the previous step's reads are done
    for (int e = threadIdx.x; e < kBq * kKc; e += kThreads) {
      const int r = e / kKc, i = e % kKc;
      qs[r][i] = (q0 + r < nq && i < kc)
                     ? q[static_cast<int64_t>(q0 + r) * d + c0 + i] : 0.f;
    }
    for (int e = threadIdx.x; e < kBn * kKc; e += kThreads) {
      const int r = e / kKc, i = e % kKc;
      cs[r][i] = (j0 + r < n && i < kc)
                     ? items[static_cast<int64_t>(j0 + r) * d + c0 + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kc; ++i) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[ty * 4 + r][i];
#pragma unroll
      for (int m = 0; m < 4; ++m) b[m] = cs[tx + 32 * m][i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          acc[r][m] = __fadd_rn(acc[r][m], __fmul_rn(a[r], b[m]));
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (j0 + tx + 32 * m >= n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][m] = NAN;

  const int n_tiles = gridDim.x;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row < nq) {  // uniform across the warp
      const int64_t out = (static_cast<int64_t>(row) * n_tiles + tile) * k;
      for (int s = 0; s < k; ++s) {
        float bv = 0.f;
        int bc = -1;  // -1: no live column
#pragma unroll
        for (int m = 0; m < 4; ++m) {  // columns ascend with m
          const float v = acc[r][m];
          if (!isnan(v) && (bc < 0 || v > bv)) {
            bv = v;
            bc = tx + 32 * m;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
          if (oc >= 0 && (bc < 0 || ov > bv || (ov == bv && oc < bc))) {
            bv = ov;
            bc = oc;
          }
        }
        if (tx == 0) {
          vals[out + s] = bc >= 0 ? bv : -INFINITY;
          ids[out + s] = bc >= 0 ? j0 + bc : -1;
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (tx + 32 * m == bc) acc[r][m] = NAN;
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
// Requires 1 <= k <= 128 and nq <= 32 * 65535 (checked by the wrapper).
extern "C" int ip_topk_launch(const void* q, const void* items, void* vals,
                              void* ids, int nq, int n, int d, int k,
                              void* stream) {
  if (nq > 0 && n > 0) {
    const dim3 grid((n + kBn - 1) / kBn, (nq + kBq - 1) / kBq);
    ip_topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(items),
        static_cast<float*>(vals), static_cast<int32_t*>(ids), nq, n, d, k);
  }
  return static_cast<int>(cudaGetLastError());
}
