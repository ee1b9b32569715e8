// Hamming distances between bit-packed SRP codes, for sm_90a: the dense
// all-pairs matrix, and the n_cand nearest rows of each lane in one pass.
//
// Replaces the Pallas kernel src/repro/kernels/hamming_scan.py::hamming_scores
// (body _hamming_kernel): out[i, j] = sum_w popcount(q[i, w] ^ items[j, w]),
// (q, W) x (n, W) 32-bit codes -> (q, n) int32. The reference's caller
// (src/repro/core/sa_alsh.py::_tile_candidates) then masks the tile and
// takes lax.top_k(-dist, n_cand); hamming_nearest_launch does all three:
// (C, W) lane codes, (T, W) tile codes and a (T,) mask -> (C, n_cand) int32
// rows, ascending by distance (masked rows at 1 << 30), the lower row first
// on ties, which is kernels/ref.py::hamming_nearest.
//
// What bounds them on an H100: the dense kernel's (q, n) int32 output. At
// the main-path shape (256, 4) x (512, 4) the call moves 12 KB of codes in
// and 512 KB out, which is 0.16 us at 3.35 TB/s, and does 1.6 M integer
// ops, far below that; both are far below one launch (a few us). The
// selecting pass writes 64 KB instead of 512 KB and does the same integer
// work plus the selection: its time is the latency of its dependent phases.
//
// Dense design: one thread per output (i, j). A block is 32 item columns by
// 8 query rows; it stages its 8 query-code rows in shared memory once, and
// each thread streams its item row's W words from global memory (L1/L2
// hits: a 512-row tile of 4 words is 8 KB). Neighbouring threads write
// neighbouring outputs, so the store, which is the bound, is coalesced.
// grid.y is capped at 65,535 blocks; each block then steps over query-row
// groups grid.y apart, so any number of query rows is taken.
//
// Selecting design: the nearest-rows selection of select.cuh, one 256-thread
// block per lane (the phases fused_scan.cu runs before its inner products),
// with the slots written straight to the output row: no (C, T) matrix, no
// mask pass, no sort, one launch per tile step of the f32 scan.

#include <cstdint>
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kBlockN = 32;       // item columns per block (threadIdx.x)
constexpr int kBlockQ = 8;        // query rows per block (threadIdx.y)
constexpr int kMaxGridY = 65535;  // CUDA's limit on grid.y

__global__ void hamming_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ items,
                               int32_t* __restrict__ out, int nq, int n,
                               int w) {
  extern __shared__ uint32_t q_rows[];  // (kBlockQ, w)
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  const int j = blockIdx.x * kBlockN + threadIdx.x;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.y) * kBlockQ; i0 < nq;
       i0 += static_cast<int64_t>(gridDim.y) * kBlockQ) {
    __syncthreads();  // the previous group's rows are read
    for (int e = tid; e < kBlockQ * w; e += kBlockN * kBlockQ) {
      const int64_t r = i0 + e / w;
      q_rows[e] = r < nq ? q[r * w + e % w] : 0u;
    }
    __syncthreads();
    const int64_t i = i0 + threadIdx.y;
    if (i >= nq || j >= n) continue;
    const uint32_t* item = items + static_cast<int64_t>(j) * w;
    const uint32_t* qr = q_rows + threadIdx.y * w;
    int dist = 0;
    for (int k = 0; k < w; ++k) dist += __popc(qr[k] ^ item[k]);
    out[i * n + j] = dist;
  }
}

// R: rows per thread, the power of two at or above ceil(T / 256).
template <int R>
__global__ void __launch_bounds__(nearest::kThreads)
hamming_nearest_kernel(const uint32_t* __restrict__ ucodes,
                       const uint32_t* __restrict__ codes,
                       const uint8_t* __restrict__ mask,
                       int32_t* __restrict__ cand, int t, int w, int n_cand,
                       bool vec_codes) {
  extern __shared__ int smem[];
  const int64_t c = blockIdx.x;
  nearest::select_nearest<R>(ucodes + c * w, codes, mask, t, w, n_cand,
                             vec_codes, smem, cand + c * n_cand);
}

template <int R>
void launch_nearest(const void* ucodes, const void* codes, const void* mask,
                    void* cand, int c, int t, int w, int n_cand,
                    cudaStream_t stream) {
  const size_t smem = sizeof(int) * nearest::smem_ints(w);  // <= 33 KB
  hamming_nearest_kernel<R><<<c, nearest::kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(ucodes), static_cast<const uint32_t*>(codes),
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(cand), t, w,
      n_cand, nearest::vector_codes(codes, w));
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int hamming_scores_launch(const void* q, const void* items,
                                     void* out, int nq, int n, int w,
                                     void* stream) {
  if (nq > 0 && n > 0) {
    const int groups = (nq + kBlockQ - 1) / kBlockQ;
    const dim3 block(kBlockN, kBlockQ);
    const dim3 grid((n + kBlockN - 1) / kBlockN,
                    groups < kMaxGridY ? groups : kMaxGridY);
    const size_t smem = sizeof(uint32_t) * kBlockQ * w;
    hamming_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(items),
        static_cast<int32_t*>(out), nq, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns cudaGetLastError() of the launch.
// Requires 1 <= w <= 32, 1 <= t <= 4096 and 1 <= n_cand <= t (checked by
// the wrapper).
extern "C" int hamming_nearest_launch(const void* ucodes, const void* codes,
                                      const void* mask, void* cand, int c,
                                      int t, int w, int n_cand,
                                      void* stream) {
  if (c > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    switch (nearest::rows_per_thread(t)) {
      case 1: launch_nearest<1>(ucodes, codes, mask, cand, c, t, w, n_cand,
                                st); break;
      case 2: launch_nearest<2>(ucodes, codes, mask, cand, c, t, w, n_cand,
                                st); break;
      case 4: launch_nearest<4>(ucodes, codes, mask, cand, c, t, w, n_cand,
                                st); break;
      case 8: launch_nearest<8>(ucodes, codes, mask, cand, c, t, w, n_cand,
                                st); break;
      default: launch_nearest<16>(ucodes, codes, mask, cand, c, t, w, n_cand,
                                  st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
