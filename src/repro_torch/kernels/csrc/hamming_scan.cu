// All-pairs Hamming distance between bit-packed SRP codes, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/hamming_scan.py::hamming_scores
// (body _hamming_kernel): out[i, j] = sum_w popcount(q[i, w] ^ items[j, w]),
// (q, W) x (n, W) 32-bit codes -> (q, n) int32.
//
// What bounds it on an H100: the (q, n) int32 output. At the main-path shape
// (256, 4) x (512, 4) the call moves 12 KB of codes in and 512 KB out, which
// is 0.16 us at 3.35 TB/s, and does 1.6 M integer ops, far below that; both
// are far below one launch (a few us). So its time is launch latency.
//
// Design: one thread per output (i, j). A block is 32 item columns by 8
// query rows; it stages its 8 query-code rows in shared memory once, and
// each thread streams its item row's W words from global memory (L1/L2 hits:
// a 512-row tile of 4 words is 8 KB). Neighbouring threads write
// neighbouring outputs, so the store, which is the bound, is coalesced.
// Fusing the candidate selection into this pass (as the TPU's fused_scan
// does) is what would remove the launch and the (q, n) write; it is left to
// a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockN = 32;  // item columns per block (threadIdx.x)
constexpr int kBlockQ = 8;   // query rows per block (threadIdx.y)

__global__ void hamming_kernel(const uint32_t* __restrict__ q,
                               const uint32_t* __restrict__ items,
                               int32_t* __restrict__ out, int nq, int n,
                               int w) {
  extern __shared__ uint32_t q_rows[];  // (kBlockQ, w)
  const int i0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.y * kBlockN + threadIdx.x;
  for (int e = tid; e < kBlockQ * w; e += kBlockN * kBlockQ) {
    const int r = i0 + e / w;
    q_rows[e] = r < nq ? q[static_cast<int64_t>(r) * w + e % w] : 0u;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = blockIdx.x * kBlockN + threadIdx.x;
  if (i >= nq || j >= n) return;
  const uint32_t* item = items + static_cast<int64_t>(j) * w;
  const uint32_t* qr = q_rows + threadIdx.y * w;
  int dist = 0;
  for (int k = 0; k < w; ++k) dist += __popc(qr[k] ^ item[k]);
  out[static_cast<int64_t>(i) * n + j] = dist;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int hamming_scores_launch(const void* q, const void* items,
                                     void* out, int nq, int n, int w,
                                     void* stream) {
  if (nq > 0 && n > 0) {
    const dim3 block(kBlockN, kBlockQ);
    const dim3 grid((n + kBlockN - 1) / kBlockN,
                    (nq + kBlockQ - 1) / kBlockQ);
    const size_t smem = sizeof(uint32_t) * kBlockQ * w;
    hamming_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(items),
        static_cast<int32_t*>(out), nq, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}
