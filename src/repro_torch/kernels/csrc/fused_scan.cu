// Fused int8 sketch scan of one item tile -- Hamming filter, candidate
// selection and dequantized inner products -- for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/fused_scan.py::fused_scan_tiles
// (body _fused_scan_kernel). For each user lane c of a chunk and one item
// tile of T rows:
//   dist[j]    = sum_w popcount(ucodes[c, w] ^ codes[j, w]), or 1 << 30 where
//                mask[j] is false (behind every live row);
//   cand[c, :] = the n_cand rows of lowest dist, ascending, the lower row
//                first on ties (the Pallas kernel's iterated argmin);
//   qips[c, p] = (sum_i float(qitems[r, i]) * users[c, i]) * qscale[r] for
//                r = cand[c, p], the sum rounded term by term in index order
//                (__fmul_rn, __fadd_rn: no FMA), so that it equals
//                kernels/ref.py::fused_scan bit for bit.
//
// What bounds it on an H100: at the main-path shape (C = 256 lanes, T = 512,
// W = 4, d = 100, n_cand = 64) it reads about 0.17 MB and writes 0.13 MB
// (0.09 us at 3.35 TB/s) and does about 1.6 M integer and 3.3 M float
// operations (0.1 us); both are far below one launch, so its time is the
// latency of its dependent phases, each a global or shared round trip.
//
// Design: one block of 256 threads (8 warps) per user lane, so C = 256 gives
// 256 blocks, all resident at once on 132 SMs. Phases 1 to 4 are the
// nearest-rows selection of select.cuh (bins in registers, per-warp counts
// by __match_any_sync, a scan in (bin, warp) order, slots by (bin, warp,
// row)), shared with hamming_nearest in hamming_scan.cu; it writes the
// candidate rows to a shared list. The user row is staged in shared memory
// while the selection reads the tile's codes. Then
//   5. one thread per candidate: it reads the candidate's int8 row as 32-bit
//      words when d % 4 == 0 (8 words ahead of the sum), else as bytes, and
//      runs the dependent sum in index order against the shared user row
//      (each read a broadcast).
// Shared memory: 4 (8 (32 W + 2) + 8 + n_cand + d) bytes, 4.6 KB at the
// main shape; at the largest tile (T = 4,096, n_cand = T) with W = 32 and
// d = 100, 49.6 KB, past the 48 KB default, so the launch opts in above it.

#include <cstdint>
#include <cuda_runtime.h>

#include "select.cuh"

namespace {

constexpr int kThreads = nearest::kThreads;  // one user lane per block
constexpr int kChunk = 8;      // int8 row words fetched one chunk ahead

size_t smem_bytes(int w, int d, int n_cand) {
  return sizeof(int) * (nearest::smem_ints(w) + n_cand + d);
}

__device__ __forceinline__ float s8(uint32_t word, int b) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * b)));
}

// The dequantization sum of one candidate row against the shared user row:
// sum_i float(row[i]) * u[i], i = 0..d-1 in order, no FMA. With `words`
// (d % 4 == 0, the row 4-byte aligned) the row is read 8 words at a time,
// the next 8 in flight while these 32 terms are summed.
__device__ __forceinline__ float int8_dot(const int8_t* __restrict__ row,
                                          const float* u, int d,
                                          bool words) {
  float s = 0.f;
  if (!words) {
#pragma unroll 8
    for (int i = 0; i < d; ++i)
      s = __fadd_rn(s, __fmul_rn(static_cast<float>(__ldg(row + i)), u[i]));
    return s;
  }
  const int32_t* row4 = reinterpret_cast<const int32_t*>(row);
  const int d4 = d / 4;
  uint32_t next[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (j < d4) next[j] = static_cast<uint32_t>(__ldg(row4 + j));
  for (int w0 = 0; w0 < d4; w0 += kChunk) {
    uint32_t x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      x[j] = next[j];
      if (w0 + kChunk + j < d4)
        next[j] = static_cast<uint32_t>(__ldg(row4 + w0 + kChunk + j));
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (w0 + j < d4) {
        const float* uj = u + 4 * (w0 + j);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          s = __fadd_rn(s, __fmul_rn(s8(x[j], b), uj[b]));
      }
  }
  return s;
}

// R: rows per thread, the power of two at or above ceil(T / 256).
template <int R>
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const uint32_t* __restrict__ ucodes,
                  const uint32_t* __restrict__ codes,
                  const uint8_t* __restrict__ mask,
                  const int8_t* __restrict__ qitems,
                  const float* __restrict__ qscale,
                  const float* __restrict__ users, int32_t* __restrict__ cand,
                  float* __restrict__ qips, int t, int w, int d, int n_cand,
                  bool vec_codes, bool vec_rows) {
  extern __shared__ __align__(16) int smem[];
  int* cand_s = smem + nearest::smem_ints(w);             // [n_cand]
  float* u = reinterpret_cast<float*>(cand_s + n_cand);  // [d]
  const int c = blockIdx.x;

  // the user row is staged while the selection reads the tile's codes; its
  // first barrier covers both
  for (int e = threadIdx.x; e < d; e += kThreads)
    u[e] = users[static_cast<int64_t>(c) * d + e];
  // 1-4. the n_cand nearest rows, into the shared list
  nearest::select_nearest<R>(ucodes + static_cast<int64_t>(c) * w, codes,
                             mask, t, w, n_cand, vec_codes, smem, cand_s);
  __syncthreads();

  // 5. one thread per candidate: its dequantized inner product
  for (int p = threadIdx.x; p < n_cand; p += kThreads) {
    const int r = cand_s[p];
    const float scale = __ldg(qscale + r);
    const float s = int8_dot(qitems + static_cast<int64_t>(r) * d, u, d,
                             vec_rows);
    const int64_t out = static_cast<int64_t>(c) * n_cand + p;
    cand[out] = r;
    qips[out] = __fmul_rn(s, scale);
  }
}

template <int R>
int launch(const void* ucodes, const void* codes, const void* mask,
           const void* qitems, const void* qscale, const void* users,
           void* cand, void* qips, int c, int t, int w, int d, int n_cand,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(w, d, n_cand);
  static size_t allowed = 48 * 1024;  // above it needs the opt-in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const bool vec_codes = nearest::vector_codes(codes, w);
  const bool vec_rows =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(qitems) % 4 == 0;
  fused_scan_kernel<R><<<c, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(ucodes), static_cast<const uint32_t*>(codes),
      static_cast<const uint8_t*>(mask), static_cast<const int8_t*>(qitems),
      static_cast<const float*>(qscale), static_cast<const float*>(users),
      static_cast<int32_t*>(cand), static_cast<float*>(qips), t, w, d, n_cand,
      vec_codes, vec_rows);
  return 0;
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 if none).
// Requires 1 <= w <= 32, 1 <= t <= 4096 and 1 <= n_cand <= t (checked by
// the wrapper).
extern "C" int fused_scan_launch(const void* ucodes, const void* codes,
                                 const void* mask, const void* qitems,
                                 const void* qscale, const void* users,
                                 void* cand, void* qips, int c, int t, int w,
                                 int d, int n_cand, void* stream) {
  if (c > 0) {
    const int rows = nearest::rows_per_thread(t);
    const auto st = static_cast<cudaStream_t>(stream);
    const int err =
        rows == 1 ? launch<1>(ucodes, codes, mask, qitems, qscale, users,
                              cand, qips, c, t, w, d, n_cand, st)
        : rows == 2 ? launch<2>(ucodes, codes, mask, qitems, qscale, users,
                                cand, qips, c, t, w, d, n_cand, st)
        : rows == 4 ? launch<4>(ucodes, codes, mask, qitems, qscale, users,
                                cand, qips, c, t, w, d, n_cand, st)
        : rows == 8 ? launch<8>(ucodes, codes, mask, qitems, qscale, users,
                                cand, qips, c, t, w, d, n_cand, st)
                    : launch<16>(ucodes, codes, mask, qitems, qscale, users,
                                 cand, qips, c, t, w, d, n_cand, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
