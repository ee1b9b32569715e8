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
// operations (0.1 us); both are far below one launch, so its time is launch
// latency and the tail of one short wave.
//
// Design: one warp per user lane, four lanes per 128-thread block. The
// selection is a counting sort over the B + 2 possible distances (0..B with
// B = 32 W, and the masked value), not n_cand rounds of argmin over T:
//   1. the warp builds its lane's histogram of distances in shared memory;
//   2. an exclusive scan turns it into each distance's first output slot;
//   3. the warp walks the rows in ascending order, 32 at a time; a row's slot
//      is its distance's next slot plus its rank among the rows of the same
//      distance in this step (__match_any_sync), and rows whose slot is below
//      n_cand are written out. Walking rows in order is what sends ties to
//      the lower row;
//   4. each thread scores candidates p = lane, lane + 32, ..., reading the
//      int8 row (d bytes, an L2 hit: the tile is 51 KB) and the user row.
// Distances are computed again in step 3 (W loads from L1) rather than kept,
// so shared memory (4 warps x (B + 2 + W) ints, 17 KB at most) does not grow
// with T.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // user lanes per block, one warp each

// Histogram bin of row j: its Hamming distance, or `masked` for a dead row.
__device__ __forceinline__ int row_bin(const uint32_t* uc,
                                       const uint32_t* __restrict__ codes,
                                       const uint8_t* __restrict__ mask,
                                       int j, int w, int masked) {
  if (!mask[j]) return masked;
  const uint32_t* row = codes + static_cast<int64_t>(j) * w;
  int dist = 0;
  for (int k = 0; k < w; ++k) dist += __popc(uc[k] ^ row[k]);
  return dist;
}

__global__ void fused_scan_kernel(const uint32_t* __restrict__ ucodes,
                                  const uint32_t* __restrict__ codes,
                                  const uint8_t* __restrict__ mask,
                                  const int8_t* __restrict__ qitems,
                                  const float* __restrict__ qscale,
                                  const float* __restrict__ users,
                                  int32_t* __restrict__ cand,
                                  float* __restrict__ qips, int c, int t,
                                  int w, int d, int n_cand) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nb = 32 * w + 2;  // bins: distances 0..32 w, then masked
  int* hist = smem + warp * (nb + w);
  uint32_t* uc = reinterpret_cast<uint32_t*>(hist + nb);
  const int lane_c = blockIdx.x * kWarps + warp;
  if (lane_c >= c) return;  // the whole warp leaves; no block barrier is used

  for (int k = lane; k < w; k += 32)
    uc[k] = ucodes[static_cast<int64_t>(lane_c) * w + k];
  for (int b = lane; b < nb; b += 32) hist[b] = 0;
  __syncwarp();

  // 1. histogram of the lane's distances
  for (int j = lane; j < t; j += 32)
    atomicAdd(&hist[row_bin(uc, codes, mask, j, w, nb - 1)], 1);
  __syncwarp();

  // 2. exclusive scan: each thread owns a contiguous run of bins
  const int per = (nb + 31) / 32;
  const int b0 = min(lane * per, nb);
  const int b1 = min(b0 + per, nb);
  int run = 0;
  for (int b = b0; b < b1; ++b) run += hist[b];
  int incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int slot = incl - run;
  for (int b = b0; b < b1; ++b) {
    const int count = hist[b];
    hist[b] = slot;
    slot += count;
  }
  __syncwarp();

  // 3. rows in ascending order take their slots
  int32_t* cand_c = cand + static_cast<int64_t>(lane_c) * n_cand;
  for (int base = 0; base < t; base += 32) {
    const int j = base + lane;
    const bool live = j < t;
    const int b = live ? row_bin(uc, codes, mask, j, w, nb - 1) : nb;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int pos = live ? hist[b] + rank : n_cand;
    __syncwarp();
    if (live && rank == 0) hist[b] += __popc(peers);
    __syncwarp();
    if (pos < n_cand) cand_c[pos] = j;
  }
  __syncwarp();  // orders the warp's cand writes before the reads below

  // 4. dequantized inner products of the candidates
  const float* u = users + static_cast<int64_t>(lane_c) * d;
  float* qips_c = qips + static_cast<int64_t>(lane_c) * n_cand;
  for (int p = lane; p < n_cand; p += 32) {
    const int r = cand_c[p];
    const int8_t* qrow = qitems + static_cast<int64_t>(r) * d;
    float s = 0.f;
    for (int i = 0; i < d; ++i)
      s = __fadd_rn(s, __fmul_rn(static_cast<float>(qrow[i]), u[i]));
    qips_c[p] = __fmul_rn(s, qscale[r]);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
// Requires 1 <= w <= 32 and 1 <= n_cand <= t (checked by the wrapper).
extern "C" int fused_scan_launch(const void* ucodes, const void* codes,
                                 const void* mask, const void* qitems,
                                 const void* qscale, const void* users,
                                 void* cand, void* qips, int c, int t, int w,
                                 int d, int n_cand, void* stream) {
  if (c > 0) {
    const int grid = (c + kWarps - 1) / kWarps;
    const size_t smem = sizeof(int) * kWarps * (32 * w + 2 + w);
    fused_scan_kernel<<<grid, 32 * kWarps, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(ucodes),
        static_cast<const uint32_t*>(codes),
        static_cast<const uint8_t*>(mask), static_cast<const int8_t*>(qitems),
        static_cast<const float*>(qscale), static_cast<const float*>(users),
        static_cast<int32_t*>(cand), static_cast<float*>(qips), c, t, w, d,
        n_cand);
  }
  return static_cast<int>(cudaGetLastError());
}
