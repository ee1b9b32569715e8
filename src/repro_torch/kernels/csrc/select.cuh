// The nearest-rows selection of one user lane against one item tile, shared
// by fused_scan.cu and hamming_scan.cu (hamming_nearest) on sm_90a.
//
// For lane codes uc (W words) and a tile of T rows (codes (T, W), mask (T,)):
//   dist[j] = sum_w popcount(uc[w] ^ codes[j, w]), or 1 << 30 where mask[j]
//             is false (behind every live row);
//   out[p]  = the row of slot p for p < n_cand: the n_cand rows of lowest
//             dist, ascending, the lower row first on ties. That is
//             kernels/ref.py::hamming_nearest, the order of lax.top_k(-dist).
//
// One block of kThreads (8 warps) per lane. The selection is a
// counting sort over the B + 2 bins (distances 0..B with B = 32 W, then
// masked):
//   1. warp v owns the contiguous rows [32 R v, 32 R (v + 1)), R the power
//      of two at or above ceil(T / 256) (a template parameter, <= 16); its
//      thread l takes rows 32 R v + 32 i + l, i < R, reads each row's W
//      words once (16-byte loads when W % 4 == 0, one word of every row in
//      flight at a time; the lane's code words come through L1 as
//      broadcasts) and keeps the R bins in registers;
//   2. the warp walks its rows in order, 32 at a time: __match_any_sync
//      groups the rows of one bin, the lowest of them adds the group's size
//      to the warp's private count of that bin, and each row keeps its rank
//      among the warp's earlier rows of its bin. No atomics;
//   3. an exclusive scan over the counts in (bin, warp) order gives each
//      warp's first slot in each bin;
//   4. a row's slot is that base plus its rank: ascending by bin, then by
//      warp, then by row within the warp, which is the lower-row-first
//      rule. Rows whose slot is below n_cand write their row to out[slot].
// The tile's codes are read straight into registers, not staged in shared
// memory: each row is read once per lane by one thread, so staging would
// add a copy and a barrier and cap T W by the shared memory.
//
// select_nearest ends without a barrier: a caller that reads `out` (in
// shared memory) from other threads synchronises first. `out` may be global
// memory: every slot below n_cand is written exactly once (T >= n_cand).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nearest {

constexpr int kThreads = 256;  // one user lane per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// ints of shared memory select_nearest uses: the per-warp bin counts
// [32 W + 2][kWarps] and the warps' scan totals [kWarps]
__host__ __device__ inline size_t smem_ints(int w) {
  return static_cast<size_t>(kWarps) * (32 * w + 2) + kWarps;
}

// R, the rows a thread takes: the power of two at or above ceil(t / 256)
inline int rows_per_thread(int t) {
  const int rows = (t + kThreads - 1) / kThreads;
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : rows <= 8 ? 8 : 16;
}

// 16-byte code loads need W % 4 == 0 and a 16-byte aligned tile
inline bool vector_codes(const void* codes, int w) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
}

// Called by all kThreads threads of the block. smem: smem_ints(w) ints.
template <int R>
__device__ __forceinline__ void select_nearest(
    const uint32_t* __restrict__ uc, const uint32_t* __restrict__ codes,
    const uint8_t* __restrict__ mask, int t, int w, int n_cand,
    bool vec_codes, int* smem, int* out) {
  const int nb = 32 * w + 2;  // bins: distances 0..32 w, then masked
  int* count = smem;                       // [nb][kWarps]
  int* warp_sum = count + nb * kWarps;     // [kWarps]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < nb * kWarps; e += kThreads) count[e] = 0;

  // 1. the bins of this thread's rows 32 R warp + 32 i + lane, each computed
  //    once: a word of every row in flight at a time
  const int row0 = warp * 32 * R + lane;
  int dist[R];
#pragma unroll
  for (int i = 0; i < R; ++i) dist[i] = 0;
  if (vec_codes) {
    const int w4 = w / 4;
    for (int k4 = 0; k4 < w4; ++k4) {
      const uint32_t u0 = __ldg(uc + 4 * k4), u1 = __ldg(uc + 4 * k4 + 1);
      const uint32_t u2 = __ldg(uc + 4 * k4 + 2), u3 = __ldg(uc + 4 * k4 + 3);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = row0 + 32 * i;
        if (j < t) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(
                                    codes + static_cast<int64_t>(j) * w) +
                                k4);
          dist[i] += __popc(u0 ^ x.x) + __popc(u1 ^ x.y) + __popc(u2 ^ x.z) +
                     __popc(u3 ^ x.w);
        }
      }
    }
  } else {
    for (int k = 0; k < w; ++k) {
      const uint32_t uk = __ldg(uc + k);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = row0 + 32 * i;
        if (j < t)
          dist[i] +=
              __popc(uk ^ __ldg(codes + static_cast<int64_t>(j) * w + k));
      }
    }
  }
  int bin[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int j = row0 + 32 * i;
    bin[i] = j < t ? (__ldg(mask + j) ? dist[i] : nb - 1) : nb;  // nb: none
  }
  __syncthreads();  // counts zeroed (and whatever the caller staged)

  // 2. per-warp counts, and each row's rank among the warp's earlier rows of
  //    its bin
  int rank[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int b = bin[i];
    const unsigned peers = __match_any_sync(kAll, b);
    const int below = __popc(peers & ((1u << lane) - 1u));
    int* slot = count + min(b, nb - 1) * kWarps + warp;
    const int prior = b < nb ? *slot : 0;
    __syncwarp();
    if (b < nb && below == 0) *slot = prior + __popc(peers);
    __syncwarp();
    rank[i] = prior + below;
  }
  __syncthreads();

  // 3. exclusive scan over the counts in (bin, warp) order
  const int total = nb * kWarps;
  const int per = (total + kThreads - 1) / kThreads;
  const int e0 = min(static_cast<int>(threadIdx.x) * per, total);
  const int e1 = min(e0 + per, total);
  int run = 0;
  for (int e = e0; e < e1; ++e) run += count[e];
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int base = incl - run;
  for (int v = 0; v < warp; ++v) base += warp_sum[v];
  for (int e = e0; e < e1; ++e) {
    const int n_e = count[e];
    count[e] = base;
    base += n_e;
  }
  __syncthreads();

  // 4. rows below slot n_cand take their slots
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (bin[i] < nb) {
      const int pos = count[bin[i] * kWarps + warp] + rank[i];
      if (pos < n_cand) out[pos] = row0 + 32 * i;
    }
}

}  // namespace nearest
