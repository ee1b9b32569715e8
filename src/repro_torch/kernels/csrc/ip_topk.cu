// Exact inner products reduced to each query's k best over a range of
// items, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ip_topk.py::ip_topk_tiles
// (body _ip_topk_kernel): scores = Q @ C^T reduced to the k best (value,
// global id) per query, the lower id first among equal values. The items
// are cut into `splits` contiguous ranges of whole 128-item tiles; the
// output is each range's top-k, (q, splits, k) values and ids, padded with
// (-inf, -1) where a range holds fewer than k items. kernels/ref.py::
// merge_topk merges the ranges with a stable descending sort, as the
// reference's ops._merge_topk merges its tiles outside its kernel;
// ref.ip_topk_partials is the plain twin of this kernel's raw output.
//
// Scores are summed term by term in index order with __fmul_rn / __fadd_rn
// (no FMA, no zero-padded term), so they equal ref.index_order_dot's bit
// for bit; an FMA chain, TF32 or a GEMM rounds differently and can swap
// near-equal items.
//
// What bounds it on an H100: at the main-path shape (4,096 x 100) x
// (17,770 x 100), 2 q n d = 14.6 GFLOP at 67 TFLOP/s float32 = 0.217 ms;
// the function's bytes (8.8 MB in, 0.3 MB of top-10 out) take 3 us.
// Operations bound it. Under this contract each of the q n d = 7.28 G terms
// is a separate multiply and add, two issue slots of the FP32 pipes, so the
// floor is 14.6 G lane-instructions at 33.5 T/s = 0.435 ms.
//
// Design: grid (splits, query tiles of 128) of 256 threads.
//  - Scores: thread (ty, tx) of a 16 x 16 grid keeps an 8 x 8 register tile:
//    queries 4 ty .. 4 ty + 3 and 64 + 4 ty .. 64 + 4 ty + 3, items likewise
//    by tx. The query and item slices of 16 dimensions are staged in shared
//    memory transposed (dimension-major, rows padded to 132 floats), so a
//    thread reads its 8 + 8 operands as four 16-byte loads per dimension:
//    4 loads for 128 FP32 instructions. The stages are copied by 4-byte
//    cp.async (the copy transposes) into a double buffer, so the next slice
//    loads while this one is multiplied. The tail of d is a shorter loop.
//  - Running top-k: a block walks its split's item tiles in order and keeps
//    each query row's k best in shared memory, sorted under the total order
//    (value descending, id ascending), empty slots (-inf, INT_MAX). After
//    each tile the threads that computed the scores offer those that rank
//    before their row's k-th entry, as a bit per column (while a row's list
//    is not full, its first tile, they also bar every score ranked after
//    the k-th best of the row's 16 threads' own bests: k scores of the tile
//    rank at or before it). The scores go to a 64 KB shared tile (float4
//    groups XOR-swizzled by row: no bank conflicts either way), and each
//    row's own thread walks its offered columns in id order and inserts
//    those that still rank before its k-th entry (merge_row).
//  - Splits are chosen by the wrapper so that query tiles x splits fill the
//    SMs' resident blocks once.
// Shared memory: two 16,896-byte stages (the one just read also holds the
// offer masks), the 64 KB score tile and 128 lists of k (value, id) pairs
// with an odd row stride: 110,592 bytes at k = 10 (two blocks an SM),
// 231,424 at k = 128.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 128;        // queries per block
constexpr int kBn = 128;        // items per tile
constexpr int kKc = 16;         // dimensions per pipeline stage
constexpr int kLd = kBq + 4;    // floats per staged dimension (16-byte rows)
constexpr int kThreads = 256;   // 16 x 16, an 8 x 8 score tile each
constexpr int kMaxK = 128;
constexpr int kEmpty = INT_MAX;  // id of an empty list slot

struct Stage {
  float q[kKc][kLd];
  float c[kKc][kLd];
};

// Row stride of the top-k lists: odd, so that the rows merged by the 32
// threads of a warp fall in 32 different banks.
__host__ __device__ __forceinline__ int list_stride(int k) { return k | 1; }

static_assert(sizeof(Stage) >= kBq * 4 * sizeof(unsigned),
              "a stage buffer holds the offered-score masks");

size_t smem_bytes(int k) {  // 231,424 bytes at k = 128
  return 2 * sizeof(Stage) + sizeof(float) * kBq * kBn +
         static_cast<size_t>(kBq) * list_stride(k) * 8;
}

// (v, i) ranks before (w, j): the larger value first, then the lower id.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Local column (query row or item) of register index m in 0..7.
__device__ __forceinline__ int local(int t, int m) {
  return m < 4 ? 4 * t + m : 64 + 4 * t + (m - 4);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Thread (cr, ci) of a 16 x 16 grid copies dimension k0 + ci of rows cr,
// cr + 16, ..., cr + 112 of the query and item tiles, transposed; `qsrc`
// and `csrc` point at dimension ci of its first query and item row, and bit
// p of `qok` / `cok` says whether row cr + 16 p exists. What lies past nq, n
// or d arrives as zeros (and is never summed); those copies read nothing and
// are given the base pointers `q` and `items`.
__device__ __forceinline__ void load_stage(Stage& st, const float* q,
                                           const float* items,
                                           const float* qsrc,
                                           const float* csrc, unsigned qok,
                                           unsigned cok, int k0, int d) {
  const int ci = threadIdx.x % kKc, cr = threadIdx.x / kKc;
  const bool in_d = k0 + ci < d;
#pragma unroll
  for (int p = 0; p < kBq / 16; ++p) {
    const int64_t off = static_cast<int64_t>(16 * p) * d + k0;
    const bool okq = in_d && ((qok >> p) & 1u);
    const bool okc = in_d && ((cok >> p) & 1u);
    cp_async4(&st.q[ci][cr + 16 * p], okq ? qsrc + off : q, okq);
    cp_async4(&st.c[ci][cr + 16 * p], okc ? csrc + off : items, okc);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fma_step(const Stage& st, int i, int tx,
                                         int ty, float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(&st.q[i][4 * ty]);
  const float4 a1 = *reinterpret_cast<const float4*>(&st.q[i][64 + 4 * ty]);
  const float4 b0 = *reinterpret_cast<const float4*>(&st.c[i][4 * tx]);
  const float4 b1 = *reinterpret_cast<const float4*>(&st.c[i][64 + 4 * tx]);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 8; ++m)
      acc[r][m] = __fadd_rn(acc[r][m], __fmul_rn(a[r], b[m]));
}

// Merges the offered scores of one item tile into the running top-k of
// query row `row`, by the row's own thread. `offered` has a bit per column
// of the tile (set by the threads that computed the scores: those that
// ranked before the row's k-th entry then); the thread walks the set bits
// in id order, reads each score from `sc` (swizzled), checks it against the
// current k-th entry and inserts it at its sorted place from the end of the
// list. After the first tiles a row has a few offers or none, so the walk
// is short and the threads of a warp rarely wait on one another.
__device__ __forceinline__ void merge_row(const float* sc, uint4 offered,
                                          float* lv, int* li, int k, int row,
                                          int j0) {
  float tv = lv[k - 1];  // the row's k-th entry
  int ti = li[k - 1];
  const unsigned words[4] = {offered.x, offered.y, offered.z, offered.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    for (unsigned bits = words[w]; bits != 0; bits &= bits - 1) {
      const int col = 32 * w + __ffs(bits) - 1;
      const float v = sc[row * kBn + 4 * ((col >> 2) ^ (row & 7)) + (col & 3)];
      const int id = j0 + col;
      if (!before(v, id, tv, ti)) continue;
      int e = k - 1;
      for (; e > 0 && before(v, id, lv[e - 1], li[e - 1]); --e) {
        lv[e] = lv[e - 1];
        li[e] = li[e - 1];
      }
      lv[e] = v;
      li[e] = id;
      tv = lv[k - 1];
      ti = li[k - 1];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ip_topk_kernel(const float* __restrict__ q, const float* __restrict__ items,
               float* __restrict__ vals, int32_t* __restrict__ ids, int nq,
               int n, int d, int k, int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* st = reinterpret_cast<Stage*>(smem);
  float* sc = reinterpret_cast<float*>(st + 2);  // [kBq][kBn], swizzled
  const int ls = list_stride(k);
  float* list_v = sc + kBq * kBn;                // [kBq][ls]
  int* list_i = reinterpret_cast<int*>(list_v + kBq * ls);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int n_tiles = (n + kBn - 1) / kBn;
  const int t0 = min(split * per_split, n_tiles);
  const int nks = max(1, (d + kKc - 1) / kKc);  // stages per tile
  const int n_stages = (min(t0 + per_split, n_tiles) - t0) * nks;

  for (int e = threadIdx.x; e < kBq * ls; e += kThreads) {
    list_v[e] = -INFINITY;
    list_i[e] = kEmpty;
  }
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[r][m] = 0.f;

  // this thread's rows of the staged tiles: cr, cr + 16, ..., cr + 112
  const int ci = threadIdx.x % kKc, cr = threadIdx.x / kKc;
  const float* qsrc = q + static_cast<int64_t>(q0 + cr) * d + ci;
  unsigned qok = 0;
#pragma unroll
  for (int p = 0; p < kBq / 16; ++p) qok |= (q0 + cr + 16 * p < nq) << p;
  auto load = [&](int s1) {  // stage s1: dims (s1 % nks) * 16.. of tile
    const int j0 = (t0 + s1 / nks) * kBn;
    unsigned cok = 0;
#pragma unroll
    for (int p = 0; p < kBn / 16; ++p) cok |= (j0 + cr + 16 * p < n) << p;
    load_stage(st[s1 & 1], q, items, qsrc,
               items + static_cast<int64_t>(j0 + cr) * d + ci, qok, cok,
               (s1 % nks) * kKc, d);
  };
  if (n_stages > 0) load(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      load(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // stage s (and, at s = 0, the empty lists) visible
    const Stage& cur = st[s & 1];
    const int ks = s % nks;
    const int kc = min(kKc, d - ks * kKc);
    if (kc == kKc) {
#pragma unroll
      for (int i = 0; i < kKc; ++i) fma_step(cur, i, tx, ty, acc);
    } else {
      for (int i = 0; i < kc; ++i) fma_step(cur, i, tx, ty, acc);
    }
    __syncthreads();  // every read of stage s is done before its reload
    if (ks == nks - 1) {  // the tile's scores are complete
      // offer the scores that rank before their row's k-th entry: a bit
      // per column, OR-ed over the 8 lanes that share a mask word, in the
      // stage buffer just read (its reload waits for the barriers below)
      const int j0 = (t0 + s / nks) * kBn;
      unsigned* offered = reinterpret_cast<unsigned*>(&st[s & 1]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = local(ty, r);
        const float tv = list_v[row * ls + k - 1];
        const int ti = list_i[row * ls + k - 1];
        // while a row's list is not full (its first tile) its k-th entry
        // bars nothing; then the k-th best of the 16 threads' own best
        // scores bars the rest: k scores of the tile rank at or before it
        float bar_v = -INFINITY;
        int bar_i = kEmpty;
        if (k <= 16 && __any_sync(0xffffffffu, ti == kEmpty)) {
          float bv = -INFINITY;
          int bi = kEmpty;
#pragma unroll
          for (int m = 0; m < 8; ++m) {  // ids ascend with m
            const int id = j0 + local(tx, m);
            if (id < n && (bi == kEmpty || acc[r][m] > bv)) {
              bv = acc[r][m];
              bi = id;
            }
          }
          const int half = threadIdx.x & 16;
          int rank = 0;
          for (int l = 0; l < 16; ++l) {
            const float ov = __shfl_sync(0xffffffffu, bv, half | l);
            const int oi = __shfl_sync(0xffffffffu, bi, half | l);
            rank += oi != kEmpty && before(ov, oi, bv, bi);
          }
          const unsigned at =
              (__ballot_sync(0xffffffffu, bi != kEmpty && rank == k - 1) >>
               half) & 0xffffu;
          const int src = half + (at ? __ffs(at) - 1 : 0);
          const float sv = __shfl_sync(0xffffffffu, bv, src);
          const int si = __shfl_sync(0xffffffffu, bi, src);
          if (at && ti == kEmpty) {
            bar_v = sv;
            bar_i = si;
          }
        }
        unsigned lo = 0, hi = 0;  // columns 4 tx.. and 64 + 4 tx..
        if (q0 + row < nq) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int id = j0 + 4 * tx + m;
            if (id < n && before(acc[r][m], id, tv, ti) &&
                !before(bar_v, bar_i, acc[r][m], id))
              lo |= 1u << (4 * (tx & 7) + m);
            if (id + 64 < n && before(acc[r][m + 4], id + 64, tv, ti) &&
                !before(bar_v, bar_i, acc[r][m + 4], id + 64))
              hi |= 1u << (4 * (tx & 7) + m);
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          lo |= __shfl_xor_sync(0xffffffffu, lo, off);
          hi |= __shfl_xor_sync(0xffffffffu, hi, off);
        }
        if ((tx & 7) == 0) {
          offered[4 * row + (tx >> 3)] = lo;
          offered[4 * row + 2 + (tx >> 3)] = hi;
        }
        float* out = sc + row * kBn;
        *reinterpret_cast<float4*>(out + 4 * (tx ^ (row & 7))) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(out + 4 * ((16 + tx) ^ (row & 7))) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[r][m] = 0.f;
      }
      __syncthreads();
      const int row = threadIdx.x;
      if (row < kBq && q0 + row < nq) {
        const uint4 o = reinterpret_cast<const uint4*>(offered)[row];
        if ((o.x | o.y | o.z | o.w) != 0)
          merge_row(sc, o, list_v + row * ls, list_i + row * ls, k, row, j0);
      }
      __syncthreads();
    }
  }
  __syncthreads();

  const int splits = gridDim.x;
  for (int e = threadIdx.x; e < kBq * k; e += kThreads) {
    const int r = e / k;
    if (q0 + r >= nq) continue;
    const int64_t out =
        (static_cast<int64_t>(q0 + r) * splits + split) * k + e % k;
    const int at = r * ls + e % k;
    const bool empty = list_i[at] == kEmpty;
    vals[out] = empty ? -INFINITY : list_v[at];
    ids[out] = empty ? -1 : list_i[at];
  }
}

cudaError_t allow_smem() {  // above 48 KB needs the opt-in, once
  static cudaError_t err = cudaFuncSetAttribute(
      ip_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxK)));
  return err;
}

}  // namespace

// Blocks of the kernel one SM holds at once for this k, or minus the CUDA
// error of the query. The wrapper sizes the splits with it.
extern "C" int ip_topk_blocks_per_sm(int k) {
  cudaError_t err = allow_smem();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ip_topk_kernel, kThreads, smem_bytes(k));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches on `stream`; returns the CUDA error of the launch (0 if none).
// vals and ids are (nq, splits, k); split s covers item tiles
// [s * per_split, (s + 1) * per_split) of 128 items, clipped to n.
// Requires 1 <= k <= min(n, 128) and nq <= 128 * 65535 (checked by the
// wrapper).
extern "C" int ip_topk_launch(const void* q, const void* items, void* vals,
                              void* ids, int nq, int n, int d, int k,
                              int splits, int per_split, void* stream) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nq > 0 && n > 0 && splits > 0) {
    const dim3 grid(splits, (nq + kBq - 1) / kBq);
    ip_topk_kernel<<<grid, kThreads, smem_bytes(k),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(items),
        static_cast<float*>(vals), static_cast<int32_t*>(ids), nq, n, d, k,
        per_split);
  }
  return static_cast<int>(cudaGetLastError());
}
