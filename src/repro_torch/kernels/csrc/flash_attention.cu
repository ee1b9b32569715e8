// Forward attention with an online softmax, causal or full, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): o = softmax(q k^T * Dh^-0.5) v over
// (B, H, S, Dh), scores above the diagonal set to -1e30 when causal, float32
// running max, sum and accumulator, output acc / max(l, 1e-30) cast to q's
// dtype. The TPU kernel walks the k blocks as a sequential grid axis with
// m, l and acc in VMEM scratch. Blocks of a GPU grid run in no order, so
// here one block owns a query tile of one (batch, head) and loops over the
// K/V tiles itself, stopping at the diagonal when causal. Any S is taken
// (the TPU kernel asks for S % block == 0): keys past S are masked with
// -1e30 and rows past S are not written. k and v may have fewer heads than
// q (grouped-query attention): query head h reads KV head h / n_rep, the
// mapping of repeat_kv, in place and without a repeated copy.
//
// What bounds it on an H100: at the prefill shape (4, 16, 2048, 128) bf16,
// causal, the products are 4 Dh S (S + 1) / 2 B H = 68.7 GFLOP, 0.070 ms at
// 989 TFLOP/s on the bf16 tensor cores, while q, k, v and o once each are
// 134 MB with repeated KV (100 MB with 8 KV heads), 0.040 ms at 3.35 TB/s.
// Operations bound it.
//
// Three routes, picked by the wrapper from dtype, Dh and alignment:
//
// flash_wgmma_kernel (bf16, Dh % 8 == 0, Dh <= 128, 16-byte aligned
// tensors) is the Hopper design:
//  - One block per (query tile of 128 rows, batch x head): 3 warpgroups.
//    Warpgroup 0 is the producer: one thread issues every TMA load and the
//    warpgroup gives up registers (setmaxnreg 24). Warpgroups 1 and 2 are
//    consumers of 64 query rows each (setmaxnreg 240). Blocks are ordered
//    longest causal tile first over all heads, so the short tiles fill the
//    tail of the grid.
//  - TMA loads, 3-D maps (Dh, S, B*H) for q and (Dh, S, B*Hkv) for k and v,
//    boxes of 64 columns (128 bytes, the swizzle width) x 128 rows, 128-byte
//    swizzle. The head dim is padded to 64 or 128 by the box: columns past
//    Dh and rows past S arrive as zeros, and no box reads the next head's
//    rows. Q once; K and V through a ring of kStages = 2 stages of 128 keys
//    (32 KB each for Dh 128), each stage with a "full" mbarrier that the
//    producer arms with expect_tx and TMA completes, and an "empty" one on
//    which all 256 consumer threads arrive when the wgmma that read it has
//    completed. K and V have separate barriers, so Q K^T starts while V is
//    still loading. 160 KB of shared memory for Dh 128, 80 KB for Dh 64.
//  - S = Q K^T on wgmma m64n128k16, Q and K both K-major from shared
//    memory; scores scaled after the product, in float32; masked by index
//    only on the diagonal tile and the ragged last tile. O += P V on wgmma
//    m64n{Dh}k16 with P as the A operand from registers (the accumulator
//    layout of S is the A-fragment layout) and V as an MN-major B operand
//    read straight from the TMA tile: no transposing stores.
//  - P is split into hi + lo bf16 parts, both multiplied with V, so P V
//    stays within ~2^-16 of the float32 product the reference takes (the
//    tensor cores do 1.5x the function's operations). Kept: on an H100
//    (chip_smoke.py) the kernel is within 0.0039 of its plain version on
//    layer 0's q/k/v of the qwen3-0.6b prefill, inside the two-ulp
//    tolerance 2^-6 |plain| + 1e-3; a single bf16 P was not measured.
//    At that shape it takes 0.248 ms against 0.787 ms for the mma.sync
//    kernel below on the same inputs (H100 80GB HBM3, 700 W).
//  Where it can go wrong: mbarrier phase parity across the ring's wrap-around
//  (the n-th use of a stage waits with parity n & 1, and the producer waits
//  for the (n-1)-th release before the n-th load); the descriptor fields of
//  the MN-major V operand (lbo = the 16 KB step between the two 64-column
//  halves, sbo = 1024 bytes between groups of 8 keys); expect_tx counting
//  the whole box, out-of-bounds part included; tiles, descriptors' start
//  addresses and the swizzle atom aligned to 1024 bytes; register pressure
//  (64 floats of S, up to 64 of O and the hi/lo fragments a thread: read the
//  -Xptxas -v line for spills).
//
// flash_bf16_kernel (bf16, any other Dh <= 128 or unaligned tensors, which
// TMA cannot address): 4 warps of 16 query rows, mma.sync m16n8k16, K and
// V^T staged in shared memory by plain loads (V transposed by 2-byte
// stores), P V as hi + lo parts. 64-query blocks, 64-key tiles.
//
// flash_f32_kernel (float32): SIMT, 8 warps of 8 query rows; lane j scores
// key j of a 32-key tile against q * Dh^-0.5 (scaled in float32 as the
// reference does); P goes through shared memory; each lane keeps 4 output
// columns of its warp's 8 rows. Its bound is the 67 TFLOP/s float32 rate.

#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> bf16 pairs hi and lo with hi + lo within 2^-16 of each x.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// ---------------------------------------------------------- bf16, wgmma ----

namespace wg {

constexpr int kBq = 128;            // query rows per block: 2 x 64
constexpr int kBk = 128;            // keys per K/V tile
constexpr int kStages = 2;          // depth of the K/V ring
constexpr int kThreads = 384;       // warpgroup 0 loads, 1 and 2 compute
constexpr int kConsumerThreads = 256;
constexpr int kBoxCols = 64;        // 64 bf16 = 128 bytes = one swizzled row
constexpr int kHalfBytes = 128 * 128;  // 128 rows x 128 bytes (kBq == kBk)

template <int DP>
__host__ __device__ constexpr int tile_bytes() {  // one Q, K or V tile
  return DP / kBoxCols * kHalfBytes;
}

template <int DP>
__host__ __device__ constexpr int smem_bytes() {  // + alignment, barriers
  return (1 + 2 * kStages) * tile_bytes<DP>() + 1024 + 128;
}

template <int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (DP == 128)
    hopper::wgmma_rs_m64n128_tb(o, a, b);
  else
    hopper::wgmma_rs_m64n64_tb(o, a, b);
}

template <int DP>  // head dim padded to 64 or 128
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int s, int d, int n_rep,
                   int causal, float scale) {
  constexpr int kTile = tile_bytes<DP>();
  constexpr int kHalves = DP / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align every tile so
  // the swizzle TMA writes is the one the wgmma descriptors read
  uint8_t* const smem = smem_raw + ((1024 - hopper::smem_addr(smem_raw) % 1024)
                                    % 1024);
  uint8_t* const qs = smem;
  uint8_t* const ks = qs + kTile;                // kStages tiles
  uint8_t* const vs = ks + kStages * kTile;      // kStages tiles
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(vs + kStages * kTile);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kStages;
  uint64_t* const k_empty = v_full + kStages;
  uint64_t* const v_empty = k_empty + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;  // longest tiles first
  const int kv_end = causal ? min(q0 + kBq, s) : s;
  const int n_tiles = (kv_end + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&k_full[st], 1);
      hopper::mbar_init(&v_full[st], 1);
      hopper::mbar_init(&k_empty[st], kConsumerThreads);
      hopper::mbar_init(&v_empty[st], kConsumerThreads);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    hopper::regs_dec<24>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&tq);
      hopper::prefetch_tensormap(&tk);
      hopper::prefetch_tensormap(&tv);
      const int kvz = bh / n_rep;   // query head h reads KV head h / n_rep
      hopper::mbar_arrive_expect_tx(q_full, kTile);
      for (int h = 0; h < kHalves; ++h)
        hopper::tma_load_3d(qs + h * kHalfBytes, &tq, q_full, h * kBoxCols,
                            q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages, use = j / kStages;
        // the whole box counts, zero-filled part past S included
        if (use > 0) hopper::mbar_wait(&k_empty[st], (use - 1) & 1);
        hopper::mbar_arrive_expect_tx(&k_full[st], kTile);
        for (int h = 0; h < kHalves; ++h)
          hopper::tma_load_3d(ks + st * kTile + h * kHalfBytes, &tk,
                              &k_full[st], h * kBoxCols, j * kBk, kvz);
        if (use > 0) hopper::mbar_wait(&v_empty[st], (use - 1) & 1);
        hopper::mbar_arrive_expect_tx(&v_full[st], kTile);
        for (int h = 0; h < kHalves; ++h)
          hopper::tma_load_3d(vs + st * kTile + h * kHalfBytes, &tv,
                              &v_full[st], h * kBoxCols, j * kBk, kvz);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    hopper::regs_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_first = q0 + 64 * c;          // this warpgroup's first row
    const int row_a = row_first + 16 * warp + g, row_b = row_a + 8;
    const uint32_t q_addr = hopper::smem_addr(qs) + c * 64 * 128;

    float oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // rows a and b: running max
    float l_a = 0.f, l_b = 0.f;           // this thread's part of the sums

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int k0 = j * kBk;

      // S = Q K^T: DP / 16 steps of 16 along the head dim
      float sc[64];
      hopper::mbar_wait(&k_full[st], parity);
      const uint32_t k_addr = hopper::smem_addr(ks + st * kTile);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        hopper::wgmma_ss_m64n128(sc, hopper::desc_sw128(q_addr + off, 16, 1024),
                                 hopper::desc_sw128(k_addr + off, 16, 1024),
                                 kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::mbar_arrive(&k_empty[st]);

      // scale in float32; mask by index on the diagonal and ragged tiles
      if (k0 + kBk > s || (causal && k0 + kBk - 1 > row_first)) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * i + 2 * t + e;
            const bool live = key < s;
            sc[4 * i + e] = (live && (!causal || key <= row_a))
                ? sc[4 * i + e] * scale : kNegInf;
            sc[4 * i + 2 + e] = (live && (!causal || key <= row_b))
                ? sc[4 * i + 2 + e] * scale : kNegInf;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale;
      }

      // online softmax: rows a and b, each spread over a quad of threads
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        oacc[4 * n] *= alpha_a;
        oacc[4 * n + 1] *= alpha_a;
        oacc[4 * n + 2] *= alpha_b;
        oacc[4 * n + 3] *= alpha_b;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * i + e] = expf(sc[4 * i + e] - m_a);
          sc[4 * i + 2 + e] = expf(sc[4 * i + 2 + e] - m_b);
          l_a += sc[4 * i + e];
          l_b += sc[4 * i + 2 + e];
        }

      // P as A fragments: keys 16 kc .. 16 kc + 15 are S columns of n8
      // blocks 2 kc and 2 kc + 1
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kc = 0; kc < 8; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_pack(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1], ph[kc][r],
                     pl[kc][r]);

      // O += P V, 16 keys per step; V read MN-major from the TMA tile
      hopper::mbar_wait(&v_full[st], parity);
      const uint32_t v_addr = hopper::smem_addr(vs + st * kTile);
      hopper::fence_regs(oacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        const uint64_t vd = hopper::desc_sw128(v_addr + kc * 16 * 128,
                                               kHalfBytes, 1024);
        pv_product<DP>(oacc, ph[kc], vd);
        pv_product<DP>(oacc, pl[kc], vd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::mbar_arrive(&v_empty[st]);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* const ob = o + static_cast<int64_t>(bh) * s * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * t;   // d % 8 == 0: col < d covers col + 1
      if (col < d) {
        if (row_a < s)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(row_a) * d + col) =
              __floats2bfloat162_rn(oacc[4 * n] / den_a,
                                    oacc[4 * n + 1] / den_a);
        if (row_b < s)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<int64_t>(row_b) * d + col) =
              __floats2bfloat162_rn(oacc[4 * n + 2] / den_b,
                                    oacc[4 * n + 3] / den_b);
      }
    }
  }
}

}  // namespace wg

// ------------------------------------------------------- bf16, mma.sync ----

constexpr int kBq = 64;          // query rows per block: 4 warps x 16
constexpr int kBk = 64;          // keys per tile
constexpr int kThreadsH = 128;
constexpr int kLdV = kBk + 8;    // row stride of V^T in shared memory

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 16, row major) * b (16 x 8, column major), float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows row0 .. row0 + 63 of a (S, d) bf16 matrix into dst[64][ld], zero past
// S and past d. With transpose, into dst[DP][kLdV] as dst[col][row]. vec:
// d % 8 == 0 and 16-byte aligned matrices, so rows load 8 values at a time.
template <int DP, bool kTranspose>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, int row0,
                                      int s, int d, bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  if (vec) {
    for (int e = threadIdx.x; e < kBk * (DP / 8); e += kThreadsH) {
      // transposed: rows vary fastest, so the 2-byte stores hit 16 banks
      const int r = kTranspose ? e % kBk : e / (DP / 8);
      const int c = 8 * (kTranspose ? e / kBk : e % (DP / 8));
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < s && c < d)
        val = *reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(row0 + r) * d + c);
      if (kTranspose) {
        const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c + i) * ld + r] = x[i];
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBk * DP; e += kThreadsH) {
      const int r = kTranspose ? e % kBk : e / DP;
      const int c = kTranspose ? e / kBk : e % DP;
      const __nv_bfloat16 x = (row0 + r < s && c < d)
          ? src[static_cast<int64_t>(row0 + r) * d + c] : zero;
      dst[kTranspose ? c * ld + r : r * ld + c] = x;
    }
  }
}

template <int DP>  // head dim padded to 32, 64 or 128
__global__ void __launch_bounds__(kThreadsH)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int s, int d, int n_rep,
                  int causal, float scale, bool vec) {
  constexpr int kLdK = DP + 8;   // K (and the staged Q) row stride
  __shared__ __align__(16) __nv_bfloat16 ks[kBk * kLdK];
  __shared__ __align__(16) __nv_bfloat16 vt[DP * kLdV];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group, column
  // the longest causal tiles first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * d;
  const int64_t kv_base = static_cast<int64_t>(blockIdx.y / n_rep) * s * d;

  // Q fragments of this warp's 16 rows, through shared memory
  stage<DP, false>(ks, kLdK, q + base, q0, s, d, vec);
  __syncthreads();
  uint32_t qa[DP / 16][4];
  {
    const __nv_bfloat16* r0 = ks + (16 * warp + g) * kLdK + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * kLdK;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      qa[kk][0] = ld32(r0 + 16 * kk);
      qa[kk][1] = ld32(r1 + 16 * kk);
      qa[kk][2] = ld32(r0 + 16 * kk + 8);
      qa[kk][3] = ld32(r1 + 16 * kk + 8);
    }
  }

  float oacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // rows g and g + 8: running max
  float l0 = 0.f, l1 = 0.f;           // this thread's part of the row sums
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;

  const int kv_end = causal ? min(q0 + kBq, s) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();  // every read of ks / vt from the last tile is done
    stage<DP, false>(ks, kLdK, k + kv_base, k0, s, d, vec);
    stage<DP, true>(vt, kLdV, v + kv_base, k0, s, d, vec);
    __syncthreads();

    float sc[kBk / 8][4];
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * n + g) * kLdK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_bf16(sc[n], qa[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * n + 2 * t + e;
        const bool live = key < s;
        sc[n][e] = (live && (!causal || key <= row0)) ? sc[n][e] * scale
                                                      : kNegInf;
        sc[n][2 + e] = (live && (!causal || key <= row1))
                           ? sc[n][2 + e] * scale : kNegInf;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = expf(m0 - mx0), alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      oacc[n][0] *= alpha0;
      oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1;
      oacc[n][3] *= alpha1;
    }
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = expf(sc[n][e] - m0);
        sc[n][2 + e] = expf(sc[n][2 + e] - m1);
        l0 += sc[n][e];
        l1 += sc[n][2 + e];
      }

#pragma unroll
    for (int kc = 0; kc < kBk / 16; ++kc) {  // 16 keys per product
      uint32_t hi[4], lo[4];
      split_pack(sc[2 * kc][0], sc[2 * kc][1], hi[0], lo[0]);
      split_pack(sc[2 * kc][2], sc[2 * kc][3], hi[1], lo[1]);
      split_pack(sc[2 * kc + 1][0], sc[2 * kc + 1][1], hi[2], lo[2]);
      split_pack(sc[2 * kc + 1][2], sc[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const __nv_bfloat16* vr = vt + (8 * n + g) * kLdV + 16 * kc + 2 * t;
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(oacc[n], hi, b0, b1);
        mma_bf16(oacc[n], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + 2 * t + e;
      if (c < d) {
        if (row0 < s)
          o[base + static_cast<int64_t>(row0) * d + c] =
              __float2bfloat16_rn(oacc[n][e] / den0);
        if (row1 < s)
          o[base + static_cast<int64_t>(row1) * d + c] =
              __float2bfloat16_rn(oacc[n][2 + e] / den1);
      }
    }
}

// ------------------------------------------------------------- float32 ----

constexpr int kBqF = 64;         // query rows per block: 8 warps x 8
constexpr int kBkF = 32;         // keys per tile: one per lane
constexpr int kThreadsF = 256;
constexpr int kDMax = 128;
constexpr int kLdF = kDMax + 4;  // 16-byte rows; lane-varying rows miss no bank
constexpr int kSmemF =
    ((kBqF + 2 * kBkF) * kLdF + kBqF * kBkF) * static_cast<int>(sizeof(float));

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows row0 .. row0 + n_rows - 1 of a (S, d) matrix into dst[n_rows][kLdF],
// times mul, zero past S and past d (all kDMax columns are written).
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int n_rows, int s, int d,
                                          float mul) {
  for (int e = threadIdx.x; e < n_rows * kDMax; e += kThreadsF) {
    const int r = e / kDMax, c = e % kDMax;
    dst[r * kLdF + c] = (row0 + r < s && c < d)
        ? src[static_cast<int64_t>(row0 + r) * d + c] * mul : 0.f;
  }
}

__global__ void __launch_bounds__(kThreadsF)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int s,
                 int d, int n_rep, int causal, float scale) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kBqF][kLdF], q * scale
  float* ks = qs + kBqF * kLdF;                  // [kBkF][kLdF]
  float* vs = ks + kBkF * kLdF;                  // [kBkF][kLdF]
  float* ps = vs + kBkF * kLdF;                  // [kBqF][kBkF]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBqF;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * d;
  const int64_t kv_base = static_cast<int64_t>(blockIdx.y / n_rep) * s * d;
  const int nd4 = (d + 3) / 4;

  stage_f32(qs, q + base, q0, kBqF, s, d, scale);

  float acc[8][4], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  const int kv_end = causal ? min(q0 + kBqF, s) : s;
  for (int k0 = 0; k0 < kv_end; k0 += kBkF) {
    __syncthreads();  // every read of ks / vs / ps from the last tile is done
    stage_f32(ks, k + kv_base, k0, kBkF, s, d, 1.f);
    stage_f32(vs, v + kv_base, k0, kBkF, s, d, 1.f);
    __syncthreads();

    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
    const float* kr = ks + lane * kLdF;
    for (int c4 = 0; c4 < nd4; ++c4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + (8 * warp + i) * kLdF + 4 * c4);
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + 8 * warp + i;
      const float x = (key < s && (!causal || key <= row)) ? sc[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = expf(x - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
      ps[(8 * warp + i) * kBkF + lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int j4 = 0; j4 < kBkF / 4; ++j4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (8 * warp + i) * kBkF + 4 * j4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + (4 * j4 + jj) * kLdF + 4 * lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * warp + i;
    if (row < s) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * lane + e;
        if (c < d) o[base + static_cast<int64_t>(row) * d + c] = acc[i][e] / den;
      }
    }
  }
}

// ------------------------------------------------------------------ host ----

// cuTensorMapEncodeTiled, looked up at run time so the library needs no
// -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

constexpr int kErrNoEncode = 1000;     // CUDA offers no tensor maps
constexpr int kErrEncode = 1001;       // 1001 + CUresult of a refused map

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (planes, s, d) bf16, contiguous, read in boxes of 64 columns x 128 rows
// of one plane, 128-byte swizzled; outside the tensor reads as zero.
int encode_map(EncodeTiled fn, CUtensorMap* map, const void* base, int planes,
               int s, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {wg::kBoxCols, wg::kBk, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b,
                 int h, int hkv, int s, int d, int causal, float scale,
                 cudaStream_t st) {
  static bool smem_set = false;  // above 48 KB needs the opt-in, once
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wg::flash_wgmma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wg::smem_bytes<DP>());
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  int err = encode_map(fn, &tq, q, b * h, s, d);
  if (err == 0) err = encode_map(fn, &tk, k, b * hkv, s, d);
  if (err == 0) err = encode_map(fn, &tv, v, b * hkv, s, d);
  if (err != 0) return err;
  const dim3 grid(b * h, (s + wg::kBq - 1) / wg::kBq);
  wg::flash_wgmma_kernel<DP><<<grid, wg::kThreads, wg::smem_bytes<DP>(), st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s, d, h / hkv, causal,
      scale);
  return 0;
}

}  // namespace

// Dynamic shared memory of a block of the wgmma route for head dims padded
// to dp (64 or 128), in bytes: what -Xptxas -v does not report.
extern "C" int flash_wgmma_smem_bytes(int dp) {
  return dp <= 64 ? wg::smem_bytes<64>() : wg::smem_bytes<128>();
}

// Launches on `stream`; returns the CUDA error of the launch (0 if none),
// or 1000 when CUDA offers no tensor maps and 1001 + the CUresult
// when it refuses one. q and o are (b, h, s, d), k and v (b, hkv, s, d),
// all contiguous. route 0: float32 (SIMT); 1: bf16 on mma.sync; 2: bf16 on
// wgmma and TMA, which needs d % 8 == 0, d <= 128 and 16-byte aligned
// pointers. Requires 1 <= d <= 128, s >= 1, h % hkv == 0 and
// 1 <= b * h <= 65535 (checked by the wrapper, which picks the route).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int hkv, int s, int d, int causal,
                                      int route, void* stream) {
  const float scale = static_cast<float>(std::pow(static_cast<double>(d),
                                                  -0.5));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rep = h / hkv;
  int err = 0;
  if (route == 2) {
    if (d % 8 != 0 || d > 128 ||
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = d <= 64 ? launch_wgmma<64>(q, k, v, o, b, h, hkv, s, d, causal,
                                     scale, st)
                  : launch_wgmma<128>(q, k, v, o, b, h, hkv, s, d, causal,
                                      scale, st);
  } else if (route == 1) {
    const dim3 grid((s + kBq - 1) / kBq, b * h);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    const bool vec = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                    reinterpret_cast<uintptr_t>(k) |
                                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    if (d <= 32)
      flash_bf16_kernel<32><<<grid, kThreadsH, 0, st>>>(
          qb, kb, vb, ob, s, d, n_rep, causal, scale, vec);
    else if (d <= 64)
      flash_bf16_kernel<64><<<grid, kThreadsH, 0, st>>>(
          qb, kb, vb, ob, s, d, n_rep, causal, scale, vec);
    else
      flash_bf16_kernel<128><<<grid, kThreadsH, 0, st>>>(
          qb, kb, vb, ob, s, d, n_rep, causal, scale, vec);
  } else {
    static bool smem_set = false;  // above 48 KB needs the opt-in, once
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemF);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = true;
    }
    const dim3 grid((s + kBqF - 1) / kBqF, b * h);
    flash_f32_kernel<<<grid, kThreadsF, kSmemF, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s, d, n_rep,
        causal, scale);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
