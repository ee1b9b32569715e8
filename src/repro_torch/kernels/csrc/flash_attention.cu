// Forward attention with an online softmax, causal or full, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): o = softmax(q k^T * Dh^-0.5) v over
// (B, H, S, Dh), scores above the diagonal set to -1e30 when causal, each
// score tile kept on chip. The TPU kernel walks the k blocks as a sequential
// grid axis with m, l and acc in VMEM scratch. Blocks of a GPU grid run in no
// order, so here one block owns a (b*h, 64-query) tile and loops over the K/V
// tiles itself, staging each in shared memory, with m, l and acc in float32
// registers per query row. When causal the loop stops at the diagonal tile;
// the diagonal tile and a ragged tail (any S, where the TPU kernel asks for
// S % block == 0) are masked with -1e30. The output is acc / max(l, 1e-30)
// cast to q's dtype.
//
// What bounds it on an H100: at the prefill shape (4, 16, 2048, 128) bf16,
// causal, the products are 4 Dh S(S+1)/2 B H = 68.7 GFLOP, 0.070 ms at 989
// TFLOP/s on the bf16 tensor cores, while q, k, v and o once each are 134 MB,
// 0.040 ms at 3.35 TB/s. Operations bound it. In float32 the products run on
// the SIMT units: 1.03 ms at 67 TFLOP/s.
//
// Design. bf16 (flash_bf16_kernel): 4 warps of 16 query rows. The products
// run on the tensor cores by mma.sync m16n8k16 (bf16 operands, float32 sums;
// products of bf16 values are exact in float32). S = Q K^T takes Q fragments
// held in registers and K from shared memory; P V packs the probabilities
// into A fragments straight from the S accumulators and reads V stored
// transposed in shared memory. Each p is split into hi + lo, two bf16 values,
// and both are multiplied with V, so P V stays within ~2^-16 of the float32
// product the reference takes. Scores are scaled after the product, in
// float32. No TMA, wgmma, cp.async or pipelining yet: each tile is loaded,
// then used, which leaves the tensor cores idle during the loads.
// float32 (flash_f32_kernel): SIMT, 8 warps of 8 query rows; lane j scores
// key j of a 32-key tile against q * Dh^-0.5 (scaled in float32 as the
// reference does); P goes through shared memory; each lane keeps 4 output
// columns of its warp's 8 rows.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16 ----

constexpr int kBq = 64;          // query rows per block: 4 warps x 16
constexpr int kBk = 64;          // keys per tile
constexpr int kThreadsH = 128;
constexpr int kLdV = kBk + 8;    // row stride of V^T in shared memory

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
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

// (x0, x1) -> bf16 pairs hi and lo with hi + lo within 2^-16 of each x.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
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
                  __nv_bfloat16* __restrict__ o, int s, int d, int causal,
                  float scale, bool vec) {
  constexpr int kLdK = DP + 8;   // K (and the staged Q) row stride
  __shared__ __align__(16) __nv_bfloat16 ks[kBk * kLdK];
  __shared__ __align__(16) __nv_bfloat16 vt[DP * kLdV];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group, column
  // the longest causal tiles first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * d;

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
    stage<DP, false>(ks, kLdK, k + base, k0, s, d, vec);
    stage<DP, true>(vt, kLdV, v + base, k0, s, d, vec);
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
                 int d, int causal, float scale) {
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kBqF][kLdF], q * scale
  float* ks = qs + kBqF * kLdF;                  // [kBkF][kLdF]
  float* vs = ks + kBkF * kLdF;                  // [kBkF][kLdF]
  float* ps = vs + kBkF * kLdF;                  // [kBqF][kBkF]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBqF;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * d;
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
    stage_f32(ks, k + base, k0, kBkF, s, d, 1.f);
    stage_f32(vs, v + base, k0, kBkF, s, d, 1.f);
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

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 if none).
// q, k, v and o are (bh, s, d) contiguous, bf16 when is_bf16 else float32.
// Requires 1 <= d <= 128, s >= 1 and 1 <= bh <= 65535 (checked by the
// wrapper).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh, int s,
                                      int d, int causal, int is_bf16,
                                      void* stream) {
  const float scale = static_cast<float>(std::pow(static_cast<double>(d),
                                                  -0.5));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((s + kBq - 1) / kBq, bh);
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(o);
    const bool vec = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) |
                                    reinterpret_cast<uintptr_t>(k) |
                                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    if (d <= 32)
      flash_bf16_kernel<32><<<grid, kThreadsH, 0, st>>>(qb, kb, vb, ob, s, d,
                                                        causal, scale, vec);
    else if (d <= 64)
      flash_bf16_kernel<64><<<grid, kThreadsH, 0, st>>>(qb, kb, vb, ob, s, d,
                                                        causal, scale, vec);
    else
      flash_bf16_kernel<128><<<grid, kThreadsH, 0, st>>>(qb, kb, vb, ob, s, d,
                                                         causal, scale, vec);
  } else {
    static bool smem_set = false;  // above 48 KB needs the opt-in, once
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemF);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
    const dim3 grid((s + kBqF - 1) / kBqF, bh);
    flash_f32_kernel<<<grid, kThreadsF, kSmemF, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), s, d, causal,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
