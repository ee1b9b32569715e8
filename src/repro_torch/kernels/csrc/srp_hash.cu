// Fused SRP hashing -- projection, sign test and bit packing -- for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/srp_hash.py::srp_hash (body
// _srp_kernel): code[i, w] bit j = (x[i] . proj[:, 32 w + j] >= 0), with
// x (n, d) f32 and proj (d, B) f32 row-major, B % 32 == 0 -> (n, B / 32)
// 32-bit words. Each score is one running sum over i = 0..d-1 in order,
// each product and each sum rounded on its own (__fmul_rn, __fadd_rn: no
// FMA), so the codes equal kernels/ref.py::srp_hash bit for bit at every
// shape; -0.0 >= 0 sets a bit and NaN does not, as in the reference.
//
// What bounds it on an H100: float32 arithmetic outside the tensor cores
// (a TF32 product would move bits). At the build shape (17,920 x 101) x
// (101 x 128) the products are 463 MFLOP, 6.9 us at 67 TFLOP/s counting an
// FMA as two; without FMA every term is two FP32 instructions, 13.8 us at
// 33.5 T instructions/s, the floor of the bitwise contract. At the
// per-chunk query shape (256 x 100) x (100 x 128) it is launch bound: each
// score is a chain of 100 dependent adds.
//
// Design: a register tile. A block of 8 warps covers 8 R rows and 32 S
// output bits (S words); warp v owns the block's rows R v .. R v + R - 1,
// and lane l keeps the R x S sums of those rows against columns 32 s + l
// of the block's words. The block stages d in chunks of at most 128: the
// proj columns of its words ([chunk][32 S]) and each warp its own x rows
// ([R][chunk], padded to a multiple of 4) in shared memory, by cp.async
// (16-byte pieces where the rows are aligned), every copy of a chunk in
// flight at once. Per 4 dims a warp then reads R float4 of x (broadcasts)
// and 4 S proj floats (one conflict-free line each) for 8 R S FP32
// instructions. __ballot_sync of (sum >= 0) over the 32 lanes is word s of
// a row, bit j = column 32 s + j; lane S r + s of the warp stores word s of
// its row r.
// Two tiles, picked by shape as fused_scan picks its rows per thread:
//   <R 1, S 1, G 4>: 8 rows x 32 bits a block, so the query chunk (256
//     rows, 4 words) runs as 128 blocks, one an SM; each thread one chain,
//     the loads of 16 dims issued ahead of their adds. It is bound by the
//     launch, the round trip of its staging and the 100 dependent adds;
//   <R 4, S 4, G 1>: 32 rows x 128 bits a block once that makes 256 blocks
//     or more (the build: 560 blocks, 66.5 KB of shared memory each at
//     d = 101, three an SM, so two uneven waves); 16 independent sums a
//     thread keep the FP32 pipes fed, and each proj value read from shared
//     memory serves 4 rows. Its loop issues 128 FP32 instructions in 167.
// Any d (staged in chunks) and any B (grid.y covers the groups of S words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 128;  // dims staged at a time
constexpr unsigned kAll = 0xffffffffu;
// the large tile once it alone makes this many blocks
constexpr int kLargeBlocks = 256;

// Asynchronous copies global -> shared of 4 and of 16 bytes; ok == false
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Stage dims [c0, c0 + dc) of the proj columns of words word0 .. word0 +
// S - 1 into ps ([dc][32 S]): every thread of the block, 16-byte copies when
// proj is 16-byte aligned (B % 32 == 0 always), else 4-byte ones. Words
// past w arrive as zeros (and are never stored).
template <int S>
__device__ __forceinline__ void stage_proj(float* ps, const float* proj,
                                           int b, int w, int word0, int c0,
                                           int dc, bool vec_p) {
  const float* pc = proj + static_cast<int64_t>(c0) * b + 32 * word0;
  if (vec_p) {
    constexpr int kRow = 8 * S;  // 16-byte pieces of a staged proj row
    for (int e = threadIdx.x; e < dc * kRow; e += kThreads) {
      const int i = e / kRow, c = e % kRow;
      const bool ok = word0 + c / 8 < w;
      cp_async16(ps + i * 32 * S + 4 * c,
                 ok ? pc + static_cast<int64_t>(i) * b + 4 * c : proj, ok);
    }
  } else {
    constexpr int kRow = 32 * S;
    for (int e = threadIdx.x; e < dc * kRow; e += kThreads) {
      const int i = e / kRow, c = e % kRow;
      const bool ok = word0 + c / 32 < w;
      cp_async4(ps + i * kRow + c,
                ok ? pc + static_cast<int64_t>(i) * b + c : proj, ok);
    }
  }
}

// Stage dims [c0, c0 + dc) of x rows row0 .. row0 + R - 1 into xw ([R][ldx]):
// the lanes of one warp, 16-byte copies when vec_x (d % 4 == 0 and x
// 16-byte aligned), else 4-byte ones. Rows past n arrive as zeros.
template <int R>
__device__ __forceinline__ void stage_x(float* xw, const float* x,
                                        int64_t row0, int n, int d, int c0,
                                        int dc, int ldx, bool vec_x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = row0 + r;
    const bool ok = row < n;
    const float* src = x + (ok ? row * d + c0 : 0);
    if (vec_x) {
      for (int c = lane; c < dc / 4; c += 32)
        cp_async16(xw + r * ldx + 4 * c, ok ? src + 4 * c : x, ok);
    } else {
      for (int i = lane; i < dc; i += 32)
        cp_async4(xw + r * ldx + i, ok ? src + i : x, ok);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// four dims i..i+3 of every sum of this thread, in order
template <int R, int S>
__device__ __forceinline__ void step4(float (&acc)[R][S], const float* xw,
                                      int ldx, const float* pl, int i) {
  float4 xv[R];
  float pv[4][S];
#pragma unroll
  for (int r = 0; r < R; ++r)
    xv[r] = *reinterpret_cast<const float4*>(xw + r * ldx + i);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int s = 0; s < S; ++s) pv[k][s] = pl[(i + k) * 32 * S + 32 * s];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s)
        acc[r][s] =
            __fadd_rn(acc[r][s], __fmul_rn(lane_of(xv[r], k), pv[k][s]));
}

// dims [0, dc) of every sum of this thread, in order; G groups of 4 dims a
// loop body
template <int R, int S, int G>
__device__ __forceinline__ void accumulate(float (&acc)[R][S], const float* xw,
                                           int ldx, const float* pl, int dc) {
  int i = 0;
  for (; i + 4 * G <= dc; i += 4 * G)
#pragma unroll
    for (int g = 0; g < G; ++g) step4<R, S>(acc, xw, ldx, pl, i + 4 * g);
  for (; i + 4 <= dc; i += 4) step4<R, S>(acc, xw, ldx, pl, i);
  for (; i < dc; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s)
        acc[r][s] = __fadd_rn(
            acc[r][s], __fmul_rn(xw[r * ldx + i], pl[i * 32 * S + 32 * s]));
}

// Block (bx, by) computes rows kWarps R bx .. kWarps R (bx + 1) - 1, R a
// warp, against words S by .. S by + S - 1. ldx: the staged chunk's
// length, d rounded up to 4 and capped at kMaxChunk.
template <int R, int S, int G>
__global__ void __launch_bounds__(kThreads, 3)
srp_kernel(const float* __restrict__ x, const float* __restrict__ proj,
           uint32_t* __restrict__ out, int n, int d, int b, int ldx,
           bool vec_x, bool vec_p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ps = smem;                                     // [ldx][32 S]
  float* xw = smem + ldx * 32 * S + warp * R * ldx;     // [R][ldx], this warp
  const int w = b / 32;
  const int word0 = blockIdx.y * S;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * R;

  float acc[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) acc[r][s] = 0.f;
  for (int c0 = 0; c0 < d; c0 += ldx) {
    const int dc = min(ldx, d - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_proj<S>(ps, proj, b, w, word0, c0, dc, vec_p);
    stage_x<R>(xw, x, row0, n, d, c0, dc, ldx, vec_x);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    accumulate<R, S, G>(acc, xw, ldx, ps + lane, dc);
  }

  // pack: word s of row r is the ballot of the 32 lanes; lane S r + s keeps it
  uint32_t word_bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t bits = __ballot_sync(kAll, acc[r][s] >= 0.f);
      if (lane == r * S + s) word_bits = bits;
    }
  if (lane < R * S) {
    const int64_t row = row0 + lane / S;
    const int word = word0 + lane % S;
    if (row < n && word < w) out[row * w + word] = word_bits;
  }
}

template <int R, int S, int G>
int launch(const float* x, const float* proj, uint32_t* out, int n, int d,
           int b, cudaStream_t stream) {
  const int d4 = (d + 3) / 4 * 4;
  const int ldx = d4 < kMaxChunk ? d4 : kMaxChunk;
  const size_t smem = sizeof(float) * ldx * (kWarps * R + 32 * S);
  static size_t allowed = 48 * 1024;  // above it needs the opt-in
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        srp_kernel<R, S, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 grid((n + kWarps * R - 1) / (kWarps * R), (b / 32 + S - 1) / S);
  const bool vec_x = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_p = reinterpret_cast<uintptr_t>(proj) % 16 == 0;
  srp_kernel<R, S, G><<<grid, kThreads, smem, stream>>>(x, proj, out, n, d, b,
                                                        ldx, vec_x, vec_p);
  return 0;
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 if none).
// Requires b % 32 == 0, 1 <= b / 32 <= 65535 and d >= 1 (checked by the
// wrapper).
extern "C" int srp_hash_launch(const void* x, const void* proj, void* out,
                               int n, int d, int b, void* stream) {
  if (n > 0) {
    const auto xf = static_cast<const float*>(x);
    const auto pf = static_cast<const float*>(proj);
    const auto o = static_cast<uint32_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    const int64_t large_blocks =
        (static_cast<int64_t>(n) + 31) / 32 * ((b / 32 + 3) / 4);
    const int err = large_blocks >= kLargeBlocks
                        ? launch<4, 4, 1>(xf, pf, o, n, d, b, st)
                        : launch<1, 1, 4>(xf, pf, o, n, d, b, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
