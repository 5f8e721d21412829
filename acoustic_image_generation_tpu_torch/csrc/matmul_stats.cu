// y = x @ w with the per-column sum and sum of squares of the f32
// accumulator in the epilogue, for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_conv_stats.py::
// matmul_stats (_kernel): the trunk's 1x1 stride-1 convs in train mode,
// whose batch-norm statistics would otherwise need a second pass over the
// conv's output. Function, as matmul_stats_reference in ops/conv_stats.py:
// operands in the compute dtype (f32 or bf16), products and sums in f32;
// the column sums are taken of the f32 accumulator before y is rounded to
// the compute dtype and stored.
//
// Bound on an H100: the trunk's 1x1 convs do 2*K*N FLOP per row against
// 2*(K + N) bytes in bf16, 64-1024 FLOP/byte, so the larger ones are bound
// by operations (989 TFLOP/s dense bf16) and the 64-channel ones by bytes
// (3.35 TB/s).
//
// Design: a tiled GEMM over (M, N), each block owning a BM x BN tile of y
// and the whole K. The f32 tile goes through shared memory; there the
// block sums each column over its valid rows (M is not a multiple of the
// tile: the edge is masked, not padded), adds the sums into the f32
// outputs with atomics (so their last bits vary from run to run), and
// stores y.
// - bf16: tensor cores through WMMA 16x16x16 bf16 fragments with f32
//   accumulators, 128x64 tiles, 8 warps of 32x32, two shared-memory stages
//   with the next step's loads held in registers (as csrc/conv_chain.cu).
// - f32: IEEE FMAs on the CUDA cores, 64x64 tiles, 4x4 per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// Column sums of the valid rows of a tile held in shared memory; `parts`
// threads share a column.
template <int BM, int BN, int LDC, int kThreads>
__device__ __forceinline__ void column_stats(const float* Cs, int rows, int n0, int n,
                                             float* s, float* ss) {
  constexpr int kParts = kThreads / BN;
  constexpr int kRows = BM / kParts;
  const int c = threadIdx.x % BN;
  const int part = threadIdx.x / BN;
  if (n0 + c >= n) return;
  float a = 0.f, b = 0.f;
  const int r0 = part * kRows;
  const int r1 = min(r0 + kRows, rows);
  for (int r = r0; r < r1; ++r) {
    const float v = Cs[r * LDC + c];
    a += v;
    b = fmaf(v, v, b);
  }
  if (r1 > r0) {
    atomicAdd(s + n0 + c, a);
    atomicAdd(ss + n0 + c, b);
  }
}

namespace fma_path {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(kThreads)
matmul_stats_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 float* __restrict__ s, float* __restrict__ ss, long long m, int k, int n) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN + kPad];
  __shared__ __align__(16) float Cs[BM * LDC];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ak = tid % BK;   // A staging: column ak of rows am + 16*i
  const int am = tid / BK;
  const int bn = tid % BN;   // B staging: column bn of rows bk + 4*i
  const int bk = tid / BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM / (kThreads / BK); ++i) {
      const int r = am + i * (kThreads / BK);
      const long long row = m0 + r;
      As[ak][r] = (row < m && k0 + ak < k) ? x[row * k + k0 + ak] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / (kThreads / BN); ++i) {
      const int kk = bk + i * (kThreads / BN);
      Bs[kk][bn] = (k0 + kk < k && n0 + bn < n) ? w[(long long)(k0 + kk) * n + n0 + bn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  const int rows = (int)min((long long)BM, m - m0);
  column_stats<BM, BN, LDC, kThreads>(Cs, rows, n0, n, s, ss);
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    if (r < rows && n0 + c < n) y[(m0 + r) * n + n0 + c] = Cs[r * LDC + c];
  }
}

}  // namespace fma_path

namespace tc_path {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int kThreads = 256;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kAElems = BM * LDA;
constexpr int kStageBytes = (kAElems + BK * LDB) * 2;
constexpr int kCBytes = BM * LDC * 4;
constexpr int kSmemBytes = 2 * kStageBytes > kCBytes ? 2 * kStageBytes : kCBytes;

// VA (VB): K (N) is a multiple of 8 and x (w) is 16-byte aligned.
template <bool VA, bool VB>
__global__ void __launch_bounds__(kThreads)
matmul_stats_bf16(const uint16_t* __restrict__ x,  // (M, K) bf16 bits
                  const uint16_t* __restrict__ w,  // (K, N) bf16 bits
                  __nv_bfloat16* __restrict__ y,   // (M, N)
                  float* __restrict__ s, float* __restrict__ ss, long long m, int k, int n) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = (k + BK - 1) / BK;

  constexpr int kAVec = BM * BK / 8 / kThreads;  // 2
  constexpr int kAOne = BM * BK / kThreads;      // 16
  constexpr int kBOne = BK * BN / kThreads;      // 8
  uint4 ra[VA ? kAVec : 1], rb;
  uint16_t sa[VA ? 1 : kAOne], sb[VB ? 1 : kBOne];

  auto load = [&](int st) {
    const int k0 = st * BK;
    if constexpr (VA) {
#pragma unroll
      for (int i = 0; i < kAVec; ++i) {
        const int v = tid + i * kThreads;
        const long long row = m0 + v / (BK / 8);
        const int col = k0 + (v % (BK / 8)) * 8;
        ra[i] = (row < m && col < k) ? *reinterpret_cast<const uint4*>(x + row * k + col)
                                     : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAOne; ++i) {
        const int e = tid + i * kThreads;
        const long long row = m0 + e / BK;
        const int col = k0 + e % BK;
        sa[i] = (row < m && col < k) ? x[row * k + col] : 0;
      }
    }
    if constexpr (VB) {
      const int kk = k0 + tid / (BN / 8);
      const int col = n0 + (tid % (BN / 8)) * 8;
      rb = (kk < k && col < n) ? *reinterpret_cast<const uint4*>(w + (long long)kk * n + col)
                               : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < kBOne; ++i) {
        const int e = tid + i * kThreads;
        const int kk = k0 + e / BN;
        const int col = n0 + e % BN;
        sb[i] = (kk < k && col < n) ? w[(long long)kk * n + col] : 0;
      }
    }
  };

  auto stash = [&](int stage) {
    uint16_t* As = reinterpret_cast<uint16_t*>(smem + stage * kStageBytes);
    uint16_t* Bs = As + kAElems;
    if constexpr (VA) {
#pragma unroll
      for (int i = 0; i < kAVec; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(As + (v / (BK / 8)) * LDA + (v % (BK / 8)) * 8) = ra[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAOne; ++i) {
        const int e = tid + i * kThreads;
        As[(e / BK) * LDA + e % BK] = sa[i];
      }
    }
    if constexpr (VB) {
      *reinterpret_cast<uint4*>(Bs + (tid / (BN / 8)) * LDB + (tid % (BN / 8)) * 8) = rb;
    } else {
#pragma unroll
      for (int i = 0; i < kBOne; ++i) {
        const int e = tid + i * kThreads;
        Bs[(e / BN) * LDB + e % BN] = sb[i];
      }
    }
  };

  const int warp = tid / 32;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  stash(0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load(st + 1);
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + (st & 1) * kStageBytes);
    const __nv_bfloat16* Bs = As + kAElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (st + 1 < steps) stash((st + 1) & 1);
    __syncthreads();
  }

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const int rows = (int)min((long long)BM, m - m0);
  column_stats<BM, BN, LDC, kThreads>(Cs, rows, n0, n, s, ss);
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    if (r < rows && n0 + c < n) y[(m0 + r) * n + n0 + c] = __float2bfloat16_rn(Cs[r * LDC + c]);
  }
}

}  // namespace tc_path

}  // namespace

// x (M, K), w (K, N) and y (M, N) in dtype (0 = float32, 1 = bfloat16);
// s, ss (N,) f32, zeroed by the caller. Returns the cudaError_t of the
// launch (0 on success), or -1 for an unknown dtype.
extern "C" int aig_matmul_stats(const void* x, const void* w, void* y, float* s, float* ss,
                                long long m, int k, int n, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    using namespace fma_path;
    const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
    matmul_stats_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(w),
                                                    static_cast<float*>(y), s, ss, m, k, n);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using namespace tc_path;
    const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
    const bool va = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vb = n % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto kernel = va ? (vb ? matmul_stats_bf16<true, true> : matmul_stats_bf16<true, false>)
                     : (vb ? matmul_stats_bf16<false, true> : matmul_stats_bf16<false, false>);
    kernel<<<grid, kThreads, 0, stream>>>(static_cast<const uint16_t*>(x),
                                          static_cast<const uint16_t*>(w),
                                          static_cast<__nv_bfloat16*>(y), s, ss, m, k, n);
    return (int)cudaGetLastError();
  }
  return -1;
}
