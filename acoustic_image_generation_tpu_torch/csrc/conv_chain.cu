// Stride-1 SAME 3x3 convolution + bias (+ ReLU) on NHWC, for sm_90a.
//
// Replaces the forward of acoustic_image_generation_tpu/ops/pallas_conv.py::
// conv_chain (_conv_chain_fwd / _fwd_kernel). The chain runs as one launch
// of this kernel per conv; the wrapper (ops/conv_chain.py) strings them.
// Function, as conv_chain_reference: operands in the compute dtype (f32 or
// bf16), products and sums in f32, f32 bias and ReLU, and one rounding to
// the compute dtype on the store.
//
// Bound on an H100: the generator's chains do 2*9*Ci*Co FLOP per output
// pixel at 128-256 channels, far above the card's ~295 FLOP/byte ridge, so
// they are bound by operations (989 TFLOP/s dense bf16 on the tensor cores;
// 67 TFLOP/s f32 on the CUDA cores).
//
// Both paths are implicit GEMMs: M = N*H*W output pixels, N = Co, K = 9*Ci
// walked as 9 taps x Ci. A step stages a slice of the shifted input (zero
// outside the image: that is the SAME padding, with no padded copy of the
// input) and a slice of the packed weights ((9*Ci, Co), row
// (dy*3+dx)*Ci + ci) in shared memory.
//
// - bf16 (the serving path): tensor cores through WMMA (mma.sync) 16x16x16
//   bf16 fragments with f32 accumulators. A block of 8 warps computes a
//   128-pixel x 64-channel tile, each warp 32x32. Two shared-memory stages:
//   the global loads of step s+1 are in flight in registers while the warps
//   multiply step s. Channel counts that are multiples of 8 load 16 bytes a
//   thread; others (the 133-channel bottleneck) load element by element,
//   for the input and the weights separately.
//   The f32 tile goes through shared memory for the bias, ReLU and bf16
//   store. What is left to the bound: wgmma and TMA, deeper pipelines, and
//   keeping the pair's intermediate on chip.
// - f32 (checks and f32 compute): IEEE FMAs on the CUDA cores, a 64x64 tile
//   with a 4x4 register tile per thread. TF32 would not compute the same
//   function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- f32, FMA

namespace fma_path {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per step
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;  // keeps float4 alignment, spreads the transposed stores

__global__ void __launch_bounds__(kThreads)
conv3x3_f32(const float* __restrict__ x,     // (N, H, W, Ci)
            const float* __restrict__ w,     // (9*Ci, Co)
            const float* __restrict__ bias,  // (Co,)
            float* __restrict__ y,           // (N, H, W, Co)
            int n, int h, int wd, int ci, int co, int relu) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // output-channel group
  const int ty = tid / (BN / TN);  // pixel group
  const long long m_total = (long long)n * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A staging: thread loads channel ak of pixels am + 16*i.
  const int ak = tid % BK;
  const int am = tid / BK;  // 0..15
  constexpr int kARows = BM / (kThreads / BK);  // 4
  int pimg[kARows], py[kARows], px[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + am + i * (kThreads / BK);
    if (m < m_total) {
      px[i] = (int)(m % wd);
      py[i] = (int)((m / wd) % h);
      pimg[i] = (int)(m / ((long long)wd * h));
    } else {
      pimg[i] = -1;
      py[i] = px[i] = 0;
    }
  }
  // B staging: thread loads output channel bn of weight rows bk + 4*i.
  const int bn = tid % BN;
  const int bk = tid / BN;  // 0..3
  constexpr int kBRows = BK / (kThreads / BN);  // 4

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < ci; c0 += BK) {
      const int c = c0 + ak;
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        const int yy = py[i] + dy;
        const int xx = px[i] + dx;
        float v = 0.f;
        if (pimg[i] >= 0 && c < ci && yy >= 0 && yy < h && xx >= 0 && xx < wd) {
          v = x[(((long long)pimg[i] * h + yy) * wd + xx) * ci + c];
        }
        As[ak][am + i * (kThreads / BK)] = v;
      }
#pragma unroll
      for (int i = 0; i < kBRows; ++i) {
        const int kk = bk + i * (kThreads / BN);
        const int col = n0 + bn;
        float v = 0.f;
        if (c0 + kk < ci && col < co) v = w[((long long)tap * ci + c0 + kk) * co + col];
        Bs[kk][bn] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= co) continue;
      float v = acc[i][j] + bias[col];
      if (relu) v = fmaxf(v, 0.f);
      y[m * co + col] = v;
    }
  }
}

}  // namespace fma_path

// ------------------------------------------------------- bf16, tensor cores

namespace tc_path {

using namespace nvcuda;

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per step
constexpr int kThreads = 256;
constexpr int LDA = BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 elements
constexpr int kAElems = BM * LDA;
constexpr int kStageElems = kAElems + BK * LDB;
constexpr int kStageBytes = kStageElems * 2;
constexpr int kCBytes = BM * LDC * 4;
constexpr int kSmemBytes = 2 * kStageBytes > kCBytes ? 2 * kStageBytes : kCBytes;

// VA (VB): Ci (Co) is a multiple of 8 and x (w) is 16-byte aligned, so a
// thread moves 8 channels (16 bytes) of the input (weights) at a time.
template <bool VA, bool VB>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16(const uint16_t* __restrict__ x,  // (N, H, W, Ci) bf16 bits
             const uint16_t* __restrict__ w,  // (9*Ci, Co) bf16 bits
             const float* __restrict__ bias,  // (Co,)
             __nv_bfloat16* __restrict__ y,   // (N, H, W, Co)
             int n, int h, int wd, int ci, int co, int relu) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ int pimg[BM], py[BM], px[BM];

  const int tid = threadIdx.x;
  const long long m_total = (long long)n * h * wd;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  for (int i = tid; i < BM; i += kThreads) {
    const long long m = m0 + i;
    if (m < m_total) {
      px[i] = (int)(m % wd);
      py[i] = (int)((m / wd) % h);
      pimg[i] = (int)(m / ((long long)wd * h));
    } else {
      pimg[i] = -1;
      py[i] = px[i] = 0;
    }
  }
  __syncthreads();

  const int kc = (ci + BK - 1) / BK;
  const int steps = 9 * kc;

  // Registers holding step s+1's tiles while step s multiplies.
  constexpr int kAVec = BM * BK / 8 / kThreads;  // 2 x 16 bytes
  constexpr int kAOne = BM * BK / kThreads;      // 16 elements
  constexpr int kBOne = BK * BN / kThreads;      // 8 elements
  uint4 ra[VA ? kAVec : 1], rb;
  uint16_t sa[VA ? 1 : kAOne], sb[VB ? 1 : kBOne];

  auto pixel_ptr = [&](int m, int dy, int dx, int c, bool& ok) -> const uint16_t* {
    const int img = pimg[m];
    const int yy = py[m] + dy;
    const int xx = px[m] + dx;
    ok = img >= 0 && c < ci && yy >= 0 && yy < h && xx >= 0 && xx < wd;
    return x + (((long long)img * h + yy) * wd + xx) * ci + c;
  };

  auto load = [&](int s) {
    const int tap = s / kc;
    const int c0 = (s % kc) * BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    if constexpr (VA) {
#pragma unroll
      for (int i = 0; i < kAVec; ++i) {
        const int v = tid + i * kThreads;
        bool ok;
        const uint16_t* p = pixel_ptr(v / (BK / 8), dy, dx, c0 + (v % (BK / 8)) * 8, ok);
        ra[i] = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAOne; ++i) {
        const int e = tid + i * kThreads;
        bool ok;
        const uint16_t* p = pixel_ptr(e / BK, dy, dx, c0 + e % BK, ok);
        sa[i] = ok ? *p : 0;
      }
    }
    if constexpr (VB) {
      const int k = tid / (BN / 8);
      const int col = n0 + (tid % (BN / 8)) * 8;
      rb = (c0 + k < ci && col < co)
               ? *reinterpret_cast<const uint4*>(w + ((long long)tap * ci + c0 + k) * co + col)
               : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int i = 0; i < kBOne; ++i) {
        const int e = tid + i * kThreads;
        const int k = e / BN;
        const int col = n0 + e % BN;
        sb[i] = (c0 + k < ci && col < co) ? w[((long long)tap * ci + c0 + k) * co + col] : 0;
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
  const int wm = (warp % 4) * 32;  // warp's pixel rows in the tile
  const int wn = (warp / 4) * 32;  // warp's channel columns in the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + (s & 1) * kStageBytes);
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
    // The stage written here was last read in step s-1, before its barrier.
    if (s + 1 < steps) stash((s + 1) & 1);
    __syncthreads();
  }

  // Epilogue through shared memory (the stages are free after the barrier).
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const long long m = m0 + e / BN;
    const int col = n0 + e % BN;
    if (m >= m_total || col >= co) continue;
    float v = Cs[(e / BN) * LDC + e % BN] + bias[col];
    if (relu) v = fmaxf(v, 0.f);
    y[m * co + col] = __float2bfloat16_rn(v);
  }
}

}  // namespace tc_path

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; bias is f32).
// Returns the cudaError_t of the launch (0 on success), or -1 for an
// unknown dtype.
extern "C" int aig_conv3x3_bias_relu(const void* x, const void* w, const float* bias, void* y,
                                     int n, int h, int wd, int ci, int co, int relu,
                                     int dtype, cudaStream_t stream) {
  const long long m_total = (long long)n * h * wd;
  if (dtype == 0) {
    using namespace fma_path;
    const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
    conv3x3_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w), bias,
                                               static_cast<float*>(y), n, h, wd, ci, co, relu);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using namespace tc_path;
    const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* wb = static_cast<const uint16_t*>(w);
    auto* yb = static_cast<__nv_bfloat16*>(y);
    const bool va = ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vb = co % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto kernel = va ? (vb ? conv3x3_bf16<true, true> : conv3x3_bf16<true, false>)
                     : (vb ? conv3x3_bf16<false, true> : conv3x3_bf16<false, false>);
    kernel<<<grid, kThreads, 0, stream>>>(xb, wb, bias, yb, n, h, wd, ci, co, relu);
    return (int)cudaGetLastError();
  }
  return -1;
}
