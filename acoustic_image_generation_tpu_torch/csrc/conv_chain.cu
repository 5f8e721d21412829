// Stride-1 SAME 3x3 convolution + bias (+ ReLU) on NHWC, forward and
// backward, for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_conv.py::conv_chain:
// the forward (_conv_chain_fwd / _fwd_kernel) and the backward
// (_conv_chain_bwd / _bwd_kernel). The chain runs as one launch per conv;
// the wrapper (ops/conv_chain.py) strings them. Forward function, as
// conv_chain_reference: operands in the compute dtype (f32 or bf16),
// products and sums in f32, f32 bias and ReLU, and one rounding to the
// compute dtype on the store. The backward is three kernels per layer (see
// the backward section at the end of the file).
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

#include <algorithm>
#include <type_traits>

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
      float v = acc[i][j] + (bias ? bias[col] : 0.f);
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

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// VA (VB): Ci (Co) is a multiple of 8 and x (w) is 16-byte aligned, so a
// thread moves 8 channels (16 bytes) of the input (weights) at a time.
// OutT: bf16 for the forward, f32 for the data grad (the cotangent stays
// f32 between layers). bias may be null.
template <bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16(const uint16_t* __restrict__ x,  // (N, H, W, Ci) bf16 bits
             const uint16_t* __restrict__ w,  // (9*Ci, Co) bf16 bits
             const float* __restrict__ bias,  // (Co,) or null
             OutT* __restrict__ y,            // (N, H, W, Co)
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
    float v = Cs[(e / BN) * LDC + e % BN] + (bias ? bias[col] : 0.f);
    if (relu) v = fmaxf(v, 0.f);
    store_out(y + m * co + col, v);
  }
}

}  // namespace tc_path

// ---------------------------------------------------------------- backward
//
// Per layer i, last to first (ops/conv_chain.py strings them), as the TPU
// kernel's _bwd_kernel computes it:
//
// 1. gate: g <- g * (a_i > 0) (no gate without ReLU); db_i = column sums of
//    the gated g in f32; gq = g rounded to the compute dtype, the operand of
//    both products. g comes in the compute dtype for the last layer (the
//    cotangent rounded on entry) and in f32 after that.
// 2. weight grad: dW_i[(tap, ci), co] = sum over pixels p of
//    x_{i-1}[p + d(tap), ci] * gq[p, co], an implicit GEMM (9*Ci x P) @
//    (P x Co) whose reduction runs over all N*H*W pixels (1.3 M at 768
//    frames of 36x48). So it is split across blocks: grid z cuts the pixels
//    into slices, each block reduces one slice of one 64x64 tile in
//    registers and adds its tile into the f32 dW with atomics (the order
//    of the adds, and so the last bits of dW, varies from run to run).
// 3. data grad: dx = conv3x3(gq, w') with w' the weights flipped in space
//    and transposed, packed (9*Co, Ci) by the wrapper: the forward kernel,
//    with no bias, no ReLU and an f32 output.
//
// Bound: the weight and data grads do 2 * 2*9*Ci*Co FLOP per pixel, the
// forward's twice, so the backward is bound by operations like the forward.
// bf16 runs on the tensor cores (WMMA, f32 accumulators); f32 stays IEEE FMA.

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename GIn, typename T>
__global__ void __launch_bounds__(256)
gate_bias_grad(const GIn* __restrict__ g,   // (M, C) cotangent
               const T* __restrict__ a,     // (M, C) layer output
               int relu,
               T* __restrict__ gq,          // (M, C) gated, in the compute dtype
               float* __restrict__ db,      // (C,) zeroed by the caller
               long long m, int c) {
  const int col = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (col < c) {
    for (long long r = (long long)blockIdx.y * 8 + threadIdx.y; r < m; r += (long long)gridDim.y * 8) {
      const long long i = r * c + col;
      float v = to_f(g[i]);
      if (relu && !(to_f(a[i]) > 0.f)) v = 0.f;
      tc_path::store_out(gq + i, v);
      sum += v;
    }
  }
  __shared__ float red[8][33];
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && col < c) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][threadIdx.x];
    atomicAdd(db + col, t);
  }
}

// Pixel p's neighbour at tap offset (dy, dx), or -1 outside the image.
__device__ __forceinline__ long long shifted_pixel(int p, int h, int wd, int dy, int dx) {
  const int xx = p % wd + dx;
  const int yy = (p / wd) % h + dy;
  if (xx < 0 || xx >= wd || yy < 0 || yy >= h) return -1;
  return (long long)p + dy * wd + dx;
}

namespace wgrad_fma {

constexpr int BM = 64;  // input channels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // pixels per step
constexpr int kThreads = 256;
constexpr int kPad = 4;

__global__ void __launch_bounds__(kThreads)
wgrad_f32(const float* __restrict__ x,   // (N, H, W, Ci) layer input
          const float* __restrict__ g,   // (N, H, W, Co) gated cotangent
          float* __restrict__ dw,        // (9*Ci, Co), zeroed by the caller
          int h, int wd, int ci, int co, int m_total, int chunk) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN + kPad];
  const int tid = threadIdx.x;
  const int ci_tiles = (ci + BM - 1) / BM;
  const int tap = blockIdx.x / ci_tiles;
  const int c0 = (blockIdx.x % ci_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p_begin + chunk, m_total);
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const int lc = tid % 64;  // channel this thread stages
  const int lp = tid / 64;  // first pixel row it stages (then +4, +8, +12)

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lp + 4 * i;
      const int p = p0 + r;
      float va = 0.f, vb = 0.f;
      if (p < p_end) {
        const long long q = shifted_pixel(p, h, wd, dy, dx);
        if (q >= 0 && c0 + lc < ci) va = x[q * ci + c0 + lc];
        if (n0 + lc < co) vb = g[(long long)p * co + n0 + lc];
      }
      As[r][lc] = va;
      Bs[r][lc] = vb;
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
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < co) atomicAdd(dw + ((long long)tap * ci + c) * co + col, acc[i][j]);
    }
  }
}

}  // namespace wgrad_fma

namespace wgrad_tc {

using namespace nvcuda;

constexpr int BM = 64;  // input channels per block (rows of dW)
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // pixels per step
constexpr int kThreads = 128;  // 4 warps, 32x32 each
constexpr int LDA = BM + 8;  // As[pixel][channel], bf16
constexpr int LDB = BN + 8;  // Bs[pixel][channel], bf16
constexpr int LDC = BN + 4;  // f32
constexpr int kAElems = BK * LDA;
constexpr int kStageBytes = (kAElems + BK * LDB) * 2;
constexpr int kCBytes = BM * LDC * 4;
constexpr int kSmemBytes = 2 * kStageBytes > kCBytes ? 2 * kStageBytes : kCBytes;

// VA (VB): Ci (Co) is a multiple of 8 and x (g) is 16-byte aligned.
//
// Rows of dW: with VA a block owns 64 channels of one tap (grid x = 9 *
// ceil(Ci/64)); without VA (Ci = 12 or 133) it owns 64 rows of the flat
// (tap, channel) order (grid x = ceil(9*Ci/64)), so a 12-channel input
// fills 2 tiles instead of 9 tiles with 12 of 64 rows used, and each block
// reads the cotangent slice 2 times instead of 9.
template <bool VA, bool VB>
__global__ void __launch_bounds__(kThreads)
wgrad_bf16(const uint16_t* __restrict__ x,  // (N, H, W, Ci) layer input, bf16 bits
           const uint16_t* __restrict__ g,  // (N, H, W, Co) gated cotangent, bf16 bits
           float* __restrict__ dw,          // (9*Ci, Co), zeroed by the caller
           int h, int wd, int ci, int co, int m_total, int chunk) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p_begin + chunk, m_total);
  const int steps = (p_end - p_begin + BK - 1) / BK;
  int tap = 0, c0 = 0, row0, rows;  // this block's dW rows: row0 .. row0 + rows - 1
  if constexpr (VA) {
    const int ci_tiles = (ci + BM - 1) / BM;
    tap = blockIdx.x / ci_tiles;
    c0 = (blockIdx.x % ci_tiles) * BM;
    row0 = tap * ci + c0;
    rows = min(BM, ci - c0);
  } else {
    row0 = blockIdx.x * BM;
    rows = min(BM, 9 * ci - row0);
  }
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;

  // Each thread stages 16 elements of A and of B per step. A with VA: two
  // 16-byte vectors (pixel v/8, channels (v%8)*8..+8, v = tid + 128*i).
  // A without VA: one pixel (slot tid % 32) and 16 flat rows (tid/32 +
  // 4*i), whose tap and offset are fixed for the block: one pixel decode a
  // step. B: two vectors as A, or sixteen scalars (pixel e/64, channel
  // e%64, e = tid + 128*i).
  constexpr int kVec = BK * BM / 8 / kThreads;  // 2
  constexpr int kOne = BK * BM / kThreads;      // 16
  uint4 ra[VA ? kVec : 1], rb[VB ? kVec : 1];
  uint16_t sa[VA ? 1 : kOne], sb[VB ? 1 : kOne];
  int rtap[VA ? 1 : kOne], roff[VA ? 1 : kOne];
  if constexpr (!VA) {
#pragma unroll
    for (int i = 0; i < kOne; ++i) {
      const int r = tid / 32 + 4 * i;
      const int t = (row0 + r) / ci;
      const int c = row0 + r - t * ci;
      rtap[i] = r < rows ? t : -1;
      roff[i] = ((t / 3 - 1) * wd + (t % 3 - 1)) * ci + c;
    }
  }

  auto load = [&](int s) {
    const int p0 = p_begin + s * BK;
    if constexpr (VA) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int v = tid + i * kThreads;
        const int p = p0 + v / (BM / 8);
        const int c = c0 + (v % (BM / 8)) * 8;
        const long long q = p < p_end ? shifted_pixel(p, h, wd, dy, dx) : -1;
        ra[i] = (q >= 0 && c < ci) ? *reinterpret_cast<const uint4*>(x + q * ci + c)
                                   : make_uint4(0, 0, 0, 0);
      }
    } else {
      const int p = p0 + tid % 32;
      const int px = p % wd;
      const int py = (p / wd) % h;
#pragma unroll
      for (int i = 0; i < kOne; ++i) {
        const int t = rtap[i];
        const int yy = py + t / 3 - 1;
        const int xx = px + t % 3 - 1;
        const bool ok = p < p_end && t >= 0 && yy >= 0 && yy < h && xx >= 0 && xx < wd;
        sa[i] = ok ? x[(long long)p * ci + roff[i]] : 0;
      }
    }
    if constexpr (VB) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int v = tid + i * kThreads;
        const int p = p0 + v / (BN / 8);
        const int col = n0 + (v % (BN / 8)) * 8;
        rb[i] = (p < p_end && col < co)
                    ? *reinterpret_cast<const uint4*>(g + (long long)p * co + col)
                    : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kOne; ++i) {
        const int e = tid + i * kThreads;
        const int p = p0 + e / BN;
        const int col = n0 + e % BN;
        sb[i] = (p < p_end && col < co) ? g[(long long)p * co + col] : 0;
      }
    }
  };

  auto stash = [&](int stage) {
    uint16_t* As = reinterpret_cast<uint16_t*>(smem + stage * kStageBytes);
    uint16_t* Bs = As + kAElems;
    if constexpr (VA) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(As + (v / (BM / 8)) * LDA + (v % (BM / 8)) * 8) = ra[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kOne; ++i) As[(tid % 32) * LDA + tid / 32 + 4 * i] = sa[i];
    }
    if constexpr (VB) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(Bs + (v / (BN / 8)) * LDB + (v % (BN / 8)) * 8) = rb[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kOne; ++i) {
        const int e = tid + i * kThreads;
        Bs[(e / BN) * LDB + e % BN] = sb[i];
      }
    }
  };

  const int warp = tid / 32;
  const int wm = (warp % 2) * 32;  // the warp's input channels in the tile
  const int wn = (warp / 2) * 32;  // its output channels
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (steps > 0) {
    load(0);
    stash(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load(s + 1);
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(smem + (s & 1) * kStageBytes);
    const __nv_bfloat16* Bs = As + kAElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A (channel x pixel) is As read column-major: element (r, c) at
      // As[c*LDA + r].
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + kk * LDA + wm + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (s + 1 < steps) stash((s + 1) & 1);
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
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN;
    const int col = n0 + e % BN;
    if (r < rows && col < co) atomicAdd(dw + (long long)(row0 + r) * co + col, Cs[r * LDC + e % BN]);
  }
}

}  // namespace wgrad_tc

template <typename OutT>
int launch_conv3x3(const void* x, const void* w, const float* bias, OutT* y, int n, int h, int wd,
                   int ci, int co, int relu, int dtype, cudaStream_t stream) {
  const long long m_total = (long long)n * h * wd;
  if (dtype == 0) {
    using namespace fma_path;
    if constexpr (!std::is_same<OutT, float>::value) return -1;
    const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
    conv3x3_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w), bias,
                                               reinterpret_cast<float*>(y), n, h, wd, ci, co, relu);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using namespace tc_path;
    const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* wb = static_cast<const uint16_t*>(w);
    const bool va = ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vb = co % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    auto kernel = va ? (vb ? conv3x3_bf16<true, true, OutT> : conv3x3_bf16<true, false, OutT>)
                     : (vb ? conv3x3_bf16<false, true, OutT> : conv3x3_bf16<false, false, OutT>);
    kernel<<<grid, kThreads, 0, stream>>>(xb, wb, bias, y, n, h, wd, ci, co, relu);
    return (int)cudaGetLastError();
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; bias is f32).
// Each entry returns the cudaError_t of its launch (0 on success), or -1
// for arguments it does not take.
extern "C" int aig_conv3x3_bias_relu(const void* x, const void* w, const float* bias, void* y,
                                     int n, int h, int wd, int ci, int co, int relu,
                                     int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_conv3x3(x, w, bias, static_cast<float*>(y), n, h, wd, ci, co, relu, 0, stream);
  return launch_conv3x3(x, w, bias, static_cast<__nv_bfloat16*>(y), n, h, wd, ci, co, relu, dtype,
                        stream);
}

// Data grad of one layer: dx (N,H,W,Ci) f32 = conv3x3(gq, wt), gq (N,H,W,Co)
// and wt (9*Co, Ci) in the compute dtype.
extern "C" int aig_conv3x3_data_grad(const void* gq, const void* wt, float* dx, int n, int h,
                                     int wd, int co, int ci, int dtype, cudaStream_t stream) {
  return launch_conv3x3(gq, wt, nullptr, dx, n, h, wd, co, ci, 0, dtype, stream);
}

// Gate and bias grad of one layer over (m, c): g is f32 when g_f32, else in
// the compute dtype; a and gq in the compute dtype; db f32, zeroed.
extern "C" int aig_conv3x3_gate(const void* g, int g_f32, const void* a, int relu, void* gq,
                                float* db, long long m, int c, int dtype, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((unsigned)((c + 31) / 32), (unsigned)std::min<long long>((m + 63) / 64, 1024));
  if (dtype == 0) {
    gate_bias_grad<float, float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(a), relu, static_cast<float*>(gq),
        db, m, c);
  } else if (dtype == 1) {
    const auto* ab = static_cast<const __nv_bfloat16*>(a);
    auto* gqb = static_cast<__nv_bfloat16*>(gq);
    if (g_f32)
      gate_bias_grad<float, __nv_bfloat16><<<grid, block, 0, stream>>>(
          static_cast<const float*>(g), ab, relu, gqb, db, m, c);
    else
      gate_bias_grad<__nv_bfloat16, __nv_bfloat16><<<grid, block, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(g), ab, relu, gqb, db, m, c);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// Weight grad of one layer: dw (9*Ci, Co) f32, zeroed, += the products of x
// (N,H,W,Ci) and gq (N,H,W,Co), both in the compute dtype, over `splits`
// slices of the pixels.
extern "C" int aig_conv3x3_weight_grad(const void* x, const void* gq, float* dw, int n, int h,
                                       int wd, int ci, int co, int splits, int dtype,
                                       cudaStream_t stream) {
  const long long m_total = (long long)n * h * wd;
  if (m_total >= (1LL << 31) || splits < 1) return -1;
  const int m = (int)m_total;
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + 31) / 32 * 32;  // whole steps of both kernels
  const unsigned gz = (unsigned)((m + chunk - 1) / chunk);
  if (dtype == 0) {
    using namespace wgrad_fma;
    const dim3 grid((unsigned)(9 * ((ci + BM - 1) / BM)), (unsigned)((co + BN - 1) / BN), gz);
    wgrad_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(gq), dw, h, wd, ci, co, m,
                                             chunk);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    using namespace wgrad_tc;
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* gb = static_cast<const uint16_t*>(gq);
    const bool va = ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vb = co % 8 == 0 && reinterpret_cast<uintptr_t>(gq) % 16 == 0;
    const unsigned gx = va ? 9 * ((ci + BM - 1) / BM) : (9 * ci + BM - 1) / BM;
    const dim3 grid(gx, (unsigned)((co + BN - 1) / BN), gz);
    auto kernel = va ? (vb ? wgrad_bf16<true, true> : wgrad_bf16<true, false>)
                     : (vb ? wgrad_bf16<false, true> : wgrad_bf16<false, false>);
    kernel<<<grid, kThreads, 0, stream>>>(xb, gb, dw, h, wd, ci, co, m, chunk);
    return (int)cudaGetLastError();
  }
  return -1;
}
