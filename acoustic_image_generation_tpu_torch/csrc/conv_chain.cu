// Stride-1 SAME 3x3 convolution + bias (+ ReLU) on NHWC, forward and
// backward, for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_conv.py::conv_chain:
// the forward (_conv_chain_fwd / _fwd_kernel, pallas_call at :388) and the
// backward (_conv_chain_bwd / _bwd_kernel, pallas_call at :443). The chain
// runs as one launch per conv; the wrapper (ops/conv_chain.py) strings
// them. Forward function, as conv_chain_reference: operands in the compute
// dtype (f32 or bf16), products and sums in f32, f32 bias and ReLU, and one
// rounding to the compute dtype on the store.
//
// Bound on an H100: the chains do 2*9*Ci*Co FLOP per output pixel at
// 128-256 channels, far above the card's ~295 FLOP/byte ridge, so they are
// bound by operations: 989 TFLOP/s dense bf16 on the tensor cores, 67
// TFLOP/s f32 on the CUDA cores.
//
// bf16 (the serving and training path), namespace sm90. What each part of
// the design does about what held the earlier tensor-core kernels back:
// 1. Tensor cores: every product is a wgmma (warpgroup MMA, m64nNk16, f32
//    accumulators in registers), the card's only route to its bf16 rate; no
//    WMMA / mma.sync is left on this path.
// 2. Staging: a ring of 4-5 shared-memory stages of K = 64, fed by one
//    copying warpgroup with 16-byte cp.async (zero fill, source size 0, for
//    taps outside the image: the SAME padding). Each of its threads arrives
//    on the stage's full mbarrier when its copies land (cp.async.mbarrier.
//    arrive); the wgmma warpgroups wait on it, keep one stage's wgmma in
//    flight, and free a slot on its empty mbarrier when the wgmma that read
//    it is done: no __syncthreads in the main loop. cp.async rather than
//    TMA because the implicit GEMM's gather is per pixel (each chunk has its
//    own tap shift and border test, and tiles need not follow image rows).
//    Tiles use the 128-byte swizzle: 8 threads copy one row's 128 contiguous
//    bytes into 8 different bank groups, and wgmma reads it conflict-free.
// 3. N tile: a block owns 64 or 128 output pixels (one wgmma warpgroup per
//    64) and ALL output channels, BN = Co rounded up to 16, 64, 128 or 136
//    (Co = 133 costs 136 columns), so the shifted input is read once per
//    tap; wider outputs (a data grad into 256 channels) take N tiles of 128.
//    The wrapper picks 64 pixels where 128 would give fewer than two blocks
//    per SM (the 12x16 chains at 96 frames: 288 blocks instead of 144).
//    K runs in slices of 64 channels, the 9 taps of a slice in consecutive
//    stages, and the input is copied through L1 (cp.async.ca), so the taps'
//    re-reads of one slice mostly hit there.
// 4. Odd channel counts: channels are zero-padded to a multiple of 8 (12 ->
//    16, 133 -> 136) by the wrapper, once per tensor, so every copy is a
//    whole aligned chunk; the packed weights carry matching zero rows and
//    columns. The chain keeps its intermediates at the padded width, with
//    zeros in the added channels, and hands out views of the real ones.
// 5. Epilogue: in registers on the accumulator fragments: bias and ReLU
//    (forward), or the previous layer's ReLU gate and bias grad (data
//    grad), then bf16x2 stores.
// 6. Backward: the gate is fused into the data grad (below), and the weight
//    grad (wgrad) is a wgmma GEMM too: dW[(tap, ci), co] = sum over pixels p
//    of x[p + d(tap), ci] * gq[p, co], K = the pixels. Both operands stay in
//    their natural [pixel][channel] layout and feed wgmma MN-major
//    (transposed). A block owns 128 rows of the flat (tap, padded channel)
//    order (so Ci = 12 fills 2 tiles, not 9) and all Co columns in whole
//    64-channel atoms (64, 128 or 192); the pixels are split across blocks,
//    each adding its tile into the f32 dW with atomics (the order of the
//    adds, and so the last bits of dW, varies from run to run).
//
// The backward of a layer chain (ops/conv_chain.py), as _bwd_kernel: one
// gate launch for the chain's incoming cotangent (gq_k = bf16 of g * (a_k >
// 0), db_k its f32 column sums), then per layer i, last to first, the
// weight grad and the data grad g_{i-1} = conv3x3(gq_i, w_i flipped and
// transposed), whose epilogue applies layer i-1's gate (a_{i-1} > 0) to
// the f32 sums, adds their column sums into db_{i-1} and writes gq_{i-1}
// in bf16: the f32 cotangent never reaches device memory. The first layer's
// data grad writes the chain's dx in bf16 with no gate.
//
// f32 (checks and f32 compute): IEEE FMAs on the CUDA cores (fma_path,
// wgrad_fma), with a gate launch per layer and f32 cotangents between
// layers. TF32 would not compute the same function.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// --------------------------------------------------- bf16, wgmma (sm_90a)

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;  // K of one pipeline stage: 4 wgmma k16 steps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte cp.async; with !valid it reads nothing and writes zeros.
// L1: cached there too (the implicit GEMM's input, which its 9 taps read
// within a few stages); else L2 only.
template <bool L1 = false>
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, bool valid) {
  if constexpr (L1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

// The implicit GEMM's K order, in 16-byte chunks of 8 channels: slices of
// up to 64 channels (8 chunks), and within a slice the 9 taps, so that the
// taps of one slice, which read the same input lines, run in consecutive
// stages. Chunk jj of a cpt-chunk input -> tap (9 past the end) and channel.
__device__ __forceinline__ void chunk_tap(int jj, int cpt, int& tap, int& c) {
  const int full = cpt >> 3;
  const int rem = cpt & 7;
  if (jj < full * 72) {
    const int b = jj / 72;
    const int r = jj - b * 72;
    tap = r >> 3;
    c = ((b << 3) + (r & 7)) << 3;
  } else if (rem) {
    const int r = jj - full * 72;
    tap = r / rem;
    c = ((full << 3) + r - tap * rem) << 3;
  } else {
    tap = 9;
    c = 0;
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk q (0..7) of row r in a tile of 128-byte
// rows with the 128-byte swizzle that wgmma reads (and TMA would write):
// the chunk moves to position q ^ (r % 8) of its row, so 8 threads copying
// one row's 8 chunks, or reading one chunk of 8 rows, hit 8 different
// 16-byte bank groups. The tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(int r, int q) {
  return (uint32_t)((r << 7) + ((q ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across an
// in-flight wgmma.
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, D += A*B. TA (TB) = 1: A
// (B) is MN-major in shared memory.
template <int N, int TA, int TB> struct Wgmma;
template <int TA, int TB> struct Wgmma<16, TA, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<64, TA, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<128, TA, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<136, TA, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67}, "
        "%68, %69, p, 1, 1, %71, %72;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB> struct Wgmma<192, TA, TB> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, %99, %100;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// Stages of the weight grad's ring: 3 at 128 rows (two blocks of 73-97 KB
// an SM; one of 121 KB at 192 columns), 4 at 256 rows (one block of 161-193
// KB).
__host__ __device__ constexpr int wgrad_stages(int mt) { return mt == 1 ? 3 : 4; }

// Bytes of dynamic shared memory of the ring: stages x (A + B tiles of 64
// K values, 128-byte rows).
template <int BM, int BN, int STAGES>
constexpr int ring_bytes() {
  return STAGES * (BM + BN) * kBK * 2 + 1024;  // + the slack to a 1024-byte boundary
}

struct ConvArgs {
  const bf16* x;       // (N*H*W, cip) input, channels zero-padded to cip
  const bf16* w;       // (n_tiles*BN, k_pad) K-major, K in chunk_tap's order
  const float* bias;   // forward: (bias_cols,), or null
  const bf16* act;     // data grad: previous layer's output, (N*H*W, act_ld), whose
                       // ReLU gates the result; null for no gate
  float* db;           // data grad: += column sums of the result, or null
  bf16* y;             // (N*H*W, y_ld) output; columns < y_cols written
  int n, h, wd, cip, k_pad;
  int bias_cols, relu, act_ld, db_cols, y_ld, y_cols;
};

// One block: BM = 64*WGS output pixels x BN output channels, WGS
// warpgroups, each the wgmma of its 64 pixels against the block's BN.
template <int BN, int WGS>
__global__ void __launch_bounds__(WGS * 128, 2) conv3x3(const ConvArgs a) {
  constexpr int BM = WGS * 64;
  constexpr int kThreads = WGS * 128;
  constexpr int kStages = WGS == 1 ? 4 : 3;
  constexpr int kABytes = BM * kBK * 2;
  constexpr int kStageBytes = kABytes + BN * kBK * 2;
  constexpr int kAPer = BM * 8 / kThreads;  // A chunks a thread copies per stage: 4
  constexpr int kBPer = (BN * 8 + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float colsum[BN];

  const int tid = threadIdx.x;
  const int hw = a.h * a.wd;
  const int m_total = a.n * hw;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int steps = a.k_pad / kBK;
  const int cpt = a.cip >> 3;  // chunks per tap
  const uint32_t sbase = (smem_addr(smem) + 1023) & ~1023u;

  // Copy e of a stage: row (e>>3), chunk e&7, so 8 neighbouring threads
  // move the 128 contiguous bytes of one row. A thread keeps its chunk
  // (hence its tap and channel, the same for all its rows) over the rows
  // it copies.
  const int q = tid & 7;
  int a_img[kAPer], a_y[kAPer], a_x[kAPer];
#pragma unroll
  for (int i = 0; i < kAPer; ++i) {
    const int m = m0 + (tid >> 3) + i * (kThreads / 8);
    if (m < m_total) {
      const int img = m / hw;
      const int rem = m - img * hw;
      a_img[i] = img * hw;
      a_y[i] = rem / a.wd;
      a_x[i] = rem - a_y[i] * a.wd;
    } else {
      a_img[i] = -1;
      a_y[i] = a_x[i] = 0;
    }
  }

  auto load = [&](int stage, int s) {
    const uint32_t sa = sbase + stage * kStageBytes;
    const uint32_t sb = sa + kABytes;
    int tap, c;
    chunk_tap(s * 8 + q, cpt, tap, c);
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int r = (tid >> 3) + i * (kThreads / 8);
      const int yy = a_y[i] + dy;
      const int xx = a_x[i] + dx;
      const bool ok = a_img[i] >= 0 && tap < 9 && (unsigned)yy < (unsigned)a.h &&
                      (unsigned)xx < (unsigned)a.wd;
      const bf16* src = ok ? a.x + ((long long)(a_img[i] + yy * a.wd + xx) * a.cip + c) : a.x;
      copy16<true>(sa + swz(r, q), src, ok);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int r = (tid >> 3) + i * (kThreads / 8);
      if (r < BN)
        copy16(sb + swz(r, q), a.w + (long long)(n0 + r) * a.k_pad + s * kBK + q * 8, true);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int c = tid; c < BN; c += kThreads) colsum[c] = 0.f;
  const int wg = tid >> 7;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    copy_commit();
  }
  for (int s = 0; s < steps; ++s) {
    copy_wait<kStages - 2>();
    proxy_fence();
    __syncthreads();  // stage s has landed; every warpgroup is done with stage s-1
    const uint32_t sa = sbase + (s % kStages) * kStageBytes;
    const uint32_t sb = sa + kABytes;
    acc_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // K-major A and B, one 128-byte row per pixel / output channel: k16
      // step kk starts 32 bytes into the rows, 8-row groups 1024 bytes apart
      const uint64_t da = make_desc(sa + wg * 8192 + kk * 32, 16, 1024);
      const uint64_t db = make_desc(sb + kk * 32, 16, 1024);
      Wgmma<BN, 0, 0>::mma(acc, da, db);
    }
    wg_commit();
    // refill the stage that step s-1 read while this step's wgmma runs
    const int ns = s + kStages - 1;
    if (ns < steps) load(ns % kStages, ns);
    copy_commit();
    wg_wait_all();
    acc_fence(acc);
  }
  copy_wait<0>();

  // Accumulator fragment of m64nN: thread (warp q, lane l) of a warpgroup
  // holds rows 16q + l/4 (+8), columns 8j + 2(l%4) (+1) in acc[4j .. 4j+3].
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row + half * 8;
      float v0 = acc[4 * j + 2 * half];
      float v1 = acc[4 * j + 2 * half + 1];
      if (a.bias) {
        v0 += col < a.bias_cols ? a.bias[col] : 0.f;
        v1 += col + 1 < a.bias_cols ? a.bias[col + 1] : 0.f;
      }
      if (a.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      if (m < m_total && col < a.y_cols) {
        if (a.act) {
          const __nv_bfloat162 g =
              *reinterpret_cast<const __nv_bfloat162*>(a.act + (long long)m * a.act_ld + col);
          if (!(__low2float(g) > 0.f)) v0 = 0.f;
          if (!(__high2float(g) > 0.f)) v1 = 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(a.y + (long long)m * a.y_ld + col) =
            __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
    if (a.db) {
      // sum over the warp's 16 rows: lanes with the same l%4 hold one column pair
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (lane < 4) {
        atomicAdd(&colsum[j * 8 + lane * 2], s0);
        atomicAdd(&colsum[j * 8 + lane * 2 + 1], s1);
      }
    }
  }
  if (a.db) {
    __syncthreads();
    for (int c = tid; c < BN; c += kThreads)
      if (n0 + c < a.db_cols) atomicAdd(a.db + n0 + c, colsum[c]);
  }
}

struct WgradArgs {
  const bf16* x;  // (N*H*W, cip) layer input, channels zero-padded
  const bf16* g;  // (N*H*W, cop) gated cotangent, channels zero-padded
  float* dw;      // (9*ci, co), zeroed by the caller
  int h, wd, m_total, cip, cop, ci, co, chunk;
};

// One block: BM = 128*MT rows of the flat (tap, padded channel) order of
// dW (two warpgroups of MT x 64) x BN output channels (64, 128 or 192),
// over one slice of `chunk` pixels. K = pixels, 64 a stage. Both tiles stay
// [pixel][channel] and feed wgmma MN-major: 128-byte-swizzled atoms of 64
// pixels x 64 channels (8 KB), atom by atom along the channels. MT = 2
// halves the cotangent's traffic per product, at one block per SM.
template <int BN, int MT>
__global__ void __launch_bounds__(256, BN > 128 || MT > 1 ? 1 : 2) wgrad(const WgradArgs a) {
  constexpr int kThreads = 256;
  constexpr int BM = 128 * MT;
  constexpr int kStages = wgrad_stages(MT);
  constexpr int kJB = BN / 8;
  constexpr int kABytes = kBK * BM * 2;
  constexpr int kStageBytes = kABytes + kBK * BN * 2;
  constexpr int kBPer = (kBK * kJB + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * a.chunk;
  const int p_end = min(p_begin + a.chunk, a.m_total);
  const int steps = (p_end - p_begin + kBK - 1) / kBK;
  const int rows = 9 * a.cip;
  const uint32_t sbase = (smem_addr(smem) + 1023) & ~1023u;

  // A copies (64 pixels x 2*MT atoms x 8 chunks): a thread moves chunk
  // tid&7 of every atom of pixels (tid>>3) and (tid>>3) + 32, so 8
  // neighbouring threads move 128 contiguous bytes of one pixel into one
  // swizzled row. Its row chunks' taps and channel offsets are fixed for
  // the block.
  constexpr int kAtoms = 2 * MT;
  const int q = tid & 7;
  int a_dy[kAtoms], a_dx[kAtoms], a_src[kAtoms];
#pragma unroll
  for (int h = 0; h < kAtoms; ++h) {
    const int r = row0 + (h * 8 + q) * 8;
    const int tap = r / a.cip;
    a_dy[h] = tap / 3 - 1;
    a_dx[h] = tap % 3 - 1;
    a_src[h] = (a_dy[h] * a.wd + a_dx[h]) * a.cip + (r - tap * a.cip);
    if (r >= rows) a_dy[h] = a.h;  // rows past 9*cip: never inside the image
  }

  auto load = [&](int stage, int s) {
    const uint32_t sa = sbase + stage * kStageBytes;
    const uint32_t sb = sa + kABytes;
    const int p0 = p_begin + s * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = (tid >> 3) + 32 * i;
      const int p = p0 + pr;
      const int px = p % a.wd;
      const int py = (p / a.wd) % a.h;
#pragma unroll
      for (int h = 0; h < kAtoms; ++h) {
        const bool ok = p < p_end && (unsigned)(py + a_dy[h]) < (unsigned)a.h &&
                        (unsigned)(px + a_dx[h]) < (unsigned)a.wd;
        copy16(sa + h * 8192 + swz(pr, q), ok ? a.x + ((long long)p * a.cip + a_src[h]) : a.x, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kBK * kJB) {
        const int pr = e / kJB;
        const int jn = e - pr * kJB;
        const int p = p0 + pr;
        const int c = n0 + jn * 8;
        const bool ok = p < p_end && c < a.cop;
        copy16(sb + (jn >> 3) * 8192 + swz(pr, jn & 7), ok ? a.g + ((long long)p * a.cop + c) : a.g, ok);
      }
    }
  };

  float acc[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.f;
  const int wg = tid >> 7;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    copy_commit();
  }
  for (int s = 0; s < steps; ++s) {
    copy_wait<kStages - 2>();
    proxy_fence();
    __syncthreads();
    const uint32_t sa = sbase + (s % kStages) * kStageBytes;
    const uint32_t sb = sa + kABytes;
#pragma unroll
    for (int t = 0; t < MT; ++t) acc_fence(acc[t]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // MN-major, 128-byte swizzle: k16 step kk starts 16 pixel rows (2048
      // bytes) in; the leading byte offset steps from one 64-channel atom
      // to the next (8192), the stride byte offset from 8 pixels to the
      // next 8 (1024). Warpgroup wg's rows are atoms wg*MT .. of the A tile.
      const uint64_t db = make_desc(sb + kk * 2048, 8192, 1024);
#pragma unroll
      for (int t = 0; t < MT; ++t)
        Wgmma<BN, 1, 1>::mma(acc[t], make_desc(sa + (wg * MT + t) * 8192 + kk * 2048, 8192, 1024), db);
    }
    wg_commit();
    const int ns = s + kStages - 1;
    if (ns < steps) load(ns % kStages, ns);
    copy_commit();
    wg_wait_all();
#pragma unroll
    for (int t = 0; t < MT; ++t) acc_fence(acc[t]);
  }
  copy_wait<0>();

  const int lane = tid & 31;
  const int rbase = row0 + wg * 64 * MT + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int th = 0; th < 2 * MT; ++th) {
    const int half = th & 1;
    const int r = rbase + (th >> 1) * 64 + half * 8;
    const int tap = r / a.cip;
    const int c = r - tap * a.cip;
    if (r >= rows || c >= a.ci) continue;
    float* out = a.dw + (long long)(tap * a.ci + c) * a.co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + (lane & 3) * 2;
      if (col < a.co) atomicAdd(out + col, acc[th >> 1][4 * j + 2 * half]);
      if (col + 1 < a.co) atomicAdd(out + col + 1, acc[th >> 1][4 * j + 2 * half + 1]);
    }
  }
}

template <typename K>
int prepare(K kernel, int smem_bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int BN, int WGS>
int launch_conv(const ConvArgs& a, int n_tiles, cudaStream_t stream) {
  constexpr int BM = WGS * 64;
  constexpr int kSmem = ring_bytes<BM, BN, WGS == 1 ? 4 : 3>();
  static const int attr = prepare(conv3x3<BN, WGS>, kSmem);
  if (attr) return attr;
  const long long m = (long long)a.n * a.h * a.wd;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)n_tiles);
  conv3x3<BN, WGS><<<grid, WGS * 128, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, int MT>
int launch_wgrad(const WgradArgs& a, int n_tiles, int splits, cudaStream_t stream) {
  constexpr int BM = 128 * MT;
  constexpr int kSmem = ring_bytes<BM, BN, wgrad_stages(MT)>();  // BN: whole atoms
  static const int attr = prepare(wgrad<BN, MT>, kSmem);
  if (attr) return attr;
  const dim3 grid((unsigned)((9 * a.cip + BM - 1) / BM), (unsigned)n_tiles, (unsigned)splits);
  wgrad<BN, MT><<<grid, 256, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------- backward
//
// Gate and bias grad of one layer: gq = g * (a > 0) (no gate without ReLU)
// in the compute dtype, db = column sums of the gated g in f32. g is f32
// (the f32 path's cotangent between layers) or in the compute dtype (the
// chain's incoming cotangent). gq has gq_ld >= c columns: the added ones
// get zeros. The bf16 path runs it once a chain, on the incoming
// cotangent; the f32 path once a layer.

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

template <typename GIn, typename T>
__global__ void __launch_bounds__(256)
gate_bias_grad(const GIn* __restrict__ g, int g_ld,  // (M, g_ld) cotangent
               const T* __restrict__ a, int a_ld,    // (M, a_ld) layer output
               int relu,
               T* __restrict__ gq, int gq_ld,        // (M, gq_ld) gated, compute dtype
               float* __restrict__ db,               // (C,) zeroed by the caller
               long long m, int c) {
  const int col = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (col < gq_ld) {
    for (long long r = (long long)blockIdx.y * 8 + threadIdx.y; r < m; r += (long long)gridDim.y * 8) {
      float v = 0.f;
      if (col < c) {
        v = to_f(g[r * g_ld + col]);
        if (relu && !(to_f(a[r * a_ld + col]) > 0.f)) v = 0.f;
      }
      store_out(gq + r * gq_ld + col, v);
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
}  // namespace

// Each entry returns the cudaError_t of its launch (0 on success), or -1
// for arguments it does not take.

// f32: y (N,H,W,Co) = conv3x3(x (N,H,W,Ci), w (9*Ci, Co)) + bias, ReLU if relu.
extern "C" int aig_conv3x3_f32(const float* x, const float* w, const float* bias, float* y, int n,
                               int h, int wd, int ci, int co, int relu, cudaStream_t stream) {
  using namespace fma_path;
  const long long m_total = (long long)n * h * wd;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  conv3x3_f32<<<grid, kThreads, 0, stream>>>(x, w, bias, y, n, h, wd, ci, co, relu);
  return (int)cudaGetLastError();
}

// bf16 implicit GEMM, the forward of one conv or the data grad of one layer
// (see sm90::ConvArgs): x (N*H*W, cip), w packed (n_tiles*bn, k_pad)
// K-major, y (N*H*W, y_ld). Forward: bias (bias_cols,) and relu. Data
// grad: bias null, relu 0; act (N*H*W, act_ld) gates unless null; db
// (db_cols,) takes the column sums unless null. bm (64, 128) and bn (16,
// 64, 128, 136) pick the tile.
extern "C" int aig_conv3x3_bf16(const void* x, const void* w, const float* bias, int relu,
                                const void* act, int act_ld, float* db, int db_cols, void* y,
                                int y_ld, int y_cols, int n, int h, int wd, int cip, int k_pad,
                                int bias_cols, int bm, int bn, int n_tiles, cudaStream_t stream) {
  using namespace sm90;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 && cip % 8 == 0 && k_pad % kBK == 0 &&
                       k_pad >= 9 * cip && y_ld % 2 == 0 && y_cols % 2 == 0 && y_cols <= y_ld &&
                       (act == nullptr || act_ld % 2 == 0);
  if (!aligned || n_tiles < 1 || (long long)n * h * wd >= (1LL << 31)) return -1;
  ConvArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<const bf16*>(act),
             db, static_cast<bf16*>(y), n, h, wd, cip, k_pad, bias_cols, relu, act_ld, db_cols, y_ld,
             y_cols};
  if (bm == 64) {
    switch (bn) {
      case 16: return launch_conv<16, 1>(a, n_tiles, stream);
      case 64: return launch_conv<64, 1>(a, n_tiles, stream);
      case 128: return launch_conv<128, 1>(a, n_tiles, stream);
      case 136: return launch_conv<136, 1>(a, n_tiles, stream);
    }
  } else if (bm == 128) {
    switch (bn) {
      case 16: return launch_conv<16, 2>(a, n_tiles, stream);
      case 64: return launch_conv<64, 2>(a, n_tiles, stream);
      case 128: return launch_conv<128, 2>(a, n_tiles, stream);
      case 136: return launch_conv<136, 2>(a, n_tiles, stream);
    }
  }
  return -1;
}

// f32 data grad of one layer: dx (N,H,W,Ci) = conv3x3(gq (N,H,W,Co), wt
// (9*Co, Ci)), no bias.
extern "C" int aig_conv3x3_data_grad_f32(const float* gq, const float* wt, float* dx, int n, int h,
                                         int wd, int co, int ci, cudaStream_t stream) {
  return aig_conv3x3_f32(gq, wt, nullptr, dx, n, h, wd, co, ci, 0, stream);
}

// Gate and bias grad over (m, c), see gate_bias_grad: g is f32 when g_f32,
// else in the compute dtype; a and gq in the compute dtype; db f32, zeroed.
extern "C" int aig_conv3x3_gate(const void* g, int g_f32, int g_ld, const void* a, int a_ld, int relu,
                                void* gq, int gq_ld, float* db, long long m, int c, int dtype,
                                cudaStream_t stream) {
  if (gq_ld < c) return -1;
  const dim3 block(32, 8);
  const dim3 grid((unsigned)((gq_ld + 31) / 32), (unsigned)std::min<long long>((m + 63) / 64, 1024));
  if (dtype == 0) {
    gate_bias_grad<float, float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(g), g_ld, static_cast<const float*>(a), a_ld, relu,
        static_cast<float*>(gq), gq_ld, db, m, c);
  } else if (dtype == 1) {
    const auto* ab = static_cast<const __nv_bfloat16*>(a);
    auto* gqb = static_cast<__nv_bfloat16*>(gq);
    if (g_f32)
      gate_bias_grad<float, __nv_bfloat16><<<grid, block, 0, stream>>>(
          static_cast<const float*>(g), g_ld, ab, a_ld, relu, gqb, gq_ld, db, m, c);
    else
      gate_bias_grad<__nv_bfloat16, __nv_bfloat16><<<grid, block, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(g), g_ld, ab, a_ld, relu, gqb, gq_ld, db, m, c);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// f32 weight grad of one layer: dw (9*Ci, Co), zeroed, += the products of x
// (N,H,W,Ci) and gq (N,H,W,Co) over `splits` slices of the pixels.
extern "C" int aig_conv3x3_weight_grad_f32(const float* x, const float* gq, float* dw, int n, int h,
                                           int wd, int ci, int co, int splits, cudaStream_t stream) {
  using namespace wgrad_fma;
  const long long m_total = (long long)n * h * wd;
  if (m_total >= (1LL << 31) || splits < 1) return -1;
  const int m = (int)m_total;
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + 31) / 32 * 32;  // whole 32-pixel steps
  const unsigned gz = (unsigned)((m + chunk - 1) / chunk);
  const dim3 grid((unsigned)(9 * ((ci + BM - 1) / BM)), (unsigned)((co + BN - 1) / BN), gz);
  wgrad_f32<<<grid, kThreads, 0, stream>>>(x, gq, dw, h, wd, ci, co, m, chunk);
  return (int)cudaGetLastError();
}

// bf16 weight grad of one layer: dw (9*ci, co) f32, zeroed, += the products
// of x (N*H*W, cip) and gq (N*H*W, cop), channels zero-padded, over
// `splits` slices of the pixels; bm rows and bn x n_tiles columns a block,
// (bm, bn) one of (256, 64), (256, 128), (128, 192).
extern "C" int aig_conv3x3_weight_grad_bf16(const void* x, const void* gq, float* dw, int n, int h,
                                            int wd, int cip, int cop, int ci, int co, int bm, int bn,
                                            int n_tiles, int splits, cudaStream_t stream) {
  using namespace sm90;
  const long long m_total = (long long)n * h * wd;
  if (m_total >= (1LL << 31) || splits < 1 || n_tiles < 1 || cip % 8 || cop % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(gq) % 16)
    return -1;
  const int m = (int)m_total;
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + kBK - 1) / kBK * kBK;  // whole stages
  WgradArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(gq), dw, h, wd, m, cip, cop, ci, co,
              chunk};
  splits = (m + chunk - 1) / chunk;
  switch (bn) {
    case 64: return bm == 256 ? launch_wgrad<64, 2>(a, n_tiles, splits, stream) : -1;
    case 128: return bm == 256 ? launch_wgrad<128, 2>(a, n_tiles, splits, stream) : -1;
    case 192: return bm == 128 ? launch_wgrad<192, 1>(a, n_tiles, splits, stream) : -1;
  }
  return -1;
}
