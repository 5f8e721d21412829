// Fused 12-coefficient MFCC frontend for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_mfcc.py::mfcc_pallas
// (its _kernel). One launch computes, for every 1024-sample frame:
//   DFT against cos/sin bases with the Tukey window folded in (512 bins,
//   Nyquist dropped) -> power -> 24-band mel projection -> log(max(., 1e-3))
//   -> DCT+lifter projection -> non-finite to 0.
//
// Precision: every product and sum is an IEEE f32 FMA on the CUDA cores.
// The samples are int16-range and the DFT sums cancel heavily, so the
// tensor cores' TF32 or bf16 paths would put O(1) errors into the MFCCs.
//
// Bound on an H100: the DFT is 2 x 1024 x 512 FMAs per frame (2.1 MFLOP);
// the bases are 4 MB and stay in L2 across blocks. At 67 TFLOP/s of f32
// outside the tensor cores the card is bound by operations, not bytes, for
// any batch above a few frames.
//
// Design: a block owns kTile frames and all 512 bins, so the (kTile, 512)
// power spectrum stays in shared memory and only (kTile, 12) is written.
// Each thread owns bins t and t + 256 (real and imaginary parts) for the
// block's frames. The block's frames sit in shared memory, transposed, for
// the whole DFT; the bases stream through two shared-memory stages of kRows
// sample rows with cp.async, so the next rows are in flight while the
// threads multiply the current ones (per sample: four basis values and
// eight broadcast frame values from shared memory, 32 FMAs). The ragged
// last block is masked: rows past n read as zeros and are never written.
// Known limit: parallelism is n / kTile blocks, so small batches use few
// SMs. Splitting the bins over a cluster would lift that.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSamples = 1024;
constexpr int kBins = 512;
constexpr int kMel = 24;
constexpr int kMfcc = 12;
constexpr int kTile = 8;       // frames per block
constexpr int kThreads = 256;  // bins t and t + kThreads per thread
constexpr int kRows = 16;      // basis rows per pipeline stage
constexpr float kMelFloor = 1e-3f;

constexpr int kStageFloats = kRows * 2 * kBins;      // cos rows then sin rows
constexpr int kXsFloats = kSamples * kTile;          // frames, transposed
constexpr size_t kSmemBytes = (2 * kStageFloats + kXsFloats) * sizeof(float);  // 160 KB

static_assert(2 * kThreads == kBins, "two bins per thread");
static_assert(kTile * kMel <= kThreads, "one mel output per thread");
static_assert(kTile * kBins <= 2 * kStageFloats, "power fits in the stages");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
mfcc_kernel(const float* __restrict__ x, int n,
            const float* __restrict__ cos_b,  // (1024, 512)
            const float* __restrict__ sin_b,  // (1024, 512)
            const float* __restrict__ mel,    // (512, 24)
            const float* __restrict__ dct,    // (24, 12)
            float* __restrict__ out) {         // (n, 12)
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                     // 2 x (cos[kRows][512], sin[kRows][512])
  float* xs = smem + 2 * kStageFloats;      // xs[k * kTile + f]
  __shared__ float logmel[kTile][kMel];

  const int t = threadIdx.x;
  const long long f0 = (long long)blockIdx.x * kTile;
  const int rows = (int)min((long long)kTile, (long long)n - f0);

  // Rows [r0, r0 + kRows) of both bases into stage s: 16 bytes a thread.
  auto issue = [&](int r0, int s) {
    float* dst = stages + s * kStageFloats;
    for (int i = t; i < kStageFloats / 4; i += kThreads) {
      const int e = i * 4;                   // float index inside the stage
      const int half = e / (kRows * kBins);  // 0 = cos, 1 = sin
      const int r = (e / kBins) % kRows;
      const int col = e % kBins;
      const float* src = (half ? sin_b : cos_b) + (size_t)(r0 + r) * kBins + col;
      cp_async16(dst + e, src);
    }
    cp_async_commit();
  };

  issue(0, 0);
  for (int i = t; i < kSamples * kTile; i += kThreads) {
    const int f = i / kSamples;
    const int k = i % kSamples;
    xs[k * kTile + f] = f < rows ? x[(f0 + f) * kSamples + k] : 0.f;
  }

  float re0[kTile], im0[kTile], re1[kTile], im1[kTile];
#pragma unroll
  for (int f = 0; f < kTile; ++f) re0[f] = im0[f] = re1[f] = im1[f] = 0.f;

  constexpr int kChunks = kSamples / kRows;
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      issue((c + 1) * kRows, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cs = stages + (c & 1) * kStageFloats;
    const float* ss = cs + kRows * kBins;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float c0 = cs[r * kBins + t], c1 = cs[r * kBins + t + kThreads];
      const float s0 = ss[r * kBins + t], s1 = ss[r * kBins + t + kThreads];
      const float4 xa = *reinterpret_cast<const float4*>(xs + (c * kRows + r) * kTile);
      const float4 xb = *reinterpret_cast<const float4*>(xs + (c * kRows + r) * kTile + 4);
      const float xv[kTile] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int f = 0; f < kTile; ++f) {
        re0[f] = fmaf(xv[f], c0, re0[f]);
        im0[f] = fmaf(xv[f], s0, im0[f]);
        re1[f] = fmaf(xv[f], c1, re1[f]);
        im1[f] = fmaf(xv[f], s1, im1[f]);
      }
    }
    // The stage read here is refilled by the next step's issue.
    __syncthreads();
  }

  float* power = stages;  // power[f * 512 + bin]; the stages are free now
#pragma unroll
  for (int f = 0; f < kTile; ++f) {
    power[f * kBins + t] = fmaf(re0[f], re0[f], im0[f] * im0[f]);
    power[f * kBins + t + kThreads] = fmaf(re1[f], re1[f], im1[f] * im1[f]);
  }
  __syncthreads();

  if (t < kTile * kMel) {
    const int f = t / kMel;
    const int m = t % kMel;
    float acc = 0.f;
    for (int b = 0; b < kBins; ++b) acc = fmaf(power[f * kBins + b], __ldg(mel + b * kMel + m), acc);
    // max() that keeps a NaN, as jnp.maximum does
    const float v = isnan(acc) ? acc : fmaxf(acc, kMelFloor);
    logmel[f][m] = logf(v);
  }
  __syncthreads();

  if (t < kTile * kMfcc) {
    const int f = t / kMfcc;
    const int j = t % kMfcc;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kMel; ++m) acc = fmaf(logmel[f][m], __ldg(dct + m * kMfcc + j), acc);
    if (f < rows) out[(f0 + f) * kMfcc + j] = isfinite(acc) ? acc : 0.f;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n > 0; cos_b and
// sin_b 16-byte aligned (they are copied with 16-byte cp.async).
extern "C" int aig_mfcc(const float* x, int n, const float* cos_b, const float* sin_b,
                        const float* mel, const float* dct, float* out,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kTile - 1) / kTile;
  mfcc_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(x, n, cos_b, sin_b, mel, dct, out);
  return (int)cudaGetLastError();
}
