// Fused 12-coefficient MFCC frontend for sm_90a, as an FFT in shared memory.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_mfcc.py::mfcc_pallas
// (its _kernel). One launch computes, for every 1024-sample frame:
//   Tukey window -> 1024-point real FFT (bins 0..511, Nyquist dropped)
//   -> power -> 24 mel bands -> log(max(., 1e-3)) -> DCT+lifter
//   -> non-finite to 0.
//
// Algorithm: the real FFT is a 512-point complex FFT over the (even, odd)
// sample pairs, three radix-8 Stockham passes in shared memory, then the
// real-split step (dsp/fft.py states the schedule and builds the tables:
// twiddles, split constants, mel band spans). Each mel band sums only its
// span of bins (942 nonzeros of the 512 x 24 filterbank), not the full
// matrix.
//
// Precision: the arithmetic is float64 on the FP64 units, from the window
// to the DCT, with float64 tables; the only float32 rounding is the
// output's. An FFT in float32 rounds once per pass, and on a loud tone over
// a quiet floor its error in the low-energy bands, which the log magnifies,
// passes twice that of the float32 DFT product it replaces (cuFFT's float32
// rfft read six times on an H100); in float64 the kernel sits far closer to
// a float64 witness than the plain version does.
//
// Bound on an H100: by bytes. Each frame reads 4 KB and writes 48 bytes;
// the FFT and its tail are about 35 kFLOP a frame (0.8 us of FP64 at 34
// TFLOP/s for 768 frames), under the 0.96 us that 768 frames take to read.
// The kernel is short, so its time is latency: one load of the frame, nine
// barriers, one store.
//
// Design: one block of 64 threads per frame, so that 96 frames spread over
// 96 SMs; blocks on one SM share the tables through L1. Thread t loads
// samples 4i..4i+3 for i = t + 64q with 16-byte loads, windows them and
// stores them as complex pairs. A pass is one radix-8 butterfly a thread:
// read its 8 points, barrier, write its 8 points in place. The buffer is
// padded by one point in 8 (pad()), which makes the 8-point strided writes
// of the first two passes free of bank conflicts. The twiddles of passes 2
// and 3 are loaded into registers before the frame arrives.

#include <cuda_runtime.h>
#include <math.h>

#include "fft.cuh"

namespace {

using namespace aig_fft;

constexpr int kSamples = 1024;
constexpr int kPoints = kSamples / 2;  // complex FFT points
constexpr int kBins = 512;
constexpr int kMel = 24;
constexpr int kMfcc = 12;
constexpr int kThreads = 64;           // one radix-8 butterfly a thread a pass
constexpr double kMelFloor = 1e-3;

static_assert(kPoints == 8 * 8 * 8 && kPoints / 8 == kThreads, "three radix-8 passes");
static_assert(2 * kMel <= kThreads, "two threads a mel band");
static_assert(kBins % kThreads == 0 && kSamples % (4 * kThreads) == 0, "whole loads");

// One radix-8 Stockham pass over kPoints points in buf, butterfly j, the
// twiddles of points 1..7 in w (unused when ns == 1). In place: all reads
// of the pass end at a barrier before any write.
template <int Ns>
__device__ __forceinline__ void pass8(double2* buf, int j, const double2 (&w)[7]) {
  double2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) v[r] = buf[pad(j + r * (kPoints / 8))];
  __syncthreads();
  if (Ns > 1) {
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], w[r - 1]);
  }
  dft8(v);
  const int k = j % Ns;
  const int base = (j / Ns) * Ns * 8 + k;
#pragma unroll
  for (int r = 0; r < 8; ++r) buf[pad(base + r * Ns)] = v[r];
  __syncthreads();
}

// Twiddles of points 1..7 of butterfly j in the pass after ns points.
template <int Ns>
__device__ __forceinline__ void load_twiddles(const double2* __restrict__ tw, int j, double2 (&w)[7]) {
  const int step = (j % Ns) * (kPoints / (Ns * 8));
#pragma unroll
  for (int r = 1; r < 8; ++r) w[r - 1] = __ldg(tw + r * step);
}

__global__ void __launch_bounds__(kThreads)
mfcc_kernel(const float* __restrict__ x,          // (n, 1024)
            const double2* __restrict__ tw,       // (512,) exp(-2 pi i m / 512)
            const double2* __restrict__ split_a,  // (512,) real-split constants
            const double2* __restrict__ split_b,  // (512,)
            const double* __restrict__ window,    // (1024,) Tukey(0.75)
            const int* __restrict__ mel_span,     // (24, 3): first bin, count, offset
            const double* __restrict__ mel_w,     // (942,) the bands' weights
            const double* __restrict__ dct,       // (24, 12) DCT-II * norm * lifter
            float* __restrict__ out) {            // (n, 12)
  __shared__ double2 buf[kPoints + kPoints / 8];
  __shared__ double logmel[kMel];
  double* power = reinterpret_cast<double*>(buf);  // after the FFT: power[bin]

  const int t = threadIdx.x;
  const float4* xf = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * kSamples);

  float4 xv[kSamples / (4 * kThreads)];
#pragma unroll
  for (int q = 0; q < kSamples / (4 * kThreads); ++q) xv[q] = __ldg(xf + t + q * kThreads);
  double2 w2[7], w3[7];
  load_twiddles<8>(tw, t, w2);
  load_twiddles<64>(tw, t, w3);

  // windowed samples 4i..4i+3 as the complex points 2i, 2i + 1
#pragma unroll
  for (int q = 0; q < kSamples / (4 * kThreads); ++q) {
    const int i = t + q * kThreads;
    const double2 wa = __ldg(reinterpret_cast<const double2*>(window) + 2 * i);
    const double2 wb = __ldg(reinterpret_cast<const double2*>(window) + 2 * i + 1);
    buf[pad(2 * i)] = make_double2((double)xv[q].x * wa.x, (double)xv[q].y * wa.y);
    buf[pad(2 * i + 1)] = make_double2((double)xv[q].z * wb.x, (double)xv[q].w * wb.y);
  }
  __syncthreads();

  pass8<1>(buf, t, w2);
  pass8<8>(buf, t, w2);
  pass8<64>(buf, t, w3);

  // real split and power of bins t + 64q; reads end at a barrier before
  // power overwrites the points
  double p[kBins / kThreads];
#pragma unroll
  for (int q = 0; q < kBins / kThreads; ++q) {
    const int k = t + q * kThreads;
    const double2 z = buf[pad(k)];
    const double2 zm = buf[pad((kPoints - k) & (kPoints - 1))];
    const double2 X = cadd(cmul(z, __ldg(split_a + k)), cmul(make_double2(zm.x, -zm.y), __ldg(split_b + k)));
    p[q] = X.x * X.x + X.y * X.y;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kBins / kThreads; ++q) power[t + q * kThreads] = p[q];
  __syncthreads();

  // mel band t / 2, half t % 2 of its span; the pair adds by shuffle
  {
    const int band = min(t >> 1, kMel - 1);
    const int first = __ldg(mel_span + 3 * band), count = __ldg(mel_span + 3 * band + 1);
    const int offset = __ldg(mel_span + 3 * band + 2);
    const int half = (count + 1) >> 1;
    const int lo = (t & 1) ? half : 0, hi = (t & 1) ? count : half;
    double acc = 0.0;
    if (t < 2 * kMel) {
      for (int i = lo; i < hi; ++i) acc = fma(power[first + i], __ldg(mel_w + offset + i), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (t < 2 * kMel && !(t & 1)) {
      // max() that keeps a NaN, as jnp.maximum does
      logmel[band] = log(isnan(acc) ? acc : fmax(acc, kMelFloor));
    }
  }
  __syncthreads();

  if (t < kMfcc) {
    double acc = 0.0;
#pragma unroll
    for (int m = 0; m < kMel; ++m) acc = fma(logmel[m], __ldg(dct + m * kMfcc + t), acc);
    const float c = __double2float_rn(acc);
    out[(size_t)blockIdx.x * kMfcc + t] = isfinite(c) ? c : 0.f;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n > 0 frames; x
// 16-byte aligned (it is read with 16-byte loads). Static shared memory
// only (9.4 KB), so no function attribute is set.
extern "C" int aig_mfcc(const float* x, int n, const double* tw, const double* split_a,
                        const double* split_b, const double* window, const int* mel_span,
                        const double* mel_w, const double* dct, float* out, cudaStream_t stream) {
  mfcc_kernel<<<n, kThreads, 0, stream>>>(
      x, reinterpret_cast<const double2*>(tw), reinterpret_cast<const double2*>(split_a),
      reinterpret_cast<const double2*>(split_b), window, mel_span, mel_w, dct, out);
  return (int)cudaGetLastError();
}
