// Zero-phase Butterworth low-pass (filtfilt) of audio frames for sm_90a.
//
// No Pallas kernel of the JAX package corresponds to this one: there the
// filter is a lax.scan (acoustic_image_generation_tpu/dsp/iir.py,
// filtfilt_jax and _sosfilt_scan). It feeds the correspondence task's
// "filtered" MFCC branch: every frame of 1024 samples, 768 of them in a
// 64-clip step.
//
// What it computes, per row of T samples: the odd extension by `pad`
// samples on each side (2 x[0] - x[pad..1], x, 2 x[T-1] - x[T-2..T-1-pad]),
// a cascade of kSections biquads in direct form II transposed over it with
// the state zi * ext[0], then the same cascade over the reversed result
// with the state zi * (its last value), reversed back and trimmed to T.
//
// Precision: float32, each multiply, add and subtract rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nvcc may not contract them into FMAs),
// in the order of the plain version (dsp/iir.py: filtfilt), so the two are
// bit-equal.
//
// Bound on an H100: the recurrence. Each time step runs the five sections
// one after another, and each section's output waits on a multiply and an
// add (the state update beside it overlaps): 2 passes x (T + 2 pad) steps
// x 5 sections x 2 dependent operations of about 4 cycles, 87k cycles for
// T = 1024 at one row per thread, about 0.045 ms at 1.98 GHz, whatever the
// number of rows up to one per resident thread. The bytes (each row read
// once, written once: 6.3 MB for 768 rows) take about 2 us.
//
// Design: one thread per row, its sections' state and coefficients in
// registers. The first pass writes the extended row's filtered values to
// the `work` rows (from the wrapper), the second reads them back in
// reverse and writes only the T kept samples. No shared memory, no
// synchronisation. A thread's loads of its own row are strided across the
// warp; the rows are short and stay in L1/L2.

#include <cuda_runtime.h>

namespace {

constexpr int kSections = 5;
constexpr int kThreads = 32;

struct Cascade {
  float b0[kSections], b1[kSections], b2[kSections], a1[kSections], a2[kSections];
  float zi0[kSections], zi1[kSections];
  float z0[kSections], z1[kSections];

  __device__ void load(const float* __restrict__ sos, const float* __restrict__ zi) {
#pragma unroll
    for (int k = 0; k < kSections; ++k) {
      b0[k] = sos[6 * k + 0];
      b1[k] = sos[6 * k + 1];
      b2[k] = sos[6 * k + 2];
      a1[k] = sos[6 * k + 4];
      a2[k] = sos[6 * k + 5];
      zi0[k] = zi[2 * k + 0];
      zi1[k] = zi[2 * k + 1];
    }
  }

  // state <- zi * x0
  __device__ void reset(float x0) {
#pragma unroll
    for (int k = 0; k < kSections; ++k) {
      z0[k] = __fmul_rn(zi0[k], x0);
      z1[k] = __fmul_rn(zi1[k], x0);
    }
  }

  // one time step through every section:
  //   y = b0 x + z0;  z0 = (b1 x + z1) - a1 y;  z1 = b2 x - a2 y
  __device__ float step(float cur) {
#pragma unroll
    for (int k = 0; k < kSections; ++k) {
      const float y = __fadd_rn(__fmul_rn(b0[k], cur), z0[k]);
      z0[k] = __fsub_rn(__fadd_rn(__fmul_rn(b1[k], cur), z1[k]), __fmul_rn(a1[k], y));
      z1[k] = __fsub_rn(__fmul_rn(b2[k], cur), __fmul_rn(a2[k], y));
      cur = y;
    }
    return cur;
  }
};

__global__ void __launch_bounds__(kThreads)
filtfilt_kernel(const float* __restrict__ x, int n, int t_len, int pad,
                const float* __restrict__ sos, const float* __restrict__ zi,
                float* __restrict__ work, float* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const int ext_len = t_len + 2 * pad;
  const float* xr = x + (size_t)row * t_len;
  float* wr = work + (size_t)row * ext_len;
  float* orow = out + (size_t)row * t_len;

  Cascade c;
  c.load(sos, zi);
  const float two_first = __fmul_rn(2.f, xr[0]);
  const float two_last = __fmul_rn(2.f, xr[t_len - 1]);

  // forward pass over the odd extension
  c.reset(__fsub_rn(two_first, xr[pad]));
  for (int t = 0; t < pad; ++t) wr[t] = c.step(__fsub_rn(two_first, xr[pad - t]));
#pragma unroll 4
  for (int t = 0; t < t_len; ++t) wr[pad + t] = c.step(xr[t]);
  for (int t = 0; t < pad; ++t) wr[pad + t_len + t] = c.step(__fsub_rn(two_last, xr[t_len - 2 - t]));

  // backward pass over the reversed result; keep the middle T samples
  c.reset(wr[ext_len - 1]);
  for (int t = ext_len - 1; t >= pad + t_len; --t) c.step(wr[t]);
#pragma unroll 4
  for (int t = t_len - 1; t >= 0; --t) orow[t] = c.step(wr[pad + t]);
}

}  // namespace

// x: (n, t_len) float32 rows; sos: (5, 6) and zi: (5, 2) float32; work:
// (n, t_len + 2 pad) float32 scratch; out: (n, t_len) float32.
extern "C" int aig_filtfilt(const float* x, int n, int t_len, int pad, const float* sos,
                            const float* zi, float* work, float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (t_len <= pad + 1 || pad < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  filtfilt_kernel<<<blocks, kThreads, 0, stream>>>(x, n, t_len, pad, sos, zi, work, out);
  return (int)cudaGetLastError();
}
