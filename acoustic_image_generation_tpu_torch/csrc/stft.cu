// STFT magnitude of one-second audio windows for sm_90a, as FFTs in shared
// memory.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_stft.py::stft_pallas
// (its _kernel). For every second of 12288 samples: 99 frames of 246
// samples at hop 122 (neighbours overlap by 124), each multiplied by the
// periodic Hann window, zero-padded to 512, through the 512-point real FFT,
// then |re + i im| for bins 0..256.
//
// Algorithm: the real FFT is a 256-point complex FFT over the (even, odd)
// sample pairs (points 123..255 are the zero padding), Stockham passes of
// radix 8, 8 and 4 in shared memory, then the real-split step (dsp/fft.py
// states the schedule and builds the tables: twiddles, split constants).
//
// Precision: the arithmetic is float64 on the FP64 units with float64
// tables; the magnitude is rounded once to float32. The plain version is
// two float32 products against float32 bases, so the two are no longer
// bit-equal: they differ by the plain version's own rounding (about 6e-7
// of the peak magnitude on int16-range audio).
//
// Bound on an H100: by bytes, narrowly. Each second reads 48 KB and writes
// 102 KB (0.045 us at 3.35 TB/s); its FFTs are about 1.5 MFLOP (0.044 us at
// FP64's 34 TFLOP/s). The kernel is short, so its time is latency.
//
// Design: one block per (second, group of 9 frames), 11 groups a second,
// so 8 seconds run 88 blocks. The group's span of samples (at most 1224
// floats) is copied into shared memory with 16-byte cp.async, once; the
// overlapping frames are read from there, never materialized. One warp per
// frame, so the passes synchronize the warp only: each lane owns one
// radix-8 butterfly in passes 1-2 and two radix-4 butterflies in pass 3,
// reads its points, __syncwarp, writes them in place. The first pass reads
// the windowed samples straight from the span (a lane's window values sit
// in registers for every frame). The buffer is padded by one point in 8
// (pad()), which keeps the strided writes of passes 1-2 free of bank
// conflicts. Each warp writes its frame's 257 magnitudes as one coalesced
// row.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "fft.cuh"

namespace {

using namespace aig_fft;
using cp_async::copy16;
using cp_async::copy_commit;
using cp_async::copy_wait;
using cp_async::smem_addr;

constexpr int kSamples = 12288;    // one second
constexpr int kFrameLength = 246;
constexpr int kFrameStep = 122;
constexpr int kFrames = 99;
constexpr int kPoints = 256;       // complex FFT points
constexpr int kBins = kPoints + 1;
constexpr int kPairs = kFrameLength / 2;  // nonzero complex points
constexpr int kGroup = 9;          // frames a block, one warp each
constexpr int kGroups = kFrames / kGroup;
constexpr int kThreads = 32 * kGroup;
// the group's samples from the 16-byte boundary at or below its first
// frame's first sample (at most 2 samples before it), in whole float4s
constexpr int kSpan = ((kGroup - 1) * kFrameStep + kFrameLength + 2 + 3) / 4 * 4;

static_assert(kGroups * kGroup == kFrames, "groups cover the frames");
static_assert(kFrameLength % 2 == 0 && kFrameStep % 2 == 0, "frames start on a complex point");
static_assert(kPoints == 8 * 8 * 4 && kPoints / 8 == 32, "passes of radix 8, 8 and 4");
static_assert((kFrames - kGroup) * kFrameStep / 4 * 4 + kSpan <= kSamples, "the last span stays in the second");

__global__ void __launch_bounds__(kThreads)
stft_kernel(const float* __restrict__ x,          // (n, 12288)
            const double2* __restrict__ tw,       // (256,) exp(-2 pi i m / 256)
            const double2* __restrict__ split_a,  // (257,) real-split constants
            const double2* __restrict__ split_b,  // (257,)
            const double* __restrict__ window,    // (246,) periodic Hann
            float* __restrict__ out) {            // (n, 99, 257)
  __shared__ __align__(16) float xs[kSpan];
  __shared__ double2 bufs[kGroup][kPoints + kPoints / 8];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long sec = blockIdx.x;
  const int f0 = blockIdx.y * kGroup;
  const int s0 = (f0 * kFrameStep) & ~3;

  const float* xsec = x + sec * kSamples + s0;
  for (int i = threadIdx.x; i < kSpan / 4; i += kThreads) copy16(smem_addr(xs + 4 * i), xsec + 4 * i, true);
  copy_commit();

  // while the span arrives: the lane's window values (points lane + 32r,
  // r < 4) and its twiddles (pass 2: points 1..7 of butterfly lane; pass 3:
  // points 1..3 of butterflies lane and lane + 32)
  double2 win[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = lane + 32 * r;
    win[r] = m < kPairs ? __ldg(reinterpret_cast<const double2*>(window) + m) : make_double2(0.0, 0.0);
  }
  double2 w2[7], w3[2][3];
#pragma unroll
  for (int r = 1; r < 8; ++r) w2[r - 1] = __ldg(tw + r * (lane % 8) * (kPoints / 64));
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int r = 1; r < 4; ++r) w3[b][r - 1] = __ldg(tw + r * (lane + 32 * b));

  copy_wait<0>();
  __syncthreads();

  double2* buf = bufs[warp];
  const int f = f0 + warp;
  const float* frame = xs + f * kFrameStep - s0;

  // pass 1 (ns = 1): butterfly lane from the windowed points lane + 32r;
  // points 128..255 are zero padding, and so are 123..127
  {
    double2 v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = lane + 32 * r;
      const float2 s = m < kPairs ? *reinterpret_cast<const float2*>(frame + 2 * m) : make_float2(0.f, 0.f);
      v[r] = make_double2((double)s.x * win[r].x, (double)s.y * win[r].y);
    }
#pragma unroll
    for (int r = 4; r < 8; ++r) v[r] = make_double2(0.0, 0.0);
    dft8(v);
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[pad(8 * lane + r)] = v[r];
    __syncwarp();
  }
  // pass 2 (ns = 8): butterfly lane, k = lane mod 8
  {
    double2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = buf[pad(lane + 32 * r)];
    __syncwarp();
#pragma unroll
    for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], w2[r - 1]);
    dft8(v);
    const int base = (lane / 8) * 64 + lane % 8;
#pragma unroll
    for (int r = 0; r < 8; ++r) buf[pad(base + 8 * r)] = v[r];
    __syncwarp();
  }
  // pass 3 (ns = 64, radix 4): butterflies lane and lane + 32, k = j
  {
    double2 v[2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[b][r] = buf[pad(lane + 32 * b + 64 * r)];
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int r = 1; r < 4; ++r) v[b][r] = cmul(v[b][r], w3[b][r - 1]);
      dft4(v[b][0], v[b][1], v[b][2], v[b][3]);
#pragma unroll
      for (int r = 0; r < 4; ++r) buf[pad(lane + 32 * b + 64 * r)] = v[b][r];
    }
    __syncwarp();
  }

  // real split and magnitude of bins lane + 32q, 0 <= q <= 8
  float* o = out + (sec * kFrames + f) * kBins;
#pragma unroll
  for (int q = 0; q < (kBins + 31) / 32; ++q) {
    const int k = lane + 32 * q;
    if (k < kBins) {
      const double2 z = buf[pad(k & (kPoints - 1))];
      const double2 zm = buf[pad((kPoints - k) & (kPoints - 1))];
      const double2 X = cadd(cmul(z, __ldg(split_a + k)), cmul(make_double2(zm.x, -zm.y), __ldg(split_b + k)));
      o[k] = __double2float_rn(sqrt(X.x * X.x + X.y * X.y));
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n > 0 seconds; x
// 16-byte aligned (it is copied with 16-byte cp.async). Static shared
// memory only (46.4 KB), so no function attribute is set.
extern "C" int aig_stft(const float* x, int n, const double* tw, const double* split_a,
                        const double* split_b, const double* window, float* out,
                        cudaStream_t stream) {
  const dim3 grid(n, kGroups);
  stft_kernel<<<grid, kThreads, 0, stream>>>(
      x, reinterpret_cast<const double2*>(tw), reinterpret_cast<const double2*>(split_a),
      reinterpret_cast<const double2*>(split_b), window, out);
  return (int)cudaGetLastError();
}
