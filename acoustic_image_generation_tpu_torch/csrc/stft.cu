// STFT magnitude of one-second audio windows for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_stft.py::stft_pallas
// (its _kernel). For every second of 12288 samples: 99 frames of 246
// samples at hop 122 (neighbours overlap by 124), each multiplied against
// the (246, 257) cos and -sin bases of the 512-point rDFT with the periodic
// Hann window folded in, then |re + i im|.
//
// Precision: every product and sum is an IEEE f32 FMA on the CUDA cores,
// summed over the frame's samples in order. The audio is int16-range and
// the DFT sums cancel heavily, so the tensor cores' TF32 or bf16 paths
// would put errors of about 1e-3 of the peak magnitude into the output.
//
// Bound on an H100: 99 x 246 x 257 x 2 FMAs per second (25.0 MFLOP); the
// input is 48 KB and the output 102 KB per second, so at 67 TFLOP/s of f32
// outside the tensor cores the card is bound by operations (0.37 us a
// second) before bytes (0.045 us).
//
// Design: one block per (second, tile of 64 bins); 257 bins make five
// tiles, the last holding only the Nyquist bin (masked). The second's 12288
// samples are copied into shared memory once (cp.async, 16 bytes a thread)
// and the 99 overlapping frames are read from there, never materialized.
// The bases, zero-padded by the wrapper to (256, 320) so that every copy is
// a whole 16-byte chunk, stream through two shared-memory stages of kRows
// rows with cp.async: the next rows are in flight while the threads
// multiply the current ones. Thread t owns bin t % 64 of the tile and the
// frames (t / 64) + 4 i, i < 25: a warp shares its frames, so each sample
// read is a broadcast, and its 32 bins are 32 consecutive basis words.
// Per sample row: two basis loads, 25 broadcast sample loads, 50 FMAs. The
// frame past the 99th (thread group 3's 25th) reads the zeroed tail of the
// sample buffer and is never written.
// Known limit: 5 blocks a second, so a request of 8 seconds runs 40 blocks
// on 132 SMs; the shared-memory loads match the FMAs nearly one for two.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSamples = 12288;    // one second
constexpr int kFrameLength = 246;
constexpr int kFrameStep = 122;
constexpr int kFrames = 99;
constexpr int kBins = 257;
constexpr int kPadRows = 256;      // basis rows, zero-padded from 246
constexpr int kPadBins = 320;      // basis columns, zero-padded from 257
constexpr int kTileBins = 64;
constexpr int kTiles = kPadBins / kTileBins;  // 5
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kTileBins;  // 4 frame groups
constexpr int kPerThread = (kFrames + kGroups - 1) / kGroups;  // 25 frames a thread
constexpr int kRows = 16;          // basis rows per pipeline stage
constexpr int kChunks = kPadRows / kRows;

// the furthest sample any thread reads, rounded up to whole float4s
constexpr int kXsFloats = ((kGroups * kPerThread - 1) * kFrameStep + kFrameLength + 3) / 4 * 4;
constexpr int kStageFloats = kRows * 2 * kTileBins;  // cos rows then sin rows
constexpr size_t kSmemBytes = (kXsFloats + 2 * kStageFloats) * sizeof(float);  // 65,680

static_assert(kTiles * kTileBins >= kBins, "tiles cover the bins");
static_assert(kGroups * kPerThread >= kFrames, "threads cover the frames");
static_assert(kChunks * kRows >= kFrameLength, "stages cover the frame");
static_assert(kSamples % 4 == 0 && kXsFloats >= kSamples, "sample buffer");

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
stft_kernel(const float* __restrict__ x,      // (n, 12288)
            const float* __restrict__ cos_b,  // (256, 320), zero-padded
            const float* __restrict__ sin_b,  // (256, 320), zero-padded
            float* __restrict__ out) {         // (n, 99, 257)
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // the second's samples, then zeros
  float* stages = smem + kXsFloats;          // 2 x (cos[kRows][64], sin[kRows][64])

  const int t = threadIdx.x;
  const long long sec = blockIdx.x;
  const int b0 = blockIdx.y * kTileBins;

  // Rows [r0, r0 + kRows) of the tile's columns of both bases into stage s.
  auto issue = [&](int r0, int s) {
    float* dst = stages + s * kStageFloats;
    for (int i = t; i < kStageFloats / 4; i += kThreads) {
      const int e = i * 4;                       // float index inside the stage
      const int half = e / (kRows * kTileBins);  // 0 = cos, 1 = sin
      const int r = (e / kTileBins) % kRows;
      const int col = e % kTileBins;
      const float* src = (half ? sin_b : cos_b) + (size_t)(r0 + r) * kPadBins + b0 + col;
      cp_async16(dst + e, src);
    }
  };

  const float* xsec = x + sec * kSamples;
  for (int i = t; i < kSamples / 4; i += kThreads) cp_async16(xs + 4 * i, xsec + 4 * i);
  for (int i = kSamples + t; i < kXsFloats; i += kThreads) xs[i] = 0.f;
  issue(0, 0);
  cp_async_commit();

  const int bin = t % kTileBins;
  const int g = t / kTileBins;
  float re[kPerThread], im[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) re[i] = im[i] = 0.f;

  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      issue((c + 1) * kRows, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cs = stages + (c & 1) * kStageFloats;
    const float* ss = cs + kRows * kTileBins;
    const int k0 = c * kRows;
    const int rows = min(kRows, kFrameLength - k0);  // the padded rows are skipped
    for (int r = 0; r < rows; ++r) {
      const float cv = cs[r * kTileBins + bin];
      const float sv = ss[r * kTileBins + bin];
      const float* xk = xs + g * kFrameStep + k0 + r;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float xv = xk[i * kGroups * kFrameStep];
        re[i] = fmaf(xv, cv, re[i]);
        im[i] = fmaf(xv, sv, im[i]);
      }
    }
    // The stage read here is refilled by the next step's issue.
    __syncthreads();
  }

  if (b0 + bin < kBins) {
    float* o = out + sec * kFrames * kBins + b0 + bin;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int f = g + i * kGroups;
      if (f < kFrames) o[f * kBins] = sqrtf(__fadd_rn(__fmul_rn(re[i], re[i]), __fmul_rn(im[i], im[i])));
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). n > 0 seconds; x,
// cos_b and sin_b 16-byte aligned (they are copied with 16-byte cp.async).
extern "C" int aig_stft(const float* x, int n, const float* cos_b, const float* sin_b, float* out,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, kTiles);
  stft_kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, cos_b, sin_b, out);
  return (int)cudaGetLastError();
}
