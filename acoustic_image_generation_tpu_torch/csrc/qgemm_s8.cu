// Fused int8 1x1 conv (a GEMM) of the quantized trunk, for sm_90a:
//   acc = x (M,K) s8 @ w^T, w stored (N,K) s8, acc exact in s32;
//   y   = f32(acc) * fb[0][n] + fb[1][n]  [+ f32(res) * res_scale]  [ReLU];
//   out = s8(clamp(round_half_even(y), -127, 127)).
// The requant scale 127/out_amax is already folded into fb and res_scale
// by the wrapper (ops/qgemm.py), as the TPU kernel folds it on the host.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_qgemm.py::qgemm_s8
// (_qgemm_kernel): every bottleneck conv1, conv3 and projection shortcut of
// the int8 trunk, 36 launches per trunk forward, with the shortcut add, the
// ReLU and the requantization to the next site fused in, so each
// inter-layer tensor exists in device memory only as int8.
//
// Bound on an H100: a launch moves M*K + N*K + M*N (+ M*N residual) bytes
// and does 2*M*K*N int8 operations; at 3.35 TB/s and 1979 dense int8 TOPS
// the trunk's shapes (K, N in 64..2048) are bound by bytes except the
// widest (K=1024, N=2048), which is bound by operations.
//
// Design. The TPU kernel keeps the whole K x N weight panel in VMEM (up to
// 2 MB) and streams row blocks of x past it. Shared memory here holds
// 227 KB, so the output is tiled in N as well as in M: each block owns a
// 128 x 64 tile of the output and walks all of K in steps of 64 bytes.
// - x and w tiles go to shared memory with 16-byte cp.async, two stages,
//   so the next step's loads are in flight during this step's products;
//   rows past M and columns past K read as zeros (src-size 0).
// - int8 tensor cores through mma.sync.m16n8k32.row.col.s32.s8.s8.s32,
//   fragments loaded with ldmatrix (w is (N,K), K-major: the "col" operand
//   needs no transpose); 8 warps of 32 x 32.
// - The s32 tile goes through shared memory; each thread then takes runs
//   of 16 columns of one row: 16-byte residual loads, the epilogue in f32
//   without contraction (__fmul_rn/__fadd_rn, so it rounds as the plain
//   version's separate torch ops do), __float2int_rn (half to even, as
//   torch.round and jnp.round), clamp, and one 16-byte store.
// - Rows are indexed with 64-bit offsets: M*N reaches 1.6e9 at 768 frames.
// Requires K and N multiples of 16 and 16-byte aligned pointers (checked by
// the wrapper, and again here).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;                 // bytes of K per stage
constexpr int kThreads = 256;
constexpr int LDS = BK + 16;           // shared row stride in bytes: ldmatrix conflict-free
constexpr int kAStage = BM * LDS;
constexpr int kStage = (BM + BN) * LDS;
constexpr int LDC = BN + 4;            // s32 tile row stride in words
constexpr int kCBytes = BM * LDC * 4;
constexpr int kSmem = 2 * kStage > kCBytes ? 2 * kStage : kCBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
qgemm_s8_kernel(const int8_t* __restrict__ x,      // (M, K)
                const int8_t* __restrict__ w,      // (N, K)
                const float* __restrict__ fb,      // (2, N): folded factor, folded bias
                const float* __restrict__ scales,  // [res_scale]
                const int8_t* __restrict__ res,    // (M, N) or null
                int8_t* __restrict__ out,          // (M, N)
                long long m, int k, int n) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  __shared__ float s_factor[BN];
  __shared__ float s_bias[BN];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (tid < BN) {
    const bool ok = n0 + tid < n;
    s_factor[tid] = ok ? fb[n0 + tid] : 0.f;
    s_bias[tid] = ok ? fb[n + n0 + tid] : 0.f;
  }

  auto load = [&](int st, int stage) {
    const int k0 = st * BK;
    unsigned char* As = smem + stage * kStage;
    unsigned char* Bs = As + kAStage;
#pragma unroll
    for (int i = 0; i < BM * BK / 16 / kThreads; ++i) {  // 2 chunks of x
      const int c = tid + i * kThreads;
      const int r = c / (BK / 16);
      const int kc = k0 + (c % (BK / 16)) * 16;
      const bool ok = m0 + r < m && kc < k;
      cp_async16(As + r * LDS + (c % (BK / 16)) * 16, ok ? x + (m0 + r) * k + kc : x, ok);
    }
    {  // 1 chunk of w
      const int r = tid / (BK / 16);
      const int kc = k0 + (tid % (BK / 16)) * 16;
      const bool ok = n0 + r < n && kc < k;
      cp_async16(Bs + r * LDS + (tid % (BK / 16)) * 16, ok ? w + (long long)(n0 + r) * k + kc : w, ok);
    }
    cp_async_commit();
  };

  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (k + BK - 1) / BK;
  load(0, 0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      load(st + 1, (st + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* As = smem + (st & 1) * kStage;
    const unsigned char* Bs = As + kAStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // rows lane%16, bytes (lane/16)*16 of a 16 x 32 tile
        ldmatrix_x4(a[i], As + (wm + i * 16 + lane % 16) * LDS + kk + (lane / 16) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)  // matrix q = lane/8: columns (q/2)*8 + lane%8, bytes (q%2)*16
        ldmatrix_x4(b[jj], Bs + (wn + jj * 16 + (lane / 16) * 8 + lane % 8) * LDS + kk +
                               ((lane / 8) % 2) * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
    __syncthreads();
  }

  // s32 tile to shared memory (the stages are free: the loop ended on a barrier)
  int* Cs = reinterpret_cast<int*>(smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + i * 16 + g;
      const int c = wn + j * 8 + 2 * t;
      *reinterpret_cast<int2*>(Cs + r * LDC + c) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(Cs + (r + 8) * LDC + c) = make_int2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  const float rs = kRes ? scales[0] : 0.f;
#pragma unroll
  for (int i = 0; i < BM * BN / 16 / kThreads; ++i) {  // 2 runs of 16 columns
    const int e = tid + i * kThreads;
    const int r = e / (BN / 16);
    const int c = (e % (BN / 16)) * 16;
    if (m0 + r >= m || n0 + c >= n) continue;
    const long long off = (m0 + r) * n + n0 + c;
    __align__(16) int8_t rv[16];
    if (kRes) *reinterpret_cast<uint4*>(rv) = *reinterpret_cast<const uint4*>(res + off);
    __align__(16) int8_t q[16];
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      float y = __fadd_rn(__fmul_rn(__int2float_rn(Cs[r * LDC + c + v]), s_factor[c + v]), s_bias[c + v]);
      if (kRes) y = __fadd_rn(y, __fmul_rn((float)rv[v], rs));
      if (kRelu) y = fmaxf(y, 0.f);
      q[v] = (int8_t)max(-127, min(127, __float2int_rn(y)));
    }
    *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(q);
  }
}

}  // namespace

// x (M,K), w (N,K), res and out (M,N) int8; fb (2,N) f32; scales[0] the
// folded residual scale (read only with a residual; res may be null
// otherwise). Returns the cudaError_t of the launch (0 on success), or -1
// for shapes or alignments the kernel does not take.
extern "C" int aig_qgemm_s8(const void* x, const void* w, const float* fb, const float* scales,
                            const void* res, void* out, long long m, int k, int n, int relu,
                            cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || n % 16 != 0) return -1;
  if (misaligned(x) || misaligned(w) || misaligned(out) || (res != nullptr && misaligned(res))) return -1;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* rp = static_cast<const int8_t*>(res);
  auto* o = static_cast<int8_t*>(out);
  if (res != nullptr) {
    if (relu)
      qgemm_s8_kernel<true, true><<<grid, kThreads, 0, stream>>>(xs, ws, fb, scales, rp, o, m, k, n);
    else
      qgemm_s8_kernel<true, false><<<grid, kThreads, 0, stream>>>(xs, ws, fb, scales, rp, o, m, k, n);
  } else {
    if (relu)
      qgemm_s8_kernel<false, true><<<grid, kThreads, 0, stream>>>(xs, ws, fb, scales, rp, o, m, k, n);
    else
      qgemm_s8_kernel<false, false><<<grid, kThreads, 0, stream>>>(xs, ws, fb, scales, rp, o, m, k, n);
  }
  return (int)cudaGetLastError();
}
