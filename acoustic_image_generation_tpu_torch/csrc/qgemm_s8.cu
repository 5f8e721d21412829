// Fused int8 1x1 conv (a GEMM) of the quantized trunk, for sm_90a:
//   acc = x (M,K) s8 @ w^T, w stored (N,K) s8, acc exact in s32;
//   y   = f32(acc) * fb[0][n] + fb[1][n]  [+ f32(res) * res_scale]  [ReLU];
//   out = s8(clamp(round_half_even(y), -127, 127)).
// where fb = (factor, bias) * out_scale, res_scale = (residual_amax / 127)
// * out_scale and out_scale = 127 / max(out_amax, 1e-12): the requant scale
// folded in as the TPU kernel folds it on the host, here by each block
// from the amaxes on the device, each f32 operation rounded once as the
// plain version's torch ops round it (ops/qgemm.py, _folded).
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
// 227 KB, so the output is tiled in N as well as in M, as wide as a wgmma
// allows, and the product runs on Hopper's int8 tensor-core path:
// - wgmma.mma_async m64nNk32 s32.s8.s8 (exact s32 sums), two warpgroups of
//   64 rows, N tile BN = 64, 128 or 256 (ops/gemm_plan.py): x is read once
//   for N <= 256 and ceil(N/256) times above that (the earlier 128 x 64
//   tiles read it N/64 times, 32 times at N = 2048). Both operands are
//   K-major, the only layout wgmma takes for 8-bit types, and exactly how
//   the port stores them (x (M,K), w (N,K)): nothing is repacked.
// - Loads: a ring of 4 (BN = 256), 6 or 8 stages of 128 bytes of K, tiles
//   in the 128-byte swizzle, filled by 16-byte cp.async from every thread
//   (8 neighbouring threads move one row's 128 contiguous bytes); rows past
//   M and columns past K read as zeros (source size 0). The grid is
//   persistent in M: a block owns one column tile and walks every
//   gridDim.x-th row tile, and the ring runs over the flattened (row tile,
//   K step) sequence, so the next tile's loads are in flight during this
//   tile's last products and its epilogue.
// - Weight panel: where the block's whole (BN, K) slice of w fits in 64 KB
//   (K <= 256 at BN = 256: the memory-bound half of the trunk's launches),
//   it is loaded once per block, and each warpgroup runs a ring of its own
//   for its 64 rows of x, synchronised by a named barrier of its 128
//   threads: the two warpgroups drift apart, so one's epilogue overlaps
//   the other's products and loads. Without it, both share each stage's w
//   tile and step together.
// - Epilogue in registers from the s32 fragments, 64 columns at a time,
//   with today's arithmetic: f32 without contraction (__fmul_rn/__fadd_rn,
//   so it rounds as the plain version's separate torch ops do), the
//   residual times res_scale, ReLU, __float2int_rn (half to even, as
//   torch.round and jnp.round), clamp to +-127. The residual is loaded
//   into registers a tile ahead with 16-byte loads; it and the int8 result
//   pass through a per-warp staging buffer of 16 rows, and the result
//   leaves with 16-byte stores.
// - Rows are indexed with 64-bit offsets: M*N reaches 1.6e9 at 768 frames.
// Requires K and N multiples of 16 (whole 16-byte chunks; a K tail inside
// a k32 step is zero-filled) and 16-byte aligned pointers (checked by the
// wrapper, and again here).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using namespace sm90gemm;

constexpr int BM = 128;       // rows of a tile: two wgmma warpgroups of 64
constexpr int kBK = 128;      // bytes (values) of K per ring stage: 4 wgmma k32 steps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageA = BM * kBK;   // 16 KB
constexpr int kPitch = 80;          // staging row pitch in bytes: 64 + 16, conflict-free fragment writes
constexpr int kStageRow = 16 * kPitch;

// Round half to even and saturate at 127 in one instruction: for v >= -127
// (the caller's lower clamp, or the ReLU) it equals clamp(__float2int_rn(v),
// -127, 127), the plain version's torch.round and clamp.
__device__ __forceinline__ int to_s8(float v) {
  int r;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Weight panel: where the block's whole (BN, K) slice of w fits in 64 KB
// (K <= 256 at BN = 256), it is loaded once per block and stays in shared
// memory, and the ring carries x alone, in more stages.
constexpr int kPanelBytes = 64 * 1024;
constexpr int kPanelStages = 8;
__host__ __device__ constexpr bool use_panel(int bn, int k) {
  return (k + kBK - 1) / kBK * bn * kBK <= kPanelBytes;
}
__host__ __device__ constexpr int stages(int bn, bool panel) {
  return panel ? kPanelStages : bn == 256 ? 4 : bn == 128 ? 6 : 8;
}
// Dynamic shared memory of a block: the ring (A tile, and the B tile
// without a panel, per stage), the panel, the warps' staging rows, the
// tile's folded factor and bias, and the slack to a 1024-byte boundary.
// ops/gemm_plan.py computes the same number; the launch checks that they
// agree.
__host__ __device__ constexpr int smem_bytes(int bn, bool panel) {
  return stages(bn, panel) * (kStageA + (panel ? 0 : bn * kBK)) + (panel ? kPanelBytes : 0) +
         kWarps * kStageRow + 2 * bn * 4 + 1024;
}

// A block owns one BN-wide column tile (blockIdx.y) and walks the row tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... . Its ring runs over the
// flattened (row tile, K step) sequence, so the next tile's first stages
// load while this tile's last products and its epilogue run.
template <int BN, bool kPanel, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads, 1)
qgemm_s8_kernel(const int8_t* __restrict__ x,      // (M, K)
                const int8_t* __restrict__ w,      // (N, K)
                const float* __restrict__ factor,  // (N,) dequant factor
                const float* __restrict__ bias,    // (N,) folded BN bias
                const float* __restrict__ out_amax,  // [the output site's amax]
                const float* __restrict__ res_amax,  // [the residual's amax], or null
                const int8_t* __restrict__ res,    // (M, N) or null
                int8_t* __restrict__ out,          // (M, N)
                long long m, int k, int n) {
  constexpr int kStages = stages(BN, kPanel);
  constexpr int kStageBytes = kStageA + (kPanel ? 0 : BN * kBK);
  constexpr int kRingBytes = kStages * kStageBytes + (kPanel ? kPanelBytes : 0);
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = tid >> 7;
  const int n0 = blockIdx.y * BN;
  const long long m_tiles = (m + BM - 1) / BM;
  const int ksteps = (k + kBK - 1) / kBK;
  const long long my_tiles = (m_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = my_tiles * ksteps;
  const uint32_t sbase = (smem_addr(smem) + 1023) & ~1023u;
  unsigned char* gbase = smem + (sbase - smem_addr(smem));
  const uint32_t panel = sbase + kStages * kStageBytes;  // (ksteps, BN rows, 128 bytes), with kPanel
  unsigned char* stage_o = gbase + kRingBytes + warp * kStageRow;
  float* s_fb = reinterpret_cast<float*>(gbase + kRingBytes + kWarps * kStageRow);
  const float out_scale = __fdiv_rn(127.f, fmaxf(*out_amax, 1e-12f));
  for (int i = tid; i < 2 * BN; i += kThreads) {
    const int col = n0 + (i % BN);
    s_fb[i] = col < n ? __fmul_rn(i < BN ? factor[col] : bias[col], out_scale) : 0.f;
  }

  // Copy mapping, both operands K-major: 8 neighbouring threads move the
  // 128 contiguous bytes of K of one row (chunk q = tid & 7). With the
  // panel, each warpgroup has a ring of its own for its 64 rows of x (its
  // threads copy them, and a named barrier of its 128 threads replaces the
  // block's), so one warpgroup's epilogue runs while the other's products
  // do; without it, both share each stage's w tile and step together.
  const int q = tid & 7;
  const uint32_t ring = kPanel ? sbase + wg * kStages * (kStageBytes / 2) : sbase;
  auto stage_a = [&](int stage) {  // this warpgroup's 64 rows of x in a stage
    return kPanel ? ring + stage * (kStageBytes / 2) : sbase + stage * kStageBytes + wg * 8192;
  };
  auto load = [&](long long g) {
    const int stage = (int)(g % kStages);
    const long long tile = blockIdx.x + (g / ksteps) * gridDim.x;
    const int kc = (int)(g % ksteps) * kBK + q * 16;
    const uint32_t sa = kPanel ? stage_a(stage) : sbase + stage * kStageBytes;
    const uint32_t sb = sa + kStageA;
    constexpr int kRows = kPanel ? 64 : BM;       // rows of x this thread's group copies
    constexpr int kCopiers = kPanel ? 128 : 256;  // threads that copy them
    const int ct = kPanel ? (tid & 127) : tid;
#pragma unroll
    for (int i = 0; i < kRows * 8 / kCopiers; ++i) {
      const int r = (ct >> 3) + i * (kCopiers / 8);
      const long long row = tile * BM + (kPanel ? wg * 64 : 0) + r;
      const bool ok = row < m && kc < k;
      copy16(sa + swz(r, q), ok ? x + row * k + kc : x, ok);
    }
    if constexpr (!kPanel) {
#pragma unroll
      for (int i = 0; i < BN * 8 / kThreads; ++i) {
        const int r = (tid >> 3) + i * (kThreads / 8);
        const bool ok = n0 + r < n && kc < k;
        copy16(sb + swz(r, q), ok ? w + (long long)(n0 + r) * k + kc : w, ok);
      }
    }
  };
  if constexpr (kPanel) {  // the panel, landed and visible to both warpgroups before the rings start
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kc = ks * kBK + q * 16;
#pragma unroll
      for (int i = 0; i < BN * 8 / kThreads; ++i) {
        const int r = (tid >> 3) + i * (kThreads / 8);
        const bool ok = n0 + r < n && kc < k;
        copy16(panel + ks * BN * kBK + swz(r, q), ok ? w + (long long)(n0 + r) * k + kc : w, ok);
      }
    }
    copy_commit();
    copy_wait<0>();
    proxy_fence();
    __syncthreads();
  }

  const float rs = kRes ? __fmul_rn(__fdiv_rn(*res_amax, 127.f), out_scale) : 0.f;
  // The residual of the warp's 16 rows of a tile, two 16-byte pieces a lane
  // per 64 columns, fetched into registers a whole tile ahead: issued right
  // after the previous tile's epilogue (the first tile's before the ring
  // starts), so its latency hides behind the tile's products instead of
  // stalling each chunk of the epilogue.
  const int wrow = wg * 64 + (warp & 3) * 16;  // the warp's first row in a tile
  uint4 rres[kRes ? BN / 64 : 1][2];
  auto fetch_res = [&](long long tile) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = lane + 32 * i;
        const long long row = tile * BM + wrow + (e >> 2);
        const int cc = n0 + c * 64 + (e & 3) * 16;
        rres[c][i] = make_uint4(0, 0, 0, 0);
        if (row < m && cc < n) rres[c][i] = __ldg(reinterpret_cast<const uint4*>(res + row * n + cc));
      }
  };
  if constexpr (kRes) fetch_res(blockIdx.x);
  int acc[BN / 2];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    copy_commit();
  }
  for (long long g = 0; g < total; ++g) {
    const int ks = (int)(g % ksteps);
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    }
    copy_wait<kStages - 2>();
    proxy_fence();
    // stage g has landed (and s_fb is written); every thread that reads
    // stage g-1 is done with it
    if constexpr (kPanel)
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    else
      __syncthreads();
    const uint32_t sa = stage_a((int)(g % kStages));
    const uint32_t sb = kPanel ? panel + ks * BN * kBK : sbase + (int)(g % kStages) * kStageBytes + kStageA;
    acc_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      // both K-major: k32 step kk starts 32 bytes into the rows
      const uint64_t da = make_desc(sa + kk * 32, 16, 1024);
      const uint64_t db = make_desc(sb + kk * 32, 16, 1024);
      WgmmaS8<BN>::mma(acc, da, db, 1);
    }
    wg_commit();
    // refill the stage that step g-1 read while this step's wgmma runs
    if (g + kStages - 1 < total) load(g + kStages - 1);
    copy_commit();
    wg_wait_all();
    acc_fence(acc);
    if (ks != ksteps - 1) continue;

    // Epilogue of the tile, from the s32 fragments, 64 columns at a time,
    // through the warp's staging rows (16 rows x 64 bytes): the residual
    // goes there from the registers it was fetched into, each thread reads
    // its entries and writes its int8 results in their place, and the rows
    // leave with 16-byte stores.
    const long long tile = blockIdx.x + (g / ksteps) * gridDim.x;
    const long long row0 = tile * BM + wrow;  // the warp's 16 rows
    const int gq = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      if constexpr (kRes) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * i;
          *reinterpret_cast<uint4*>(stage_o + (e >> 2) * kPitch + (e & 3) * 16) = rres[c][i];
        }
        __syncwarp();
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int* a = acc + 4 * (c * 8 + jj);
        const int col = c * 64 + jj * 8 + 2 * t;
        const float2 f2 = *reinterpret_cast<const float2*>(s_fb + col);
        const float2 b2 = *reinterpret_cast<const float2*>(s_fb + BN + col);
        const float fs[2] = {f2.x, f2.y};
        const float bs[2] = {b2.x, b2.y};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned char* p = stage_o + (gq + 8 * half) * kPitch + jj * 8 + 2 * t;
          char2 rv = make_char2(0, 0);
          if (kRes) rv = *reinterpret_cast<const char2*>(p);
          int qv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float yv = __fadd_rn(__fmul_rn(__int2float_rn(a[2 * half + u]), fs[u]), bs[u]);
            if (kRes) yv = __fadd_rn(yv, __fmul_rn((float)(u ? rv.y : rv.x), rs));
            qv[u] = to_s8(fmaxf(yv, kRelu ? 0.f : -127.f));  // ReLU or the lower clamp
          }
          *reinterpret_cast<char2*>(p) = make_char2((signed char)qv[0], (signed char)qv[1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = lane + 32 * i;
        const int r = e >> 2;
        const int cc = n0 + c * 64 + (e & 3) * 16;
        if (row0 + r < m && cc < n)
          *reinterpret_cast<uint4*>(out + (row0 + r) * n + cc) =
              *reinterpret_cast<const uint4*>(stage_o + r * kPitch + (e & 3) * 16);
      }
      __syncwarp();
    }
    if constexpr (kRes) {
      if (tile + gridDim.x < m_tiles) fetch_res(tile + gridDim.x);
    }
  }
  copy_wait<0>();
}

template <int BN, bool kPanel, bool kRes, bool kRelu>
int launch(const int8_t* x, const int8_t* w, const float* factor, const float* bias, const float* out_amax,
           const float* res_amax, const int8_t* res, int8_t* out, long long m, int k, int n, int blocks_m,
           cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(BN, kPanel);
  static const int attr = (int)cudaFuncSetAttribute(qgemm_s8_kernel<BN, kPanel, kRes, kRelu>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr) return attr;
  const dim3 grid((unsigned)blocks_m, (unsigned)((n + BN - 1) / BN));
  qgemm_s8_kernel<BN, kPanel, kRes, kRelu><<<grid, kThreads, kSmem, stream>>>(x, w, factor, bias, out_amax,
                                                                               res_amax, res, out, m, k, n);
  return (int)cudaGetLastError();
}

template <int BN, bool kPanel>
int launch_bn(const int8_t* x, const int8_t* w, const float* factor, const float* bias, const float* out_amax,
              const float* res_amax, const int8_t* res, int8_t* out, long long m, int k, int n, int relu,
              int blocks_m, int smem, cudaStream_t stream) {
  if (smem != smem_bytes(BN, kPanel)) return -2;
  const auto fn = res != nullptr ? (relu ? launch<BN, kPanel, true, true> : launch<BN, kPanel, true, false>)
                                  : (relu ? launch<BN, kPanel, false, true> : launch<BN, kPanel, false, false>);
  return fn(x, w, factor, bias, out_amax, res_amax, res, out, m, k, n, blocks_m, stream);
}

}  // namespace

// x (M,K), w (N,K), res and out (M,N) int8; factor and bias (N,) f32;
// out_amax and res_amax one f32 each on the device (res_amax read only with
// a residual; res and res_amax may be null otherwise); bn (64, 128 or 256), blocks_m and smem from the launch plan
// (ops/gemm_plan.py), and panel, whether the plan keeps the weights
// resident. Returns the cudaError_t of the launch (0 on success), -1 for
// shapes, alignments or tiles the kernel does not take, -2 if smem or
// panel is not the kernel's own.
extern "C" int aig_qgemm_s8(const void* x, const void* w, const float* factor, const float* bias,
                            const float* out_amax, const float* res_amax, const void* res, void* out, long long m,
                            int k, int n, int relu, int bn, int blocks_m, int smem, int panel,
                            cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || n % 16 != 0 || blocks_m <= 0) return -1;
  if (res != nullptr && res_amax == nullptr) return -1;
  if ((panel != 0) != use_panel(bn, k)) return -2;
  if (misaligned(x) || misaligned(w) || misaligned(out) || (res != nullptr && misaligned(res))) return -1;
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* rp = static_cast<const int8_t*>(res);
  auto* o = static_cast<int8_t*>(out);
  switch (bn) {
    case 64: return (use_panel(64, k) ? launch_bn<64, true> : launch_bn<64, false>)(
        xs, ws, factor, bias, out_amax, res_amax, rp, o, m, k, n, relu, blocks_m, smem, stream);
    case 128: return (use_panel(128, k) ? launch_bn<128, true> : launch_bn<128, false>)(
        xs, ws, factor, bias, out_amax, res_amax, rp, o, m, k, n, relu, blocks_m, smem, stream);
    case 256: return (use_panel(256, k) ? launch_bn<256, true> : launch_bn<256, false>)(
        xs, ws, factor, bias, out_amax, res_amax, rp, o, m, k, n, relu, blocks_m, smem, stream);
    default: return -1;
  }
}
