// y = x @ w with the per-column sum and sum of squares of the f32
// accumulator in the epilogue, for sm_90a.
//
// Replaces acoustic_image_generation_tpu/ops/pallas_conv_stats.py::
// matmul_stats (_kernel): the trunk's 1x1 stride-1 convs in train mode,
// whose batch-norm statistics would otherwise need a second pass over the
// conv's output. Function, as matmul_stats_reference in ops/conv_stats.py:
// operands in the compute dtype (f32 or bf16), products and sums in f32;
// the column sums are taken of the f32 accumulator before y is rounded to
// the compute dtype and stored.
//
// Bound on an H100: the trunk's 1x1 convs do 2*K*N FLOP per row against
// 2*(K + N) bytes in bf16, 64-1024 FLOP/byte, so the larger ones are bound
// by operations (989 TFLOP/s dense bf16) and the 64-channel ones by bytes
// (3.35 TB/s).
//
// Design, bf16 (the path the trunk runs), namespace sm90_path:
// - Product: wgmma.mma_async m64nNk16 bf16 x bf16 -> f32, two warpgroups
//   of 64 rows. A = x, K-major; B = w (K, N) read as it lies, MN-major
//   (64-column atoms of the 128-byte swizzle, as conv_chain's weight grad
//   reads its operands). N tile BN = 64, 128 or 256 (ops/gemm_plan.py), so
//   x is read ceil(N/256) times (the earlier WMMA kernel's 128 x 64 tiles
//   read it N/64 times: 32 times at N = 2048).
// - Loads: a ring of 4 (BN = 256), 6 or 8 stages of 64 K values, filled by
//   16-byte cp.async from every thread into 128-byte-swizzled tiles; rows
//   past M and columns past K or N read as zeros (source size 0), so rows
//   past M add 0 to the sums and only the store of y is masked. The grid is
//   persistent in M: a block owns one column tile and walks every
//   gridDim.x-th row tile, the ring running over the flattened (row tile,
//   K step) sequence, so the next tile's loads are in flight during this
//   tile's last products and its epilogue.
// - Statistics from the accumulator fragments, no f32 tile in shared
//   memory: each thread sums its two rows of each of its columns, a
//   halving butterfly of __shfl_xor over the 8 lanes that share a column
//   (offsets 16, 8, 4) leaves each lane one column group's 16-row sums,
//   and each warp adds them into its own column partials in shared memory,
//   over all the row tiles the block walks. At the end the block sums its
//   8 warps' partials in a fixed order into a (blocks, 2, N) scratch, and a
//   second small launch sums the blocks' rows in block order: no atomics,
//   the same bits every run.
// - y is rounded to bf16 from the accumulator (after the sums are taken)
//   and leaves through a per-warp staging buffer of 16 rows x 128 bytes
//   with 16-byte stores.
// f32 (checks and f32 compute), namespace fma_path: IEEE FMAs on the CUDA
// cores, 64x64 tiles, 4x4 per thread; the f32 tile goes through shared
// memory, where the block sums each column over its valid rows and adds the
// sums into the f32 outputs with atomics (so their last bits vary from run
// to run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

// Column sums of the valid rows of a tile held in shared memory; `parts`
// threads share a column.
template <int BM, int BN, int LDC, int kThreads>
__device__ __forceinline__ void column_stats(const float* Cs, int rows, int n0, int n,
                                             float* s, float* ss) {
  constexpr int kParts = kThreads / BN;
  constexpr int kRows = BM / kParts;
  const int c = threadIdx.x % BN;
  const int part = threadIdx.x / BN;
  if (n0 + c >= n) return;
  float a = 0.f, b = 0.f;
  const int r0 = part * kRows;
  const int r1 = min(r0 + kRows, rows);
  for (int r = r0; r < r1; ++r) {
    const float v = Cs[r * LDC + c];
    a += v;
    b = fmaf(v, v, b);
  }
  if (r1 > r0) {
    atomicAdd(s + n0 + c, a);
    atomicAdd(ss + n0 + c, b);
  }
}

namespace fma_path {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(kThreads)
matmul_stats_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
                 float* __restrict__ s, float* __restrict__ ss, long long m, int k, int n) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN + kPad];
  __shared__ __align__(16) float Cs[BM * LDC];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ak = tid % BK;   // A staging: column ak of rows am + 16*i
  const int am = tid / BK;
  const int bn = tid % BN;   // B staging: column bn of rows bk + 4*i
  const int bk = tid / BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM / (kThreads / BK); ++i) {
      const int r = am + i * (kThreads / BK);
      const long long row = m0 + r;
      As[ak][r] = (row < m && k0 + ak < k) ? x[row * k + k0 + ak] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK / (kThreads / BN); ++i) {
      const int kk = bk + i * (kThreads / BN);
      Bs[kk][bn] = (k0 + kk < k && n0 + bn < n) ? w[(long long)(k0 + kk) * n + n0 + bn] : 0.f;
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  const int rows = (int)min((long long)BM, m - m0);
  column_stats<BM, BN, LDC, kThreads>(Cs, rows, n0, n, s, ss);
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    if (r < rows && n0 + c < n) y[(m0 + r) * n + n0 + c] = Cs[r * LDC + c];
  }
}

}  // namespace fma_path

namespace sm90_path {

using namespace sm90gemm;

constexpr int BM = 128;       // rows of a tile: two wgmma warpgroups of 64
constexpr int kBK = 64;       // K of one ring stage: 4 wgmma k16 steps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageA = BM * kBK * 2;  // 16 KB
constexpr int kStageRow = 16 * 128;    // a warp's 16 rows x 64 bf16 columns of y

__host__ __device__ constexpr int stages(int bn) { return bn == 256 ? 4 : bn == 128 ? 6 : 8; }
// Dynamic shared memory of a block: the ring (A tile + B tile per stage),
// the warps' y staging rows, their column partials (sum and sum of squares
// of BN columns each), and the slack to a 1024-byte boundary. ops/
// gemm_plan.py computes the same number; the launch checks that they agree.
__host__ __device__ constexpr int smem_bytes(int bn) {
  return stages(bn) * (kStageA + bn * kBK * 2) + kWarps * kStageRow + kWarps * 2 * bn * 4 + 1024;
}

// One step of the statistics' butterfly over lanes O apart: the lane with
// bit O set keeps the upper half of v[0, 2*O) (the lower lane the lower
// half), adds its partner's copy of that half, and leaves it in v[0, O).
template <int O>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? v[i] : v[i + O];
    const float keep = upper ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// A block owns one BN-wide column tile (blockIdx.y) and walks the row tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... . Its ring runs over the
// flattened (row tile, K step) sequence, so the next tile's first stages
// load while this tile's last products and its epilogue run.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_stats_bf16(const __nv_bfloat16* __restrict__ x,  // (M, K), K % 8 == 0
                  const __nv_bfloat16* __restrict__ w,  // (K, N), N % 8 == 0
                  __nv_bfloat16* __restrict__ y,        // (M, N)
                  float* __restrict__ part,             // (gridDim.x, 2, N) block partials
                  long long m, int k, int n) {
  constexpr int kStages = stages(BN);
  constexpr int kStageBytes = kStageA + BN * kBK * 2;
  constexpr int kBPer = kBK * BN / 8 / kThreads;  // B chunks a thread copies per stage
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
  unsigned char* stage_y = gbase + kStages * kStageBytes + warp * kStageRow;
  float* colpart = reinterpret_cast<float*>(gbase + kStages * kStageBytes + kWarps * kStageRow);
  float* my_part = colpart + warp * 2 * BN;  // [0, BN): sums, [BN, 2BN): sums of squares
  for (int i = lane; i < 2 * BN; i += 32) my_part[i] = 0.f;

  // Copy mapping: A, 8 neighbouring threads move the 128 contiguous bytes
  // of one row (chunk q = tid & 7); B (MN-major), neighbouring threads move
  // neighbouring 16-byte chunks of one K row of w, into 64-column atoms of
  // 8 KB.
  const int q = tid & 7;
  auto load = [&](long long g) {
    const int stage = (int)(g % kStages);
    const long long tile = blockIdx.x + (g / ksteps) * gridDim.x;
    const int k0 = (int)(g % ksteps) * kBK;
    const uint32_t sa = sbase + stage * kStageBytes;
    const uint32_t sb = sa + kStageA;
    const int kc = k0 + q * 8;
#pragma unroll
    for (int i = 0; i < BM * 8 / kThreads; ++i) {
      const int r = (tid >> 3) + i * (kThreads / 8);
      const long long row = tile * BM + r;
      const bool ok = row < m && kc < k;
      copy16(sa + swz(r, q), ok ? x + row * k + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (BN / 8);
      const int c = e % (BN / 8);
      const bool ok = k0 + r < k && n0 + c * 8 < n;
      copy16(sb + (c >> 3) * 8192 + swz(r, c & 7), ok ? w + (long long)(k0 + r) * n + n0 + c * 8 : w, ok);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s);
    copy_commit();
  }
  for (long long g = 0; g < total; ++g) {
    const int ks = (int)(g % ksteps);
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    copy_wait<kStages - 2>();
    proxy_fence();
    __syncthreads();  // stage g has landed; every warpgroup is done with stage g-1
    const uint32_t sa = sbase + (int)(g % kStages) * kStageBytes;
    const uint32_t sb = sa + kStageA;
    acc_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A K-major: k16 step kk starts 32 bytes into the rows; B MN-major:
      // 16 K rows (2048 bytes) in, atoms of 64 columns 8192 bytes apart
      const uint64_t da = make_desc(sa + wg * 8192 + kk * 32, 16, 1024);
      const uint64_t db = make_desc(sb + kk * 2048, 8192, 1024);
      WgmmaBf16<BN, 1>::mma(acc, da, db, 1);
    }
    wg_commit();
    // refill the stage that step g-1 read while this step's wgmma runs
    if (g + kStages - 1 < total) load(g + kStages - 1);
    copy_commit();
    wg_wait_all();
    acc_fence(acc);
    if (ks != ksteps - 1) continue;

    // Epilogue of the tile, from the fragments, 64 columns at a time.
    const long long tile = blockIdx.x + (g / ksteps) * gridDim.x;
    const long long row0 = tile * BM + wg * 64 + (warp & 3) * 16;  // the warp's 16 rows
    const int gq = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      // Column sum and sum of squares of the f32 accumulator over the
      // warp's 16 rows. v[4jj..4jj+3]: this thread's two rows of columns
      // 8jj + 2t and +1 (sum, sum, square, square). A butterfly that
      // halves the values at each step (lane offsets 16, 8, 4: the 8
      // lanes that share t) leaves lane (gq, t) the 16-row sums of group
      // jj = gq: 28 shuffles instead of 96. Rows past M are zeros.
      float v[32];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float* a = acc + 4 * (c * 8 + jj);
        v[4 * jj] = a[0] + a[2];
        v[4 * jj + 1] = a[1] + a[3];
        v[4 * jj + 2] = fmaf(a[2], a[2], a[0] * a[0]);
        v[4 * jj + 3] = fmaf(a[3], a[3], a[1] * a[1]);
      }
      halve<16>(v, lane);
      halve<8>(v, lane);
      halve<4>(v, lane);
      const int col = c * 64 + gq * 8 + 2 * t;
      float2* ps = reinterpret_cast<float2*>(my_part + col);
      float2* pq = reinterpret_cast<float2*>(my_part + BN + col);
      *ps = make_float2(ps->x + v[0], ps->y + v[1]);
      *pq = make_float2(pq->x + v[2], pq->y + v[3]);

      // y: bf16 from the accumulator into the warp's staging rows (16 rows
      // x 128 bytes, chunks swizzled by row: conflict-free both ways), then
      // 16-byte stores, 8 lanes per 128-byte row segment.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float* a = acc + 4 * (c * 8 + jj);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = gq + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(stage_y + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(a[2 * half], a[2 * half + 1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = lane + 32 * i;
        const int r = e >> 3;
        const int qq = e & 7;
        const long long row = row0 + r;
        const int cc = n0 + c * 64 + qq * 8;
        if (row < m && cc < n)
          *reinterpret_cast<uint4*>(y + row * n + cc) =
              *reinterpret_cast<const uint4*>(stage_y + r * 128 + ((qq ^ (r & 7)) << 4));
      }
      __syncwarp();
    }
  }
  copy_wait<0>();
  __syncthreads();
  // The block's partials: the 8 warps' in a fixed order (no atomics).
  for (int i = tid; i < 2 * BN; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += colpart[wi * 2 * BN + i];
    const int col = n0 + (i % BN);
    if (col < n) part[(long long)blockIdx.x * 2 * n + (i / BN) * n + col] = s;
  }
}

// s[c], ss[c]: the blocks' partials of column c, summed in block order.
__global__ void sum_partials(const float* __restrict__ part, int blocks, int n, float* __restrict__ s,
                             float* __restrict__ ss) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float a = 0.f, b = 0.f;
  for (int p = 0; p < blocks; ++p) {
    a += part[(long long)p * 2 * n + c];
    b += part[(long long)p * 2 * n + n + c];
  }
  s[c] = a;
  ss[c] = b;
}

template <int BN>
int launch(const void* x, const void* w, void* y, float* s, float* ss, float* part, long long m, int k, int n,
           int blocks_m, int smem, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(BN);
  if (smem != kSmem) return -2;
  static const int attr =
      (int)cudaFuncSetAttribute(matmul_stats_bf16<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr) return attr;
  const dim3 grid((unsigned)blocks_m, (unsigned)((n + BN - 1) / BN));
  matmul_stats_bf16<BN><<<grid, kThreads, kSmem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                            static_cast<const __nv_bfloat16*>(w),
                                                            static_cast<__nv_bfloat16*>(y), part, m, k, n);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  sum_partials<<<(n + 255) / 256, 256, 0, stream>>>(part, blocks_m, n, s, ss);
  return (int)cudaGetLastError();
}

}  // namespace sm90_path

}  // namespace

// x (M, K), w (K, N) and y (M, N) in dtype (0 = float32, 1 = bfloat16);
// s, ss (N,) f32. float32: s and ss zeroed by the caller; part, bn,
// blocks_m and smem unused. bfloat16: K and N multiples of 8, x and w
// 16-byte aligned; part (blocks_m, 2, N) f32 scratch; bn (64, 128 or 256),
// blocks_m and smem from the launch plan (ops/gemm_plan.py). Returns the
// cudaError_t of the launches (0 on success), -1 for arguments the kernels
// do not take, -2 if smem is not the kernel's shared-memory size.
extern "C" int aig_matmul_stats(const void* x, const void* w, void* y, float* s, float* ss, float* part,
                                long long m, int k, int n, int dtype, int bn, int blocks_m, int smem,
                                cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0) return -1;
  if (dtype == 0) {
    using namespace fma_path;
    const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((n + BN - 1) / BN));
    matmul_stats_f32<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(w),
                                                    static_cast<float*>(y), s, ss, m, k, n);
    return (int)cudaGetLastError();
  }
  if (dtype != 1) return -1;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (k % 8 || n % 8 || misaligned(x) || misaligned(w) || misaligned(y) || blocks_m <= 0) return -1;
  switch (bn) {
    case 64: return sm90_path::launch<64>(x, w, y, s, ss, part, m, k, n, blocks_m, smem, stream);
    case 128: return sm90_path::launch<128>(x, w, y, s, ss, part, m, k, n, blocks_m, smem, stream);
    case 256: return sm90_path::launch<256>(x, w, y, s, ss, part, m, k, n, blocks_m, smem, stream);
    default: return -1;
  }
}
