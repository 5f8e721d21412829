// Complex float64 arithmetic and the small forward DFTs of the frontends'
// shared-memory FFTs (csrc/mfcc.cu, csrc/stft.cu). The schedule they run is
// stated in dsp/fft.py; tests/fft_model.py models these butterflies.

#pragma once

#include <cuda_runtime.h>

namespace aig_fft {

// Shared-memory index of point i: one pad point every 8, so that the
// stride-8 writes of a radix-8 pass fall on distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 mul_mi(double2 a) { return make_double2(a.y, -a.x); }  // a * -i

// Forward 4-point DFT in place.
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2, double2& a3) {
  const double2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3), t3 = mul_mi(csub(a1, a3));
  a0 = cadd(t0, t2);
  a1 = cadd(t1, t3);
  a2 = csub(t0, t2);
  a3 = csub(t1, t3);
}

// Forward 8-point DFT in place: two 4-point DFTs (even, odd) and one
// radix-2 step with the 8th roots of unity.
__device__ __forceinline__ void dft8(double2 (&v)[8]) {
  double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  constexpr double h = 0.70710678118654752440;
  o1 = make_double2((o1.x + o1.y) * h, (o1.y - o1.x) * h);   // * (1 - i) / sqrt(2)
  o2 = mul_mi(o2);
  o3 = make_double2((o3.y - o3.x) * h, -(o3.x + o3.y) * h);  // * (-1 - i) / sqrt(2)
  v[0] = cadd(e0, o0); v[1] = cadd(e1, o1); v[2] = cadd(e2, o2); v[3] = cadd(e3, o3);
  v[4] = csub(e0, o0); v[5] = csub(e1, o1); v[6] = csub(e2, o2); v[7] = csub(e3, o3);
}

}  // namespace aig_fft
