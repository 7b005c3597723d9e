// The multi-level Antonini 7/9 cascade, operation for operation as the
// native library's parity cascade computes it (native/cvx_host.cpp
// wav_fwd_axis_parity :141, wav_inv_axis_parity :165): the pair sums first,
// the taps added from the outside in, every multiply and add rounded on its
// own (__fmul_rn / __fadd_rn: no FMA contraction, and never fast-math: a
// subnormal input must stay subnormal).  About 22 FLOP per cell and axis
// against the 2n of a dense n-tap product.
//
// The one copy of the cascade's arithmetic: the 32^3 kernels (common.cuh)
// run whole 32-point lines through `reg_cascade` in one thread's registers;
// the 128^3 kernels (block_common.cuh) run the levels 128 to 32 in shared
// memory with `fwd_pair` / `inv_pair` and the levels 16 to 2 through
// `reg_cascade`.  `wavelet.cascade` in ops/wavelet.py is the plain version
// of both, so kernels and plain versions agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace cvx {

// The analysis (AL, AH) and synthesis (SL, SH) taps, as native/cvx_host.cpp
// writes them.
constexpr float AL0 = 8.526986790094000e-001f, AL1 = 3.774028556126500e-001f,
                AL2 = -1.106244044184200e-001f, AL3 = -2.384946501938001e-002f,
                AL4 = 3.782845550699501e-002f;
constexpr float AH0 = 7.884856164056601e-001f, AH1 = -4.180922732222101e-001f,
                AH2 = -4.068941760955800e-002f, AH3 = 6.453888262893799e-002f;
constexpr float SL0 = 7.884856164056601e-001f, SL1 = 4.180922732222101e-001f,
                SL2 = -4.068941760955800e-002f, SL3 = -6.453888262893799e-002f;
constexpr float SH0 = 8.526986790094000e-001f, SH1 = -3.774028556126500e-001f,
                SH2 = -1.106244044184200e-001f, SH3 = 2.384946501938001e-002f,
                SH4 = 3.782845550699501e-002f;

// The symmetric extensions at the ends of a level (native/cvx_host.cpp
// mirr, mirr_sl, mirr_sh), usable in constant expressions.
__host__ __device__ constexpr int mirr(int v, int n) {
  v = v < 0 ? -v : v;
  v = v >= n ? 2 * n - 2 - v : v;
  v = v < 0 ? -v : v;
  return v >= n ? 2 * n - 2 - v : v;
}
__host__ __device__ constexpr int mirr_sl(int v, int nl) {
  for (int r = 0; r < 3; ++r) {
    v = v < 0 ? -v : v;
    v = v >= nl ? 2 * nl - 1 - v : v;
  }
  return v;
}
__host__ __device__ constexpr int mirr_sh(int v, int nl, int nh) {
  v -= nl;
  for (int r = 0; r < 3; ++r) {
    v = v < 0 ? -v - 1 : v;
    v = v >= nh ? 2 * nh - 2 - v : v;
  }
  return nl + v;
}

// One forward output pair from its taps x[k] = line[mirr(2j - 4 + k)]:
// the lowpass and highpass outputs, in wav_fwd_axis_parity's order.
__device__ __forceinline__ void fwd_pair(const float (&x)[9], float& lo,
                                         float& hi) {
  float a = __fmul_rn(AL4, __fadd_rn(x[0], x[8]));
  a = __fadd_rn(a, __fmul_rn(AL3, __fadd_rn(x[1], x[7])));
  a = __fadd_rn(a, __fmul_rn(AL2, __fadd_rn(x[2], x[6])));
  a = __fadd_rn(a, __fmul_rn(AL1, __fadd_rn(x[3], x[5])));
  lo = __fadd_rn(a, __fmul_rn(AL0, x[4]));
  float b = __fmul_rn(AH3, __fadd_rn(x[2], x[8]));
  b = __fadd_rn(b, __fmul_rn(AH2, __fadd_rn(x[3], x[7])));
  b = __fadd_rn(b, __fmul_rn(AH1, __fadd_rn(x[4], x[6])));
  hi = __fadd_rn(b, __fmul_rn(AH0, x[5]));
}

// One inverse output pair from the lowpass taps L[c] (k - 1 + c) and the
// highpass taps H[c] (n/2 + k - 2 + c): the even and odd outputs, in
// wav_inv_axis_parity's order.
__device__ __forceinline__ void inv_pair(const float (&L)[4], const float (&H)[5],
                                         float& ev, float& od) {
  float e = __fmul_rn(SH3, __fadd_rn(H[0], H[3]));
  e = __fadd_rn(e, __fmul_rn(SL2, __fadd_rn(L[0], L[2])));
  e = __fadd_rn(e, __fmul_rn(SH1, __fadd_rn(H[1], H[2])));
  ev = __fadd_rn(e, __fmul_rn(SL0, L[1]));
  float o = __fmul_rn(SH4, __fadd_rn(H[0], H[4]));
  o = __fadd_rn(o, __fmul_rn(SL3, __fadd_rn(L[0], L[3])));
  o = __fadd_rn(o, __fmul_rn(SH2, __fadd_rn(H[1], H[3])));
  o = __fadd_rn(o, __fmul_rn(SL1, __fadd_rn(L[1], L[2])));
  od = __fadd_rn(o, __fmul_rn(SH0, H[2]));
}

// One level of length N in place on the first N of a line's LEN values,
// held in registers `v` (every index, mirrored ones included, a constant).
template <int N, bool INVERSE, int LEN>
__device__ __forceinline__ void reg_level(float (&v)[LEN]) {
  constexpr int H = N / 2;
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = v[i];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    if constexpr (INVERSE) {
      float L[4], Hi[5];
#pragma unroll
      for (int c = 0; c < 4; ++c) L[c] = t[mirr_sl(j - 1 + c, H)];
#pragma unroll
      for (int c = 0; c < 5; ++c) Hi[c] = t[mirr_sh(H + j - 2 + c, H, H)];
      inv_pair(L, Hi, v[2 * j], v[2 * j + 1]);
    } else {
      float x[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) x[k] = t[mirr(2 * j - 4 + k, N)];
      fwd_pair(x, v[j], v[H + j]);
    }
  }
}

// The levels N, N/2, ..., 2 forward, or 2, ..., N inverse, on v[0, N).
template <int N, bool INVERSE, int LEN>
__device__ __forceinline__ void reg_levels(float (&v)[LEN]) {
  if constexpr (!INVERSE) reg_level<N, false>(v);
  if constexpr (N > 2) reg_levels<N / 2, INVERSE>(v);
  if constexpr (INVERSE) reg_level<N, true>(v);
}

// The whole multi-level cascade of one line of LEN (a power of two) values
// in one thread's registers.
template <bool INVERSE, int LEN>
__device__ __forceinline__ void reg_cascade(float (&v)[LEN]) {
  reg_levels<LEN, INVERSE>(v);
}

}  // namespace cvx
