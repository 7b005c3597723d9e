// The token grammar shared by the encode and emit kernels of every block
// geometry: the cvttps quantizer, the token classes and group-of-8 modes,
// the byte costs, a block-wide scan, and the writer of one group's tokens.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cvx {

// x86 cvttss2si: truncate toward zero; NaN and out-of-range give INT32_MIN.
// __float2int_rz alone saturates and maps NaN to 0, hence the mask.
__device__ __forceinline__ int32_t cvtt(float f) {
  return (f >= -2147483648.0f && f < 2147483648.0f) ? __float2int_rz(f)
                                                     : INT32_MIN;
}

__device__ __forceinline__ bool is_byte(int32_t v) { return v > -125 && v < 125; }
__device__ __forceinline__ bool is_short(int32_t v) { return v >= -32768 && v <= 32767; }
__device__ __forceinline__ bool is_i3(int32_t v) { return v >= -8388608 && v <= 8388607; }

// Group-of-8 mode: 0 mixed, 1 eight plain bytes, 2 VLESC2_8x, 3 VLESC3_8x,
// with the reference's selection guards (Run_Length_Encode_Slow.cpp:216,
// 231, 246), from the group's counts of zeros, bytes, shorts and 24-bit
// values.
__device__ __forceinline__ int group_mode_counts(int nzero, int nb, int ns, int n3) {
  if (nzero != 0) return 0;
  if (nb == 8) return 1;
  if (ns == 8 && nb + (8 - nb) * 3 > 17) return 2;
  if (n3 == 8 && nb + (ns - nb) * 3 + (8 - ns) * 4 > 25) return 3;
  return 0;
}

__device__ __forceinline__ int group_mode(const int32_t iv[8]) {
  int nzero = 0, nb = 0, ns = 0, n3 = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    nzero += iv[l] == 0;
    nb += is_byte(iv[l]);
    ns += is_short(iv[l]);
    n3 += is_i3(iv[l]);
  }
  return group_mode_counts(nzero, nb, ns, n3);
}

constexpr int32_t MAX_RUN24 = (1 << 24) - 1;

// Byte cost of a non-zero cell's token, given its group mode and lane.
__device__ __forceinline__ int value_cost(int mode, int lane, int32_t v) {
  if (mode == 1) return 1;
  if (mode == 2) return lane == 0 ? 3 : 2;
  if (mode == 3) return lane == 0 ? 4 : 3;
  if (is_byte(v)) return 1;
  if (is_short(v)) return 3;
  if (is_i3(v)) return 4;
  return 5;
}

// Byte cost of the token that flushes a zero run of `len` cells.
__device__ __forceinline__ int run_cost(int32_t len) {
  return len == 1 ? 1 : len < 256 ? 2 : len <= MAX_RUN24 ? 4 : 5;
}

// Descriptor of a zero cell: cost | run_end << 3 | min(run_len, 2^24-1) << 4.
__device__ __forceinline__ int32_t zero_desc(bool run_end, int32_t len) {
  const int cst = run_end ? run_cost(len) : 0;
  return cst | ((int)run_end << 3) | ((len < MAX_RUN24 ? len : MAX_RUN24) << 4);
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Block-wide exclusive scan over the CTA's threads' values; `*total`
// receives the combination of all of them.  `buf` holds 32 ints of shared
// memory.  Every thread of the block must call it.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* buf,
                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = op(inc, n);
  }
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? buf[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, n);
    }
    buf[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = identity;
  const int res = op(warp == 0 ? identity : buf[warp - 1], excl);
  *total = buf[nwarps - 1];
  __syncthreads();  // buf may be reused by the next scan
  return res;
}

// The descriptors of one thread's 64 consecutive cells of one block, l0 the
// first one's block-local index: q(i) is cell i's quantized value, `nonzero`
// the mask of the non-zero ones, `last` the block-local index of the last
// non-zero cell before them (-1: none since the block's start), `end_after`
// whether a zero run in the 64th cell ends there (at the block's end, or
// before a non-zero cell).  Writes the 64 descriptors at dst (16-byte
// aligned) and returns their total cost.
template <class Q>
__device__ __forceinline__ int tokenize64(Q q, uint64_t nonzero, int last,
                                          int l0, bool end_after,
                                          int32_t* dst) {
  int total_cost = 0;
  for (int g = 0; g < 8; ++g) {
    int32_t iv[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) iv[l] = q(8 * g + l);
    const int mode = group_mode(iv);
    int32_t d[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int i = 8 * g + l;
      const int lc = l0 + i;
      if (iv[l] != 0) {
        last = lc;
        d[l] = value_cost(mode, l, iv[l]);
      } else {
        const bool nz_next = i + 1 < 64 ? ((nonzero >> (i + 1)) & 1) != 0 : end_after;
        d[l] = zero_desc(nz_next, lc - last);
      }
      total_cost += d[l] & 7;
    }
    int4* v = reinterpret_cast<int4*>(dst + 8 * g);
    v[0] = make_int4(d[0], d[1], d[2], d[3]);
    v[1] = make_int4(d[4], d[5], d[6], d[7]);
  }
  return total_cost;
}

// A thread's cost of its 64 cells (from global cell g0 of block blk) into
// its chunk's byte count and its block's size.  A 128-cell chunk is two
// neighbouring threads' cells, a 64-cell one (cells == 64) one thread's; the
// block's size is the sum over its threads inside the warp (a butterfly
// over aligned groups of cells / 64 lanes, at most the warp), then one
// atomic add per group into the zeroed sizes.  `live`: the warp's lanes
// that call it; the lanes of one chunk or one block are all in it or out.
__device__ __forceinline__ void store_counts(int cost, unsigned live, int cells,
                                             int64_t g0, int64_t blk,
                                             int32_t* chunk_bytes,
                                             int32_t* sizes) {
  if (cells >= 128) {
    const int pair = cost + __shfl_xor_sync(live, cost, 1);
    if ((threadIdx.x & 1) == 0) chunk_bytes[g0 >> 7] = pair;
  } else {
    chunk_bytes[g0 >> 6] = cost;
  }
  const int w = cells / 64 < 32 ? cells / 64 : 32;
  int bsum = cost;
  for (int o = 1; o < w; o <<= 1) bsum += __shfl_xor_sync(live, bsum, o);
  if ((threadIdx.x & (w - 1)) == 0 && bsum) atomicAdd(&sizes[blk], bsum);
}

// Sum of the CTA's threads' values in a fixed order, returned to every
// thread: a halving tree over each warp's lanes (lane i + lane i+16, then
// i + i+8, ...), then the same tree over the warps' sums.  No atomics, so
// the result is the same on every run, and ops/quant.py `cta_sumsq`
// repeats it.  `buf` holds 32 doubles of shared memory.  Every thread of
// the block must call it.
__device__ __forceinline__ double block_sum_f64(double v, double* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < nwarps ? buf[lane] : 0.0;  // + 0.0 keeps the tree's sums
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) buf[0] = w;
  }
  __syncthreads();
  const double total = buf[0];
  __syncthreads();  // buf may be reused
  return total;
}

// A block's mulfac from the f64 sum of its coefficients' squares:
// rms = f32(sqrt(ss / cells)), mulfac = 1/(rms * scale) in f32, 1.0 when
// rms is 0 or the quotient is not finite (CvxCompress.cpp:291-295,
// native/cvx_host.cpp:654-659).  Explicitly rounded intrinsics: the value
// must equal the host's and the plain version's to the bit.
__device__ __forceinline__ float local_mulfac(double ss, int64_t cells,
                                              float scale) {
  const float rms =
      __double2float_rn(__dsqrt_rn(__ddiv_rn(ss, (double)cells)));
  const float mf = rms != 0.0f ? __fdiv_rn(1.0f, __fmul_rn(rms, scale)) : 1.0f;
  return isfinite(mf) ? mf : 1.0f;
}

// Writes the tokens of one group of 8 cells at p and returns the byte after
// them.  `cv` holds the group's UNSCALED coefficients and `d` their
// descriptors; values, classes and the group mode are re-derived with the
// encoder's one f32 rounding (fv = cv * mulfac), so the bytes agree with the
// costs the descriptors carry.
__device__ __forceinline__ uint8_t* emit_group(uint8_t* p, const float cv[8],
                                               const int32_t d[8],
                                               float mulfac) {
  float fv[8];
  int32_t iv[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    fv[l] = __fmul_rn(cv[l], mulfac);
    iv[l] = cvtt(fv[l]);
  }
  const int mode = group_mode(iv);
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int cost = d[l] & 7;
    if (cost == 0) continue;
    const int32_t v = iv[l];
    if (mode == 1) {
      *p++ = (uint8_t)v;
    } else if (mode == 2) {
      if (l == 0) *p++ = 0x82;  // VLESC2_8x
      *p++ = (uint8_t)v;
      *p++ = (uint8_t)(v >> 8);
    } else if (mode == 3) {
      if (l == 0) *p++ = 0x7E;  // VLESC3_8x
      *p++ = (uint8_t)v;
      *p++ = (uint8_t)(v >> 8);
      *p++ = (uint8_t)(v >> 16);
    } else if (v == 0) {  // the token that flushes a zero run
      const int32_t rl = (int32_t)((uint32_t)d[l] >> 4);
      if (cost == 1) {
        *p++ = 0;
      } else if (cost == 2) {
        *p++ = 127;  // RLESC1
        *p++ = (uint8_t)rl;
      } else {  // RLESC3 (+ the trailing single zero of a split run)
        *p++ = 125;
        *p++ = (uint8_t)rl;
        *p++ = (uint8_t)(rl >> 8);
        *p++ = (uint8_t)(rl >> 16);
        if (cost == 5) *p++ = 0;
      }
    } else if (is_byte(v)) {
      *p++ = (uint8_t)v;
    } else if (is_short(v)) {
      *p++ = 0x83;  // VLESC2
      *p++ = (uint8_t)v;
      *p++ = (uint8_t)(v >> 8);
    } else if (is_i3(v)) {
      *p++ = 0x81;  // VLESC3
      *p++ = (uint8_t)v;
      *p++ = (uint8_t)(v >> 8);
      *p++ = (uint8_t)(v >> 16);
    } else {
      const uint32_t bits = __float_as_uint(fv[l]);
      *p++ = 0x80;  // VLESC4: the scaled float itself
      *p++ = (uint8_t)bits;
      *p++ = (uint8_t)(bits >> 8);
      *p++ = (uint8_t)(bits >> 16);
      *p++ = (uint8_t)(bits >> 24);
    }
  }
  return p;
}

}  // namespace cvx
