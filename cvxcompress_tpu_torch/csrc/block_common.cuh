// Shared pieces of the 128^3 whole-block kernels (block_encode, block_emit,
// block_inverse).
//
// A 128^3 f32 block is 8 MiB: it fits neither a CTA's shared memory nor a
// cluster's, so each kernel works on one 128 x 128 slice of a block at a
// time and the three axis passes split into two launches through device
// memory.  Inside a CTA one axis pass over the slice is a 128 x 128 x 128
// f32 product with the operator, written as a register-tiled SIMT product:
// the operator and the slice sit in shared memory at a padded pitch of 129
// words, and each of the 256 threads accumulates an 8 x 8 tile of outputs
// in registers (rows ti + 16r, columns tj + 16c), with one FMA chain per
// output in ascending k.  The tile goes back to shared memory only after a
// barrier, so no input is overwritten while another thread still needs it.
#pragma once

#include "tokens.cuh"

namespace cvx {

constexpr int BB = 128;                  // block edge
constexpr int BB_CELLS = BB * BB * BB;   // 2^21 cells, 8 MiB of f32
constexpr int SLICE = BB * BB;           // cells of one 128 x 128 slice
constexpr int PITCH = BB + 1;            // padded row pitch in shared memory
constexpr int MAT = BB * PITCH;          // one padded 128 x 128 matrix
constexpr int BT = 256;                  // threads per CTA (16 x 16 tiles)
// operator + slice, dynamic shared memory (the launcher raises the limit)
constexpr size_t BSMEM = 2 * (size_t)MAT * sizeof(float);

// s[r * PITCH + c] = src[r * stride + c] for the 128 x 128 slice.
__device__ __forceinline__ void load_slice(float* s, const float* src,
                                           int64_t stride) {
  for (int i = threadIdx.x; i < SLICE; i += BT) {
    const int r = i >> 7, c = i & (BB - 1);
    s[r * PITCH + c] = src[r * stride + c];
  }
}

// acc[r][c] = sum_k A(i, k) * B(k, j) for i = ti + 16r, j = tj + 16c, where
// A(i, k) = a[i * AI + k * AK] and B(k, j) = b[k * BK + j * BJ] in shared
// memory.  With the 129-word pitch both the row- and the column-wise
// operand reads of a warp fall on distinct banks (or broadcast).
template <int AI, int AK, int BK, int BJ>
__device__ __forceinline__ void mm128(const float* a, const float* b,
                                      float (&acc)[8][8]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < BB; ++k) {
    float av[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = a[(ti + 16 * r) * AI + k * AK];
#pragma unroll
    for (int c = 0; c < 8; ++c) bv[c] = b[k * BK + (tj + 16 * c) * BJ];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// The 8 x 8 tile into shared memory, s[i * PITCH + j].
__device__ __forceinline__ void store_tile(float* s, const float (&acc)[8][8]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      s[(ti + 16 * r) * PITCH + tj + 16 * c] = acc[r][c];
}

// The 8 x 8 tile into device memory, g[i * stride + j].
__device__ __forceinline__ void store_tile(float* g, int64_t stride,
                                           const float (&acc)[8][8]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      g[(ti + 16 * r) * stride + tj + 16 * c] = acc[r][c];
}

// The block's volume origin from its raster index (nx, ny multiples of 128).
struct BlockOrigin {
  int64_t x0, y0, z0;
};
__device__ __forceinline__ BlockOrigin block_origin(int64_t blk, int nx,
                                                    int ny) {
  const int64_t nbx = nx / BB, nby = ny / BB;
  return {(blk % nbx) * BB, ((blk / nbx) % nby) * BB, (blk / (nbx * nby)) * BB};
}

}  // namespace cvx
