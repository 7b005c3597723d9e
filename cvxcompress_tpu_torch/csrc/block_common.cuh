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

// The x, then y cascade of one z-slice: the operator into `op`, the slice
// of `src` (16,384 contiguous cells) into `s` at the padded pitch, the two
// products; the slice's coefficients are left in `s`.
__device__ __forceinline__ void slice_xy(const float* src,
                                         const float* __restrict__ op_g,
                                         float* op, float* s) {
  load_slice(op, op_g, BB);
  load_slice(s, src, BB);
  __syncthreads();
  float acc[8][8];
  mm128<PITCH, 1, 1, PITCH>(s, op, acc);  // x: out[y][x'] = sum_x s[y][x] W[x'][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
  mm128<PITCH, 1, PITCH, 1>(op, s, acc);  // y: out[y'][x] = sum_y W[y'][y] s[y][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
}

__device__ __forceinline__ int32_t quantized(const float* s, int c,
                                             float mulfac) {
  return cvtt(__fmul_rn(s[(c >> 7) * PITCH + (c & (BB - 1))], mulfac));
}

// The tokenize of one z-slice, shared by block_encode_xy (global RMS) and
// block_scale_tok (local RMS).  `s` holds the slice's UNSCALED coefficients
// at the padded pitch, `tile` = block * 128 + z comes from the launch's
// atomic ticket, `mulfac` is the block's.  fv = c * mulfac (one f32
// rounding), cvttps, the classes, group-of-8 modes and per-cell descriptors
// (cost | run_end << 3 | min(run_len, 2^24-1) << 4), per 128-cell chunk its
// byte count and per block its size (atomic integer adds into zeroed
// counters, exact in any order); the z = 0 slice writes the block's mulfac
// into the table.
//
// The zero-run carry.  A run crosses z-slices and chunks and resets only at
// a block start, so a slice's leading zeros need the last non-zero cell of
// the slices before it.  Single-pass decoupled look-back: the CTA publishes
// its own last non-zero cell in status[tile], then walks back over the
// published slices of its block until one holds a non-zero cell (or the
// block starts).  The ticket order means every earlier slice's CTA has
// started, and a CTA publishes before it waits on anything, so the walk
// always ends.  The last cell of a slice, when zero and not the block's
// last, belongs to the next slice's CTA: only that CTA knows whether the run
// ends there; it writes the descriptor and adds its cost to the chunk and
// the block.  Every slice of a block has the block's one mulfac, so that
// CTA quantizes its own first cell with the same factor.
__device__ __forceinline__ void slice_tokenize(
    const float* s, float mulfac, int tile, int* __restrict__ status,
    int32_t* __restrict__ desc, int32_t* __restrict__ chunk_bytes,
    int32_t* __restrict__ sizes, float* __restrict__ mulfacs, int* scan_buf,
    int* s_carry) {
  const int64_t blk = tile >> 7;
  const int z = tile & (BB - 1);
  const int gbase = z * SLICE;  // the slice's first cell in its block
  const int64_t off = blk * BB_CELLS + gbase;
  if (z == 0 && threadIdx.x == 0) mulfacs[blk] = mulfac;

  // thread t owns the slice's cells [64t, 64t + 64): eight whole groups
  constexpr int PER = SLICE / BT;
  const int c0 = threadIdx.x * PER;
  uint64_t nonzero = 0;
  for (int i = 0; i < PER; ++i)
    nonzero |= (uint64_t)(quantized(s, c0 + i, mulfac) != 0) << i;
  const int last_local = nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
  const bool next_zero =
      c0 + PER < SLICE && quantized(s, c0 + PER, mulfac) == 0;
  int slice_last;
  const int excl =
      block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &slice_last);

  if (threadIdx.x == 0) {
    atomicExch(&status[tile], slice_last + 2);  // 1: no non-zero cell
    int carry = -1;  // last non-zero cell before the slice, in the block
    for (int p = 1; p <= z; ++p) {
      int v;
      while ((v = atomicAdd(&status[tile - p], 0)) == 0) __nanosleep(64);
      if (v >= 2) {
        carry = (z - p) * SLICE + v - 2;
        break;
      }
    }
    *s_carry = carry;
    // the previous slice's last cell, when zero, is this CTA's to write
    if (z > 0 && carry < gbase - 1) {
      const bool run_end = quantized(s, 0, mulfac) != 0;
      const int32_t d = zero_desc(run_end, gbase - 1 - carry);
      desc[off - 1] = d;
      if (d & 7) {
        atomicAdd(&chunk_bytes[(off - 1) >> 7], d & 7);
        atomicAdd(&sizes[blk], d & 7);
      }
    }
  }
  __syncthreads();

  int last = excl >= 0 ? gbase + excl : *s_carry;
  // the slice's last cell when zero and z < 127: the next CTA's (above)
  const bool hand_off = z < BB - 1 && threadIdx.x == BT - 1 && !(nonzero >> 63);
  int total_cost = 0;
  int32_t* dst = desc + off + c0;
  for (int g = 0; g < PER / 8; ++g) {
    int32_t iv[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) iv[l] = quantized(s, c0 + 8 * g + l, mulfac);
    const int mode = group_mode(iv);
    int32_t d[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int i = 8 * g + l;
      const int gc = gbase + c0 + i;
      if (iv[l] != 0) {
        last = gc;
        d[l] = value_cost(mode, l, iv[l]);
      } else {
        // the block's end also ends a run (z == 127, last thread)
        const bool nz_next = i + 1 < PER ? ((nonzero >> (i + 1)) & 1) != 0
                                         : !next_zero;
        d[l] = zero_desc(nz_next, gc - last);
      }
      total_cost += d[l] & 7;
    }
    if (hand_off && g == PER / 8 - 1) {
      total_cost -= d[7] & 7;
#pragma unroll
      for (int l = 0; l < 7; ++l) dst[8 * g + l] = d[l];
    } else {
      int4* v = reinterpret_cast<int4*>(dst + 8 * g);
      v[0] = make_int4(d[0], d[1], d[2], d[3]);
      v[1] = make_int4(d[4], d[5], d[6], d[7]);
    }
  }
  // two threads per 128-cell chunk
  const int pair = total_cost + __shfl_xor_sync(0xffffffffu, total_cost, 1);
  if ((threadIdx.x & 1) == 0 && pair)
    atomicAdd(&chunk_bytes[(off + c0) >> 7], pair);
  int wsum = total_cost;
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o2);
  if ((threadIdx.x & 31) == 0 && wsum) atomicAdd(&sizes[blk], wsum);
}

// Zero the look-back ticket and status words, the chunk counters and the
// block sizes of an encode launch over nnn blocks (on every call).
__host__ inline cudaError_t reset_encode_counters(int* scratch,
                                                  int32_t* chunk_bytes,
                                                  int32_t* sizes, int64_t nnn,
                                                  cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + nnn * BB) * sizeof(int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(chunk_bytes, 0,
                        nnn * (BB_CELLS / 128) * sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  return e;
}

}  // namespace cvx
