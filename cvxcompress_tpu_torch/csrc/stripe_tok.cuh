// The row-wise tokenize of a tile of block-order cells in shared memory,
// shared by stripe_fused.cu (after its cascades) and tokenize_stripe.cu
// (the stripe route's tokenize): each 32-cell segment's last non-zero cell
// by a ballot, a CTA-wide max-scan over the segments, cut at block starts
// (a carry from before the tile where a block spans several), then each
// cell's descriptor by common.cuh seg_desc, a lane a cell.  Also the TMA
// pieces both kernels copy their tiles with.
#pragma once

#include "common.cuh"

namespace cvx {

// Word offset of buffer word w in the swizzled layout.
__device__ __forceinline__ int sw(int w, int smask) {
  return w ^ (((w >> 5) & smask) << 2);
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

// One thread: the box of a 3-D tensor map at coordinates (x, y, z) into
// dst, completing on bar.
__device__ __forceinline__ void tma_box3(float* dst, const void* tmap, int x, int y, int z,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// Tokenize, step 1: each 32-cell segment j of the first n cells of the
// ncells at s (warp w the segments of its share, eight at a time: their
// reads and ballots first) into rows[j]: 1 + its last non-zero cell (0:
// none), bit 16 its first cell non-zero.  mf[b]: block b's mulfac (b =
// cell >> lc).
static __device__ __noinline__ void tok_summaries(const float* s, int ncells, int n,
                                                  int lc, const float* mf, int smask,
                                                  int* rows) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int per = ncells / warps, c_beg = (threadIdx.x >> 5) * per;
#pragma unroll 1
  for (int c0 = c_beg; c0 < c_beg + per; c0 += 256) {
    unsigned m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + 32 * k;
      // cvtt(fv) != 0 exactly where |fv| >= 1 or fv is NaN
      m[k] = c < n ? __ballot_sync(
                         ~0u, !(fabsf(__fmul_rn(s[sw(c + lane, smask)], mf[c >> lc])) < 1.0f))
                   : 0u;
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = c0 + 32 * k;
        rows[c >> 5] = (m[k] ? c + 32 - __clz((int)m[k]) : 0) | (int)((m[k] & 1) << 16);
      }
  }
}

// Tokenize, step 2: rows[j] becomes 1 + the last non-zero cell before
// segment j (0: none) with its bit 16 kept; returns 1 + the last non-zero
// cell of all (0: none).  Thread t takes segments t * spt .. + spt.
static __device__ __noinline__ int tok_scan(int* rows, int nseg, int* scan_buf) {
  const int spt = nseg / blockDim.x, j0 = threadIdx.x * spt;
  int v[4], top = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < spt) {
      v[k] = rows[j0 + k];
      top = max(top, v[k] & 0xffff);
    }
  int total;
  int run = block_exclusive_scan(top, 0, MaxOp(), scan_buf, &total);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < spt) {
      rows[j0 + k] = run | (v[k] & 0x10000);
      run = max(run, v[k] & 0xffff);
    }
  __syncthreads();
  return total;
}

// Tokenize, step 3: the descriptors of the first n cells of the ncells at
// s (global block-major cell gbase; block-local index of cell 0: boff, 0
// in a tile) from rows (tok_scan's), a chunk of K segments (K = 4: 128
// cells; K = 2: the 64-cell chunk of a 64-cell block) a warp step, their
// reads and ballots first; each chunk's byte count and each block's size
// (atomics into the zeroed sizes; blk0 the block of cell 0).  carry0: the
// block-local last non-zero cell before cell 0 (-1: none); next_first:
// whether the cell after the ncells is non-zero (a range that ends inside
// its block).
template <int K>
__device__ __noinline__ void tok_descs(const float* s, int ncells, int n, int lc,
                                       const float* mf, int smask, const int* rows,
                                       int64_t gbase, int boff, int64_t blk0, int carry0,
                                       bool next_first, int32_t* __restrict__ desc,
                                       int32_t* __restrict__ chunk_bytes,
                                       int32_t* __restrict__ sizes) {
  constexpr int CH = 32 * K, LCH = K == 4 ? 7 : 6;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5, cells = 1 << lc;
  const int per = ncells / warps, c_beg = (threadIdx.x >> 5) * per;
  const int c_end = min(n, c_beg + per);
  int32_t* dst = desc + gbase + lane;
  int bsum = 0;
#pragma unroll 1
  for (int c0 = c_beg; c0 < c_end; c0 += CH) {
    const float m0 = mf[c0 >> lc];  // a chunk lies in one block
    const int bl0 = (boff + c0) & (cells - 1), bs = c0 - bl0;
    int32_t q[K];
    unsigned m[K];
    int e[K + 1];
#pragma unroll
    for (int k = 0; k < K; ++k) q[k] = cvtt(__fmul_rn(s[sw(c0 + 32 * k + lane, smask)], m0));
#pragma unroll
    for (int k = 0; k <= K; ++k)
      e[k] = k < K || c0 + CH < ncells ? rows[(c0 >> 5) + k] : (int)next_first << 16;
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = __ballot_sync(~0u, q[k] != 0);
    const bool block_end = bl0 + CH == cells;
    int cost = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int last = (e[k] & 0xffff) - 1;  // tile-local, -1: none
      const int carry = last >= 0 && last >= bs ? last - bs : carry0;
      const bool end_last = (k == K - 1 && block_end) || (e[k + 1] >> 16) != 0;
      const int32_t d = seg_desc(q[k], m[k], lane, bl0 + 32 * k + lane, carry, end_last);
      dst[c0 + 32 * k] = d;
      cost += d & 7;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cost += __shfl_xor_sync(~0u, cost, o);
    if (lane == 0) chunk_bytes[(gbase + c0) >> LCH] = cost;
    bsum += cost;
    if (block_end || c0 + CH == c_end) {
      if (lane == 0 && bsum) atomicAdd(&sizes[blk0 + (c0 >> lc)], bsum);
      bsum = 0;
    }
  }
}

static inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace cvx
