// The row-wise tokenize of a tile of block-order cells in shared memory,
// shared by stripe_fused.cu (after its cascades), tokenize_stripe.cu (the
// stripe route's tokenize), tokenize_compact.cu and block_encode_local.cu
// (block_scale_tok): each 32-cell segment's last non-zero cell by a
// ballot, a CTA-wide max-scan over the segments, cut at block starts (a
// carry from before the tile where a block spans several: run_carry's
// look-back), then each cell's descriptor by common.cuh seg_desc, a lane a
// cell.  Also the TMA and bulk copies the kernels fill their tiles with.
#pragma once

#include "common.cuh"
#include "lookback.cuh"

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

// Where tok_descs puts a chunk's results: each cell's descriptor at its
// global block-major index g + i, the chunk's byte count at g >> lch.
struct DescOut {
  int32_t* desc;
  int32_t* chunk_bytes;
  template <int K>
  __device__ __forceinline__ void operator()(int64_t g, int lch, const int32_t (&d)[K],
                                             int cost, const float*, int, int) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) desc[g + 32 * k + lane] = d[k];
    if (lane == 0) chunk_bytes[g >> lch] = cost;
  }
};

// Tokenize, step 3: the descriptors of the first n cells of the ncells at
// s (global block-major cell gbase; block-local index of cell 0: boff, 0
// in a tile) from rows (tok_scan's; top its return), a chunk of K segments
// (K = 4: 128 cells; K = 2: the 64-cell chunk of a 64-cell block) a warp
// step; each chunk's descriptors and byte count to `out` (DescOut, or a
// caller's of the same call) and each block's size (atomics into the
// zeroed sizes; blk0 the block of cell 0).  A chunk with no non-zero cell
// (rows shows it: the last non-zero cell before its end is the one before
// its start) is one zero run in closed form, without reading its cells;
// any other takes its reads and ballots first, then each segment its
// descriptors: where every value is a byte (|v| < 125, zeros included)
// each non-zero cell costs 1 whatever its group's mode, so only the runs
// need work; else common.cuh seg_desc.  The closed form and the byte short
// cut are for 128-cell chunks: at the 64-cell chunks of (8, 8, 1) blocks
// their tests cost more than they save.
// carry0: the block-local last non-zero cell before cell 0 (-1: none);
// next_first: whether the cell after the ncells is non-zero (a range that
// ends inside its block).
template <int K, class Out>
__device__ __noinline__ void tok_descs(const float* s, int ncells, int n, int lc,
                                       const float* mf, int smask, const int* rows, int top,
                                       int64_t gbase, int boff, int64_t blk0, int carry0,
                                       bool next_first, const Out out,
                                       int32_t* __restrict__ sizes) {
  constexpr int CH = 32 * K, LCH = K == 4 ? 7 : 6;
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5, cells = 1 << lc;
  const int per = ncells / warps, c_beg = (threadIdx.x >> 5) * per;
  const int c_end = min(n, c_beg + per);
  int bsum = 0;
#pragma unroll 1
  for (int c0 = c_beg; c0 < c_end; c0 += CH) {
    const int bl0 = (boff + c0) & (cells - 1), bs = c0 - bl0;
    const bool block_end = bl0 + CH == cells;
    int e[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k)
      e[k] = k < K || c0 + CH < ncells ? rows[(c0 >> 5) + k] : top | (int)next_first << 16;
    int32_t d[K];
    int cost = 0;
    if (K == 4 && (e[K] & 0xffff) == (e[0] & 0xffff)) {  // no non-zero cell
      const int last = (e[0] & 0xffff) - 1;
      const int carry = last >= 0 && last >= bs ? last - bs : carry0;
      const bool end = block_end || (e[K] >> 16) != 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        d[k] = zero_desc(k == K - 1 && lane == 31 && end, bl0 + 32 * k + lane - carry);
      cost = zero_desc(end, bl0 + CH - 1 - carry) & 7;
    } else {
      const float m0 = mf[c0 >> lc];  // a chunk lies in one block
      int32_t q[K];
      unsigned m[K];
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = cvtt(__fmul_rn(s[sw(c0 + 32 * k + lane, smask)], m0));
      unsigned mb[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        m[k] = __ballot_sync(~0u, q[k] != 0);
        if constexpr (K == 4) mb[k] = __ballot_sync(~0u, is_byte(q[k]));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int last = (e[k] & 0xffff) - 1;  // tile-local, -1: none
        const int carry = last >= 0 && last >= bs ? last - bs : carry0;
        const bool end_last = (k == K - 1 && block_end) || (e[k + 1] >> 16) != 0;
        const int c = bl0 + 32 * k + lane;
        if constexpr (K == 4) {
          if (m[k] && mb[k] == ~0u) {  // all bytes: a group's mode is 0 or 1, a value costs 1
            const unsigned lower = m[k] & ((1u << lane) - 1u);
            const int lst = lower ? c - lane + 31 - __clz((int)lower) : carry;
            const bool end = lane < 31 ? ((m[k] >> (lane + 1)) & 1) != 0 : end_last;
            d[k] = q[k] != 0 ? 1 : zero_desc(end, c - lst);
          } else {
            d[k] = seg_desc(q[k], m[k], mb[k], lane, c, carry, end_last);
          }
        } else {
          d[k] = seg_desc(q[k], m[k], lane, c, carry, end_last);
        }
        cost += d[k] & 7;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cost += __shfl_xor_sync(~0u, cost, o);
    }
    out(gbase + c0, LCH, d, cost, s, c0, smask);
    bsum += cost;
    if (block_end || c0 + CH == c_end) {
      if (lane == 0 && bsum) atomicAdd(&sizes[blk0 + (c0 >> lc)], bsum);
      bsum = 0;
    }
  }
}

// The zero-run carry of tile t, the zt-th of a block that spans several
// tiles (boff = zt * tile cells), whose tok_scan returned top (1 + its last
// non-zero cell, 0: none); first_nz: its first cell is non-zero.  Warp-wide
// (the lanes of one warp).  run_publish, right after the scan: the tile's
// last non-zero cell as an inclusive value (LB_INCL | 1 + the block-local
// cell), or, having none, "aggregate: no non-zero cell" (LB_AGG; the
// block's first tile: inclusive, none).  run_walk, for a tile whose first
// cell is zero: reads its block's earlier tiles' words 32 at a time (a lane
// each; the first window may come from lookback.cuh peek_window), back to
// the nearest inclusive one, and, if the tile had no non-zero cell of its
// own, publishes that value as its inclusive one: a tile in an all-zero
// stretch stops at the nearest tile that has finished, not at the
// stretch's start.  The ticket order means every earlier tile's CTA has
// started, and each publishes before it waits, so the walk ends.  Returns
// the block-local last non-zero cell before the tile (-1: none; only
// needed when its first cell is zero).  run_carry: the two at once.
__device__ __forceinline__ void run_publish(unsigned* status, int64_t t, int zt, int boff,
                                            int top) {
  if ((threadIdx.x & 31) == 0)
    st_relaxed(&status[t], top ? LB_INCL | (unsigned)(boff + top) : zt ? LB_AGG : LB_INCL);
}

__device__ __forceinline__ int run_walk(unsigned* status, int64_t t, int zt, int top,
                                        bool first_nz, unsigned pre) {
  const int lane = threadIdx.x & 31;
  int carry = -1;
  if (zt && !first_nz) {
    for (int64_t base = t - 1;; base -= 32) {
      const int64_t r = base - lane;
      const unsigned f = base == t - 1 && pre ? pre
                         : r >= t - zt      ? wait_status(&status[r])
                                            : LB_INCL;
      const unsigned incl = __ballot_sync(~0u, (f & LB_INCL) != 0);
      if (incl) {
        carry = (int)(__shfl_sync(~0u, f, __ffs(incl) - 1) & LB_VALUE) - 1;
        break;
      }
    }
    if (!top && lane == 0) st_relaxed(&status[t], LB_INCL | (unsigned)(carry + 1));
  }
  return carry;
}

__device__ __forceinline__ int run_carry(unsigned* status, int64_t t, int zt, int boff,
                                         int top, bool first_nz) {
  run_publish(status, t, zt, boff, top);
  return run_walk(status, t, zt, top, first_nz, 0u);
}

// One thread: `bytes` (a multiple of 16) of global memory at src (16-byte
// aligned) into shared memory at dst by one bulk copy, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

static inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace cvx
