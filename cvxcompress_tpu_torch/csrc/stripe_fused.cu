// stripe_fused: forward wavelet + scale + quantize + tokenize, and the
// inverse wavelet, of the fused stripe blocks other than 32^3 (16^3,
// (16, 16, 1), (8, 16, 8), (32, 32, 16), (64, 32, 32), ...: the JAX gate
// stripe_fused_ok, ops/geometry.py; bx in 8..64, by in 8..256, bz 1 or
// 8..256, at most 2^18 cells).
//
// Replaces the TPU kernels tokenize_pallas.stripe_fused_tiles
// (cvxcompress_tpu/ops/tokenize_pallas.py:939, call :1024; global kernel
// _kernel_stripe_fused :896, launched as `stripe_fused_encode`; local-RMS
// kernel _kernel_stripe_fused_local :907, launched as
// `stripe_fused_encode_local`) at those blocks, with the XLA pad before and
// _stripe_accounting (:1092) after them, and
// fused_inverse.stripe_fused_inverse (cvxcompress_tpu/ops/fused_inverse.py:128,
// launched as `stripe_fused_inverse`).  The 32^3 blocks keep fused_encode.cu
// and fused_inverse.cu.
//
// Arithmetic: the native library's parity cascade (cascade.cuh), x, then
// y, then z in both directions; a line of 8 to 32 cells, and an x-row of
// 64, runs in one thread's registers (reg_cascade); a y- or z-line of 64
// to 256 cells takes its levels 256 .. 64 in shared memory, a warp a line
// (each lane its share of the output pairs, every tap read before any
// output is written), then the levels 32 .. 2 in a thread's registers.  `wavelet.cascade_3d` is the
// plain version, so kernel and plain version agree bit for bit and the
// containers are those of native's parity codec.
//
// Layout.  A CTA's cells sit block-major in shared memory, x-rows dense, in
// the TMA swizzle of the row width (32 B at bx = 8, 64 B at 16, 128 B at
// 32 and 64): word w lives at w ^ (((w >> 5) & mask) << 2), so a thread's
// row reads as float4s and a warp's 32 consecutive cells fall on 32 banks.
//
// Blocks of at most 16,384 cells: one persistent CTA of 512 threads per SM
// walks tiles of 16,384 cells (64 KiB) of whole blocks, two tile buffers:
// the next tile's copy runs under this tile's cascades and tokenize.  The
// copy is one TMA tile copy per block (cp.async.bulk.tensor, a box of
// bx x by x bz, zero past the volume's edges as native pads; at bx = 64 a
// 4-D box of two 32-float halves, so that a row stays within the 128-byte
// swizzle span), or, where TMA's 16-byte rules fail (nx % 4 != 0, nx % 32
// != 0 at bx = 64, a misaligned base), 4-byte cp.async into the same
// places.
//
// Larger blocks (32,768 to 2^18 cells: (64, 32, 32), (64, 64, 64), ...):
// a thread-block cluster of R = min(8, cells / 16,384) CTAs of 256 threads
// (two CTAs an SM, so that one's copies and barriers overlap the other's
// work) holds one block, each CTA a range of bz / R z-planes (a contiguous range
// of block-order cells, <= 128 KiB).  The x and y cascades run locally;
// the z cascade on lines that each CTA reads from and writes to its peers'
// shared memory (distributed shared memory), with a cluster barrier before
// and after.
//
// Encode, per tile or CTA: the UNSCALED coefficients go out block-major
// (raw-fallback blocks and the emit kernel read them); each block's
// mulfac: the global one, or 1/(rms * scale) of its own coefficients, the
// f64 squares summed in a fixed order that ops/quant.py `stripe_rms`
// repeats (lane l of a warp adds cell 32 j + l of each 32-cell segment j of
// its span in turn, the lanes meet in a halving tree, the spans of a CTA
// add in order, then the CTAs of a cluster in rank order); then the
// row-wise tokenize (stripe_tok.cuh, shared with tokenize_stripe.cu, on
// common.cuh seg_desc): segments of 32 consecutive block-order cells, a
// lane a cell, several segments a warp step (their reads and ballots
// first), each segment's last non-zero cell by a ballot, a CTA-wide
// max-scan over the segments, cut at block starts; in a cluster
// the last non-zero cell before a CTA's range and the first cell after it
// come from its peers.  Outputs as tokenize_stripe: descriptors, the byte
// count of each 128-cell chunk, block sizes (the raw decision is the
// wrapper's).
//
// The inverse reads the dense block-major coefficients the device entropy
// decoder writes (16-byte cp.async), runs the x, y, z inverse cascades and
// writes the (nz, ny, nx) volume, clipped at the edges, as float4s where a
// row's four cells lie inside it.
// What bounds them on an H100: the bytes set the bound (the volume in, the
// coefficients and descriptors out; or the coefficients in, the volume
// out), but the kernels are bound by issue: the cascades' ~22 separately
// rounded f32 operations per cell and axis (no FMA: native's parity order)
// and, in the encode, the tokenize's ~2 warp instructions per cell, which
// at 16^3 take more than half its time (PERF.md).

#include <cooperative_groups.h>

#include <cstring>

#include "stripe_tok.cuh"

namespace cvx {

namespace cg = cooperative_groups;

constexpr int SF_LTILE = 14;
constexpr int SF_TILE = 1 << SF_LTILE;  // cells of a tile buffer (64 KiB)
constexpr int SF_NT = 512;              // threads of the tile kernels
constexpr int SF_CT = 256;              // threads of a cluster CTA
constexpr int SF_MAXPART = 1 << 15;     // a cluster CTA's cells, at most
// two tile buffers and the slack to align them to 1,024 bytes
constexpr size_t SF_TILE_SMEM = 2 * SF_TILE * sizeof(float) + 1024;
constexpr size_t SF_PART_SMEM = SF_MAXPART * sizeof(float) + 1024;

struct Geom {
  int lbx, lby, lbz;  // log2 of the block edges (lbz 0: bz == 1)
  int nx, ny, nz;     // the volume
  int nbx, nby;       // blocks along x and y
  int64_t nnn;        // blocks
  int smask;          // the swizzle: 1 at bx = 8, 3 at 16, 7 at 32 and 64
};

// The volume coordinates of block blk's cell 0
// (32-bit division: a volume has fewer than 2^32 blocks).
__device__ __forceinline__ int3 block_origin(const Geom& g, int64_t blk) {
  const unsigned b = (unsigned)blk, t = b / (unsigned)g.nbx;
  return make_int3((int)(b - t * g.nbx) << g.lbx, (int)(t % (unsigned)g.nby) << g.lby,
                   (int)(t / (unsigned)g.nby) << g.lbz);
}

// A line in this CTA's buffer: positions off + i * st.
struct Lin {
  float* s;
  int off, st, smask;
  __device__ __forceinline__ float& operator()(int i) const {
    return s[sw(off + i * st, smask)];
  }
};

// A z-line across a cluster: position i is plane i % zc of rank i / zc.
struct Dist {
  float* s;
  int off, plane, lzc, smask;
  __device__ __forceinline__ float& operator()(int i) const {
    float* p = s + sw(off + (i & ((1 << lzc) - 1)) * plane, smask);
    return *cg::this_cluster().map_shared_rank(p, (unsigned)(i >> lzc));
  }
};

// One level of length n (64, 128 or 256) of a line, in place, by the 32
// lanes of a warp: lane l the output pairs l, l + 32, ...; every tap is
// read before any output is written.
template <bool INV, class A>
__device__ __forceinline__ void warp_level(const A& a, int n, int lane) {
  const int h = n >> 1;
  float o0[4], o1[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j < h) {
      if constexpr (INV) {
        float L[4], H[5];
#pragma unroll
        for (int c = 0; c < 4; ++c) L[c] = a(mirr_sl(j - 1 + c, h));
#pragma unroll
        for (int c = 0; c < 5; ++c) H[c] = a(mirr_sh(h + j - 2 + c, h, h));
        inv_pair(L, H, o0[m], o1[m]);
      } else {
        float x[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = a(mirr(2 * j - 4 + k, n));
        fwd_pair(x, o0[m], o1[m]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j < h) {
      if constexpr (INV) {
        a(2 * j) = o0[m];
        a(2 * j + 1) = o1[m];
      } else {
        a(j) = o0[m];
        a(h + j) = o1[m];
      }
    }
  }
  __syncwarp();
}

// The levels N .. 2 (forward) or 2 .. N (inverse) of positions [0, N) of
// one line in this thread's registers.
template <bool INV, int N, class A>
__device__ __forceinline__ void reg_line(const A& a) {
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = a(i);
  reg_cascade<INV>(v);
#pragma unroll
  for (int i = 0; i < N; ++i) a(i) = v[i];
}

// The whole cascade of `nlines` lines of length 2^ln; mk(l) is line l's
// accessor.  Lines of 8 to 32: a thread a line.  Longer lines (nlines a
// multiple of 32): warp w takes lines 32 w .. 32 w + 31, their levels of
// 64 and more one line at a time (warp_level), their levels of 32 and less
// a lane a line.
template <bool INV, int N, class MK>
__device__ __forceinline__ void lines_short(int nlines, const MK& mk) {
#pragma unroll 1
  for (int l = threadIdx.x; l < nlines; l += blockDim.x) reg_line<INV, N>(mk(l));
}
template <bool INV, class MK>
__device__ __noinline__ void lines_long(int n, int nlines, const MK& mk) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int g = threadIdx.x & ~31; g < nlines; g += blockDim.x) {
    if (INV) {
      reg_line<true, 32>(mk(g + lane));
      __syncwarp();
#pragma unroll 1
      for (int lv = 64; lv <= n; lv <<= 1)
#pragma unroll 1
        for (int l = 0; l < 32; ++l) warp_level<true>(mk(g + l), lv, lane);
    } else {
#pragma unroll 1
      for (int lv = n; lv >= 64; lv >>= 1)
#pragma unroll 1
        for (int l = 0; l < 32; ++l) warp_level<false>(mk(g + l), lv, lane);
      reg_line<false, 32>(mk(g + lane));
    }
  }
}
template <bool INV, class MK>
__device__ __forceinline__ void lines_any(int ln, int nlines, const MK& mk) {
  switch (ln) {
    case 3: lines_short<INV, 8>(nlines, mk); break;
    case 4: lines_short<INV, 16>(nlines, mk); break;
    case 5: lines_short<INV, 32>(nlines, mk); break;
    default: lines_long<INV>(1 << ln, nlines, mk);
  }
}

// Rows of N <= 32 cells, a thread a row, read and written as float4s.
template <bool INV, int N>
__device__ __forceinline__ void rows_short(float* s, int nrows, int smask) {
#pragma unroll 1
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float v[N];
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 q = *reinterpret_cast<const float4*>(s + sw(r * N + 4 * c, smask));
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
    reg_cascade<INV>(v);
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      *reinterpret_cast<float4*>(s + sw(r * N + 4 * c, smask)) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Rows of 64 cells, a thread a row: read as float4s into registers; the
// level 64 computed from them (forward: its highpass half stored at once,
// the lowpass half kept for the levels 32 .. 2; inverse: after the levels
// 2 .. 32 of the lowpass half), the outputs stored as float4s.
template <bool INV>
__device__ __forceinline__ void rows_64(float* s, int nrows, int smask) {
#pragma unroll 1
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    auto at = [&](int c) { return reinterpret_cast<float4*>(s + sw(r * 64 + 4 * c, smask)); };
    float v[64];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float4 q = *at(c);
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
    if constexpr (INV) {
      reg_levels<32, true>(v);
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        float o[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float L[4], H[5];
#pragma unroll
          for (int c = 0; c < 4; ++c) L[c] = v[mirr_sl(k + i - 1 + c, 32)];
#pragma unroll
          for (int c = 0; c < 5; ++c) H[c] = v[mirr_sh(32 + k + i - 2 + c, 32, 32)];
          inv_pair(L, H, o[2 * i], o[2 * i + 1]);
        }
        *at(k / 2) = make_float4(o[0], o[1], o[2], o[3]);
      }
    } else {
      float lo[32];
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        float hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) x[k] = v[mirr(2 * (j + i) - 4 + k, 64)];
          fwd_pair(x, lo[j + i], hi[i]);
        }
        *at(8 + j / 4) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
      reg_cascade<false>(lo);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *at(c) = make_float4(lo[4 * c], lo[4 * c + 1], lo[4 * c + 2], lo[4 * c + 3]);
    }
  }
}

// The x, then y cascades of the n cells (whole x-rows and y-columns) at s;
// the caller synchronises the CTA before and after.
template <bool INV>
__device__ __forceinline__ void passes_xy_local(float* s, int n, const Geom& g) {
  const int m = g.smask;
  switch (g.lbx) {
    case 3: rows_short<INV, 8>(s, n >> 3, m); break;
    case 4: rows_short<INV, 16>(s, n >> 4, m); break;
    case 5: rows_short<INV, 32>(s, n >> 5, m); break;
    default: rows_64<INV>(s, n >> 6, m);
  }
  __syncthreads();
  const int lbx = g.lbx, lxy = g.lbx + g.lby, bx = 1 << g.lbx;
  lines_any<INV>(g.lby, n >> g.lby, [=](int l) {
    return Lin{s, ((l >> lbx) << lxy) + (l & (bx - 1)), bx, m};
  });
}

// The z cascades of the n cells (whole blocks) at s.
template <bool INV>
__device__ __forceinline__ void pass_z_local(float* s, int n, const Geom& g) {
  const int lxy = g.lbx + g.lby, lc = lxy + g.lbz, m = g.smask;
  lines_any<INV>(g.lbz, n >> g.lbz, [=](int l) {
    return Lin{s, ((l >> lxy) << lc) + (l & ((1 << lxy) - 1)), 1 << lxy, m};
  });
}

// The z cascades of this cluster CTA's share of its block's z-lines (the
// columns rank * cols .. + cols), their planes spread over the cluster.
template <bool INV>
__device__ __forceinline__ void pass_z_cluster(float* s, const Geom& g, int lranks,
                                               int rank) {
  const int lxy = g.lbx + g.lby, cols = (1 << lxy) >> lranks;
  const int lzc = g.lbz - lranks, m = g.smask, c0 = rank * cols;
  lines_any<INV>(g.lbz, cols, [=](int l) {
    return Dist{s, c0 + l, 1 << lxy, lzc, m};
  });
}

// ---- copies ------------------------------------------------------------

// One thread: the bx x by x nzc box at volume origin o into dst (a TMA tile
// copy completing on bar; at bx = 64 the map is 4-D, x split in halves).
__device__ __forceinline__ void tma_box(float* dst, const void* tmap, int lbx, int3 o,
                                        unsigned bar) {
  if (lbx == 6)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
        "l"(tmap), "r"(0), "r"(o.x >> 5), "r"(o.y), "r"(o.z), "r"(bar)
        : "memory");
  else
    tma_box3(dst, tmap, o.x, o.y, o.z, bar);
}

// Every thread: n cells of boxes (block-order: x, y, then z; whole blocks
// from `blk`, or with cluster a partition from plane z of one block) by
// 4-byte cp.async, zero past the volume's edges; no commit.
__device__ __forceinline__ void load4(float* s, const float* vol, const Geom& g,
                                      int64_t blk, int zoff, int n) {
  const int lc = g.lbx + g.lby + g.lbz, lxy = g.lbx + g.lby;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int3 o = block_origin(g, blk + (c >> lc));
    const int l = c & ((1 << lc) - 1);
    const int gx = o.x + (l & ((1 << g.lbx) - 1));
    const int gy = o.y + ((l >> g.lbx) & ((1 << g.lby) - 1));
    const int gz = o.z + zoff + (l >> lxy);
    const bool in = gx < g.nx && gy < g.ny && gz < g.nz;
    cp_async<4>(s + sw(c, g.smask),
                in ? vol + ((int64_t)gz * g.ny + gy) * g.nx + gx : vol, in);
  }
}

// Every thread: n dense coefficients by 16-byte cp.async; no commit.
__device__ __forceinline__ void load16(float* s, const float* src, int n, int smask) {
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
    cp_async<16>(s + sw(4 * q, smask), src + 4 * q, true);
}

// The n cells at s (whole x-rows of block blk from plane zoff on) into the
// volume, clipped at its edges; float4 stores where a row's four cells lie
// inside it and `vec` (nx % 4 == 0).
__device__ __forceinline__ void store_volume(const float* s, float* vol, const Geom& g,
                                             int64_t blk, int zoff, int n, bool vec) {
  const int lc = g.lbx + g.lby + g.lbz, lxy = g.lbx + g.lby;
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
    const int c = 4 * q;
    const int3 o = block_origin(g, blk + (c >> lc));
    const int l = c & ((1 << lc) - 1);
    const int gx = o.x + (l & ((1 << g.lbx) - 1));
    const int gy = o.y + ((l >> g.lbx) & ((1 << g.lby) - 1));
    const int gz = o.z + zoff + (l >> lxy);
    if (gy >= g.ny || gz >= g.nz || gx >= g.nx) continue;
    const float4 v = *reinterpret_cast<const float4*>(s + sw(c, g.smask));
    float* dst = vol + ((int64_t)gz * g.ny + gy) * g.nx + gx;
    if (vec && gx + 3 < g.nx) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (gx + 1 < g.nx) dst[1] = v.y;
      if (gx + 2 < g.nx) dst[2] = v.z;
      if (gx + 3 < g.nx) dst[3] = v.w;
    }
  }
}

// ---- the encode's epilogue ----------------------------------------------

// The n coefficients at s, block-major, to dst as float4s.
__device__ __forceinline__ void store_coeffs(const float* s, float* dst, int n, int smask) {
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x)
    reinterpret_cast<float4*>(dst)[q] = *reinterpret_cast<const float4*>(s + sw(4 * q, smask));
}

// The local RMS's spans: warp w owns the cells [w, w + 1) * ncells / warps;
// lane l adds the f64 square of cell 32 j + l of each segment j of a span
// in turn, the lanes meet in a halving tree, and span k's sum goes to
// out[k].  Only the first n cells (whole blocks) count.
__device__ __noinline__ void span_sums(const float* s, int ncells, int n, int span,
                                          int smask, double* out) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int per = ncells / warps, c_end = min(n, (int)(threadIdx.x >> 5) * per + per);
  double acc = 0.0;
#pragma unroll 1
  for (int c0 = (threadIdx.x >> 5) * per; c0 < c_end; c0 += 32) {
    const double d = s[sw(c0 + lane, smask)];
    acc += d * d;  // exact square: an FMA contraction changes nothing
    if ((c0 + 32) % span == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(~0u, acc, o);
      if (lane == 0) out[(c0 + 32) / span - 1] = acc;
      acc = 0.0;
    }
  }
}

// ---- the tile kernels (blocks of at most SF_TILE cells) -------------------

// `factor`: the global mulfac, or with `local` the scale.  `tma`: the copy
// route (uniform); `tmap` describes the volume when it is set.
__global__ void __launch_bounds__(SF_NT, 1)
sf_encode_tile(const __grid_constant__ CUtensorMap tmap, int tma, const float* __restrict__ vol,
               Geom g, int local, float factor, float* __restrict__ coeffs,
               int32_t* __restrict__ desc, int32_t* __restrict__ chunk_bytes,
               int32_t* __restrict__ sizes, float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const buf0 = block_buffer(dsmem);
  __shared__ uint64_t full[2];
  __shared__ int rows[SF_TILE / 32];
  __shared__ int scan_buf[32];
  __shared__ double spans[SF_TILE / 128];
  __shared__ float s_mf[SF_TILE / 128];
  const int lc = g.lbx + g.lby + g.lbz, cells = 1 << lc, bpt = SF_TILE >> lc;
  const int64_t ntiles = (g.nnn + bpt - 1) / bpt;
  const int span = min(cells, SF_TILE / (SF_NT / 32));

  auto load = [&](int64_t t, int b) {
    float* dst = buf0 + b * SF_TILE;
    const int64_t blk = t * bpt;
    const int nb = (int)min((int64_t)bpt, g.nnn - blk);
    if (!tma) {
      load4(dst, vol, g, blk, 0, nb << lc);
      cp_async_commit();
    } else if (threadIdx.x < 32) {
      const unsigned bar = smem_addr(&full[b]);
      if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(nb << lc) * 4u);
      __syncwarp();
      for (int k = threadIdx.x; k < nb; k += 32)
        tma_box(dst + (k << lc), &tmap, g.lbx, block_origin(g, blk + k), bar);
    }
  };

  if (tma && threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]));
    mbar_init(smem_addr(&full[1]));
  }
  __syncthreads();
  if (blockIdx.x < ntiles) load(blockIdx.x, 0);
  int i = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int b = i & 1;
    float* s = buf0 + b * SF_TILE;
    if (t + gridDim.x < ntiles)
      load(t + gridDim.x, b ^ 1);
    else if (!tma)
      cp_async_commit();
    if (tma) {
      mbar_wait(smem_addr(&full[b]), (i >> 1) & 1);
    } else {
      cp_async_wait<1>();
      __syncthreads();
    }
    const int64_t blk = t * bpt;
    const int nb = (int)min((int64_t)bpt, g.nnn - blk), n = nb << lc;
    passes_xy_local<false>(s, SF_TILE, g);
    __syncthreads();
    if (g.lbz) {
      pass_z_local<false>(s, SF_TILE, g);
      __syncthreads();
    }
    store_coeffs(s, coeffs + (blk << lc), n, g.smask);
    if (local) {
      span_sums(s, SF_TILE, n, span, g.smask, spans);
      __syncthreads();
    }
    if (threadIdx.x < nb) {
      float mf = factor;
      if (local) {
        const int k = cells / span;
        double ss = 0.0;
        for (int j = 0; j < k; ++j) ss += spans[threadIdx.x * k + j];
        mf = local_mulfac(ss, cells, factor);
      }
      s_mf[threadIdx.x] = mf;
      mulfacs[blk + threadIdx.x] = mf;
    }
    __syncthreads();
    tok_summaries(s, SF_TILE, n, lc, s_mf, g.smask, rows);
    __syncthreads();
    const int top = tok_scan(rows, SF_TILE / 32, scan_buf);
    tok_descs<4>(s, SF_TILE, n, lc, s_mf, g.smask, rows, top, blk << lc, 0, blk, -1, false,
                 DescOut{desc, chunk_bytes}, sizes);
    fence_proxy_async();  // this tile's accesses before a later copy into it
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SF_NT, 1)
sf_inverse_tile(const float* __restrict__ dense, Geom g, int vec, float* __restrict__ vol) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const buf0 = block_buffer(dsmem);
  const int lc = g.lbx + g.lby + g.lbz, bpt = SF_TILE >> lc;
  const int64_t ntiles = (g.nnn + bpt - 1) / bpt;
  auto ncells = [&](int64_t t) { return (int)min((int64_t)bpt, g.nnn - t * bpt) << lc; };
  if (blockIdx.x < ntiles) load16(buf0, dense + ((int64_t)blockIdx.x * bpt << lc),
                                  ncells(blockIdx.x), g.smask);
  cp_async_commit();
  int i = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    float* s = buf0 + (i & 1) * SF_TILE;
    const int64_t tn = t + gridDim.x;
    if (tn < ntiles)
      load16(buf0 + ((i & 1) ^ 1) * SF_TILE, dense + (tn * bpt << lc), ncells(tn), g.smask);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    passes_xy_local<true>(s, SF_TILE, g);
    __syncthreads();
    if (g.lbz) {
      pass_z_local<true>(s, SF_TILE, g);
      __syncthreads();
    }
    store_volume(s, vol, g, t * bpt, 0, ncells(t), vec);
    __syncthreads();
  }
}

// ---- the cluster kernels (blocks over SF_TILE cells) ----------------------

// Cluster CTA `rank` of block blockIdx.x >> lranks: its planes rank * zc ..
// + zc, cells boff = rank << lp .. + 2^lp of the block.
__global__ void __launch_bounds__(SF_CT, 2)
sf_encode_cluster(const __grid_constant__ CUtensorMap tmap, int tma,
                  const float* __restrict__ vol, Geom g, int lranks, int local, float factor,
                  float* __restrict__ coeffs, int32_t* __restrict__ desc,
                  int32_t* __restrict__ chunk_bytes, int32_t* __restrict__ sizes,
                  float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const s = block_buffer(dsmem);
  __shared__ uint64_t full;
  __shared__ int rows[SF_MAXPART / 32];
  __shared__ int scan_buf[32];
  __shared__ double spans[SF_CT / 32];
  __shared__ double part;      // this CTA's sum of squares
  __shared__ int last, first;  // 1 + its last non-zero cell, block-local; its first cell
  __shared__ float s_mf;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nr = 1 << lranks;
  const int lc = g.lbx + g.lby + g.lbz, cells = 1 << lc, lp = lc - lranks, n = 1 << lp;
  const int64_t blk = blockIdx.x >> lranks;
  const int boff = rank << lp, zoff = rank << (g.lbz - lranks);
  const int64_t gbase = (blk << lc) + boff;

  if (tma) {
    if (threadIdx.x == 0) {
      const unsigned bar = smem_addr(&full);
      mbar_init(bar);
      mbar_expect(bar, (unsigned)n * 4u);
      int3 o = block_origin(g, blk);
      o.z += zoff;
      tma_box(s, &tmap, g.lbx, o, bar);
    }
    __syncthreads();
    mbar_wait(smem_addr(&full), 0);
  } else {
    load4(s, vol, g, blk, zoff, n);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  passes_xy_local<false>(s, n, g);
  cl.sync();
  pass_z_cluster<false>(s, g, lranks, rank);
  cl.sync();
  store_coeffs(s, coeffs + gbase, n, g.smask);
  if (local) {
    span_sums(s, n, n, n / (SF_CT / 32), g.smask, spans);
    __syncthreads();
    if (threadIdx.x == 0) {
      double ss = 0.0;
      for (int w = 0; w < SF_CT / 32; ++w) ss += spans[w];
      part = ss;
    }
    cl.sync();
  }
  if (threadIdx.x == 0) {
    float mf = factor;
    if (local) {
      double ss = 0.0;
      for (int r = 0; r < nr; ++r) ss += *cl.map_shared_rank(&part, (unsigned)r);
      mf = local_mulfac(ss, cells, factor);
    }
    s_mf = mf;
    if (rank == 0) mulfacs[blk] = mf;
  }
  __syncthreads();
  // s_mf is indexed by cell >> lc, 0 for every cell of the range
  tok_summaries(s, n, n, lc, &s_mf, g.smask, rows);
  __syncthreads();
  const int top = tok_scan(rows, n / 32, scan_buf);
  if (threadIdx.x == 0) {
    last = top ? boff + top : 0;
    first = rows[0] >> 16;
  }
  cl.sync();
  int carry = -1;
  for (int r = 0; r < rank; ++r) carry = max(carry, *cl.map_shared_rank(&last, (unsigned)r) - 1);
  const bool next_first = rank + 1 < nr && *cl.map_shared_rank(&first, (unsigned)rank + 1) != 0;
  tok_descs<4>(s, n, n, lc, &s_mf, g.smask, rows, top, gbase, boff, blk, carry, next_first,
               DescOut{desc, chunk_bytes}, sizes);
  cl.sync();  // the peers have read `last`, `first` and `part`
}

__global__ void __launch_bounds__(SF_CT, 2)
sf_inverse_cluster(const float* __restrict__ dense, Geom g, int lranks, int vec,
                   float* __restrict__ vol) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const s = block_buffer(dsmem);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int lc = g.lbx + g.lby + g.lbz, lp = lc - lranks, n = 1 << lp;
  const int64_t blk = blockIdx.x >> lranks;
  load16(s, dense + (blk << lc) + (rank << lp), n, g.smask);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  passes_xy_local<true>(s, n, g);
  cl.sync();
  pass_z_cluster<true>(s, g, lranks, rank);
  cl.sync();
  store_volume(s, vol, g, blk, rank << (g.lbz - lranks), n, vec);
}

// ---- launchers ------------------------------------------------------------

static Geom make_geom(int nx, int ny, int nz, int lbx, int lby, int lbz) {
  Geom g;
  g.lbx = lbx;
  g.lby = lby;
  g.lbz = lbz;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.nbx = (nx + (1 << lbx) - 1) >> lbx;
  g.nby = (ny + (1 << lby) - 1) >> lby;
  g.nnn = (int64_t)g.nbx * g.nby * ((nz + (1 << lbz) - 1) >> lbz);
  g.smask = lbx == 3 ? 1 : lbx == 4 ? 3 : 7;
  return g;
}

// log2 of the cluster's CTAs for a block of 2^lc cells (0: the tile
// kernels): at most 8, the portable cluster size.
static int cluster_lranks(int lc) {
  if (lc <= SF_LTILE) return 0;
  return lc - SF_LTILE < 3 ? lc - SF_LTILE : 3;
}

// The TMA map of the volume for boxes of bx x by x nzc (x in 32-float halves
// at bx = 64), or false where TMA's rules fail (the 4-byte route).
static bool make_tmap(CUtensorMap* tmap, const float* vol, const Geom& g, int nzc,
                      int* err) {
  *err = 0;
  const int bx = 1 << g.lbx;
  if (reinterpret_cast<uintptr_t>(vol) % 16 || g.nx % 4 || (bx == 64 && g.nx % 32))
    return false;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    *err = (int)cudaErrorSymbolNotFound;
    return false;
  }
  const CUtensorMapSwizzle swz = bx == 8    ? CU_TENSOR_MAP_SWIZZLE_32B
                                 : bx == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t row = (cuuint64_t)g.nx * 4, plane = row * g.ny;
  CUresult r;
  if (bx == 64) {
    const cuuint64_t dims[4] = {32, (cuuint64_t)g.nx / 32, (cuuint64_t)g.ny,
                                (cuuint64_t)g.nz};
    const cuuint64_t strides[3] = {128, row, plane};
    const cuuint32_t box[4] = {32, 2, (cuuint32_t)(1 << g.lby), (cuuint32_t)nzc};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    r = enc(tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, (void*)vol, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[3] = {(cuuint64_t)g.nx, (cuuint64_t)g.ny, (cuuint64_t)g.nz};
    const cuuint64_t strides[2] = {row, plane};
    const cuuint32_t box[3] = {(cuuint32_t)bx, (cuuint32_t)(1 << g.lby), (cuuint32_t)nzc};
    const cuuint32_t one[3] = {1, 1, 1};
    r = enc(tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)vol, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) *err = (int)cudaErrorInvalidValue;
  return r == CUDA_SUCCESS;
}

// A launch of `kernel` as nnn clusters of 2^lranks CTAs of SF_CT threads.
template <class K, class... Args>
static cudaError_t launch_clusters(K kernel, const Geom& g, int lranks, cudaStream_t st,
                                   Args... args) {
  const int lc = g.lbx + g.lby + g.lbz;
  const size_t smem = ((size_t)1 << (lc - lranks)) * sizeof(float) + 1024;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SF_PART_SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.nnn << lranks));
  cfg.blockDim = dim3(SF_CT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << lranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

static int launch_encode(const float* vol, int nx, int ny, int nz, int lbx, int lby, int lbz,
                         int local, float factor, float* coeffs, int32_t* desc,
                         int32_t* chunk_bytes, int32_t* sizes, float* mulfacs,
                         cudaStream_t st) {
  const Geom g = make_geom(nx, ny, nz, lbx, lby, lbz);
  if (g.nnn == 0) return 0;
  const int lc = lbx + lby + lbz, lranks = cluster_lranks(lc);
  CUtensorMap tmap;
  std::memset(&tmap, 0, sizeof tmap);
  int err;
  const int tma = make_tmap(&tmap, vol, g, (1 << lbz) >> lranks, &err);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(sizes, 0, g.nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (lranks) {
    e = launch_clusters(sf_encode_cluster, g, lranks, st, tmap, tma, vol, g, lranks, local,
                        factor, coeffs, desc, chunk_bytes, sizes, mulfacs);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  int sms = 0;
  e = cudaFuncSetAttribute(sf_encode_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SF_TILE_SMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int64_t ntiles = (g.nnn + (SF_TILE >> lc) - 1) / (SF_TILE >> lc);
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  sf_encode_tile<<<grid, SF_NT, SF_TILE_SMEM, st>>>(tmap, tma, vol, g, local, factor, coeffs,
                                                    desc, chunk_bytes, sizes, mulfacs);
  return (int)cudaGetLastError();
}

}  // namespace cvx

extern "C" int cvx_stripe_fused_encode(const float* vol, int nx, int ny, int nz, int lbx,
                                       int lby, int lbz, float mulfac, float* coeffs,
                                       int32_t* desc, int32_t* chunk_bytes, int32_t* sizes,
                                       float* mulfacs, void* stream) {
  return cvx::launch_encode(vol, nx, ny, nz, lbx, lby, lbz, 0, mulfac, coeffs, desc,
                            chunk_bytes, sizes, mulfacs, (cudaStream_t)stream);
}

extern "C" int cvx_stripe_fused_encode_local(const float* vol, int nx, int ny, int nz,
                                             int lbx, int lby, int lbz, float scale,
                                             float* coeffs, int32_t* desc,
                                             int32_t* chunk_bytes, int32_t* sizes,
                                             float* mulfacs, void* stream) {
  return cvx::launch_encode(vol, nx, ny, nz, lbx, lby, lbz, 1, scale, coeffs, desc,
                            chunk_bytes, sizes, mulfacs, (cudaStream_t)stream);
}

// `dense` must be 16-byte aligned (its rows move by 16-byte cp.async).
extern "C" int cvx_stripe_fused_inverse(const float* dense, int nx, int ny, int nz, int lbx,
                                        int lby, int lbz, float* vol, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  const Geom g = make_geom(nx, ny, nz, lbx, lby, lbz);
  if (g.nnn == 0) return 0;
  const int lc = lbx + lby + lbz, lranks = cluster_lranks(lc);
  const int vec = nx % 4 == 0 && reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  cudaError_t e;
  if (lranks) {
    e = launch_clusters(sf_inverse_cluster, g, lranks, st, dense, g, lranks, vec, vol);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  int sms = 0;
  e = cudaFuncSetAttribute(sf_inverse_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SF_TILE_SMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int64_t ntiles = (g.nnn + (SF_TILE >> lc) - 1) / (SF_TILE >> lc);
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  sf_inverse_tile<<<grid, SF_NT, SF_TILE_SMEM, st>>>(dense, g, vec, vol);
  return (int)cudaGetLastError();
}
