// Probe kernels for tools/probe_stripe.py: the fused stripe kernels as
// they were before the parity cascade (dense per-axis operator products,
// tiles of 16,384 cells in shared memory or one block per CTA in device
// memory, a 64-cell tokenize walk per thread), with a mask `parts` that
// keeps the phases it names: 1 the x pass, 2 the y pass, 4 the z pass, 8
// the coefficient store (encode) or the volume store (inverse), 16 the
// table and the tokenize.  The load always runs.  Not part of the package;
// built only by the probe script.

#include "tokens.cuh"

namespace oldsf {

using namespace cvx;

constexpr int LFT = 14;                // log2 cells per tile
constexpr int FT = 1 << LFT;           // 16,384 cells per tile
constexpr int FTHREADS = 256;          // each thread tokenizes 64 cells
// the largest tile: 8-cell rows at a pitch of 9 words
constexpr size_t FSMEM = (size_t)(FT / 8) * 9 * sizeof(float);

struct Geom {
  int lbx, lby, lbz;  // log2 of the block edges (lbz 0: bz == 1)
  int nx, ny, nz;     // the volume
  int64_t nbx, nby;   // blocks along x and y
  int64_t nnn;        // blocks
};

// Working-buffer offset of cell c (block-major, from the buffer's first
// block): rows of bx cells at a pitch of rp words.
__device__ __forceinline__ int64_t woff(int64_t c, int lbx, int rp) {
  return (c >> lbx) * rp + (c & ((1 << lbx) - 1));
}

// The volume coordinates (x0, y0, z0) of block blk's cell 0.
__device__ __forceinline__ int3 block_origin(const Geom& g, int64_t blk) {
  const int64_t t = blk / g.nbx;
  return make_int3((int)(blk % g.nbx) << g.lbx, (int)(t % g.nby) << g.lby,
                   (int)(t / g.nby) << g.lbz);
}

// Volume offset of the cell l of the block at origin o, or -1 outside the
// volume (the partial edge blocks' zero padding).
__device__ __forceinline__ int64_t vol_offset(const Geom& g, int3 o, int l) {
  const int gx = o.x + (l & ((1 << g.lbx) - 1));
  const int gy = o.y + ((l >> g.lbx) & ((1 << g.lby) - 1));
  const int gz = o.z + (l >> (g.lbx + g.lby));
  if (gx >= g.nx || gy >= g.ny || gz >= g.nz) return -1;
  return ((int64_t)gz * g.ny + gy) * g.nx + gx;
}

// One axis (0 x, 1 y, 2 z) of the transform in place over the ncells cells
// (whole blocks, a multiple of 2,048) of the working buffer: every line v
// along the axis becomes op @ v, opT = op transposed ((n, n), opT[j*n + k] =
// op[k][j]).  Thread t computes outputs 8(t % (n/8)) .. +8 of one line.
__device__ void transform_axis_g(float* buf, int rp, const Geom& g, int axis,
                                 const float* __restrict__ opT,
                                 int64_t ncells) {
  const int ln = axis == 0 ? g.lbx : axis == 1 ? g.lby : g.lbz;
  const int n = 1 << ln;
  const int gpl = n >> 3;  // threads per line
  const int li = threadIdx.x / gpl, k0 = (threadIdx.x % gpl) * 8;
  const int64_t nlines = ncells >> ln;
  const int xmask = (1 << g.lbx) - 1;
  for (int64_t l0 = 0; l0 < nlines; l0 += FTHREADS / gpl) {
    const int64_t line = l0 + li;
    int64_t base, stride;
    if (axis == 0) {  // line = row
      base = line * rp;
      stride = 1;
    } else if (axis == 1) {  // line = (block, z, x)
      base = ((line >> g.lbx) << g.lby) * rp + (line & xmask);
      stride = rp;
    } else {  // line = (block, y, x)
      const int64_t yx = line & ((1 << (g.lbx + g.lby)) - 1);
      base = ((line >> (g.lbx + g.lby)) << (g.lbz + g.lby)) * rp +
             (yx >> g.lbx) * rp + (yx & xmask);
      stride = (int64_t)rp << g.lby;
    }
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int j = 0; j < n; ++j) {  // n is a multiple of 8
      const float v = buf[base + j * stride];
      const float4 a = __ldg(reinterpret_cast<const float4*>(opT + j * n + k0));
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(opT + j * n + k0 + 4));
      acc[0] = fmaf(a.x, v, acc[0]);
      acc[1] = fmaf(a.y, v, acc[1]);
      acc[2] = fmaf(a.z, v, acc[2]);
      acc[3] = fmaf(a.w, v, acc[3]);
      acc[4] = fmaf(b.x, v, acc[4]);
      acc[5] = fmaf(b.y, v, acc[5]);
      acc[6] = fmaf(b.z, v, acc[6]);
      acc[7] = fmaf(b.w, v, acc[7]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) buf[base + (k0 + i) * stride] = acc[i];
    __syncthreads();
  }
}

__device__ __forceinline__ void transform_3d(float* buf, int rp, const Geom& g,
                                             const float* opx, const float* opy,
                                             const float* opz, int64_t ncells, int parts) {
  if (parts & 1) transform_axis_g(buf, rp, g, 0, opx, ncells);
  if (parts & 2) transform_axis_g(buf, rp, g, 1, opy, ncells);
  if (g.lbz > 0 && (parts & 4)) transform_axis_g(buf, rp, g, 2, opz, ncells);
}

// SMEM: a tile of whole blocks in shared memory (cells <= FT); else one
// block per CTA, worked in its slot of `coeffs`.  `factor`: the global
// mulfac, or with LOCAL the scale.
template <bool LOCAL, bool SMEM>
__global__ void __launch_bounds__(FTHREADS)
stripe_fused_encode_kernel(const float* __restrict__ vol, Geom g,
                           const float* __restrict__ opx,
                           const float* __restrict__ opy,
                           const float* __restrict__ opz, float factor, int parts,
                           float* coeffs, int32_t* __restrict__ desc,
                           int32_t* __restrict__ chunk_bytes,
                           int32_t* __restrict__ sizes,
                           float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[FTHREADS];
  __shared__ float s_mf[FT / 128];  // a tile holds at most 128 blocks
  __shared__ int3 s_org[FT / 128];  // and their origins in the volume
  __shared__ int scan_buf[32];

  const int lcells = g.lbx + g.lby + g.lbz;
  const int64_t cells = (int64_t)1 << lcells;
  const int64_t ncells = SMEM ? FT : cells;  // the CTA's cells
  const int64_t fb = SMEM ? (int64_t)blockIdx.x << (LFT - lcells) : blockIdx.x;
  const int64_t gbase = fb << lcells;  // its first cell, block-major
  const int bpt = (int)(ncells >> lcells);  // its blocks
  const int rp = (1 << g.lbx) + (SMEM ? 1 : 0);
  float* buf = SMEM ? smem : coeffs + gbase;
  if (threadIdx.x < bpt) s_org[threadIdx.x] = block_origin(g, fb + threadIdx.x);
  __syncthreads();

  for (int64_t c = threadIdx.x; c < ncells; c += FTHREADS) {
    float v = 0.0f;
    if (fb + (c >> lcells) < g.nnn) {
      const int64_t o = vol_offset(g, s_org[c >> lcells], (int)(c & (cells - 1)));
      if (o >= 0) v = vol[o];
    }
    buf[woff(c, g.lbx, rp)] = v;
  }
  __syncthreads();
  transform_3d(buf, rp, g, opx, opy, opz, ncells, parts);
  const int64_t valid =
      min(ncells, (g.nnn - fb) << lcells);  // the cells of real blocks
  if (SMEM && (parts & 8))
    for (int64_t c = threadIdx.x; c < valid; c += FTHREADS)
      coeffs[gbase + c] = buf[woff(c, g.lbx, rp)];

  if (!(parts & 16)) return;
  // each block's mulfac
  if (LOCAL) {
    // a block's 64-cell runs in the CTA's passes of FT cells: per pass each
    // thread sums its run's squares, then one thread per block adds the
    // pass's runs of its block in order
    const int rpb = (int)min((int64_t)FTHREADS, cells >> 6);  // runs per block and pass
    double total = 0.0;  // a block over a tile: its sum so far (thread 0)
    for (int64_t p0 = 0; p0 < ncells; p0 += FT) {
      const int64_t c0 = p0 + threadIdx.x * 64;
      double ss = 0.0;
      for (int i = 0; i < 64; ++i) {
        const double v = buf[woff(c0 + i, g.lbx, rp)];
        ss += v * v;  // exact square: an FMA contraction changes nothing
      }
      part[threadIdx.x] = ss;
      __syncthreads();
      if (threadIdx.x < FTHREADS / rpb) {
        double acc = SMEM ? 0.0 : total;
        for (int r = 0; r < rpb; ++r) acc += part[threadIdx.x * rpb + r];
        if (SMEM)
          s_mf[threadIdx.x] = local_mulfac(acc, cells, factor);
        else
          total = acc;
      }
      __syncthreads();
    }
    if (!SMEM && threadIdx.x == 0) s_mf[0] = local_mulfac(total, cells, factor);
  } else if (threadIdx.x < bpt) {
    s_mf[threadIdx.x] = factor;
  }
  __syncthreads();
  if (threadIdx.x < bpt && fb + threadIdx.x < g.nnn)
    mulfacs[fb + threadIdx.x] = s_mf[threadIdx.x];

  // the tokenize, pass by pass; `carry`: a block over a tile's last non-zero
  // cell before the pass, block-local (-1: none)
  int carry = -1;
  for (int64_t p0 = 0; p0 < ncells; p0 += FT) {
    const int64_t c0 = p0 + threadIdx.x * 64;  // the thread's first cell
    const int bt = (int)(c0 >> lcells);
    const int64_t blk = fb + bt;
    const bool active = blk < g.nnn;
    const int l0 = (int)(c0 & (cells - 1));
    const float mf = s_mf[bt];
    auto q = [&](int i) {
      return cvtt(__fmul_rn(buf[woff(c0 + i, g.lbx, rp)], mf));
    };
    uint64_t nonzero = 0;
    if (active)
      for (int i = 0; i < 64; ++i) nonzero |= (uint64_t)(q(i) != 0) << i;
    const int t0 = (int)(c0 - p0);  // pass-local
    const int last_local = nonzero ? t0 + 63 - __clzll((long long)nonzero) : -1;
    int pass_last;
    const int excl =
        block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &pass_last);
    const unsigned live = __ballot_sync(0xffffffffu, active);
    if (active) {
      // a scan result from an earlier block of the tile falls below 0
      const int el = excl >= 0 ? excl - t0 + l0 : -1;
      const bool end_after = l0 + 64 == cells || q(64) != 0;
      const int cost = tokenize64(q, nonzero, el >= 0 ? el : carry, l0,
                                  end_after, desc + gbase + c0);
      store_counts(cost, live, (int)cells, gbase + c0, blk, chunk_bytes, sizes);
    }
    if (pass_last >= 0) carry = (int)p0 + pass_last;
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(FTHREADS)
stripe_fused_inverse_kernel(const float* __restrict__ dense, Geom g,
                            const float* __restrict__ opx,
                            const float* __restrict__ opy,
                            const float* __restrict__ opz, int parts, float* work,
                            float* __restrict__ vol) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int3 s_org[FT / 128];
  const int lcells = g.lbx + g.lby + g.lbz;
  const int64_t cells = (int64_t)1 << lcells;
  const int64_t ncells = SMEM ? FT : cells;
  const int64_t fb = SMEM ? (int64_t)blockIdx.x << (LFT - lcells) : blockIdx.x;
  const int64_t gbase = fb << lcells;
  const int rp = (1 << g.lbx) + (SMEM ? 1 : 0);
  float* buf = SMEM ? smem : work + gbase;
  const int64_t valid = min(ncells, (g.nnn - fb) << lcells);
  if (threadIdx.x < (int)(ncells >> lcells))
    s_org[threadIdx.x] = block_origin(g, fb + threadIdx.x);

  for (int64_t c = threadIdx.x; c < ncells; c += FTHREADS)
    buf[woff(c, g.lbx, rp)] = c < valid ? dense[gbase + c] : 0.0f;
  __syncthreads();
  transform_3d(buf, rp, g, opx, opy, opz, ncells, parts);
  if (parts & 8)
  for (int64_t c = threadIdx.x; c < valid; c += FTHREADS) {
    const int64_t o = vol_offset(g, s_org[c >> lcells], (int)(c & (cells - 1)));
    if (o >= 0) vol[o] = buf[woff(c, g.lbx, rp)];
  }
}

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
  g.nnn = g.nbx * g.nby * ((nz + (1 << lbz) - 1) >> lbz);
  return g;
}

// The CTAs and dynamic shared memory of a launch: tiles of FT cells (true),
// or one block each when a block is larger (false).
static bool grid_of(const Geom& g, int64_t* ctas, size_t* smem) {
  const int lcells = g.lbx + g.lby + g.lbz;
  if (lcells > LFT) {
    *ctas = g.nnn;
    *smem = 0;
    return false;
  }
  *ctas = (g.nnn + (1 << (LFT - lcells)) - 1) >> (LFT - lcells);
  *smem = (size_t)(FT >> g.lbx) * ((1 << g.lbx) + 1) * sizeof(float);
  return true;
}

template <bool LOCAL>
static int launch_encode(const float* vol, int nx, int ny, int nz, int lbx,
                         int lby, int lbz, const float* opx, const float* opy,
                         const float* opz, float factor, int parts, float* coeffs,
                         int32_t* desc, int32_t* chunk_bytes, int32_t* sizes,
                         float* mulfacs, cudaStream_t st) {
  const Geom g = make_geom(nx, ny, nz, lbx, lby, lbz);
  if (g.nnn == 0) return 0;
  int64_t ctas;
  size_t smem;
  const bool tiled = grid_of(g, &ctas, &smem);
  cudaError_t e = cudaMemsetAsync(sizes, 0, g.nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (tiled) {
    e = cudaFuncSetAttribute(stripe_fused_encode_kernel<LOCAL, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FSMEM);
    if (e != cudaSuccess) return (int)e;
    stripe_fused_encode_kernel<LOCAL, true><<<(unsigned)ctas, FTHREADS, smem, st>>>(
        vol, g, opx, opy, opz, factor, parts, coeffs, desc, chunk_bytes, sizes, mulfacs);
  } else {
    stripe_fused_encode_kernel<LOCAL, false><<<(unsigned)ctas, FTHREADS, smem, st>>>(
        vol, g, opx, opy, opz, factor, parts, coeffs, desc, chunk_bytes, sizes, mulfacs);
  }
  return (int)cudaGetLastError();
}

}  // namespace oldsf

extern "C" int probe_old_encode(int parts, int local, const float* vol, int nx, int ny,
                                int nz, int lbx, int lby, int lbz, const float* opx,
                                const float* opy, const float* opz, float factor,
                                float* coeffs, int32_t* desc, int32_t* chunk_bytes,
                                int32_t* sizes, float* mulfacs, void* stream) {
  auto f = local ? oldsf::launch_encode<true> : oldsf::launch_encode<false>;
  return f(vol, nx, ny, nz, lbx, lby, lbz, opx, opy, opz, factor, parts, coeffs, desc,
           chunk_bytes, sizes, mulfacs, (cudaStream_t)stream);
}

extern "C" int probe_old_inverse(int parts, const float* dense, int nx, int ny, int nz,
                                 int lbx, int lby, int lbz, const float* opx,
                                 const float* opy, const float* opz, float* work,
                                 float* vol, void* stream) {
  using namespace oldsf;
  cudaStream_t st = (cudaStream_t)stream;
  const Geom g = make_geom(nx, ny, nz, lbx, lby, lbz);
  if (g.nnn == 0) return 0;
  int64_t ctas;
  size_t smem;
  if (grid_of(g, &ctas, &smem)) {
    cudaError_t e = cudaFuncSetAttribute(
        stripe_fused_inverse_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FSMEM);
    if (e != cudaSuccess) return (int)e;
    stripe_fused_inverse_kernel<true><<<(unsigned)ctas, FTHREADS, smem, st>>>(
        dense, g, opx, opy, opz, parts, work, vol);
  } else {
    stripe_fused_inverse_kernel<false><<<(unsigned)ctas, FTHREADS, smem, st>>>(
        dense, g, opx, opy, opz, parts, work, vol);
  }
  return (int)cudaGetLastError();
}
