// The address map of the block-major cell order onto a volume-order plane,
// shared by tokenize_stripe.cu and block_emit.cu.
//
// The stripe route (ops/geometry.py) keeps the forward transform's output in
// volume order: the zero-padded (nzp, nyp, nxp) plane, each block's
// coefficients at its own place.  Block b (raster order, x fastest) has its
// local cell l = (z * by + y) * bx + x at
//   ((bz_i * bz + z) * nyp + by_i * by + y) * nxp + bx_i * bx + x.
// Every block edge is a power of two (bz may be 1), so the local split is
// shifts; 8 | bx, so 8 consecutive local cells from a multiple of 8 are 8
// consecutive, 32-byte aligned floats of one plane row.  The kernels take
// the map as a template parameter STRIPE: false reads block-major (nnn,
// cells) input (the identity: only lbx + lby + lbz, log2 of the cells, is
// used), true the volume-order plane.
// Counterpart: ops/geometry.py `stripe_addr`; the JAX package's
// codec.stripe_rowmap (cvxcompress_tpu/ops/codec.py:151).
#pragma once

#include <cstdint>

namespace cvx {

struct StripeMap {
  int lbx, lby, lbz;   // log2 of the block edges
  int64_t nbx, nby;    // blocks along x and y
  int64_t nxp, nyp;    // the plane's padded x and y extents
};

// Offset of block `blk`'s cell 0 in the source.
template <bool STRIPE>
__device__ __forceinline__ int64_t map_origin(const StripeMap& m, int64_t blk) {
  const int lcells = m.lbx + m.lby + m.lbz;
  if (!STRIPE) return blk << lcells;
  const int64_t bxi = blk % m.nbx, t = blk / m.nbx;
  const int64_t byi = t % m.nby, bzi = t / m.nby;
  return ((bzi << m.lbz) * m.nyp + (byi << m.lby)) * m.nxp + (bxi << m.lbx);
}

// Offset of block-local cell l from the block's cell 0.
template <bool STRIPE>
__device__ __forceinline__ int64_t map_cell(const StripeMap& m, int l) {
  if (!STRIPE) return l;
  const int x = l & ((1 << m.lbx) - 1);
  const int y = (l >> m.lbx) & ((1 << m.lby) - 1);
  const int z = l >> (m.lbx + m.lby);
  return ((int64_t)z * m.nyp + y) * m.nxp + x;
}

__host__ inline StripeMap make_map(int lbx, int lby, int lbz, int64_t nbx,
                                   int64_t nby, int64_t nxp, int64_t nyp) {
  StripeMap m;
  m.lbx = lbx;
  m.lby = lby;
  m.lbz = lbz;
  m.nbx = nbx;
  m.nby = nby;
  m.nxp = nxp;
  m.nyp = nyp;
  return m;
}

}  // namespace cvx
