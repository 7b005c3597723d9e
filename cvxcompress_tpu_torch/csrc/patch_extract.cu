// patch_extract: the live 128-cell chunks of the stripe route's volume-order
// coefficient plane as chunk rows, in chunk order.
//
// Replaces the TPU kernel pack_pallas.patch_extract (K17,
// cvxcompress_tpu/ops/pack_pallas.py:94, call :102, kernel _kernel_patch
// :59) with the XLA gather around it (rle_device._gather_from_planes
// :333-381), the pack path the JAX package takes under CVX_STRIPE=patch.
// A block-major chunk of a block with bx < 128 is rpc = 128 / bx x-rows of
// one block column.  A TPU lane cannot load at a computed address, so the
// JAX package gathers each chunk's whole (rpc, W) patch of the plane and the
// Pallas kernel selects and lane-rolls its bx-wide windows into one 128-lane
// row.  A GPU thread loads where it likes: one warp per chunk, each lane 4
// consecutive cells (one float4 of an x-row, as 8 | bx), read through the
// stripe map (stripe_map.cuh) and stored at the chunk's row.  The row is the
// exclusive cumsum of the live mask (chunk byte count not 0), computed by
// the wrapper; the descriptors are block-major already, so a chunk's 128
// come as one 512-byte copy.
//
// What bounds it on an H100: bytes, 1 KiB read and written per live chunk
// plus 8 B per chunk for the count and the position.

#include "stripe_map.cuh"

namespace cvx {

constexpr int PX_WARPS = 8;

__global__ void __launch_bounds__(PX_WARPS * 32)
patch_extract_kernel(const float* __restrict__ plane,
                     const int32_t* __restrict__ desc,
                     const int32_t* __restrict__ chunk_bytes,
                     const int32_t* __restrict__ pos, int64_t nchunks,
                     StripeMap map, float* __restrict__ rows,
                     int32_t* __restrict__ drows, int32_t* __restrict__ ids) {
  const int64_t c = (int64_t)blockIdx.x * PX_WARPS + (threadIdx.x >> 5);
  if (c >= nchunks || chunk_bytes[c] == 0) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int lcpb = map.lbx + map.lby + map.lbz - 7;  // log2 chunks per block
  const int64_t r = pos[c];
  const int64_t blk = c >> lcpb;
  const int l = ((int)(c & ((1 << lcpb) - 1)) << 7) + 4 * lane;
  const float4 v = *reinterpret_cast<const float4*>(
      plane + map_origin<true>(map, blk) + map_cell<true>(map, l));
  reinterpret_cast<float4*>(rows + r * 128)[lane] = v;
  reinterpret_cast<int4*>(drows + r * 128)[lane] =
      reinterpret_cast<const int4*>(desc + c * 128)[lane];
  if (lane == 0) ids[r] = (int32_t)c;
}

}  // namespace cvx

// One warp per chunk; `pos` is each chunk's row among the live ones.
extern "C" int cvx_patch_extract(const float* plane, const int32_t* desc,
                                 const int32_t* chunk_bytes, const int32_t* pos,
                                 int64_t nchunks, int lbx, int lby, int lbz,
                                 int64_t nbx, int64_t nby, int64_t nxp,
                                 int64_t nyp, float* rows, int32_t* drows,
                                 int32_t* ids, void* stream) {
  using namespace cvx;
  if (nchunks == 0) return 0;
  if (lbx + lby + lbz < 7 || lbx < 3) return (int)cudaErrorInvalidValue;
  patch_extract_kernel<<<(unsigned)((nchunks + PX_WARPS - 1) / PX_WARPS),
                         PX_WARPS * 32, 0, (cudaStream_t)stream>>>(
      plane, desc, chunk_bytes, pos, nchunks,
      make_map(lbx, lby, lbz, nbx, nby, nxp, nyp), rows, drows, ids);
  return (int)cudaGetLastError();
}
