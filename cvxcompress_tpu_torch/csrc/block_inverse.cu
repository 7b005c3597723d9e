// block_inverse: dense block-major 128^3 coefficients -> inverse wavelet ->
// volume, in two launches.
//
// Replaces the TPU kernel fused_inverse.block_fused_inverse
// (cvxcompress_tpu/ops/fused_inverse.py:65, call :81, kernel
// _kernel_block_inv :46), which holds the whole 8 MiB block in VMEM.  On
// Hopper it does not fit on chip, so the three inverse cascades, in the
// reference's order x, y, then z, split into two passes, the volume itself
// holding the intermediate:
//   1. block_inv_xy: one CTA per (block, z).  It takes the z-slice's 16,384
//      contiguous cells of the dense buffer (as the device entropy decoder
//      writes it), runs the x inverse, then the y inverse, and writes the
//      slice to its place in the volume (128 x-rows of 512 B).
//   2. block_inv_z: one CTA per (block, y).  It loads the (z, x) slab of the
//      volume, runs the z inverse and writes the slab back in place.
// What bounds it on an H100: device-memory bytes (dense in and the volume
// out, then the volume in and out again, 16 B per cell).  Each pass runs the
// multi-level inverse 7/9 cascade itself (cascade_lines in block_common.cuh,
// the native parity cascade's operations in its order, so the volume equals
// native's cvx_decompress_inplace_parity_th bit for bit); one 64.5 KiB
// slice per CTA, three CTAs per SM, float4 copies.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 3)
block_inv_xy_kernel(const float* __restrict__ dense, int nx, int ny,
                    float* __restrict__ vol) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  const int64_t blk = blockIdx.x >> 7;
  const int z = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);

  build_tables(&tabs);
  load_slice(s, dense + blk * BB_CELLS + (int64_t)z * SLICE, BB);
  __syncthreads();
  cascade_lines<PITCH, 1, true>(s, tabs);  // x: along each row y
  __syncthreads();
  cascade_lines<1, PITCH, true>(s, tabs);  // y: along each column x
  __syncthreads();
  store_slice(vol + ((o.z0 + z) * ny + o.y0) * nx + o.x0, nx, s);
}

__global__ void __launch_bounds__(BT, 3)
block_inv_z_kernel(int nx, int ny, float* __restrict__ vol) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);
  const int64_t zstride = (int64_t)ny * nx;
  float* slab = vol + o.z0 * zstride + (o.y0 + y) * nx + o.x0;

  build_tables(&tabs);
  load_slice(s, slab, zstride);
  __syncthreads();
  cascade_lines<1, PITCH, true>(s, tabs);  // z: along each column x
  __syncthreads();
  store_slice(slab, zstride, s);
}

}  // namespace cvx

extern "C" int cvx_block_inv_xy(const float* dense, int nx, int ny, int nz,
                                float* vol, void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_inv_xy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_inv_xy_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                        (cudaStream_t)stream>>>(dense, nx, ny, vol);
  return (int)cudaGetLastError();
}

extern "C" int cvx_block_inv_z(int nx, int ny, int nz, float* vol,
                               void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_inv_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_inv_z_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                       (cudaStream_t)stream>>>(nx, ny, vol);
  return (int)cudaGetLastError();
}
