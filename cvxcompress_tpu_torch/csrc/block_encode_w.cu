// block_encode_w: the 128^3 forward wavelet + scale + quantize + tokenize
// split at x,z | y, in two launches.
//
// Replaces the TPU kernels of the JAX package's two-kernel 128^3 encode
// (CVX_FUSED_W=1): fused_compress.forward_xz (K16a,
// cvxcompress_tpu/ops/fused_compress.py:71, call :82, kernel _kernel_xz :59)
// and fused_compress.tokenize_fused_y (K16b, :144, call :178, kernel
// _kernel_ytok :100).  block_encode.cu splits the same encode at z | x,y;
// both keep the axis order z, x, y and the cascade of block_common.cuh
// (cascade_lines), so every coefficient is the same chain of f32 operations
// and the two encodes agree bit for bit.
//   1. block_fwd_xz: one CTA per (block, y).  It loads the (z, x) slab of
//      the volume (128 x-rows of 512 B at a stride), runs the z cascade,
//      then the x cascade on the slab in shared memory, and writes it back
//      to the x,z plane in volume order: (nz, ny, nx) f32.
//   2. block_encode_y: one CTA per (block, z) from an atomic ticket.  It
//      loads the (y, x) slice of the plane (128 rows of 512 B at a stride of
//      nx), runs the y cascade, writes the UNSCALED coefficients block-major
//      (z, y, x inside a block) and tokenizes the slice with the global
//      mulfac (slice_tokenize: descriptors, chunk byte counts, block sizes,
//      the zero-run carry by decoupled look-back).  The JAX kernel tokenizes
//      chunk-major tiles in grid order with a look-ahead into the next
//      tile's first z-layer; here the look-back on published slices takes
//      the carry's place, and the last cell of a slice is its successor's.
//
// What bounds it on an H100: bytes, like block_encode's pair (both make one
// 8 B per cell round trip through device memory between the launches); one
// 64.5 KiB slice per CTA, three CTAs per SM, float4 copies.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 3)
block_fwd_xz_kernel(const float* __restrict__ vol, int nx, int ny,
                    float* __restrict__ plane) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);
  const int64_t zstride = (int64_t)ny * nx;
  const int64_t base = o.z0 * zstride + (o.y0 + y) * nx + o.x0;

  build_tables(&tabs);
  load_slice(s, vol + base, zstride);
  __syncthreads();
  cascade_lines<1, PITCH, false>(s, tabs);  // z: along each column x
  __syncthreads();
  cascade_lines<PITCH, 1, false>(s, tabs);  // x: along each row z
  __syncthreads();
  store_slice(plane + base, zstride, s);
}

__global__ void __launch_bounds__(BT, 3)
block_encode_y_kernel(const float* __restrict__ plane, int nx, int ny,
                      float mulfac,
                      int* __restrict__ ticket, int* __restrict__ status,
                      float* __restrict__ coeffs, int32_t* __restrict__ desc,
                      int32_t* __restrict__ chunk_bytes,
                      int32_t* __restrict__ sizes,
                      float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  __shared__ int s_tile, s_carry, scan_buf[32];

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  build_tables(&tabs);
  __syncthreads();
  const int tile = s_tile;  // (block, z) in block-major, z-ascending order
  const int64_t blk = tile >> 7;
  const int z = tile & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);

  load_slice(s, plane + (o.z0 + z) * ny * (int64_t)nx + o.y0 * nx + o.x0, nx);
  __syncthreads();
  cascade_lines<1, PITCH, false>(s, tabs);  // y: along each column x
  __syncthreads();
  store_slice(coeffs + (int64_t)tile * SLICE, BB, s);
  slice_tokenize(s, mulfac, tile, status, desc, chunk_bytes, sizes, mulfacs,
                 scan_buf, &s_carry);
}

}  // namespace cvx

extern "C" int cvx_block_fwd_xz(const float* vol, int nx, int ny, int nz,
                                float* plane, void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_xz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_fwd_xz_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                        (cudaStream_t)stream>>>(vol, nx, ny, plane);
  return (int)cudaGetLastError();
}

// `scratch` holds 1 + nnn * 128 ints: the ticket and the slices' status.
extern "C" int cvx_block_encode_y(const float* plane, int nx, int ny,
                                  float mulfac, int64_t nnn,
                                  int* scratch, float* coeffs, int32_t* desc,
                                  int32_t* chunk_bytes, int32_t* sizes,
                                  float* mulfacs, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      block_encode_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e == cudaSuccess)
    e = reset_encode_counters(scratch, chunk_bytes, sizes, nnn, st);
  if (e != cudaSuccess) return (int)e;
  block_encode_y_kernel<<<(unsigned)(nnn * BB), BT, BSMEM, st>>>(
      plane, nx, ny, mulfac, scratch, scratch + 1, coeffs, desc,
      chunk_bytes, sizes, mulfacs);
  return (int)cudaGetLastError();
}
