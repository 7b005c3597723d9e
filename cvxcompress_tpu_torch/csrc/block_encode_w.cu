// block_encode_w: the 128^3 forward wavelet + scale + quantize + tokenize
// split at x,z | y, in two launches.
//
// Replaces the TPU kernels of the JAX package's two-kernel 128^3 encode
// (CVX_FUSED_W=1): fused_compress.forward_xz (K16a,
// cvxcompress_tpu/ops/fused_compress.py:71, call :82, kernel _kernel_xz :59)
// and fused_compress.tokenize_fused_y (K16b, :144, call :178, kernel
// _kernel_ytok :100).  block_encode.cu splits the same encode at z | x,y;
// both keep the axis order z, x, y and the products of block_common.cuh, so
// every coefficient is the same FMA chain over its 128 taps and the two
// encodes agree bit for bit.
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
// What bounds it on an H100: bytes, like block_encode's pair (the plane
// makes one more full round trip than z | x,y's block-major buffer, both
// 8 B per cell); the three 128-tap products (768 FLOP per cell) on the
// CUDA cores; one CTA of 132 KiB per SM.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 1)
block_fwd_xz_kernel(const float* __restrict__ vol, int nx, int ny,
                    const float* __restrict__ op_g, float* __restrict__ plane) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + MAT;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);
  const int64_t zstride = (int64_t)ny * nx;
  const int64_t base = o.z0 * zstride + (o.y0 + y) * nx + o.x0;

  load_slice(op, op_g, BB);
  load_slice(s, vol + base, zstride);
  __syncthreads();
  float acc[8][8];
  mm128<PITCH, 1, PITCH, 1>(op, s, acc);  // z: out[z'][x] = sum_z W[z'][z] s[z][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
  mm128<PITCH, 1, 1, PITCH>(s, op, acc);  // x: out[z][x'] = sum_x s[z][x] W[x'][x]
  store_tile(plane + base, zstride, acc);
}

__global__ void __launch_bounds__(BT, 1)
block_encode_y_kernel(const float* __restrict__ plane, int nx, int ny,
                      const float* __restrict__ op_g, float mulfac,
                      int* __restrict__ ticket, int* __restrict__ status,
                      float* __restrict__ coeffs, int32_t* __restrict__ desc,
                      int32_t* __restrict__ chunk_bytes,
                      int32_t* __restrict__ sizes,
                      float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + MAT;
  __shared__ int s_tile, s_carry, scan_buf[32];

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;  // (block, z) in block-major, z-ascending order
  const int64_t blk = tile >> 7;
  const int z = tile & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);

  load_slice(op, op_g, BB);
  load_slice(s, plane + (o.z0 + z) * ny * (int64_t)nx + o.y0 * nx + o.x0, nx);
  __syncthreads();
  float acc[8][8];
  mm128<PITCH, 1, PITCH, 1>(op, s, acc);  // y: out[y'][x] = sum_y W[y'][y] s[y][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
  const int64_t off = (int64_t)tile * SLICE;
  for (int i = threadIdx.x; i < SLICE; i += BT)
    coeffs[off + i] = s[(i >> 7) * PITCH + (i & (BB - 1))];
  slice_tokenize(s, mulfac, tile, status, desc, chunk_bytes, sizes, mulfacs,
                 scan_buf, &s_carry);
}

}  // namespace cvx

extern "C" int cvx_block_fwd_xz(const float* vol, int nx, int ny, int nz,
                                const float* op, float* plane, void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_xz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_fwd_xz_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                        (cudaStream_t)stream>>>(vol, nx, ny, op, plane);
  return (int)cudaGetLastError();
}

// `scratch` holds 1 + nnn * 128 ints: the ticket and the slices' status.
extern "C" int cvx_block_encode_y(const float* plane, int nx, int ny,
                                  const float* op, float mulfac, int64_t nnn,
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
      plane, nx, ny, op, mulfac, scratch, scratch + 1, coeffs, desc,
      chunk_bytes, sizes, mulfacs);
  return (int)cudaGetLastError();
}
