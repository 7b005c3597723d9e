// block_encode: 128^3 forward wavelet + scale + quantize + tokenize, in two
// launches.
//
// Replaces the TPU kernel fused_compress.tokenize_block_fused, global branch
// (cvxcompress_tpu/ops/fused_compress.py:422, call :562; kernel
// _kernel_block :291 with the tokenize tail _block_tokenize_tail :259).
// There the whole 8 MiB block sits in VMEM for one grid step.  On Hopper it
// does not fit on chip, so the cascades split into two passes through
// device memory, in _kernel_block's axis order z, then x, then y:
//   1. block_fwd_z: one CTA per (block, y).  It loads the (z, x) slab of
//      the volume (128 x-rows of 512 B at a stride), runs the z cascade and
//      writes the slab into the coefficient buffer, block-major (z, y, x).
//   2. block_encode_xy: one CTA per (block, z), on the z-slice's 16,384
//      contiguous cells: the x cascade, then the y cascade (slice_xy); the
//      UNSCALED coefficients go out (in place: the CTA holds its slice in
//      shared memory before it writes); then the slice's tokenize with the
//      global mulfac (slice_tokenize in block_common.cuh, shared with
//      block_encode_y: descriptors, chunk byte counts, block
//      sizes, and the zero-run carry across slices by decoupled look-back
//      on an atomic ticket).  The raw-fallback decision (size > 4 * cells)
//      follows in the wrapper.
//
// What bounds it on an H100: device-memory bytes.  Each pass runs the
// multi-level 7/9 cascade itself (cascade_lines in block_common.cuh, ~23
// FLOP per cell and axis in the native parity cascade's operation order);
// a CTA holds one 64.5 KiB slice, so three CTAs share an SM and one CTA's
// float4 copies overlap another's cascades.  block_encode_xy's tokenize
// (the look-back and the descriptors, 4 B per cell) is the larger half.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 3)
block_fwd_z_kernel(const float* __restrict__ vol, int nx, int ny,
                   float* __restrict__ tmp) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);

  build_tables(&tabs);
  const int64_t zstride = (int64_t)ny * nx;
  load_slice(s, vol + o.z0 * zstride + (o.y0 + y) * nx + o.x0, zstride);
  __syncthreads();
  cascade_lines<1, PITCH, false>(s, tabs);  // z: along each column x
  __syncthreads();
  store_slice(tmp + blk * BB_CELLS + y * BB, SLICE, s);
}

__global__ void __launch_bounds__(BT, 3)
block_encode_xy_kernel(const float* src, float mulfac,
                       int* __restrict__ ticket, int* __restrict__ status,
                       float* coeffs, int32_t* __restrict__ desc,
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
  const int64_t off = (int64_t)tile * SLICE;

  slice_xy(src + off, tabs, s);
  store_slice(coeffs + off, BB, s);
  slice_tokenize(s, mulfac, tile, status, desc, chunk_bytes, sizes, mulfacs,
                 scan_buf, &s_carry);
}

}  // namespace cvx

extern "C" int cvx_block_fwd_z(const float* vol, int nx, int ny, int nz,
                               float* tmp, void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_fwd_z_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                       (cudaStream_t)stream>>>(vol, nx, ny, tmp);
  return (int)cudaGetLastError();
}

// `scratch` holds 1 + nnn * 128 ints: the ticket and the slices' status.
extern "C" int cvx_block_encode_xy(const float* src, float mulfac, int64_t nnn,
                                   int* scratch, float* coeffs, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes,
                                   float* mulfacs, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      block_encode_xy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e == cudaSuccess)
    e = reset_encode_counters(scratch, chunk_bytes, sizes, nnn, st);
  if (e != cudaSuccess) return (int)e;
  block_encode_xy_kernel<<<(unsigned)(nnn * BB), BT, BSMEM, st>>>(
      src, mulfac, scratch, scratch + 1, coeffs, desc, chunk_bytes, sizes,
      mulfacs);
  return (int)cudaGetLastError();
}
