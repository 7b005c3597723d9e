// fused_inverse: block-major coefficients -> 32^3 inverse wavelet -> volume.
//
// Replaces the TPU kernel fused_inverse.stripe_fused_inverse
// (cvxcompress_tpu/ops/fused_inverse.py:128), together with the XLA
// sparse-to-plane expand in front of it (ops/codec.py:1040-1068).  Two
// input modes:
// - dense (invmap == nullptr): rows is the whole block-major buffer
//   (nnn*256, 128), as the device entropy decoder writes it;
// - chunk-sparse: what the host decode uploads (codec.sparse_chunks), the
//   non-zero 128-cell chunks as rows (nrows, 128) and invmap (nnn*256,),
//   each chunk's row, where any index >= nrows stands for an all-zero chunk.
//
// One CTA per block: gather the block's 256 chunk rows into shared memory
// (zeros for all-zero chunks), run the x, y and z inverse operators in f32,
// and write the block into the (nz, ny, nx) volume, clipped at the edges.
// What bounds it on an H100: the 3.1 M FMA per block from shared memory by
// one resident CTA per SM, then the 128 KiB each block writes and, in the
// dense mode, the 128 KiB each block reads.

#include "common.cuh"

namespace cvx {

__global__ void __launch_bounds__(THREADS, 1)
fused_inverse_kernel(const float* __restrict__ rows, int64_t nrows,
                     const int32_t* __restrict__ invmap,
                     const float* __restrict__ op_g, int nx, int ny, int nz,
                     float* __restrict__ vol) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + B * B;

  const int nbx = (nx + B - 1) / B, nby = (ny + B - 1) / B;
  const int64_t blk = blockIdx.x;
  const int ix = (int)(blk % nbx);
  const int iy = (int)((blk / nbx) % nby);
  const int iz = (int)(blk / ((int64_t)nbx * nby));
  const int x0 = ix * B, y0 = iy * B, z0 = iz * B;

  for (int i = threadIdx.x; i < B * B; i += blockDim.x) op[i] = op_g[i];
  if (invmap == nullptr) {
    const float* src = rows + blk * CELLS;
    for (int c = threadIdx.x; c < CELLS; c += blockDim.x)
      s[sidx_flat(c)] = src[c];
  } else {
    const int32_t* imap = invmap + blk * CHUNKS_PER_BLOCK;
    for (int c = threadIdx.x; c < CELLS; c += blockDim.x) {
      const uint32_t r = (uint32_t)imap[c / CHUNK];
      s[sidx_flat(c)] =
          (int64_t)r < nrows ? rows[(int64_t)r * CHUNK + (c % CHUNK)] : 0.0f;
    }
  }
  __syncthreads();
  transform_axis(s, op, 0);
  __syncthreads();
  transform_axis(s, op, 1);
  __syncthreads();
  transform_axis(s, op, 2);
  __syncthreads();

  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) {
    const int z = c >> 10, y = (c >> 5) & 31, x = c & 31;
    const int gz = z0 + z, gy = y0 + y, gx = x0 + x;
    if (gz < nz && gy < ny && gx < nx)
      vol[((int64_t)gz * ny + gy) * nx + gx] = s[sidx(z, y, x)];
  }
}

}  // namespace cvx

extern "C" int cvx_fused_inverse(const float* rows, int64_t nrows,
                                 const int32_t* invmap, const float* op,
                                 int nx, int ny, int nz, float* vol,
                                 void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      fused_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)((nx + B - 1) / B) * ((ny + B - 1) / B) *
                      ((nz + B - 1) / B);
  fused_inverse_kernel<<<(unsigned)nnn, THREADS, SMEM_BYTES,
                         (cudaStream_t)stream>>>(rows, nrows, invmap, op, nx,
                                                 ny, nz, vol);
  return (int)cudaGetLastError();
}
