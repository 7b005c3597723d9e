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
// One persistent CTA of 512 threads per SM walks the blocks blockIdx.x,
// + gridDim.x, ...  For each block: its 256 chunk rows arrive in shared
// memory (common.cuh's swizzled layout) by 16-byte cp.async in two halves
// of 16 z-planes, zero-filled for an all-zero chunk, the same copy in both
// modes (only the row index differs; the chunk-sparse map of the next
// block is read ahead); the x and y inverse cascades in place (cascade.cuh,
// a thread's whole lines in its registers), the first half's while the
// second half arrives; each thread reads its two z-lines into registers,
// which frees the buffer for the next block's copy; the z cascades run in
// registers and the volume goes out from there, clipped at the edges, 128
// bytes per warp and row.  Every operation is the native
// parity cascade's, so the volume equals native's parity decompress
// (`cvx_decompress_inplace_parity_th`) bit for bit.
// What bounds it on an H100: the 128 KiB each block writes and, in the
// dense mode, the 128 KiB each block reads (0.11 ms at A); the cascades'
// ~2.2 M f32 operations per block take about as long.

#include "common.cuh"

namespace cvx {

__global__ void __launch_bounds__(THREADS, 1)
fused_inverse_kernel(const float* __restrict__ rows, int64_t nrows,
                     const int32_t* __restrict__ invmap, int nx, int ny, int nz,
                     int64_t nnn, float* __restrict__ vol) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* s = block_buffer(dsmem);
  __shared__ uint32_t chunk_rows[CHUNKS_PER_BLOCK];  // the next block's invmap
  const int lane = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);

  // chunk-sparse: the next block's chunk rows into shared memory, read at
  // the top of an iteration so the copies need not wait for them
  auto fetch_map = [&](int64_t blk) {
    if (invmap != nullptr && threadIdx.x < CHUNKS_PER_BLOCK && blk < nnn)
      chunk_rows[threadIdx.x] = (uint32_t)invmap[blk * CHUNKS_PER_BLOCK + threadIdx.x];
  };
  // thread t moves the 16-byte quarters p = t + 512 i of the block's half
  // h (i in [8h, 8h + 8)): x-row p / 8 (chunk p / 32), quarter p % 8; one
  // commit group
  auto load = [&](int64_t blk, int h) {
    constexpr int PER_HALF = CELLS / 8 / THREADS;
#pragma unroll
    for (int i = PER_HALF * h; i < PER_HALF * (h + 1); ++i) {
      const int p = threadIdx.x + THREADS * i, r = p >> 3, k = p & 7;
      const float* src = rows + blk * CELLS + 4 * p;
      bool valid = true;
      if (invmap != nullptr) {
        const uint32_t row = chunk_rows[r >> 2];
        valid = (int64_t)row < nrows;
        src = valid ? rows + (int64_t)row * CHUNK + 4 * (p & 31) : rows;
      }
      cp_async<16>(s + (r << 5) + ((k ^ (r & 7)) << 2), src, valid);
    }
    cp_async_commit();
  };

  fetch_map(blockIdx.x);
  __syncthreads();
  load(blockIdx.x, 0);
  load(blockIdx.x, 1);
  for (int64_t blk = blockIdx.x; blk < nnn; blk += gridDim.x) {
    cp_async_wait<1>();
    __syncthreads();  // also: every copy has read chunk_rows
    fetch_map(blk + gridDim.x);
    passes_xy<true>(s, 0);
    cp_async_wait<0>();
    __syncthreads();
    passes_xy<true>(s, 1);
    __syncthreads();
    float v[LINES][B];
    read_z(s, v);
    __syncthreads();
    if (blk + gridDim.x < nnn) {
      load(blk + gridDim.x, 0);
      load(blk + gridDim.x, 1);
    }
#pragma unroll
    for (int i = 0; i < LINES; ++i) reg_cascade<true>(v[i]);
    const Origin o = origin32(blk, nx, ny);
    const int gx = o.x0 + lane;
#pragma unroll
    for (int i = 0; i < LINES; ++i) {
      const int gy = o.y0 + y0 + i;
      if (gx >= nx || gy >= ny) continue;
      float* dst = vol + ((int64_t)o.z0 * ny + gy) * nx + gx;
#pragma unroll
      for (int z = 0; z < B; ++z)
        if (o.z0 + z < nz) dst[(int64_t)z * ny * nx] = v[i][z];
    }
  }
}

}  // namespace cvx

extern "C" int cvx_fused_inverse(const float* rows, int64_t nrows,
                                 const int32_t* invmap, int nx, int ny, int nz,
                                 float* vol, void* stream) {
  using namespace cvx;
  const int64_t nnn = (int64_t)((nx + B - 1) / B) * ((ny + B - 1) / B) *
                      ((nz + B - 1) / B);
  if (nnn == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(nnn < sms ? nnn : sms);
  fused_inverse_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      rows, nrows, invmap, nx, ny, nz, nnn, vol);
  return (int)cudaGetLastError();
}
