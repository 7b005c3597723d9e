// fused_encode: 32^3 forward wavelet + scale + quantize + tokenize.
//
// Replaces the TPU kernel tokenize_pallas.stripe_fused_tiles
// (cvxcompress_tpu/ops/tokenize_pallas.py:939, wrapped by
// stripe_fused_encode :1056).  One CTA per 32^3 block:
//   1. read the block from the (nz, ny, nx) volume, zero-padding the edges,
//      into shared memory (128 KiB + pad, dynamic shared memory);
//   2. x, y, z cascades as 32x32 f32 operators (no TF32, no tensor cores);
//   3. write the UNSCALED coefficients block-major (raw-fallback blocks
//      store them, and the emit kernel re-derives each token from them);
//   4. fv = coeff * mulfac (one f32 rounding, oracle/rle.py:63), cvttps
//      quantize, classes, group-of-8 modes, and the zero runs as a
//      block-wide max-scan of "last non-zero cell" (reset at block start);
//   5. per cell the descriptor cost | run_end << 3 | run_len << 4, per block
//      the payload size and the raw flag (size > 4*cells).
// What bounds it on an H100: the 3 x 1024 32-tap dot products per block
// (3.1 M FMA) issued from shared memory by one resident CTA per SM (the
// 132 KiB block leaves room for one), then the 256 KiB of coefficients and
// descriptors each block writes.  The design keeps the block in shared
// memory from load to tokenize, so the volume is read once and nothing
// between the transform and the tokenizer touches device memory.

#include "common.cuh"

namespace cvx {

__global__ void __launch_bounds__(THREADS, 1)
fused_encode_kernel(const float* __restrict__ vol, int nx, int ny, int nz,
                    const float* __restrict__ op_g, float mulfac,
                    float* __restrict__ coeffs, int32_t* __restrict__ desc,
                    int32_t* __restrict__ sizes, uint8_t* __restrict__ raw) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;          // B*B forward operator
  float* s = smem + B * B;   // padded block
  __shared__ int scan_buf[32];

  const int nbx = (nx + B - 1) / B, nby = (ny + B - 1) / B;
  const int64_t blk = blockIdx.x;
  const int ix = (int)(blk % nbx);
  const int iy = (int)((blk / nbx) % nby);
  const int iz = (int)(blk / ((int64_t)nbx * nby));
  const int x0 = ix * B, y0 = iy * B, z0 = iz * B;

  for (int i = threadIdx.x; i < B * B; i += blockDim.x) op[i] = op_g[i];
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) {
    const int z = c >> 10, y = (c >> 5) & 31, x = c & 31;
    const int gz = z0 + z, gy = y0 + y, gx = x0 + x;
    float v = 0.0f;
    if (gz < nz && gy < ny && gx < nx)
      v = vol[((int64_t)gz * ny + gy) * nx + gx];
    s[sidx(z, y, x)] = v;
  }
  __syncthreads();
  transform_axis(s, op, 0);
  __syncthreads();
  transform_axis(s, op, 1);
  __syncthreads();
  transform_axis(s, op, 2);
  __syncthreads();

  float* cblk = coeffs + blk * CELLS;
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x)
    cblk[c] = s[sidx_flat(c)];

  // tokenize: thread t owns cells [64t, 64t + 64), eight whole groups
  const int c0 = threadIdx.x * CELLS_PER_THREAD;
  uint64_t nonzero = 0;
  for (int i = 0; i < CELLS_PER_THREAD; ++i) {
    const int32_t v = cvtt(__fmul_rn(s[sidx_flat(c0 + i)], mulfac));
    nonzero |= (uint64_t)(v != 0) << i;
  }
  const int last_local =
      nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
  const bool next_zero =
      c0 + CELLS_PER_THREAD < CELLS &&
      cvtt(__fmul_rn(s[sidx_flat(c0 + CELLS_PER_THREAD)], mulfac)) == 0;
  int unused;
  int last = block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &unused);

  int total_cost = 0;
  int32_t* dblk = desc + blk * CELLS;
  for (int g = 0; g < CELLS_PER_THREAD / 8; ++g) {
    int32_t iv[8];
#pragma unroll
    for (int l = 0; l < 8; ++l)
      iv[l] = cvtt(__fmul_rn(s[sidx_flat(c0 + 8 * g + l)], mulfac));
    const int mode = group_mode(iv);
    int32_t d[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int i = 8 * g + l;
      const int c = c0 + i;
      if (iv[l] != 0) {
        last = c;
        d[l] = value_cost(mode, l, iv[l]);
      } else {
        const bool nz_next =
            i + 1 < CELLS_PER_THREAD ? ((nonzero >> (i + 1)) & 1) != 0
                                     : !next_zero;
        const bool run_end = nz_next;  // block end also ends the run
        const int32_t len = c - last;
        const int cst = run_end ? run_cost(len) : 0;
        d[l] = cst | ((int)run_end << 3) |
               ((len < MAX_RUN24 ? len : MAX_RUN24) << 4);
      }
      total_cost += d[l] & 7;
    }
    int4* dst = reinterpret_cast<int4*>(dblk + c0 + 8 * g);
    dst[0] = make_int4(d[0], d[1], d[2], d[3]);
    dst[1] = make_int4(d[4], d[5], d[6], d[7]);
  }
  int size;
  block_exclusive_scan(total_cost, 0, SumOp(), scan_buf, &size);
  if (threadIdx.x == 0) {
    const bool is_raw = size > 4 * CELLS;
    sizes[blk] = is_raw ? 4 * CELLS : size;
    raw[blk] = is_raw;
  }
}

}  // namespace cvx

extern "C" int cvx_fused_encode(const float* vol, int nx, int ny, int nz,
                                const float* op, float mulfac, float* coeffs,
                                int32_t* desc, int32_t* sizes, uint8_t* raw,
                                void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      fused_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)((nx + B - 1) / B) * ((ny + B - 1) / B) *
                      ((nz + B - 1) / B);
  fused_encode_kernel<<<(unsigned)nnn, THREADS, SMEM_BYTES,
                        (cudaStream_t)stream>>>(vol, nx, ny, nz, op, mulfac,
                                                coeffs, desc, sizes, raw);
  return (int)cudaGetLastError();
}

extern "C" const char* cvx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
