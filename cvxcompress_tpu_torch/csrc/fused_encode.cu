// fused_encode: 32^3 forward wavelet + scale + quantize + tokenize.
//
// Replaces the TPU kernels tokenize_pallas.stripe_fused_tiles
// (cvxcompress_tpu/ops/tokenize_pallas.py:939, wrapped by
// stripe_fused_encode :1056): its global kernel _kernel_stripe_fused
// (:896), launched as `fused_encode`, and its local-RMS kernel
// _kernel_stripe_fused_local (:907), launched as `fused_encode_local`.
// One template; one persistent CTA of 512 threads per SM walks the blocks
// blockIdx.x, + gridDim.x, ...  For each block:
//   1. the block arrives in shared memory (common.cuh's swizzled layout) in
//      two halves of 16 z-planes, zero past the volume's edges: by TMA tile
//      copies (cp.async.bulk.tensor of a 32 x 32 x 16 box, each finished on
//      its mbarrier) where the volume allows them (16-byte aligned, nx % 4
//      == 0), else by 4-byte cp.async with zero-fill, one commit group a
//      half: the route is chosen by shape and alignment, and both write the
//      same bytes;
//   2. the x and y cascades in place, a warp's own z-plane at a time (a
//      thread's whole 32-point lines in its registers, cascade.cuh), the
//      first half's while the second half arrives; then the z cascades in
//      registers, whose lines go out as the UNSCALED coefficients,
//      block-major, 128 bytes per warp and row (raw-fallback blocks store
//      them, and the emit kernel re-derives each token), and back to the
//      buffer;
//   3. the block's mulfac: the given global one, or (local RMS) 1/(rms *
//      scale) of the block's own coefficients, their squares summed in f64
//      in a fixed order (each thread its two z-lines from z = 0, then
//      block_sum_f64), as ops/quant.py `local_rms` repeats; it goes to the
//      (nnn,) table in both modes;
//   4. the tokenize from the buffer, row by row (common.cuh
//      tokenize_carries, tokenize_half): fv = coeff * mulfac (one f32
//      rounding), cvttps, the group-of-8 modes from ballots over 8 lanes,
//      the zero runs from each row's last non-zero cell (a ballot) and a
//      block-wide max-scan over the rows; the next block's first half is
//      copied in as soon as this block's is tokenized, its second half
//      after the block;
//   5. per cell the descriptor cost | run_end << 3 | run_len << 4, stored
//      128 bytes per warp and row; per block the payload size and the raw
//      flag (size > 4*cells); per 128-cell chunk its byte count (0 in a raw
//      block), from each warp's per-plane sums in 512 shared slots (common.cuh
//      tokenize_half) stored as one coalesced 1 KiB row, so that the emit
//      (block_emit.cu) reads only the live chunks, as on every other route;
//      the chunks' sum is the block's size.
// What bounds it on an H100: the 128 KiB read and 257 KiB written per block
// (0.17 ms at A); the cascades' ~2.2 M separately rounded f32 operations
// per block (no FMA: native's parity order) take about 0.11 ms at A, the
// tokenize's integer work about as long.  One 128 KiB block fills an SM's
// shared memory, so the copies overlap the work only half a block at a
// time.  (A tokenize unrolled over the registers that hold the z-lines
// would free the buffer before the z cascade, but the kernel's code then
// outgrows the instruction cache and the kernel takes twice as long:
// PERF.md.)

#include <cstring>

#include "common.cuh"

namespace cvx {

// `factor`: the global mulfac, or with LOCAL the scale.  `tma`: the copy
// route (uniform); `tmap` describes the volume when it is set.
template <bool LOCAL>
__global__ void __launch_bounds__(THREADS, 1)
fused_encode_kernel(const __grid_constant__ CUtensorMap tmap, int tma,
                    const float* __restrict__ vol, int nx, int ny, int nz,
                    int64_t nnn, float factor, float* __restrict__ coeffs,
                    int32_t* __restrict__ desc, int32_t* __restrict__ chunk_bytes,
                    int32_t* __restrict__ sizes, uint8_t* __restrict__ raw,
                    float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* s = block_buffer(dsmem);
  __shared__ uint64_t full[2];  // the TMA copies' barriers, one a half
  __shared__ int rows[B * B];   // tokenize_carries' row summaries
  __shared__ __align__(16) int halves[2 * CHUNKS_PER_BLOCK];  // tokenize_half's sums
  __shared__ int scan_buf[32];
  __shared__ double sum_buf[32];

  auto load = [&](int64_t blk, int h) {
    const Origin o = origin32(blk, nx, ny);
    if (!tma)
      load_async4(s, vol, nx, ny, nz, o, h);
    else if (threadIdx.x == 0)
      load_tma(s, &tmap, o, h, smem_addr(&full[h]));
  };
  // half h of the block in place: every thread has seen its copy complete
  auto wait = [&](int h, unsigned parity) {
    if (tma) {
      mbar_wait(smem_addr(&full[h]), parity);
    } else {
      if (h == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
  };

  if (tma && threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]));
    mbar_init(smem_addr(&full[1]));
  }
  __syncthreads();
  load(blockIdx.x, 0);
  load(blockIdx.x, 1);
  unsigned parity = 0;
  for (int64_t blk = blockIdx.x; blk < nnn; blk += gridDim.x, parity ^= 1) {
    wait(0, parity);
    passes_xy<false>(s, 0);
    wait(1, parity);
    passes_xy<false>(s, 1);
    __syncthreads();
    float v[LINES][B];
    read_z(s, v);
#pragma unroll
    for (int i = 0; i < LINES; ++i) reg_cascade<false>(v[i]);
    store_lines(v, coeffs + blk * CELLS);
    write_z(s, v);  // each thread's own lines: no barrier since read_z

    float mulfac = factor;
    if (LOCAL) {
      double ss = 0.0;
#pragma unroll
      for (int i = 0; i < LINES; ++i)
#pragma unroll
        for (int z = 0; z < B; ++z) {
          const double d = v[i][z];
          ss += d * d;  // exact square: an FMA contraction changes nothing
        }
      mulfac = local_mulfac(block_sum_f64(ss, sum_buf), CELLS, factor);
    }
    __syncthreads();
    tokenize_carries(s, mulfac, rows, scan_buf);
    int32_t* dblk = desc + blk * CELLS;
    const bool more = blk + gridDim.x < nnn;
    tokenize_half(s, mulfac, rows, 0, dblk, halves);
    fence_proxy_async();  // this block's accesses before the next one's copy
    __syncthreads();
    if (more) load(blk + gridDim.x, 0);
    tokenize_half(s, mulfac, rows, 1, dblk, halves);
    __syncthreads();  // halves complete
    // the chunk counts out, and their sum the block's size; a raw block's
    // counts are zeroed after the barrier below by the thread that decides
    const int count =
        threadIdx.x < CHUNKS_PER_BLOCK ? chunk_cost(halves, threadIdx.x) : 0;
    if (threadIdx.x < CHUNKS_PER_BLOCK)
      chunk_bytes[blk * CHUNKS_PER_BLOCK + threadIdx.x] = count;
    int size;
    block_exclusive_scan(count, 0, SumOp(), scan_buf, &size);
    fence_proxy_async();
    __syncthreads();
    if (more) load(blk + gridDim.x, 1);
    if (threadIdx.x == 0) {
      const bool is_raw = size > 4 * CELLS;
      sizes[blk] = is_raw ? 4 * CELLS : size;
      raw[blk] = is_raw;
      mulfacs[blk] = mulfac;
      if (is_raw)
        for (int j = 0; j < CHUNKS_PER_BLOCK; ++j) chunk_bytes[blk * CHUNKS_PER_BLOCK + j] = 0;
    }
  }
}

// The TMA route takes a 16-byte aligned volume whose rows are a multiple of
// 16 bytes (nx % 4 == 0); every other volume the 4-byte cp.async route.
static bool tma_route(const float* vol, int nx) {
  return reinterpret_cast<uintptr_t>(vol) % 16 == 0 && nx % 4 == 0;
}

template <bool LOCAL>
static int launch_fused_encode(const float* vol, int nx, int ny, int nz, float factor,
                               float* coeffs, int32_t* desc, int32_t* chunk_bytes,
                               int32_t* sizes, uint8_t* raw, float* mulfacs,
                               void* stream) {
  const int64_t nnn = (int64_t)((nx + B - 1) / B) * ((ny + B - 1) / B) *
                      ((nz + B - 1) / B);
  if (nnn == 0) return 0;
  CUtensorMap tmap;
  std::memset(&tmap, 0, sizeof tmap);
  const bool tma = tma_route(vol, nx);
  if (tma) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny, (cuuint64_t)nz};
    const cuuint64_t strides[2] = {(cuuint64_t)nx * 4, (cuuint64_t)nx * ny * 4};
    const cuuint32_t box[3] = {B, B, HALF}, one[3] = {1, 1, 1};
    if (enc(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)vol, dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(fused_encode_kernel<LOCAL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(nnn < sms ? nnn : sms);
  fused_encode_kernel<LOCAL><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tmap, tma, vol, nx, ny, nz, nnn, factor, coeffs, desc, chunk_bytes, sizes, raw,
      mulfacs);
  return (int)cudaGetLastError();
}

}  // namespace cvx

extern "C" int cvx_fused_encode(const float* vol, int nx, int ny, int nz, float mulfac,
                                float* coeffs, int32_t* desc, int32_t* chunk_bytes,
                                int32_t* sizes, uint8_t* raw, float* mulfacs,
                                void* stream) {
  return cvx::launch_fused_encode<false>(vol, nx, ny, nz, mulfac, coeffs, desc,
                                         chunk_bytes, sizes, raw, mulfacs, stream);
}

extern "C" int cvx_fused_encode_local(const float* vol, int nx, int ny, int nz,
                                      float scale, float* coeffs, int32_t* desc,
                                      int32_t* chunk_bytes, int32_t* sizes,
                                      uint8_t* raw, float* mulfacs, void* stream) {
  return cvx::launch_fused_encode<true>(vol, nx, ny, nz, scale, coeffs, desc,
                                        chunk_bytes, sizes, raw, mulfacs, stream);
}

extern "C" const char* cvx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
