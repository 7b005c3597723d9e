// block_encode_local: the 128^3 encode with the local RMS, the two launches
// after block_fwd_z (block_encode.cu).
//
// Replaces the TPU kernels of fused_compress.tokenize_block_fused's local
// branch (cvxcompress_tpu/ops/fused_compress.py:422): K10a
// _kernel_block_casc_local (:312, call :487), K10b _kernel_scale_tok (:395,
// call :539), and K11 _kernel_block_local1 (:361, call :448), which computes
// the same function in one kernel.  On the TPU the split only dodged a
// Mosaic compile cliff.  On Hopper the constraint is another: the 8 MiB
// block does not fit on chip, and its mulfac needs every slice's
// coefficients before any slice can be tokenized.  So, after block_fwd_z:
//   1. block_casc_local: one CTA per (block, z) slice: the x and y cascades
//      (slice_xy, as block_encode_xy), the UNSCALED coefficients out in
//      place, and the slice's sum of squares in f64 (each thread its 64
//      cells in turn, then block_sum_f64) into partials[block * 128 + z].
//      No tokenize.
//   2. block_scale_tok: one CTA per slice, taken from an atomic ticket.  It
//      loads the slice's coefficients, adds its block's 128 partials in
//      slice order into the block's mulfac (local_mulfac in tokens.cuh; the
//      z = 0 slice writes the table entry), and tokenizes the slice with it
//      (slice_tokenize in block_common.cuh, the same tail and zero-run
//      look-back as block_encode_xy).  Every slice of a block shares the
//      block's mulfac, and a run ends at every block end, so K10b's
//      next-tile mulfac lookahead is not needed.
// No float atomics: the table is the same on every run and equals the
// plain version's (ops/quant.py local_rms) bit for bit.
// What bounds it on an H100: device-memory bytes.  block_casc_local, the
// slice in and the coefficients out (the two cascades of block_common.cuh
// cascade_lines, as block_encode_xy); block_scale_tok, reading the
// coefficients and writing the descriptors (8 bytes per cell) and the chunk
// counts.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 3)
block_casc_local_kernel(float* buf, double* __restrict__ partials) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  __shared__ double sum_buf[32];
  const int64_t tile = blockIdx.x;  // block * 128 + z
  const int64_t off = tile * SLICE;

  build_tables(&tabs);
  slice_xy(buf + off, tabs, s);
  store_slice(buf + off, BB, s);
  constexpr int PER = SLICE / BT;
  const int c0 = threadIdx.x * PER;
  double ss = 0.0;
  for (int i = 0; i < PER; ++i) {
    const int c = c0 + i;
    const double v = s[(c >> 7) * PITCH + (c & (BB - 1))];
    ss += v * v;  // exact square: an FMA contraction changes nothing
  }
  ss = block_sum_f64(ss, sum_buf);
  if (threadIdx.x == 0) partials[tile] = ss;
}

__global__ void __launch_bounds__(BT, 1)
block_scale_tok_kernel(const float* __restrict__ coeffs,
                       const double* __restrict__ partials, float scale,
                       int* __restrict__ ticket, int* __restrict__ status,
                       int32_t* __restrict__ desc,
                       int32_t* __restrict__ chunk_bytes,
                       int32_t* __restrict__ sizes,
                       float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) float s[];  // one padded slice
  __shared__ int s_tile, s_carry, scan_buf[32];
  __shared__ float s_mulfac;

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;  // (block, z) in block-major, z-ascending order
  const int64_t blk = tile >> 7;
  load_slice(s, coeffs + (int64_t)tile * SLICE, BB);
  if (threadIdx.x == 0) {
    double ss = 0.0;
    for (int z = 0; z < BB; ++z) ss += partials[blk * BB + z];
    s_mulfac = local_mulfac(ss, BB_CELLS, scale);
  }
  __syncthreads();
  slice_tokenize(s, s_mulfac, tile, status, desc, chunk_bytes, sizes,
                 mulfacs, scan_buf, &s_carry);
}

}  // namespace cvx

// `buf` (nnn, 2^21) f32 holds block_fwd_z's output and receives the
// coefficients; `partials` (nnn, 128) f64.
extern "C" int cvx_block_casc_local(float* buf, int64_t nnn, double* partials,
                                    void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_casc_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  block_casc_local_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                            (cudaStream_t)stream>>>(buf, partials);
  return (int)cudaGetLastError();
}

// `scratch` holds 1 + nnn * 128 ints: the ticket and the slices' status.
extern "C" int cvx_block_scale_tok(const float* coeffs,
                                   const double* partials, float scale,
                                   int64_t nnn, int* scratch, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes,
                                   float* mulfacs, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)MAT * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      block_scale_tok_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = reset_encode_counters(scratch, chunk_bytes, sizes, nnn, st);
  if (e != cudaSuccess) return (int)e;
  block_scale_tok_kernel<<<(unsigned)(nnn * BB), BT, smem, st>>>(
      coeffs, partials, scale, scratch, scratch + 1, desc, chunk_bytes, sizes,
      mulfacs);
  return (int)cudaGetLastError();
}
