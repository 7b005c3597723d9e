// block_emit: the block-ordered payload stream of 128-cell chunks.
//
// Replaces the TPU kernel pack_pallas.pack_staging
// (cvxcompress_tpu/ops/pack_pallas.py:515, call :528, kernel _kernel :142),
// with the XLA around it in rle_device.pack_active (rle_device.py:401-518)
// and the host squeeze (_subrow_squeeze :946, assemble_payload_sparse
// :1097).  A TPU lane cannot store a byte at a computed address, so the
// Pallas kernel spreads the five token byte planes into (A, 640) staging
// with one-hot matmuls and front-packs them with 10 log-shift rounds.  A GPU
// can, so the whole stage is one kernel writing the final stream.
//
// One warp per two chunks, a half-warp per chunk, a lane per group of 8
// cells.  A chunk whose byte count is 0 (all of a raw block's chunks are)
// costs one 4-byte read.  Otherwise each lane sums its cells' costs from the
// descriptors, a half-warp exclusive scan gives its offset in the chunk, and
// it writes its tokens at chunk_base[chunk] + offset, re-deriving values,
// classes and group modes from the unscaled coefficients and the block's
// entry of the (nnn,) mulfac table (emit_group in tokens.cuh, shared with
// emit_payload; one value repeated under the global RMS).
// What bounds it on an H100: the chunk byte counts (4 B per 128 cells) and
// the coefficients and descriptors of the live chunks only; at a high ratio
// the launch itself.

#include "block_common.cuh"

namespace cvx {

constexpr int EMIT_WARPS = 8;

__global__ void __launch_bounds__(EMIT_WARPS * 32)
block_emit_kernel(const float* __restrict__ coeffs,
                  const float* __restrict__ mulfacs,
                  const int32_t* __restrict__ desc,
                  const int32_t* __restrict__ chunk_bytes,
                  const int64_t* __restrict__ chunk_base, int64_t nchunks,
                  uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      ((int64_t)blockIdx.x * EMIT_WARPS + (threadIdx.x >> 5)) * 2 + (lane >> 4);
  const bool live = chunk < nchunks && chunk_bytes[chunk] != 0;
  if (!__any_sync(0xffffffffu, live)) return;  // uniform over the warp

  const int64_t cell = chunk * 128 + (lane & 15) * 8;
  int32_t d[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int mine = 0;
  if (live) {
    const int4 d0 = *reinterpret_cast<const int4*>(desc + cell);
    const int4 d1 = *reinterpret_cast<const int4*>(desc + cell + 4);
    d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
    d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
#pragma unroll
    for (int l = 0; l < 8; ++l) mine += d[l] & 7;
  }
  int inc = mine;
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o, 16);
    if ((lane & 15) >= o) inc += n;
  }
  if (mine == 0) return;
  const float4 a = *reinterpret_cast<const float4*>(coeffs + cell);
  const float4 b = *reinterpret_cast<const float4*>(coeffs + cell + 4);
  const float cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  emit_group(out + chunk_base[chunk] + (inc - mine), cv, d,
             mulfacs[chunk / (BB_CELLS / 128)]);
}

}  // namespace cvx

extern "C" int cvx_block_emit(const float* coeffs, const float* mulfacs,
                              const int32_t* desc, const int32_t* chunk_bytes,
                              const int64_t* chunk_base, int64_t nchunks,
                              uint8_t* out, void* stream) {
  using namespace cvx;
  if (nchunks == 0) return 0;
  const int64_t per_cta = 2 * EMIT_WARPS;
  block_emit_kernel<<<(unsigned)((nchunks + per_cta - 1) / per_cta),
                      EMIT_WARPS * 32, 0, (cudaStream_t)stream>>>(
      coeffs, mulfacs, desc, chunk_bytes, chunk_base, nchunks, out);
  return (int)cudaGetLastError();
}
