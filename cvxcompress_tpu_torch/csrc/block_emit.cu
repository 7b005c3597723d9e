// block_emit: the block-ordered payload stream of min(128, cells)-cell
// chunks, for every geometry but 32^3.
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
// A lane per group of 8 cells, LPC = chunk / 8 lanes per chunk (16 for
// 128-cell chunks, 8 for the 64-cell chunks of an (8, 8, 1) block), so a
// warp takes 32 / LPC chunks.  A chunk whose byte count is 0 (all of a raw
// block's chunks are) costs one 4-byte read.  Otherwise each lane sums its
// cells' costs from the descriptors, an LPC-lane exclusive scan gives its
// offset in the chunk, and it writes its tokens at chunk_base[chunk] +
// offset, re-deriving values, classes and group modes from the unscaled
// coefficients and the block's entry of the (nnn,) mulfac table (emit_group
// in tokens.cuh, shared with emit_payload; one value repeated under the
// global RMS).  The descriptors are block-major; the coefficients are
// block-major too (the 128^3 and fused stripe encodes), or (template
// STRIPE) the stripe route's volume-order plane, read through the stripe
// map (stripe_map.cuh): a group of 8 cells is 8 consecutive, aligned floats
// of one plane row either way.
// Rows mode (template ROWS, cvx_block_emit_rows): the K7 role inside the
// JAX package's pack_compacted (rle_device.py:969-1001) and the patch pack
// (pack_active with K17).  The coefficients and descriptors come as gathered
// (n, 128) rows, row r holding chunk ids[r] (patch_extract.cu,
// tokenize_compact.cu); its tokens land at chunk_base[ids[r]] with the
// mulfac of the chunk's block, ids[r] >> lcpb, and a row whose chunk counts
// 0 bytes (a raw block's) writes nothing.  The stream equals the in-place
// modes' byte for byte.
// What bounds it on an H100: the chunk byte counts (4 B per chunk) and the
// coefficients and descriptors of the live chunks only; at a high ratio the
// launch itself.

#include "stripe_map.cuh"
#include "tokens.cuh"

namespace cvx {

constexpr int EMIT_WARPS = 8;

// `n` counts the chunks, or in ROWS mode the rows.
template <int LPC, bool STRIPE, bool ROWS>
__global__ void __launch_bounds__(EMIT_WARPS * 32)
block_emit_kernel(const float* __restrict__ coeffs,
                  const float* __restrict__ mulfacs,
                  const int32_t* __restrict__ desc,
                  const int32_t* __restrict__ chunk_bytes,
                  const int64_t* __restrict__ chunk_base,
                  const int32_t* __restrict__ ids, int64_t n, int lcpb,
                  StripeMap map, uint8_t* __restrict__ out) {
  constexpr int CW = 8 * LPC;  // cells per chunk
  const int lane = threadIdx.x & 31;
  const int64_t r =
      ((int64_t)blockIdx.x * EMIT_WARPS + (threadIdx.x >> 5)) * (32 / LPC) +
      lane / LPC;  // the chunk, or the row
  const int64_t chunk = !ROWS ? r : r < n ? ids[r] : 0;
  const bool live = r < n && chunk_bytes[chunk] != 0;
  if (!__any_sync(0xffffffffu, live)) return;  // uniform over the warp

  const int64_t cell = r * CW + (lane % LPC) * 8;
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
  for (int o = 1; o < LPC; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o, LPC);
    if ((lane % LPC) >= o) inc += n;
  }
  if (mine == 0) return;
  const int64_t blk = chunk >> lcpb;
  const int l = (int)(cell - (blk << (lcpb + (CW == 128 ? 7 : 6))));
  const float* src = ROWS ? coeffs + cell
                          : coeffs + map_origin<STRIPE>(map, blk) +
                                map_cell<STRIPE>(map, l);
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  const float cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  emit_group(out + chunk_base[chunk] + (inc - mine), cv, d, mulfacs[blk]);
}

// One CTA of EMIT_WARPS warps per EMIT_WARPS * 32 / LPC chunks or rows.
template <int LPC, bool STRIPE, bool ROWS = false>
static int launch_emit(const float* coeffs, const float* mulfacs,
                       const int32_t* desc, const int32_t* chunk_bytes,
                       const int64_t* chunk_base, const int32_t* ids, int64_t n,
                       int lcpb, StripeMap map, uint8_t* out, cudaStream_t st) {
  const int64_t per_cta = EMIT_WARPS * (32 / LPC);
  block_emit_kernel<LPC, STRIPE, ROWS>
      <<<(unsigned)((n + per_cta - 1) / per_cta), EMIT_WARPS * 32, 0, st>>>(
          coeffs, mulfacs, desc, chunk_bytes, chunk_base, ids, n, lcpb, map, out);
  return (int)cudaGetLastError();
}

}  // namespace cvx

// `lchunk` is log2 of the cells per chunk (7, or 6 for 64-cell blocks, which
// only the stripe route has), `lcpb` log2 of the chunks per block; `stripe`
// 0 reads block-major coefficients, 1 the volume-order plane through the map
// of the other arguments (stripe_map.cuh; they are ignored when `stripe` is
// 0).
extern "C" int cvx_block_emit(const float* coeffs, const float* mulfacs,
                              const int32_t* desc, const int32_t* chunk_bytes,
                              const int64_t* chunk_base, int64_t nchunks,
                              int lchunk, int lcpb, int stripe, int lbx,
                              int lby, int lbz, int64_t nbx, int64_t nby,
                              int64_t nxp, int64_t nyp, uint8_t* out,
                              void* stream) {
  using namespace cvx;
  if (nchunks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (stripe) {
    const StripeMap map = make_map(lbx, lby, lbz, nbx, nby, nxp, nyp);
    if (lchunk == 7)
      return launch_emit<16, true>(coeffs, mulfacs, desc, chunk_bytes,
                                   chunk_base, nullptr, nchunks, lcpb, map, out,
                                   st);
    if (lchunk == 6)
      return launch_emit<8, true>(coeffs, mulfacs, desc, chunk_bytes,
                                  chunk_base, nullptr, nchunks, lcpb, map, out,
                                  st);
  } else {
    const StripeMap map = make_map(lchunk + lcpb, 0, 0, 1, 1, 0, 0);
    if (lchunk == 7)
      return launch_emit<16, false>(coeffs, mulfacs, desc, chunk_bytes,
                                    chunk_base, nullptr, nchunks, lcpb, map,
                                    out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Rows mode: `nrows` gathered 128-cell chunk rows (coefficients `rows`,
// descriptors `drows`), row r holding chunk ids[r]; `lcpb` is log2 of the
// chunks per block.
extern "C" int cvx_block_emit_rows(const float* rows, const int32_t* drows,
                                   const int32_t* ids, int64_t nrows,
                                   const float* mulfacs,
                                   const int32_t* chunk_bytes,
                                   const int64_t* chunk_base, int lcpb,
                                   uint8_t* out, void* stream) {
  using namespace cvx;
  if (nrows == 0) return 0;
  return launch_emit<16, false, true>(rows, mulfacs, drows, chunk_bytes,
                                      chunk_base, ids, nrows, lcpb,
                                      make_map(7 + lcpb, 0, 0, 1, 1, 0, 0), out,
                                      (cudaStream_t)stream);
}
