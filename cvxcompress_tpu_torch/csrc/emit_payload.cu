// emit_payload: the block-ordered payload stream, one pass.
//
// Replaces the TPU kernels pack_pallas.pack_staging_seg
// (cvxcompress_tpu/ops/pack_pallas.py:479, byte planes + per-segment
// log-shift front-pack) and pack_pallas.tile_compact (:605, log-shift tile
// compaction), together with the XLA gathers and merges around them in
// rle_device.pack_active_stripe_seg (rle_device.py:547-764).  On the TPU,
// variable-length packing has to be built from monotone lane shifts; a GPU
// stores bytes at computed addresses, so the whole stage is one kernel.
//
// One CTA per block (raw-fallback blocks exit at once: the host splices
// their coefficients in).  Thread t owns cells [64t, 64t + 64): it sums
// their token costs from the descriptors, a block-wide exclusive scan gives
// its byte offset, and it writes each token's bytes at
// base[block] + offset, re-deriving values, classes and group modes from
// the unscaled coefficients and the block's mulfac exactly as fused_encode
// did.  The mulfac comes from the (nnn,) table fused_encode wrote: one
// value repeated under the global RMS, each block's own under the local
// RMS, the same f32 value the tokenize used.
// What bounds it on an H100: reading the 256 KiB of coefficients and
// descriptors per block (the stream it writes is ~1/1000 of that at the
// reference CI config); each thread reads 64 consecutive cells with 16-byte
// loads, so a warp's request spans 32 separate segments.

#include "common.cuh"

namespace cvx {

__global__ void __launch_bounds__(THREADS)
emit_payload_kernel(const float* __restrict__ coeffs,
                    const float* __restrict__ mulfacs,
                    const int32_t* __restrict__ desc,
                    const int64_t* __restrict__ base,
                    const uint8_t* __restrict__ raw,
                    uint8_t* __restrict__ out) {
  __shared__ int scan_buf[32];
  const int64_t blk = blockIdx.x;
  if (raw[blk]) return;  // uniform over the CTA
  const int c0 = threadIdx.x * CELLS_PER_THREAD;
  const int32_t* dblk = desc + blk * CELLS + c0;
  const float* cblk = coeffs + blk * CELLS + c0;
  const float mulfac = mulfacs[blk];

  int mine = 0;
  for (int i = 0; i < CELLS_PER_THREAD; i += 4) {
    const int4 d = *reinterpret_cast<const int4*>(dblk + i);
    mine += (d.x & 7) + (d.y & 7) + (d.z & 7) + (d.w & 7);
  }
  int unused;
  const int off = block_exclusive_scan(mine, 0, SumOp(), scan_buf, &unused);
  if (mine == 0) return;  // after the scan's barriers
  uint8_t* p = out + base[blk] + off;

  for (int g = 0; g < CELLS_PER_THREAD / 8; ++g) {
    int32_t d[8];
    const float4 a = *reinterpret_cast<const float4*>(cblk + 8 * g);
    const float4 b = *reinterpret_cast<const float4*>(cblk + 8 * g + 4);
    const float cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int4 d0 = *reinterpret_cast<const int4*>(dblk + 8 * g);
    const int4 d1 = *reinterpret_cast<const int4*>(dblk + 8 * g + 4);
    d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
    d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
    p = emit_group(p, cv, d, mulfac);
  }
}

}  // namespace cvx

extern "C" int cvx_emit_payload(const float* coeffs, const float* mulfacs,
                                const int32_t* desc, const int64_t* base,
                                const uint8_t* raw, int64_t nnn, uint8_t* out,
                                void* stream) {
  using namespace cvx;
  emit_payload_kernel<<<(unsigned)nnn, THREADS, 0, (cudaStream_t)stream>>>(
      coeffs, mulfacs, desc, base, raw, out);
  return (int)cudaGetLastError();
}
