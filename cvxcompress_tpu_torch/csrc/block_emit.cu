// block_emit: the block-ordered payload stream of min(128, cells)-cell
// chunks, for every geometry, 32^3 included.
//
// Replaces the TPU kernels pack_pallas.pack_staging
// (cvxcompress_tpu/ops/pack_pallas.py:515, call :528, kernel _kernel :142),
// with the XLA around it in rle_device.pack_active (rle_device.py:401-518)
// and the host squeeze (_subrow_squeeze :946, assemble_payload_sparse
// :1097), and at 32^3 pack_pallas.pack_staging_seg (:479, call :496) and
// tile_compact (:605, call :618), with the XLA of
// rle_device.pack_active_stripe_seg (rle_device.py:547-764).  A TPU lane
// cannot store a byte at a computed address, so the Pallas kernels spread
// the five token byte planes into staging with one-hot matmuls and
// front-pack them with log-shift rounds.  A GPU can, so the whole stage is
// one kernel writing the final stream.
//
// Each chunk's tokens land at its base, the exclusive cumsum of the chunk
// byte counts (0 in a raw block), so the stream is the same whatever order
// the chunks are written in.  The design reads a chunk's data only when the
// chunk holds tokens:
//   - persistent CTAs of 8 warps, four an SM (64 registers a thread: the
//     warps in flight carry the loads), as many as the card holds; each
//     warp walks windows of W consecutive chunks (or rows), W = 32 unless
//     the windows would then be fewer than twice the warps (rows mode, small
//     inputs: down to one step's chunks); pass p of the grid takes the next
//     band of windows in order, so that the warps in flight read one region
//     (the GPU's TLB reach), rotated by p * ROT, so that live chunks with a
//     period in the chunk index (a 32^3 block's 8 windows, a 256^3 block's
//     z-planes) do not all fall to the same warps;
//   - a window is one coalesced load of the counts (a lane a chunk) and a
//     ballot of the live ones; a window with none costs only that, and no
//     thread exists for a dead chunk; the live lanes load their chunk's
//     base and its block's mulfac; the next window's counts (in rows mode
//     its ids) are in flight while this one is emitted;
//   - the live chunks go out CPS = 32 / LPC a step, LPC = chunk / 8 lanes a
//     chunk and a lane a group of 8 cells (16 lanes for 128-cell chunks, 8
//     for the 64-cell chunks of an (8, 8, 1) block), in a pipeline of two
//     steps: while step k's coefficients (only of the groups whose cost is
//     not 0, read through the stripe map on the stripe route) are in
//     flight, step k + 1's live chunks are found, from the next window when
//     this one is done, and their descriptors requested; then step k's
//     LPC-lane exclusive scan of the group costs and its tokens, written at
//     chunk base + offset by emit_group (tokens.cuh), which re-derives
//     values, classes and group modes from the unscaled coefficients and
//     the block's entry of the (nnn,) mulfac table (one value repeated
//     under the global RMS).
// The descriptors are block-major; the coefficients are block-major too
// (the 32^3, 128^3 and fused stripe encodes), or (template STRIPE) the
// stripe route's volume-order plane, read through the stripe map
// (stripe_map.cuh): a group of 8 cells is 8 consecutive, aligned floats of
// one plane row either way.
// Rows mode (template ROWS, cvx_block_emit_rows): the K7 role inside the
// JAX package's pack_compacted (rle_device.py:969-1001) and the patch pack
// (pack_active with K17).  The coefficients and descriptors come as gathered
// (n, 128) rows, row r holding chunk ids[r] (patch_extract.cu,
// tokenize_compact.cu); its tokens land at chunk_base[ids[r]] with the
// mulfac of the chunk's block, ids[r] >> lcpb, and a row whose chunk counts
// 0 bytes (a raw block's) writes nothing.  The stream equals the in-place
// modes' byte for byte.
// What bounds it on an H100: the chunk byte counts (4 B per chunk) and the
// descriptors, bases and token-holding groups' coefficients of the live
// chunks only (chip_smoke.py emit_chunks_bytes).  It runs at 2-10x that:
// a warp's steps follow one another, each waiting on its loads, so where
// every chunk is live (8^3 blocks, rows mode) the loads in flight a warp,
// not the bytes, set the time (PERF.md).

#include "stripe_map.cuh"
#include "tokens.cuh"

namespace cvx {

constexpr int EMIT_WARPS = 8;  // warps a CTA
constexpr int ROT = 40503;     // a pass's rotation of its band, per pass

// `n` (< 2^31) counts the chunks, or in ROWS mode the rows; windows of
// 1 << lw of them.
template <int LPC, bool STRIPE, bool ROWS>
__global__ void __launch_bounds__(EMIT_WARPS * 32, 4)
block_emit_kernel(const float* __restrict__ coeffs,
                  const float* __restrict__ mulfacs,
                  const int32_t* __restrict__ desc,
                  const int32_t* __restrict__ chunk_bytes,
                  const int64_t* __restrict__ chunk_base,
                  const int32_t* __restrict__ ids, int n, int lcpb, StripeMap map,
                  int lw, uint8_t* __restrict__ out) {
  constexpr int CW = 8 * LPC;    // cells per chunk
  constexpr int CPS = 32 / LPC;  // chunks a step, one a lane group
  const int lane = threadIdx.x & 31, grp = lane / LPC, sub = lane % LPC;
  const int nwin = (int)(((int64_t)n + (1 << lw) - 1) >> lw);
  const int stride = gridDim.x * EMIT_WARPS;  // < 2^14
  const int g0 = blockIdx.x * EMIT_WARPS + (threadIdx.x >> 5);  // the warp's rank
  int pass = 0;
  // the warp's window in pass p (-1 past the last): the pass takes the band
  // of windows [p stride, p stride + len) in order, rotated by p * ROT; and
  // the lane's chunk (in rows mode its row's chunk) in window w, -1 for none
  auto window = [&](int p) -> int {
    const int band = p * stride;
    if (band + g0 >= nwin) return -1;
    const unsigned len = nwin - band < stride ? nwin - band : stride;
    return band + (int)((g0 + (p % len) * (ROT % len)) % len);
  };
  auto entry = [&](int w) -> int {
    const int r = (w << lw) + lane;
    return w < 0 || lane >= (1 << lw) || r >= n ? -1 : ROWS ? ids[r] : r;
  };
  // the next window, in flight: its number, the lane's chunk and count
  int w_next = window(pass);
  int ch_next = entry(w_next);
  int cnt_next = !ROWS && ch_next >= 0 ? chunk_bytes[ch_next] : 0;
  // the current window: its first row, the live lanes not yet taken, and
  // the live lanes' bases and mulfacs
  int r0 = 0;
  unsigned live = 0;
  int64_t lane_base = 0;
  float lane_mf = 0.0f;
  // The next step: lane group g takes the window's g-th live lane left, -1
  // for none (c: the chunk, or in rows mode the row; src: the lane it came
  // from), and requests its descriptors d.  False (uniform) when the
  // warp's windows are done.
  auto request = [&](int& c, int& src, int32_t (&d)[8]) -> bool {
    while (live == 0) {
      if (w_next < 0) return false;
      int cnt = cnt_next;
      if (ROWS) cnt = ch_next >= 0 ? chunk_bytes[ch_next] : 0;
      r0 = w_next << lw;
      lane_base = 0;
      lane_mf = 0.0f;
      if (cnt != 0) {
        lane_base = chunk_base[ch_next];
        lane_mf = mulfacs[ch_next >> lcpb];
      }
      live = __ballot_sync(~0u, cnt != 0);  // uniform over the warp
      w_next = window(++pass);
      ch_next = entry(w_next);
      cnt_next = !ROWS && ch_next >= 0 ? chunk_bytes[ch_next] : 0;
    }
#pragma unroll
    for (int g = 0; g < CPS; ++g) {
      if (g == grp) src = live ? __ffs((int)live) - 1 : -1;
      live &= live - 1;
    }
    c = src < 0 ? -1 : r0 + src;
#pragma unroll
    for (int l = 0; l < 8; ++l) d[l] = 0;
    if (c >= 0) {
      const int32_t* dp = desc + (int64_t)c * CW + sub * 8;
      const int4 d0 = *reinterpret_cast<const int4*>(dp);
      const int4 d1 = *reinterpret_cast<const int4*>(dp + 4);
      d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
      d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
    }
    return true;
  };

  int c, src = -1;
  int32_t d[8];
  if (!request(c, src, d)) return;  // uniform over the warp
  bool more = true;
  while (more) {
    // step k: its coefficients, where its group holds a token
    int mine = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) mine += d[l] & 7;
    float cv[8];
    if (mine != 0) {
      const float* p;
      if (ROWS) {
        p = coeffs + (int64_t)c * CW + sub * 8;
      } else {
        const int blk = c >> lcpb;
        const int l = (c - (blk << lcpb)) * CW + sub * 8;
        p = coeffs + map_origin<STRIPE>(map, blk) + map_cell<STRIPE>(map, l);
      }
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      cv[0] = a.x; cv[1] = a.y; cv[2] = a.z; cv[3] = a.w;
      cv[4] = b.x; cv[5] = b.y; cv[6] = b.z; cv[7] = b.w;
    }
    // its base and mulfac, from the lanes of its window
    const int64_t at = __shfl_sync(~0u, lane_base, src < 0 ? 0 : src);
    const float mf = __shfl_sync(~0u, lane_mf, src < 0 ? 0 : src);
    // step k + 1: its chunks found, their descriptors requested
    int c_next = -1, src_next = -1;
    int32_t d_next[8];
    more = request(c_next, src_next, d_next);
    // step k's tokens
    int inc = mine;
#pragma unroll
    for (int o = 1; o < LPC; o <<= 1) {
      const int v = __shfl_up_sync(~0u, inc, o, LPC);
      if (sub >= o) inc += v;
    }
    if (mine != 0) emit_group(out + at + (inc - mine), cv, d, mf);
    c = c_next;
    src = src_next;
#pragma unroll
    for (int l = 0; l < 8; ++l) d[l] = d_next[l];
  }
}

// As many CTAs of EMIT_WARPS warps as the card holds at once, fewer when
// the windows are fewer than their warps.
template <int LPC, bool STRIPE, bool ROWS = false>
static int launch_emit(const float* coeffs, const float* mulfacs,
                       const int32_t* desc, const int32_t* chunk_bytes,
                       const int64_t* chunk_base, const int32_t* ids, int64_t n,
                       int lcpb, StripeMap map, uint8_t* out, cudaStream_t st) {
  if (n >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  static int per_sm = 0;  // resident CTAs an SM, the kernel's own
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, block_emit_kernel<LPC, STRIPE, ROWS>, EMIT_WARPS * 32, 0);
  if (e != cudaSuccess) return (int)e;
  // at most 2^11 CTAs: the window order's arithmetic takes the grid's warps
  // below 2^14
  int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (most > 2048) most = 2048;
  // windows of 32, halved (down to one step's chunks) while they are fewer
  // than twice the resident warps
  int lw = 5;
  while ((1 << lw) > 32 / LPC && ((n + (1 << lw) - 1) >> lw) < 2 * most * EMIT_WARPS)
    --lw;
  const int64_t nwin = (n + (1 << lw) - 1) >> lw;
  const int64_t need = (nwin + EMIT_WARPS - 1) / EMIT_WARPS;
  block_emit_kernel<LPC, STRIPE, ROWS>
      <<<(unsigned)(need < most ? need : most), EMIT_WARPS * 32, 0, st>>>(
          coeffs, mulfacs, desc, chunk_bytes, chunk_base, ids, (int)n, lcpb, map, lw,
          out);
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
