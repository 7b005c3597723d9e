// patch_extract: the live 128-cell chunks of the stripe route's volume-order
// coefficient plane as chunk rows, in chunk order.
//
// Replaces the TPU kernel pack_pallas.patch_extract (K17,
// cvxcompress_tpu/ops/pack_pallas.py:94, call :102, kernel _kernel_patch
// :59) with the XLA gather around it (rle_device._gather_from_planes
// :333-381), the pack path the JAX package takes under CVX_STRIPE=patch.
// A block-major chunk of a block with bx < 128 is rpc = 128 / bx x-rows of
// one block column.  A TPU lane cannot load at a computed address, so the
// JAX package gathers each chunk's whole (rpc, W) patch of the plane and the
// Pallas kernel selects and lane-rolls its bx-wide windows into one 128-lane
// row.  A GPU thread loads where it likes, so one launch finds the live
// chunks (byte count not 0), ranks them and copies each once:
//
// - Persistent CTAs of PX_WARPS warps, as many as the card holds, take
//   tiles of PX_TILE consecutive chunks from an atomic ticket (in
//   increasing order: a tile's look-back waits only on tiles already taken
//   by running CTAs, so it cannot deadlock).  Warp w of a tile takes
//   its window w of 32 chunks: one 128-byte load of the counts and a
//   ballot of the live lanes; a lane's rank in its window is the popcount
//   of the ballot below it; the warps' popcounts, summed in shared memory,
//   give each window's first row within the tile and the tile's count.
// - The tiles' counts cross tiles by a decoupled look-back (lookback.cuh
//   prefix_publish / prefix_walk, warp 0) that lags a tile: iteration i
//   counts its new tile and publishes the count, then walks for the tile
//   of iteration i - 1 and copies that tile's live chunks.  By then the
//   tiles before it have published, and the walk's first window, read at
//   the iteration's start (peek_window), has landed: the walk rarely
//   waits.  The next tile's counts are in flight while the copy runs.
// - A warp copies the live chunks of its own window, STEP at a time:
//   every load of a step (a lane a float4 of coefficients, 4 cells of one
//   plane x-row through the stripe map, stripe_map.cuh, as 8 | bx; and an
//   int4 of descriptors, block-major) before any store; the chunk's block
//   origin comes from its window lane, computed once per window.  Where a
//   block holds fewer than 32 chunks (template XN), a step takes the same
//   chunk of the window's x-neighbour blocks: at bx = 8 their 32-byte
//   x-rows fill 128-byte lines together.  Each live lane writes its
//   chunk's id.
// - Two shapes, chosen by the launcher from the share of live chunks:
//   below half, 4 chunks a step at four CTAs an SM (the count and the
//   look-back are much of the work: more warps); from half up, 16 a step
//   at one CTA an SM (the copy is the work: more bytes in flight a warp).
//   Each shape is the faster of the two on the other's inputs by 1-20 %
//   (tools/ab_patch.py, PERF.md).
//
// The launcher zeroes the ticket and the status words (the wrapper's
// scratch, one per tile, held across the launch) on every call.  A row at
// or past `nlive` (the caller's count of live chunks) is not written.
//
// What bounds it on an H100: bytes, each chunk's count (4 B) and per live
// chunk 512 B of coefficients and 512 B of descriptors in, 1 KiB of rows
// and a 4-byte id out.

#include "lookback.cuh"
#include "stripe_map.cuh"

namespace cvx {

constexpr int PX_WARPS = 8;             // warps a CTA, a window each a tile
constexpr int PX_TILE = 32 * PX_WARPS;  // chunks a tile

// STEP: live chunks a warp copies at once; MINB: CTAs an SM
template <bool XN, int STEP, int MINB>
__global__ void __launch_bounds__(PX_WARPS * 32, MINB)
patch_extract_kernel(const float* __restrict__ plane, const int32_t* __restrict__ desc,
                     const int32_t* __restrict__ chunk_bytes, int nchunks, int ntiles,
                     int nlive, StripeMap map, unsigned* __restrict__ ticket,
                     unsigned* __restrict__ status, float* __restrict__ rows,
                     int32_t* __restrict__ drows, int32_t* __restrict__ ids) {
  __shared__ int s_cnt[PX_WARPS];  // the warps' live chunks in the tile
  __shared__ int s_tile;           // the next tile (ntiles: none)
  __shared__ unsigned s_first;     // the live chunks before the walked tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lcpb = map.lbx + map.lby + map.lbz - 7;  // log2 chunks per block
  // XN: the copy order's position p = j nb + b takes chunk j of the
  // window's block b (nb = 2^lb blocks a window); lane_of(p) is its lane
  const int lb = XN ? 5 - lcpb : 0;
  auto lane_of = [&](int p) {
    return XN ? ((p & ((1 << lb) - 1)) << lcpb) | (p >> lb) : p;
  };
  // lane's count in tile t's window of this warp
  auto count_of = [&](int t) {
    const int c = (t * PX_WARPS + warp) * 32 + lane;
    return t < ntiles && c < nchunks ? chunk_bytes[c] : 0;
  };

  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  int t = s_tile;
  int cnt = count_of(t);
  // the walked tile (-1: none) and, of its window, the live lanes, their
  // first row within the tile, the lane's block origin; warp 0 its count
  int prev = -1, pbase = 0;
  unsigned pmask = 0, pcount = 0;
  int64_t porigin = 0;
#pragma unroll 1
  for (;;) {
    const bool cur = t < ntiles;  // uniform
    if (!cur && prev < 0) break;
    // the ticket after this one, its latency under this iteration
    const unsigned nt = threadIdx.x == 0 && cur ? atomicAdd(ticket, 1u) : 0u;
    const unsigned pre = warp == 0 && prev > 0 ? peek_window(status, prev, 0) : 0u;
    // tile t: the window's live lanes and their block origins
    const unsigned mask = __ballot_sync(~0u, cnt != 0);
    if (lane == 0) s_cnt[warp] = __popc(mask);
    const int c = (t * PX_WARPS + warp) * 32 + lane;
    const int64_t origin = cnt != 0 ? map_origin<true>(map, c >> lcpb) : 0;
    __syncthreads();
    int base = 0;
    unsigned count = 0;
    if (cur) {
#pragma unroll
      for (int w = 0; w < PX_WARPS; ++w) {
        const int v = s_cnt[w];
        base += w < warp ? v : 0;
        count += v;
      }
      if (warp == 0) prefix_publish(status, t, count);
    }
    if (warp == 0 && prev >= 0) {
      const unsigned first = prefix_walk(status, prev, pcount, pre);
      if (lane == 0) s_first = first;
    }
    if (threadIdx.x == 0) s_tile = cur && nt < (unsigned)ntiles ? (int)nt : ntiles;
    __syncthreads();
    const int tn = s_tile;
    cnt = count_of(tn);  // in flight under the copy
    if (prev >= 0 && pmask) {  // tile prev: the warp's window's live chunks
      const int w0 = (prev * PX_WARPS + warp) * 32;
      const int r0 = (int)s_first + pbase;  // the window's first row
      if ((pmask >> lane) & 1) {
        const int r = r0 + __popc(pmask & ((1u << lane) - 1));
        if (r < nlive) ids[r] = w0 + lane;
      }
      // the live positions not yet copied
      unsigned m = XN ? __ballot_sync(~0u, (pmask >> lane_of(lane)) & 1) : pmask;
      while (m) {  // uniform
        int src[STEP];  // the step's chunks' window lanes (-1: none)
#pragma unroll
        for (int k = 0; k < STEP; ++k) {
          src[k] = m ? lane_of(__ffs((int)m) - 1) : -1;
          m &= m - 1;
        }
        float4 v[STEP];
        int4 d[STEP];
#pragma unroll
        for (int k = 0; k < STEP; ++k) {
          if (src[k] < 0) continue;  // uniform
          const int ch = w0 + src[k];
          const int64_t o = __shfl_sync(~0u, porigin, src[k]);
          const int l = ((ch & ((1 << lcpb) - 1)) << 7) + 4 * lane;
          v[k] = *reinterpret_cast<const float4*>(plane + o + map_cell<true>(map, l));
          d[k] = reinterpret_cast<const int4*>(desc + (int64_t)ch * 128)[lane];
        }
#pragma unroll
        for (int k = 0; k < STEP; ++k) {
          if (src[k] < 0) continue;
          const int r = r0 + __popc(pmask & ((1u << src[k]) - 1));
          if (r >= nlive) continue;
          reinterpret_cast<float4*>(rows + (int64_t)r * 128)[lane] = v[k];
          reinterpret_cast<int4*>(drows + (int64_t)r * 128)[lane] = d[k];
        }
      }
    }
    prev = cur ? t : -1;
    pmask = mask;
    pbase = base;
    pcount = count;
    porigin = origin;
    t = tn;
  }
}

template <bool XN, int STEP, int MINB>
static int launch_patch(const float* plane, const int32_t* desc, const int32_t* chunk_bytes,
                        int nchunks, int nlive, StripeMap map, unsigned* scratch,
                        float* rows, int32_t* drows, int32_t* ids, cudaStream_t st) {
  const int ntiles = (nchunks + PX_TILE - 1) / PX_TILE;
  static int per_sm = 0;  // resident CTAs an SM, the kernel's own
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_extract_kernel<XN, STEP, MINB>,
                                                      PX_WARPS * 32, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  patch_extract_kernel<XN, STEP, MINB>
      <<<(unsigned)(ntiles < most ? ntiles : most), PX_WARPS * 32, 0, st>>>(
          plane, desc, chunk_bytes, nchunks, ntiles, nlive, map, scratch, scratch + 1, rows,
          drows, ids);
  return (int)cudaGetLastError();
}

}  // namespace cvx

// `scratch` holds 1 + ceil(nchunks / 256) 32-bit words: the ticket, then a
// status word per tile; the launcher zeroes them.  nchunks must stay below
// 2^30 (the look-back's values), the map is stripe_map.cuh's, `nlive` the
// number of rows (chunks whose count is not 0).
extern "C" int cvx_patch_extract(const float* plane, const int32_t* desc,
                                 const int32_t* chunk_bytes, int64_t nchunks, int64_t nlive,
                                 int lbx, int lby, int lbz, int64_t nbx, int64_t nby,
                                 int64_t nxp, int64_t nyp, unsigned* scratch, float* rows,
                                 int32_t* drows, int32_t* ids, void* stream) {
  using namespace cvx;
  if (nchunks == 0 || nlive == 0) return 0;
  if (lbx + lby + lbz < 7 || lbx < 3 || nchunks > (int64_t)LB_VALUE || nlive > nchunks)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(plane) % 16 || reinterpret_cast<uintptr_t>(desc) % 16)
    return (int)cudaErrorMisalignedAddress;
  const StripeMap map = make_map(lbx, lby, lbz, nbx, nby, nxp, nyp);
  cudaStream_t st = (cudaStream_t)stream;
  const int n = (int)nchunks, nl = (int)nlive;
  // fewer than 32 chunks a block: the x-neighbour copy order; half the
  // chunks live or more: 16 a step at one CTA an SM, else 4 at four
  const bool xn = lbx + lby + lbz - 7 < 5, dense = 2 * nlive >= nchunks;
  if (dense)
    return xn ? launch_patch<true, 16, 1>(plane, desc, chunk_bytes, n, nl, map, scratch,
                                          rows, drows, ids, st)
              : launch_patch<false, 16, 1>(plane, desc, chunk_bytes, n, nl, map, scratch,
                                           rows, drows, ids, st);
  return xn ? launch_patch<true, 4, 4>(plane, desc, chunk_bytes, n, nl, map, scratch, rows,
                                       drows, ids, st)
            : launch_patch<false, 4, 4>(plane, desc, chunk_bytes, n, nl, map, scratch, rows,
                                        drows, ids, st);
}
