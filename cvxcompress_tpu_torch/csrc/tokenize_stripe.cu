// tokenize_stripe: scale + quantize + tokenize of the wavelet coefficients
// of every block geometry without an encode kernel of its own (all but
// 32^3, aligned 128^3 and the fused stripe blocks of stripe_fused.cu).
//
// Replaces the TPU kernels tokenize_pallas.tokenize_tiles_stripe (K13,
// cvxcompress_tpu/ops/tokenize_pallas.py:744, call :781; `_kernel_stripe`
// :702 with `_tile_desc_stripe` :538), tokenize_tiles2 (K12, :437, call
// :454) and tokenize_tiles (K12', :391, call :402; the same body `_kernel`
// :292 with `_tile_desc` :116), with the XLA epilogues around them
// (_stripe_accounting :1092, tokenize_desc_fast2 :478: chunk bytes, block
// sizes).  The JAX package tokenizes the block-major, chunk-major layout
// (K12) where its stripe gate fails; here every geometry reads the
// transform's volume-order plane in place, so no relayout precedes the
// tokenize.  The raw-fallback decision follows in the wrapper
// (ops/tokenize.py).
//
// Input: the UNSCALED coefficients of the volume-order (nzp, nyp, nxp)
// plane, read through the stripe map (stripe_map.cuh).  Each block's mulfac
// comes from the (nnn,) table (one value repeated under the global RMS):
// fv = __fmul_rn(c, mf[block]), the single f32 rounding of the JAX stage
// `chunks * mfc` (codec.py:94).  Output, block major: the per-cell
// descriptors (cost | run_end << 3 | min(run_len, 2^24 - 1) << 4), the byte
// count of every min(128, cells)-cell chunk and every block's size.
//
// A CTA takes a tile of 16,384 consecutive block-major cells from an atomic
// ticket, copies them into shared memory (65-word rows, one per thread, so
// the thread-per-64-cells reads fall on distinct banks) and tokenizes them:
// thread t owns cells [64t, 64t + 64), eight whole groups of 8, always
// inside one block (cells >= 64).  The JAX kernels carry the zero-run state
// across sequential grid steps in SMEM; a GPU grid has no order.  A tile of
// blocks smaller than itself (8^3 = 512 cells: 32 whole blocks) needs no
// carry: a block-wide max-scan of the threads' last non-zero cells, cut at
// each block's start.  A block larger than a tile (64^3 = 16 tiles, 256^3 =
// 1,024) carries its run state by the decoupled look-back of the 128^3 path
// (block_common.cuh slice_tokenize): the CTA publishes its tile's last
// non-zero cell, then walks back over its block's earlier tiles until one has
// a non-zero cell.  The ticket order means every earlier tile's CTA has
// started and publishes before it waits, so the walk ends.  The cell after a
// tile's last, inside the same block, is read from the source: a run's end
// needs one cell of lookahead, the TPU kernels' clamped next-row window.
// Runs of 2^24 zeros (an all-zero 256^3 block) cost 5 bytes: an RLESC3 of
// 2^24 - 1 and a trailing [0] (tokens.cuh run_cost).
//
// What bounds it on an H100: bytes (4 B in, 4 B of descriptor out per cell,
// 4 B per chunk); the scan and look-back are per tile.

#include "stripe_map.cuh"
#include "tokens.cuh"

namespace cvx {

constexpr int LTT = 14;               // log2 cells per tile
constexpr int TT = 1 << LTT;          // 16,384 cells per tile
constexpr int TBT = 256;              // threads per CTA
constexpr int TPER = TT / TBT;        // 64 cells per thread
constexpr int TPITCH = TPER + 1;      // padded row of one thread's cells
constexpr size_t TSMEM = (size_t)TBT * TPITCH * sizeof(float);

__global__ void __launch_bounds__(TBT)
tokenize_stripe_kernel(const float* __restrict__ src,
                       const float* __restrict__ mulfacs, int64_t nnn,
                       StripeMap map, int* __restrict__ ticket,
                       int* __restrict__ status, int32_t* __restrict__ desc,
                       int32_t* __restrict__ chunk_bytes,
                       int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) float s[];
  __shared__ int64_t s_org[TBT];
  __shared__ int s_tile, s_carry, scan_buf[32];

  const int lcells = map.lbx + map.lby + map.lbz;
  const int cells = 1 << lcells;
  const int64_t total = nnn << lcells;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t tbase = (int64_t)tile << LTT;  // the tile's first cell
  const int64_t fb = tbase >> lcells;          // the tile's first block
  // a block spans 2^ltpb tiles (ltpb > 0 only when cells > TT); zt is the
  // tile's place in it
  const int ltpb = lcells > LTT ? lcells - LTT : 0;
  const int zt = tile & ((1 << ltpb) - 1);
  const int bpt = lcells < LTT ? 1 << (LTT - lcells) : 1;  // blocks per tile
  if (threadIdx.x < bpt)
    s_org[threadIdx.x] =
        fb + threadIdx.x < nnn ? map_origin<true>(map, fb + threadIdx.x) : 0;
  __syncthreads();

  // the tile into shared memory, consecutive threads on consecutive cells
  for (int k = 0; k < TPER; ++k) {
    const int c = k * TBT + threadIdx.x;
    const int64_t g = tbase + c;
    if (g < total) {
      const int bi = (int)((g >> lcells) - fb);
      const int l = (int)(g & (cells - 1));
      s[(c >> 6) * TPITCH + (c & (TPER - 1))] =
          src[s_org[bi] + map_cell<true>(map, l)];
    }
  }
  __syncthreads();

  const int c0 = threadIdx.x * TPER;   // the thread's first cell in the tile
  const int64_t g0 = tbase + c0;
  const bool active = g0 < total;      // whole blocks: all 64 cells or none
  const int64_t blk = g0 >> lcells;
  const int l0 = (int)(g0 & (cells - 1));  // its block-local index
  const float mf = active ? mulfacs[blk] : 1.0f;
  const float* row = s + threadIdx.x * TPITCH;
  uint64_t nonzero = 0;
  if (active)
    for (int i = 0; i < TPER; ++i)
      nonzero |= (uint64_t)(cvtt(__fmul_rn(row[i], mf)) != 0) << i;
  const int last_local = nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
  int tile_last;
  const int excl =
      block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &tile_last);

  if (ltpb > 0 && threadIdx.x == 0) {
    atomicExch(&status[tile], tile_last + 2);  // 1: no non-zero cell
    int carry = -1;  // the block's last non-zero cell before the tile
    for (int p = 1; p <= zt; ++p) {
      int v;
      while ((v = atomicAdd(&status[tile - p], 0)) == 0) __nanosleep(64);
      if (v >= 2) {
        carry = ((zt - p) << LTT) + v - 2;
        break;
      }
    }
    s_carry = carry;
  }
  __syncthreads();
  // the warp's lanes that hold cells; the lanes of one chunk or one block
  // are all in it or all out
  const unsigned live = __ballot_sync(0xffffffffu, active);
  if (!active) return;

  // the last non-zero cell before the thread's first, block-local (-1: the
  // run starts at the block's start); a scan result from an earlier block
  // of the tile falls below 0 and does not count
  const int el = excl >= 0 ? excl - c0 + l0 : -1;
  const int last = el >= 0 ? el : (ltpb > 0 ? s_carry : -1);
  // whether a run in the thread's last cell ends there: at its block's end
  // always, else when the next cell quantizes to non-zero
  bool end_after;
  if (l0 + TPER == cells) {
    end_after = true;
  } else if (threadIdx.x + 1 < TBT) {
    end_after = cvtt(__fmul_rn(row[TPITCH], mf)) != 0;
  } else {  // the next tile's first cell, same block
    end_after =
        cvtt(__fmul_rn(src[s_org[0] + map_cell<true>(map, l0 + TPER)], mf)) != 0;
  }

  const int cost = tokenize64(
      [&](int i) { return cvtt(__fmul_rn(row[i], mf)); }, nonzero, last, l0,
      end_after, desc + g0);
  store_counts(cost, live, cells, g0, blk, chunk_bytes, sizes);
}

}  // namespace cvx

// `scratch` holds 1 + ceil(nnn * cells / 16384) ints: the ticket and the
// tiles' status words.  Zeroes them and the block sizes, then launches one
// CTA per tile.
extern "C" int cvx_tokenize_stripe(const float* plane, const float* mulfacs,
                                   int64_t nnn, int lbx, int lby, int lbz,
                                   int64_t nbx, int64_t nby, int64_t nxp,
                                   int64_t nyp, int* scratch, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes,
                                   void* stream) {
  using namespace cvx;
  if (nnn == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = ((nnn << (lbx + lby + lbz)) + TT - 1) >> LTT;
  cudaError_t e = cudaFuncSetAttribute(
      tokenize_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TSMEM);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  tokenize_stripe_kernel<<<(unsigned)ntiles, TBT, TSMEM, st>>>(
      plane, mulfacs, nnn, make_map(lbx, lby, lbz, nbx, nby, nxp, nyp),
      scratch, scratch + 1, desc, chunk_bytes, sizes);
  return (int)cudaGetLastError();
}
