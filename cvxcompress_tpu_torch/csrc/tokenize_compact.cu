// tokenize_compact: scale + quantize + tokenize of block-major coefficients
// with the live 128-cell chunks compacted into rows, in chunk order.
//
// Replaces the TPU kernel tokenize_pallas.tokenize_compact_tiles (K14,
// cvxcompress_tpu/ops/tokenize_pallas.py:1313, call :1327, kernel
// _kernel_compact :317) with its XLA epilogue (tokenize_compact_fast :1365),
// the encode the JAX package runs under CVX_FUSED_COMPACT=1.  The JAX kernel
// walks (1024, 128) chunk tiles in grid order, carries the zero run and an
// append cursor in SMEM scalars, front-packs each tile's live rows with
// log-shift rounds and DMAs them out padded to 8 rows.  A GPU grid has no
// order and a thread stores at computed addresses, so:
//
// - One persistent CTA of 512 threads per SM takes tiles of 16,384
//   consecutive cells (128 chunks: whole blocks, or a range of one larger
//   block) from an atomic ticket, taken two tiles ahead, three tile
//   buffers: the next tile's one bulk copy (the cells are contiguous)
//   lands while the CTA works.
// - The tokenize is the row-wise one of stripe_tok.cuh, a lane a cell:
//   tok_summaries, tok_scan, the zero run of a block over several tiles
//   (run_publish / run_walk) and tok_descs, whose chunk results go to
//   RowsOut below.
// - A chunk is live (its byte count is not 0) when it holds a non-zero
//   cell or a zero run ends in its last cell: the next cell is non-zero or
//   the block ends there.  The segment summaries show both, so the CTA
//   knows its live chunks (four ballots) before any descriptor: the rows'
//   places are fixed before tok_descs runs.  The live-row count crosses
//   tiles by a second decoupled look-back (lookback.cuh prefix_publish /
//   prefix_walk): a tile publishes its count, then adds the earlier tiles'
//   32 at a time back to the nearest inclusive sum.  Warp 0 walks the zero
//   run, warp 1 the count, at once, on two status arrays.
// - The walks lag a tile: iteration i summarizes tile i and publishes its
//   words, then walks for tile i - 1 and writes its descriptors.  By then
//   the words behind tile i - 1 are published, and the walks' first
//   windows, read at the iteration's start (peek_window), have landed
//   under tile i's summaries: the walks rarely wait.
// - tok_descs writes each chunk's byte count; a live chunk's warp writes
//   its 128 UNSCALED coefficients and 128 descriptors to its row, 128
//   bytes a store, and its id and byte count.  No pad rows; the last tile
//   writes the number of rows.
//
// The chunk byte counts (before the raw-fallback decision, which the
// wrapper takes) and the block sizes go out as tokenize_stripe's.  A raw
// block's chunks keep their rows; the rows emit skips them.
//
// What bounds it on an H100: bytes (4 B in per cell; the live chunks' rows,
// 1 KiB each, and 12 B per chunk out).

#include "stripe_tok.cuh"

namespace cvx {

constexpr int LCT = 14;
constexpr int CT = 1 << LCT;   // cells per tile (64 KiB), 128 chunks
constexpr int CBT = 512;       // threads per CTA
constexpr int CCH = CT / 128;  // chunks per tile
// three tile buffers and the slack to align them to 1,024 bytes
constexpr size_t CSMEM = 3 * CT * sizeof(float) + 1024;

// tok_descs' chunk results of tokenize_compact: every chunk's byte count,
// a live chunk's row.  `live`: the tile's chunk masks (shared), `first`:
// the live chunks before the tile.
struct RowsOut {
  int32_t* chunk_bytes;
  float* rows;
  int32_t* drows;
  int32_t* ids;
  int32_t* row_bytes;
  const unsigned* live;
  int64_t first;
  template <int K>
  __device__ __forceinline__ void operator()(int64_t g, int, const int32_t (&d)[K], int cost,
                                             const float* s, int c0, int) const {
    const int lane = threadIdx.x & 31, k = c0 >> 7;  // the chunk's place in the tile
    if (lane == 0) chunk_bytes[g >> 7] = cost;
    if (!((live[k >> 5] >> (k & 31)) & 1)) return;  // uniform
    int before = __popc(live[k >> 5] & ((1u << (k & 31)) - 1));
    for (int w = 0; w < (k >> 5); ++w) before += __popc(live[w]);
    const int64_t r = first + before;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      rows[r * 128 + 32 * j + lane] = s[c0 + 32 * j + lane];
      drows[r * 128 + 32 * j + lane] = d[j];
    }
    if (lane == 0) {
      ids[r] = (int32_t)(g >> 7);
      row_bytes[r] = cost;
    }
  }
};

__global__ void __launch_bounds__(CBT, 1)
tokenize_compact_kernel(const float* __restrict__ src, const float* __restrict__ mulfacs,
                        int64_t nnn, int lc, int64_t ntiles, unsigned* __restrict__ ticket,
                        unsigned* __restrict__ run_status, unsigned* __restrict__ row_status,
                        int32_t* __restrict__ chunk_bytes, int32_t* __restrict__ sizes,
                        float* __restrict__ rows, int32_t* __restrict__ drows,
                        int32_t* __restrict__ ids, int32_t* __restrict__ row_bytes,
                        int32_t* __restrict__ nrows) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const buf0 = block_buffer(dsmem);
  // per tile buffer: its tile, copy barrier, segment summaries, live
  // chunks, scan total and next cell
  __shared__ uint64_t full[3];
  __shared__ int64_t s_tile[3];
  __shared__ int segs[3][CT / 32];
  __shared__ unsigned s_live[3][CCH / 32];
  __shared__ int s_top[3], s_next[3];
  __shared__ int scan_buf[32];
  __shared__ int s_carry;
  __shared__ int64_t s_first;
  const int cells = 1 << lc, warp = threadIdx.x >> 5;
  const int ltpb = lc > LCT ? lc - LCT : 0;  // log2 tiles per block
  const int lbpt = lc < LCT ? LCT - lc : 0;  // log2 blocks per tile
  const int64_t total = nnn << lc;

  // tile t's cells into buffer b: one bulk copy (a block-major tile is
  // contiguous; the last one may hold fewer blocks)
  auto load = [&](int64_t t, int b) {
    if (threadIdx.x == 0) {
      const unsigned bar = smem_addr(&full[b]);
      const unsigned bytes = (unsigned)min((int64_t)CT, total - (t << LCT)) * 4u;
      mbar_expect(bar, bytes);
      bulk_copy(buf0 + b * CT, src + (t << LCT), bytes, bar);
    }
  };
  // tile t's (first) block, its first cell's block-local index, its cells
  auto geometry = [&](int64_t t, int64_t& blk0, int& boff, int& n) {
    if (ltpb) {
      blk0 = t >> ltpb;
      boff = (int)(t & ((1 << ltpb) - 1)) << LCT;
      n = CT;
    } else {
      blk0 = t << lbpt;
      boff = 0;
      n = (int)min((int64_t)CT, total - (t << LCT));
    }
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(smem_addr(&full[b]));
    s_tile[0] = atomicAdd(ticket, 1u);
    s_tile[1] = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  if (s_tile[0] < ntiles) load(s_tile[0], 0);
  int64_t prev = -1;  // the tile whose walks and descriptors this iteration does
#pragma unroll 1
  for (int i = 0;; ++i) {
    const int b = i % 3, nb = (i + 1) % 3, pb = (i + 2) % 3;
    const int64_t t = s_tile[b], nt = s_tile[nb];  // tickets rise: t < nt
    const bool cur = t < ntiles;  // uniform
    if (!cur && prev < 0) break;
    // the ticket after next, its latency under this iteration (stored at its end)
    const unsigned t2 = threadIdx.x == 0 && nt < ntiles ? atomicAdd(ticket, 1u) : 0u;
    if (nt < ntiles) load(nt, nb);
    int64_t pblk0 = 0;
    int pboff = 0, pn = 0;
    if (prev >= 0) geometry(prev, pblk0, pboff, pn);
    // the first windows of prev's walks (warp 0 its zero run, warp 1 its
    // rows before it), landing under this tile's summaries
    unsigned pre = 0;
    if (prev >= 0 && warp == 0 && pboff && !(segs[pb][0] >> 16))
      pre = peek_window(run_status, prev, prev - (pboff >> LCT));
    if (prev > 0 && warp == 1) pre = peek_window(row_status, prev, 0);

    if (cur) {  // tile t: summaries, live chunks, scan; its status words
      int64_t blk0;
      int boff, n;
      geometry(t, blk0, boff, n);
      const float* mf = mulfacs + blk0;  // mf[c >> lc]: cell c's block's mulfac
      // the cell after the tile, same block: read now, used after the summaries
      const bool has_next = ltpb && boff + CT < cells;
      const float after = has_next && threadIdx.x == 32 ? src[(t + 1) << LCT] : 0.0f;
      mbar_wait(smem_addr(&full[b]), (i / 3) & 1);
      tok_summaries(buf0 + b * CT, CT, n, lc, mf, 0, segs[b]);
      if (threadIdx.x == 32) s_next[b] = has_next && cvtt(__fmul_rn(after, mf[0])) != 0;
      __syncthreads();
      if (threadIdx.x < CCH) {  // thread k: chunk k live?
        const int k = threadIdx.x, j = 4 * k;
        const int* sg = segs[b];
        bool live = false;
        if (128 * k < n) {
          const bool nz = ((sg[j] | sg[j + 1] | sg[j + 2] | sg[j + 3]) & 0xffff) != 0;
          const bool block_end = ((boff + 128 * k + 128) & (cells - 1)) == 0;
          const bool next = k + 1 < CCH ? (sg[j + 4] >> 16) != 0 : s_next[b] != 0;
          live = nz || block_end || next;
        }
        const unsigned m = __ballot_sync(~0u, live);
        if ((k & 31) == 0) s_live[b][k >> 5] = m;
      }
      const int top = tok_scan(segs[b], CT / 32, scan_buf);  // its barriers publish s_live
      if (threadIdx.x == 0) s_top[b] = top;
      if (warp == 0 && ltpb) run_publish(run_status, t, boff >> LCT, boff, top);
      if (warp == 1) {
        unsigned count = 0;
#pragma unroll
        for (int w = 0; w < CCH / 32; ++w) count += __popc(s_live[b][w]);
        prefix_publish(row_status, t, count);
      }
    }
    if (prev >= 0) {  // tile prev: its walks, then its descriptors and rows
      if (warp == 0 && ltpb) {
        const int c = run_walk(run_status, prev, pboff >> LCT, s_top[pb],
                               (segs[pb][0] >> 16) != 0, pre);
        if (threadIdx.x == 0) s_carry = c;
      }
      if (warp == 1) {
        unsigned count = 0;
#pragma unroll
        for (int w = 0; w < CCH / 32; ++w) count += __popc(s_live[pb][w]);
        const unsigned first = prefix_walk(row_status, prev, count, pre);
        if (threadIdx.x == 32) {
          s_first = first;
          if (prev == ntiles - 1) *nrows = (int32_t)(first + count);
        }
      }
      __syncthreads();
      const RowsOut out{chunk_bytes, rows, drows, ids, row_bytes, s_live[pb], s_first};
      tok_descs<4>(buf0 + pb * CT, CT, pn, lc, mulfacs + pblk0, 0, segs[pb], s_top[pb],
                   prev << LCT, pboff, pblk0, ltpb ? s_carry : -1, s_next[pb] != 0, out,
                   sizes);
    }
    if (!cur) break;
    if (threadIdx.x == 0) s_tile[pb] = nt < ntiles ? t2 : ntiles;
    fence_proxy_async();  // this iteration's reads before a later copy into them
    __syncthreads();
    prev = t;
  }
}

}  // namespace cvx

// `coeffs` must be 16-byte aligned (the bulk copy's rule).  `scratch` holds
// 1 + 2 * ceil(nnn * 2^lcells / 16384) 32-bit words: the ticket, then the
// tiles' zero-run and row-count status words.  Zeroes them and the block
// sizes, then launches one CTA per SM (at most one per tile) over nnn
// blocks of 2^lcells cells (lcells >= 7).
extern "C" int cvx_tokenize_compact(const float* coeffs, const float* mulfacs, int64_t nnn,
                                    int lcells, unsigned* scratch, int32_t* chunk_bytes,
                                    int32_t* sizes, float* rows, int32_t* drows, int32_t* ids,
                                    int32_t* row_bytes, int32_t* nrows, void* stream) {
  using namespace cvx;
  if (nnn == 0) return 0;
  if (lcells < 7) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(coeffs) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = ((nnn << lcells) + CT - 1) >> LCT;
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      tokenize_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CSMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (1 + 2 * ntiles) * sizeof(unsigned), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  tokenize_compact_kernel<<<grid, CBT, CSMEM, st>>>(
      coeffs, mulfacs, nnn, lcells, ntiles, scratch, scratch + 1, scratch + 1 + ntiles,
      chunk_bytes, sizes, rows, drows, ids, row_bytes, nrows);
  return (int)cudaGetLastError();
}
