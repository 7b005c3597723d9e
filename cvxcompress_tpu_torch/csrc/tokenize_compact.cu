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
// - A CTA takes a tile of 16,384 consecutive cells (128 chunks) from an
//   atomic ticket, copies it into shared memory (65-word rows, one per
//   thread) and tokenizes it as tokenize_stripe.cu does: thread t owns
//   cells [64t, 64t + 64), a block-wide max-scan cut at block starts gives
//   each thread the run's start inside the tile, the cell after the tile is
//   read from the source.
// - Two carries cross tiles, both in one 64-bit status word per tile, so a
//   tile that reads the word sees both at once:
//     bit 0       the tile's last non-zero cell is published,
//     bits 1-2    1: the tile's live-chunk count, 2: the inclusive count of
//                 live chunks up to and including the tile,
//     bits 3-18   the tile's last non-zero cell + 2 (1: none),
//     bits 19-63  the count.
//   First the CTA publishes its last non-zero cell and, where a block spans
//   several tiles (cells > 16,384), walks back over its block's earlier
//   tiles until one holds a non-zero cell: the zero-run carry.  Then it
//   tokenizes into shared memory, counts its live chunks (byte count not
//   0), publishes the count and walks back over every earlier tile, adding
//   counts until one holds an inclusive count: its first row (decoupled
//   look-back).  Ticket order means every earlier tile's CTA has started,
//   and each publishes before it waits, so every walk ends.
// - Each live chunk's two threads write its 128 UNSCALED coefficients and
//   128 descriptors to its row, the even one its id and byte count.  No pad
//   rows; the last tile writes the number of rows.
//
// The chunk byte counts (before the raw-fallback decision, which the
// wrapper takes) and the block sizes go out as tokenize_stripe's.  A raw
// block's chunks keep their rows; the rows emit skips them.
//
// What bounds it on an H100: bytes (4 B in per cell; the live chunks' rows,
// 1 KiB each, and 12 B per chunk out).

#include "tokens.cuh"

namespace cvx {

constexpr int CLT = 14;             // log2 cells per tile
constexpr int CT = 1 << CLT;        // 16,384 cells, 128 chunks per tile
constexpr int CBT = 256;            // threads per CTA
constexpr int CPER = CT / CBT;      // 64 cells per thread
constexpr int CPITCH = CPER + 1;    // padded row of one thread's cells
// the coefficients at the padded pitch, then the tile's descriptors
constexpr size_t CSMEM = ((size_t)CBT * CPITCH + CT) * sizeof(float);

constexpr unsigned long long ST_LAST = 1ull;   // last non-zero cell published
constexpr unsigned long long ST_AGG = 2ull;    // the tile's count
constexpr unsigned long long ST_INCL = 4ull;   // the inclusive count

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flags, int last2, long long count) {
  return flags | ((unsigned long long)last2 << 3) |
         ((unsigned long long)count << 19);
}

__device__ __forceinline__ unsigned long long read_status(
    unsigned long long* p, unsigned long long flag) {
  unsigned long long v;
  while (!((v = atomicAdd(p, 0ull)) & flag)) __nanosleep(64);
  return v;
}

__global__ void __launch_bounds__(CBT)
tokenize_compact_kernel(const float* __restrict__ src,
                        const float* __restrict__ mulfacs, int64_t nnn,
                        int lcells, int64_t ntiles, int* __restrict__ ticket,
                        unsigned long long* __restrict__ status,
                        int32_t* __restrict__ chunk_bytes,
                        int32_t* __restrict__ sizes, float* __restrict__ rows,
                        int32_t* __restrict__ drows, int32_t* __restrict__ ids,
                        int32_t* __restrict__ row_bytes,
                        int32_t* __restrict__ nrows) {
  extern __shared__ __align__(16) float s[];
  int32_t* sd = reinterpret_cast<int32_t*>(s + CBT * CPITCH);
  __shared__ int s_tile, s_carry, scan_buf[32];
  __shared__ long long s_first;

  const int cells = 1 << lcells;
  const int64_t total = nnn << lcells;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tbase = tile << CLT;  // the tile's first cell
  // a block spans 2^ltpb tiles (ltpb > 0 only when cells > CT); zt is the
  // tile's place in it
  const int ltpb = lcells > CLT ? lcells - CLT : 0;
  const int zt = (int)(tile & ((1 << ltpb) - 1));

  // the tile into shared memory, consecutive threads on consecutive cells
  for (int k = 0; k < CPER; ++k) {
    const int c = k * CBT + threadIdx.x;
    if (tbase + c < total) s[(c >> 6) * CPITCH + (c & (CPER - 1))] = src[tbase + c];
  }
  __syncthreads();

  const int c0 = threadIdx.x * CPER;  // the thread's first cell in the tile
  const int64_t g0 = tbase + c0;
  const bool active = g0 < total;     // whole blocks: all 64 cells or none
  const int64_t blk = g0 >> lcells;
  const int l0 = (int)(g0 & (cells - 1));  // its block-local index
  const float mf = active ? mulfacs[blk] : 1.0f;
  const float* row = s + threadIdx.x * CPITCH;
  uint64_t nonzero = 0;
  if (active)
    for (int i = 0; i < CPER; ++i)
      nonzero |= (uint64_t)(cvtt(__fmul_rn(row[i], mf)) != 0) << i;
  const int last_local = nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
  int tile_last;
  const int excl =
      block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &tile_last);

  if (threadIdx.x == 0) {
    atomicExch(&status[tile], status_word(ST_LAST, tile_last + 2, 0));
    int carry = -1;  // the block's last non-zero cell before the tile
    for (int p = 1; p <= zt; ++p) {
      const int v = (int)((read_status(&status[tile - p], ST_LAST) >> 3) & 0xffff);
      if (v >= 2) {
        carry = ((zt - p) << CLT) + v - 2;
        break;
      }
    }
    s_carry = carry;
  }
  __syncthreads();

  // the tokenize of the thread's 64 cells, into shared memory
  int cost = 0;
  if (active) {
    // the last non-zero cell before the thread's first, block-local (-1:
    // the run starts at the block's start); a scan result from an earlier
    // block of the tile falls below 0 and does not count
    const int el = excl >= 0 ? excl - c0 + l0 : -1;
    const int last = el >= 0 ? el : (ltpb > 0 ? s_carry : -1);
    bool end_after;  // a run in the thread's last cell ends there
    if (l0 + CPER == cells) {
      end_after = true;
    } else if (threadIdx.x + 1 < CBT) {
      end_after = cvtt(__fmul_rn(row[CPITCH], mf)) != 0;
    } else {  // the next tile's first cell, same block
      end_after = cvtt(__fmul_rn(src[g0 + CPER], mf)) != 0;
    }
    cost = tokenize64([&](int i) { return cvtt(__fmul_rn(row[i], mf)); },
                      nonzero, last, l0, end_after, sd + c0);
  }
  const unsigned live = __ballot_sync(0xffffffffu, active);
  if (active) store_counts(cost, live, cells, g0, blk, chunk_bytes, sizes);
  // a chunk is two neighbouring threads' cells (cells >= 128)
  const int pair = cost + __shfl_xor_sync(0xffffffffu, cost, 1);
  int tile_live;
  const int mine = block_exclusive_scan(
      (threadIdx.x & 1) == 0 && pair > 0 ? 1 : 0, 0, SumOp(), scan_buf, &tile_live);
  const int local_row = __shfl_sync(0xffffffffu, mine, (threadIdx.x & 31) & ~1);

  if (threadIdx.x == 0) {
    const int last2 = tile_last + 2;
    long long first = 0;  // live chunks before the tile
    if (tile == 0) {
      atomicExch(&status[0], status_word(ST_LAST | ST_INCL, last2, tile_live));
    } else {
      atomicExch(&status[tile], status_word(ST_LAST | ST_AGG, last2, tile_live));
      for (int64_t p = tile - 1; p >= 0; --p) {
        const unsigned long long v = read_status(&status[p], ST_AGG | ST_INCL);
        first += (long long)(v >> 19);
        if (v & ST_INCL) break;
      }
      atomicExch(&status[tile],
                 status_word(ST_LAST | ST_INCL, last2, first + tile_live));
    }
    if (tile == ntiles - 1) *nrows = (int32_t)(first + tile_live);
    s_first = first;
  }
  __syncthreads();

  if (active && pair > 0) {
    const int64_t r = s_first + local_row;
    const int half = threadIdx.x & 1;
    float4* dst = reinterpret_cast<float4*>(rows + r * 128 + 64 * half);
    int4* ddst = reinterpret_cast<int4*>(drows + r * 128 + 64 * half);
    const int4* dsrc = reinterpret_cast<const int4*>(sd + c0);
#pragma unroll 4
    for (int i = 0; i < CPER / 4; ++i) {
      dst[i] = make_float4(row[4 * i], row[4 * i + 1], row[4 * i + 2],
                           row[4 * i + 3]);
      ddst[i] = dsrc[i];
    }
    if (half == 0) {
      ids[r] = (int32_t)(g0 >> 7);
      row_bytes[r] = pair;
    }
  }
}

}  // namespace cvx

// `scratch` holds 1 + ntiles 64-bit words: the ticket (in the first word)
// and the tiles' status words.  Zeroes them and the block sizes, then
// launches one CTA per 16,384-cell tile over nnn blocks of 2^lcells cells
// (lcells >= 7).
extern "C" int cvx_tokenize_compact(const float* coeffs, const float* mulfacs,
                                    int64_t nnn, int lcells,
                                    unsigned long long* scratch,
                                    int32_t* chunk_bytes, int32_t* sizes,
                                    float* rows, int32_t* drows, int32_t* ids,
                                    int32_t* row_bytes, int32_t* nrows,
                                    void* stream) {
  using namespace cvx;
  if (nnn == 0) return 0;
  if (lcells < 7) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = ((nnn << lcells) + CT - 1) >> CLT;
  cudaError_t e = cudaFuncSetAttribute(
      tokenize_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)CSMEM);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(unsigned long long), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  tokenize_compact_kernel<<<(unsigned)ntiles, CBT, CSMEM, st>>>(
      coeffs, mulfacs, nnn, lcells, ntiles, reinterpret_cast<int*>(scratch),
      scratch + 1, chunk_bytes, sizes, rows, drows, ids, row_bytes, nrows);
  return (int)cudaGetLastError();
}
