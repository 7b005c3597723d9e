// tokenize_stripe: scale + quantize + tokenize of the wavelet coefficients
// of every block geometry without an encode kernel of its own (all but
// 32^3, aligned 128^3 and the fused stripe blocks of stripe_fused.cu).
//
// Replaces the TPU kernels tokenize_pallas.tokenize_tiles_stripe (K13,
// cvxcompress_tpu/ops/tokenize_pallas.py:744, call :781; `_kernel_stripe`
// :702 with `_tile_desc_stripe` :538), tokenize_tiles2 (K12, :437, call
// :454), tokenize_tiles (K12', :391, call :402; the same body `_kernel`
// :292 with `_tile_desc` :116) and tokenize_tiles_volume (K15, :1170, call
// :1209), with the XLA epilogues around them (_stripe_accounting :1092,
// tokenize_desc_fast2 :478: chunk bytes, block sizes).  The JAX package
// tokenizes the block-major, chunk-major layout (K12) where its stripe gate
// fails; here every geometry reads the transform's volume-order plane in
// place, so no relayout precedes the tokenize.  The raw-fallback decision
// follows in the wrapper (ops/tokenize.py).
//
// Input: the UNSCALED coefficients of the volume-order (nzp, nyp, nxp)
// plane (stripe_map.cuh: every edge a multiple of the block's, bx >= 8).
// Each block's mulfac comes from the (nnn,) table (one value repeated under
// the global RMS): fv = __fmul_rn(c, mf[block]), the single f32 rounding of
// the JAX stage `chunks * mfc` (codec.py:94).  Output, block major: the
// per-cell descriptors (cost | run_end << 3 | min(run_len, 2^24 - 1) << 4),
// the byte count of every min(128, cells)-cell chunk and every block's
// size.  Runs of 2^24 zeros (an all-zero 256^3 block) cost 5 bytes: an
// RLESC3 of 2^24 - 1 and a trailing [0] (tokens.cuh run_cost).
//
// A tile is 16,384 consecutive block-major cells: whole blocks (8^3: 32 of
// them; (8, 8, 1): 256), or a range of z-planes or y-rows of one larger
// block (64^3: 16 tiles a block, 256^3: 1,024).  Either way each block's
// share is a box of the plane.  One persistent CTA of 512 threads per SM
// takes tiles from an atomic ticket, two tile buffers: the next tile's TMA
// boxes (one per block, or one per tile; no swizzle, so a tile lies dense
// in block order) land under this tile's tokenize.  The tokenize is the
// row-wise one of stripe_tok.cuh (the fused stripe kernels'): a lane a cell,
// ballots, a max-scan over the 512 segments' last non-zero cells.
//
// A block larger than a tile carries its zero run from tile to tile by a
// decoupled look-back on one status word per tile (stripe_tok.cuh
// run_carry, shared with tokenize_compact.cu and block_scale_tok): a tile
// whose first cell is zero reads its block's earlier tiles' words 32 at a
// time, back to the nearest one that knows the block's last non-zero cell.
// A run's end needs the cell after the tile, in the same block: one read
// from the plane.
//
// What bounds it on an H100: the bytes set the bound (4 B in, 4 B of
// descriptor out per cell, 4 B per chunk), but the kernel is bound by
// issue: the descriptors' instructions per 32-cell segment take over half
// its time (PERF.md).

#include <cstring>

#include "stripe_map.cuh"
#include "stripe_tok.cuh"

namespace cvx {

constexpr int LTT = 14;
constexpr int TT = 1 << LTT;  // cells per tile (64 KiB)
constexpr int TBT = 512;      // threads per CTA
// two tile buffers and the slack to align them to 1,024 bytes
constexpr size_t TSMEM = 2 * TT * sizeof(float) + 1024;
static_assert(TT / 64 <= TBT, "a thread per block's box");

__global__ void __launch_bounds__(TBT, 1)
tokenize_stripe_kernel(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ src,
                       const float* __restrict__ mulfacs, int64_t nnn, StripeMap map,
                       int64_t ntiles, unsigned* __restrict__ ticket,
                       unsigned* __restrict__ status, int32_t* __restrict__ desc,
                       int32_t* __restrict__ chunk_bytes, int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const buf0 = block_buffer(dsmem);
  __shared__ uint64_t full[2];
  __shared__ int rows[TT / 32];
  __shared__ int scan_buf[32];
  __shared__ int64_t s_tile[2];
  __shared__ int s_carry, s_next;
  const int lxy = map.lbx + map.lby, lc = lxy + map.lbz, cells = 1 << lc;
  const int ltpb = lc > LTT ? lc - LTT : 0;  // log2 tiles per block
  const int lbpt = lc < LTT ? LTT - lc : 0;  // log2 blocks per tile

  // the plane coordinates of block blk's cell 0 (32-bit division: a plane
  // holds fewer than 2^32 blocks)
  auto origin = [&](int64_t blk) {
    const unsigned bi = (unsigned)blk, r = bi / (unsigned)map.nbx;
    return make_int3((int)(bi - r * (unsigned)map.nbx) << map.lbx,
                     (int)(r % (unsigned)map.nby) << map.lby,
                     (int)(r / (unsigned)map.nby) << map.lbz);
  };
  // tile t's boxes into buffer b: one box, or one per block, a thread each
  // (a box may land before thread 0's expect_tx; the barrier's transaction
  // count may go below zero until its one arrival)
  auto load = [&](int64_t t, int b) {
    float* dst = buf0 + b * TT;
    const unsigned bar = smem_addr(&full[b]);
    if (ltpb) {
      if (threadIdx.x == 0) {
        const int boff = (int)(t & ((1 << ltpb) - 1)) << LTT;
        const int3 o = origin(t >> ltpb);
        mbar_expect(bar, TT * 4u);
        tma_box3(dst, &tmap, o.x, o.y + ((boff >> map.lbx) & ((1 << map.lby) - 1)),
                 o.z + (boff >> lxy), bar);
      }
    } else {
      const int64_t fb = t << lbpt;
      const int nb = (int)min((int64_t)1 << lbpt, nnn - fb);
      if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(nb << lc) * 4u);
      if (threadIdx.x < nb) {
        const int3 o = origin(fb + threadIdx.x);
        tma_box3(dst + (threadIdx.x << lc), &tmap, o.x, o.y, o.z, bar);
      }
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]));
    mbar_init(smem_addr(&full[1]));
    s_tile[0] = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  if (s_tile[0] < ntiles) load(s_tile[0], 0);
#pragma unroll 1
  for (int i = 0;; ++i) {
    const int b = i & 1;
    const int64_t t = s_tile[b];
    if (t >= ntiles) break;  // uniform
    if (threadIdx.x == 0) s_tile[b ^ 1] = atomicAdd(ticket, 1u);
    __syncthreads();
    if (s_tile[b ^ 1] < ntiles) load(s_tile[b ^ 1], b ^ 1);

    int64_t blk0;   // the tile's (first) block
    int boff, n;    // its first cell's block-local index; its cells
    if (ltpb) {
      blk0 = t >> ltpb;
      boff = (int)(t & ((1 << ltpb) - 1)) << LTT;
      n = TT;
    } else {
      blk0 = t << lbpt;
      boff = 0;
      n = (int)min((int64_t)1 << lbpt, nnn - blk0) << lc;
    }
    const float* mf = mulfacs + blk0;  // mf[c >> lc]: cell c's block's mulfac
    if (ltpb && threadIdx.x == 32)  // the cell after the tile, same block
      s_next = boff + TT < cells &&
               cvtt(__fmul_rn(src[map_origin<true>(map, blk0) +
                                  map_cell<true>(map, boff + TT)], mf[0])) != 0;
    float* s = buf0 + b * TT;
    mbar_wait(smem_addr(&full[b]), (i >> 1) & 1);
    tok_summaries(s, TT, n, lc, mf, 0, rows);
    __syncthreads();
    const int top = tok_scan(rows, TT / 32, scan_buf);  // 1 + last non-zero, 0: none

    if (ltpb && threadIdx.x < 32) {
      const int c = run_carry(status, t, (int)(t & ((1 << ltpb) - 1)), boff, top,
                              (rows[0] >> 16) != 0);
      if (threadIdx.x == 0) s_carry = c;
    }
    __syncthreads();
    const DescOut out{desc, chunk_bytes};
    if (ltpb)
      tok_descs<4>(s, TT, n, lc, mf, 0, rows, top, t << LTT, boff, blk0, s_carry,
                   s_next != 0, out, sizes);
    else if (lc == 6)  // (8, 8, 1): 64-cell chunks
      tok_descs<2>(s, TT, n, lc, mf, 0, rows, top, t << LTT, 0, blk0, -1, false, out, sizes);
    else
      tok_descs<4>(s, TT, n, lc, mf, 0, rows, top, t << LTT, 0, blk0, -1, false, out, sizes);
    fence_proxy_async();  // this tile's reads before a later copy into it
    __syncthreads();
  }
}

// The TMA map of the plane for a tile's box of each block: bx x by x bz,
// or, for a block over a tile, bx x min(by, TT / bx) x max(1, TT / (bx by)).
static int make_plane_map(CUtensorMap* tmap, const float* plane, const StripeMap& m,
                          int64_t nzp) {
  if (reinterpret_cast<uintptr_t>(plane) % 16) return (int)cudaErrorMisalignedAddress;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const int lxy = m.lbx + m.lby, lc = lxy + m.lbz;
  const cuuint64_t dims[3] = {(cuuint64_t)m.nxp, (cuuint64_t)m.nyp, (cuuint64_t)nzp};
  const cuuint64_t strides[2] = {(cuuint64_t)m.nxp * 4, (cuuint64_t)m.nxp * m.nyp * 4};
  const int lby = m.lby < LTT - m.lbx ? m.lby : LTT - m.lbx;
  const int lbz = lc <= LTT ? m.lbz : lxy < LTT ? LTT - lxy : 0;
  const cuuint32_t box[3] = {1u << m.lbx, 1u << lby, 1u << lbz};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = enc(tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)plane, dims,
                         strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace cvx

// `plane` must be 16-byte aligned (the TMA's rule; every edge of the plane
// is a multiple of 8 floats).  `scratch` holds 1 + ceil(nnn * cells /
// 16384) words: the ticket and the tiles' status words.  Zeroes them and
// the block sizes, then launches one CTA per SM (at most one per tile).
extern "C" int cvx_tokenize_stripe(const float* plane, const float* mulfacs, int64_t nnn,
                                   int lbx, int lby, int lbz, int64_t nbx, int64_t nby,
                                   int64_t nxp, int64_t nyp, unsigned* scratch, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes, void* stream) {
  using namespace cvx;
  if (nnn == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const StripeMap map = make_map(lbx, lby, lbz, nbx, nby, nxp, nyp);
  const int64_t ntiles = ((nnn << (lbx + lby + lbz)) + TT - 1) >> LTT;
  CUtensorMap tmap;
  std::memset(&tmap, 0, sizeof tmap);
  const int err = make_plane_map(&tmap, plane, map, (nnn / (nbx * nby)) << lbz);
  if (err) return err;
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      tokenize_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TSMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(unsigned), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  tokenize_stripe_kernel<<<grid, TBT, TSMEM, st>>>(tmap, plane, mulfacs, nnn, map, ntiles,
                                                   scratch, scratch + 1, desc, chunk_bytes,
                                                   sizes);
  return (int)cudaGetLastError();
}
