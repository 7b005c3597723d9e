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
//   2. block_scale_tok: the tokenize of tokenize_stripe.cu over the
//      coefficients, a (block, z) slice a 16,384-cell tile.  One
//      persistent CTA of 512 threads per SM takes slices from an atomic
//      ticket, two ahead, three tile buffers: the next slice's one bulk
//      copy (64 KiB, contiguous) lands while the CTA works.  The tokenize is the
//      row-wise one of stripe_tok.cuh with the zero-run look-back over the
//      block's slices (run_publish / run_walk), the walk a slice behind
//      (as tokenize_compact.cu: iteration i summarizes slice i and
//      publishes its word, then walks for slice i - 1, whose first window
//      was read at the iteration's start, and writes its descriptors).
//      The block's mulfac is made once: the CTA that takes the block's
//      z = 0 slice adds the block's 128 partials in slice order
//      (local_mulfac in tokens.cuh, the order of ops/quant.py
//      rms_of_partials) as soon as it holds the ticket, writes the table
//      entry and publishes the value in a flagged 64-bit word; every slice
//      of the block reads it there, an iteration before its summaries.
//      Its ticket comes before theirs and it publishes before it waits on
//      anything, so they never wait long.  Every slice of a block shares
//      the block's mulfac, and a run ends at every block end, so K10b's
//      next-tile mulfac lookahead is not needed.
// No float atomics: the table is the same on every run and equals the
// plain version's (ops/quant.py local_rms) bit for bit.
// What bounds it on an H100: device-memory bytes.  block_casc_local, the
// slice in and the coefficients out (the two cascades of block_common.cuh
// cascade_lines, as block_encode_xy); block_scale_tok, reading the
// coefficients and writing the descriptors (8 bytes per cell) and the chunk
// counts.

#include "block_common.cuh"
#include "stripe_tok.cuh"

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

constexpr int LST = 14;  // log2 cells of a slice, the tile
static_assert(1 << LST == SLICE, "a slice is a tile");
constexpr int ST_THREADS = 512;
// three slice buffers and the slack to align them to 1,024 bytes
constexpr size_t ST_SMEM = 3 * SLICE * sizeof(float) + 1024;

__global__ void __launch_bounds__(ST_THREADS, 1)
block_scale_tok_kernel(const float* __restrict__ coeffs, const double* __restrict__ partials,
                       float scale, int64_t ntiles, unsigned* __restrict__ ticket,
                       unsigned long long* __restrict__ mf_status,
                       unsigned* __restrict__ status, int32_t* __restrict__ desc,
                       int32_t* __restrict__ chunk_bytes, int32_t* __restrict__ sizes,
                       float* __restrict__ mulfacs) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* const buf0 = block_buffer(dsmem);
  // per slice buffer: its slice, copy barrier, segment summaries, scan
  // total, mulfac and next cell
  __shared__ uint64_t full[3];
  __shared__ int64_t s_tile[3];
  __shared__ int segs[3][SLICE / 32];
  __shared__ int s_top[3], s_next[3];
  __shared__ float s_mf[3];
  __shared__ double s_part[BB];
  __shared__ int scan_buf[32];
  __shared__ int s_carry;
  const int warp = threadIdx.x >> 5;

  // slice t (block t >> 7, z = t & 127) into buffer b; the first slice of
  // a block also makes the block's mulfac (warp 0)
  auto take = [&](int64_t t, int b) {
    if (threadIdx.x == 0) {
      const unsigned bar = smem_addr(&full[b]);
      mbar_expect(bar, SLICE * 4u);
      bulk_copy(buf0 + b * SLICE, coeffs + (t << LST), SLICE * 4u, bar);
    }
    if ((t & (BB - 1)) == 0 && warp == 0) {
      const int64_t blk = t >> 7;
#pragma unroll
      for (int j = 0; j < BB / 32; ++j)
        s_part[32 * j + threadIdx.x] = partials[blk * BB + 32 * j + threadIdx.x];
      __syncwarp();
      if (threadIdx.x == 0) {
        double ss = 0.0;
        for (int z = 0; z < BB; ++z) ss += s_part[z];
        const float mf = local_mulfac(ss, BB_CELLS, scale);
        mulfacs[blk] = mf;
        st_relaxed64(&mf_status[blk], 1ull << 32 | __float_as_uint(mf));
      }
      __syncwarp();
    }
  };
  // thread 32: slice t's mulfac (its word read ahead as `word`, 0 if not
  // yet published then) and whether the cell after it, read ahead as
  // `after`, is non-zero, into buffer b's slots
  auto settle = [&](int64_t t, int b, unsigned long long word, float after) {
    const float mf = __uint_as_float((unsigned)(word ? word : wait_status64(&mf_status[t >> 7])));
    s_mf[b] = mf;
    s_next[b] = (t & (BB - 1)) < BB - 1 && cvtt(__fmul_rn(after, mf)) != 0;
  };
  auto after_of = [&](int64_t t) {  // the cell after slice t, same block
    return (t & (BB - 1)) < BB - 1 ? coeffs[(t + 1) << LST] : 0.0f;
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(smem_addr(&full[b]));
    s_tile[0] = atomicAdd(ticket, 1u);
    s_tile[1] = atomicAdd(ticket, 1u);
  }
  __syncthreads();
  if (s_tile[0] < ntiles) {
    take(s_tile[0], 0);
    if (threadIdx.x == 32) settle(s_tile[0], 0, 0ull, after_of(s_tile[0]));
  }
  __syncthreads();
  int64_t prev = -1;  // the slice whose walk and descriptors this iteration does
#pragma unroll 1
  for (int i = 0;; ++i) {
    const int b = i % 3, nb = (i + 1) % 3, pb = (i + 2) % 3;
    const int64_t t = s_tile[b], nt = s_tile[nb];  // tickets rise: t < nt
    const bool cur = t < ntiles;  // uniform
    if (!cur && prev < 0) break;
    // the ticket after next, its latency under this iteration (stored at its end)
    const unsigned t2 = threadIdx.x == 0 && nt < ntiles ? atomicAdd(ticket, 1u) : 0u;
    if (nt < ntiles) take(nt, nb);
    // read ahead: the next slice's mulfac word and next cell (thread 32),
    // the first window of prev's walk (warp 0)
    unsigned long long nword = 0;
    float nafter = 0.0f;
    if (threadIdx.x == 32 && nt < ntiles) {
      nword = ld_relaxed64(&mf_status[nt >> 7]);
      nafter = after_of(nt);
    }
    const int pz = (int)(prev & (BB - 1));
    unsigned pre = 0;
    if (prev >= 0 && warp == 0 && pz && !(segs[pb][0] >> 16))
      pre = peek_window(status, prev, prev - pz);

    if (cur) {  // slice t: summaries and scan; its status word
      const int z = (int)(t & (BB - 1));
      mbar_wait(smem_addr(&full[b]), (i / 3) & 1);
      tok_summaries(buf0 + b * SLICE, SLICE, SLICE, 21, &s_mf[b], 0, segs[b]);
      __syncthreads();
      const int top = tok_scan(segs[b], SLICE / 32, scan_buf);  // 1 + last non-zero, 0: none
      if (threadIdx.x == 0) s_top[b] = top;
      if (warp == 0) run_publish(status, t, z, z << LST, top);
    }
    if (prev >= 0) {  // slice prev: its walk, then its descriptors
      if (warp == 0) {
        const int c = run_walk(status, prev, pz, s_top[pb], (segs[pb][0] >> 16) != 0, pre);
        if (threadIdx.x == 0) s_carry = c;
      }
      __syncthreads();
      tok_descs<4>(buf0 + pb * SLICE, SLICE, SLICE, 21, &s_mf[pb], 0, segs[pb], s_top[pb],
                   prev << LST, pz << LST, prev >> 7, s_carry, s_next[pb] != 0,
                   DescOut{desc, chunk_bytes}, sizes);
    }
    if (threadIdx.x == 32 && nt < ntiles) settle(nt, nb, nword, nafter);
    if (!cur) break;
    if (threadIdx.x == 0) s_tile[pb] = nt < ntiles ? t2 : ntiles;
    fence_proxy_async();  // this iteration's reads before a later copy into them
    __syncthreads();
    prev = t;
  }
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

// `coeffs` must be 16-byte aligned (the bulk copy's rule).  `scratch` holds
// 2 + 2 * nnn + 128 * nnn 32-bit words: the ticket (and a pad word), the
// blocks' 64-bit mulfac words, the slices' status words.  Zeroes them and
// the block sizes, then launches one CTA per SM.
extern "C" int cvx_block_scale_tok(const float* coeffs, const double* partials, float scale,
                                   int64_t nnn, unsigned* scratch, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes, float* mulfacs,
                                   void* stream) {
  using namespace cvx;
  if (nnn == 0) return 0;
  if (reinterpret_cast<uintptr_t>(coeffs) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = nnn * BB;
  int sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      block_scale_tok_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ST_SMEM);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, (2 + 2 * nnn + ntiles) * sizeof(unsigned), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(ntiles < sms ? ntiles : sms);
  block_scale_tok_kernel<<<grid, ST_THREADS, ST_SMEM, st>>>(
      coeffs, partials, scale, ntiles, scratch,
      reinterpret_cast<unsigned long long*>(scratch + 2), scratch + 2 + 2 * nnn, desc,
      chunk_bytes, sizes, mulfacs);
  return (int)cudaGetLastError();
}
