// decode_emit: stage 3 of the parallel entropy parse.  Every token start
// decodes its token and writes the dequantized values straight into the
// zeroed dense block-major buffer out[block * cells + cursor].
//
// Replaces the TPU kernel entropy_decode._emit_values_pallas
// (cvxcompress_tpu/ops/entropy_decode.py:733, call :786, kernel :617) and
// the XLA scatter after it (ops/codec.py:856-862; the block-major target
// of decode_to_blocks :884-898).  On the TPU a row of bytes is a vector
// register, so the group-of-8 tokens' carrier bytes are found with lane
// rolls and a previous-row window (:664-712).  On a GPU the lane that
// starts a token simply reads forward in the flat stream.
//
// A warp takes G consecutive subsegments (EMIT_G, or 1 on a short stream),
// lane = byte, and issues all their loads before it uses any: the G rows
// of M, two aligned stream words a lane and subsegment (a funnel shift
// gives the token's first four bytes, as in decode_maps.cu), and on lanes
// 0..G-1 the subsegments' e32, c32 and sub_block, then their blocks'
// scalefac, which the subsegments take by shuffle (c32 and e32 packed in
// one word).
// Lane p starts a token when bit e32[k] of M[k][p] is set; a warp scan of
// the starts' cell counts gives each token's cursor, min(c32[k] +
// exclusive sum, cells) (:749-752): the group's G scans interleaved, or,
// when no token of the group covers more than a cell (dense data), a count
// of the starts below each lane by ballot.  The starting lane then writes
// its value(s): a plain byte and the VLESC2/3/4 escapes one, VLESC2_8x and
// VLESC3_8x eight at cursor + j (their bytes read forward in the stream,
// into the next subsegment or the zero padding after the stream), the runs
// none (the buffer is zero); neighbouring lanes write neighbouring
// cursors.  Every value is __fmul_rn(v, scalefac[block of the chain]): one
// f32 rounding and no FMA contraction, bit-exact with the host decoders.
// The host computes the (nnn,) table as 1.0f / mulfac (one value repeated
// under the global RMS, 1 / blkmulfac[b] under the local RMS): a
// reciprocal on the card could round differently.
// Positions >= cells and blocks outside [0, nnn) (the padding subsegments)
// are dropped, so a corrupt stream never writes outside the buffer, and
// all of a chain's writes go to its own block at strictly increasing
// cursors: live targets are unique and need no atomics.
// What bounds it on an H100: reading M (4 bytes per stream byte) and the
// 4-byte stores of the non-zero values; the 187 MB zeroing of the buffer at
// the reference CI config is a memset before it.  The design before this
// one took a subsegment a warp, a byte a lane, through one chain of
// dependent loads (M and e32, then the stream's bytes, a 32-lane scan, c32
// and sub_block, then scalefac): latency- and issue-bound on noisy streams.

#include "decode_common.cuh"

namespace cvx {

constexpr int EMIT_G = 4;  // subsegments a warp on a long stream
// Below this many subsegments (a stream of 1 MiB) a warp takes one, so
// that a short stream still spreads over the card.
constexpr int64_t EMIT_SHORT = 1 << 15;

__device__ __forceinline__ void put(float* blk_out, int pos, int cells,
                                    float v, float sf) {
  if (pos < cells) blk_out[pos] = __fmul_rn(v, sf);
}

// The token starting at s (first four bytes w), cursor cur < cells: its
// value(s) times sf into blk_out.
__device__ __forceinline__ void emit_token(float* blk_out, const uint8_t* s,
                                           uint32_t w, int cur, int cells,
                                           float sf) {
  const int sv = (int)(int8_t)w;
  if (sv > -125 && sv < 125) {
    put(blk_out, cur, cells, (float)sv, sf);
  } else if (sv == -125) {  // VLESC2: i16
    put(blk_out, cur, cells, (float)(int16_t)(w >> 8), sf);
  } else if (sv == -127) {  // VLESC3: i24
    put(blk_out, cur, cells, (float)((int)w >> 8), sf);
  } else if (sv == -128) {  // VLESC4: the scaled f32 itself
    put(blk_out, cur, cells, __uint_as_float((w >> 8) | ((uint32_t)s[4] << 24)), sf);
  } else if (sv == -126) {  // VLESC2_8x: eight i16
#pragma unroll
    for (int j = 0; j < 8; ++j)
      put(blk_out, cur + j, cells,
          (float)(int16_t)(s[1 + 2 * j] | (s[2 + 2 * j] << 8)), sf);
  } else if (sv == 126) {  // VLESC3_8x: eight i24
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u = s[1 + 3 * j] | (s[2 + 3 * j] << 8) | (s[3 + 3 * j] << 16);
      put(blk_out, cur + j, cells, (float)((int)(u << 8) >> 8), sf);
    }
  }
  // RLESC1 (127) and RLESC3 (125): zero runs, nothing to write
}

template <int G>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_emit_kernel(const uint8_t* __restrict__ stream,
                   const int32_t* __restrict__ M,
                   const int32_t* __restrict__ e32,
                   const int32_t* __restrict__ c32,
                   const int32_t* __restrict__ sub_block, int64_t nsub,
                   const float* __restrict__ scalefac, int cells, int64_t nnn,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 = ((int64_t)blockIdx.x * DEC_WARPS + (threadIdx.x >> 5)) * G;
  if (k0 >= nsub) return;  // uniform over the warp

  // the group's loads first (a subsegment past the end repeats the last
  // one and writes nothing): M and the stream words, and on lane i < G
  // subsegment k0 + i's entry, cursor and block, then the block's scalefac
  const int n = (int)min((int64_t)G, nsub - k0);  // the warp's subsegments
  const int32_t* m0 = M + k0 * SUB + lane;
  const uint32_t* w0 =
      reinterpret_cast<const uint32_t*>(stream) + k0 * (SUB / 4) + (lane >> 2);
  int32_t mrow[G];
  uint32_t lo[G], hi[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int ii = n == G ? i : min(i, n - 1);
    mrow[i] = __ldg(m0 + ii * SUB);
    lo[i] = __ldg(w0 + ii * (SUB / 4));
    hi[i] = __ldg(w0 + ii * (SUB / 4) + 1);
  }
  const int64_t kl = k0 + min(lane, n - 1);
  const int ce_l = __ldg(c32 + kl) << 5 | (__ldg(e32 + kl) & 31);  // c32 <= cells < 2^26
  const int b_l = __ldg(sub_block + kl);
  const float sf_l = b_l >= 0 && b_l < nnn ? __ldg(scalefac + b_l) : 0.0f;

  // token starts, their cell counts (-1: no start) and the group's warp
  // scans, interleaved
  uint32_t b[G];
  int ce[G], cnt[G], inc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    b[i] = __funnelshift_r(lo[i], hi[i], (lane & 3) * 8);  // bytes p..p+3
    ce[i] = __shfl_sync(FULL, ce_l, i);
    cnt[i] = (mrow[i] >> (ce[i] & 31)) & 1 ? token_at(b[i], cells).cnt : -1;
    inc[i] = max(cnt[i], 0);
  }
  bool unit = true;
#pragma unroll
  for (int i = 0; i < G; ++i) unit &= cnt[i] <= 1;
  if (__all_sync(FULL, unit)) {
    // no token of the group covers more than one cell (dense data): the
    // scan counts the starts below each lane
    const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane
#pragma unroll
    for (int i = 0; i < G; ++i) inc[i] = __popc(__ballot_sync(FULL, cnt[i] == 1) & upto);
  } else {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int up = __shfl_up_sync(FULL, inc[i], o);
        if (lane >= o) inc[i] += up;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int blk = __shfl_sync(FULL, b_l, i);
    const float sf = __shfl_sync(FULL, sf_l, i);
    const int cur = (ce[i] >> 5) + inc[i] - max(cnt[i], 0);
    if (i < n && cnt[i] >= 0 && cur < cells && blk >= 0 && blk < nnn)
      emit_token(out + (int64_t)blk * cells, stream + (k0 + i) * SUB + lane, b[i], cur,
                 cells, sf);
  }
}

}  // namespace cvx

extern "C" int cvx_decode_emit(const uint8_t* stream, const int32_t* M,
                               const int32_t* e32, const int32_t* c32,
                               const int32_t* sub_block, int64_t nsub,
                               const float* scalefac, int cells, int64_t nnn,
                               float* out,
                               void* stream_) {
  using namespace cvx;
  if (nsub == 0) return 0;
  const int g = nsub >= EMIT_SHORT ? EMIT_G : 1;
  const int64_t grid = ((nsub + g - 1) / g + DEC_WARPS - 1) / DEC_WARPS;
  auto kernel = g == EMIT_G ? decode_emit_kernel<EMIT_G> : decode_emit_kernel<1>;
  kernel<<<(unsigned)grid, DEC_WARPS * 32, 0, (cudaStream_t)stream_>>>(
      stream, M, e32, c32, sub_block, nsub, scalefac, cells, nnn, out);
  return (int)cudaGetLastError();
}
