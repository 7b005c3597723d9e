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
// One warp per subsegment, lane = byte.  Lane p starts a token when bit
// e32[k] of M[k][p] is set; a warp scan of the starts' cell counts gives
// each token's cursor, min(c32[k] + exclusive sum, cells) (:749-752).  The
// starting lane then writes its value(s): a plain byte and the VLESC2/3/4
// escapes one, VLESC2_8x and VLESC3_8x eight at cursor + j, the runs none
// (the buffer is zero).  Every value is __fmul_rn(v, scalefac[block of the
// chain]): one f32 rounding and no FMA contraction, bit-exact with the host
// decoders.  The host computes the (nnn,) table as 1.0f / mulfac (one value
// repeated under the global RMS, 1 / blkmulfac[b] under the local RMS):
// a reciprocal on the card could round differently.
// Positions >= cells and blocks >= nnn (the padding subsegments) are
// dropped, so a corrupt stream never writes outside the buffer, and all of
// a chain's writes go to its own block at strictly increasing cursors:
// live targets are unique and need no atomics.
// What bounds it on an H100: reading M (4 bytes per stream byte) and the
// scattered 4-byte stores of the non-zero values; the 187 MB zeroing of the
// buffer at the reference CI config is a memset before it.

#include "decode_common.cuh"

namespace cvx {

__device__ __forceinline__ void put(float* blk_out, int pos, int cells,
                                    float v, float sf) {
  if (pos < cells) blk_out[pos] = __fmul_rn(v, sf);
}

__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_emit_kernel(const uint8_t* __restrict__ stream,
                   const int32_t* __restrict__ M,
                   const int32_t* __restrict__ e32,
                   const int32_t* __restrict__ c32,
                   const int32_t* __restrict__ sub_block, int64_t nsub,
                   const float* __restrict__ scalefac, int cells, int64_t nnn,
                   float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * DEC_WARPS + warp;
  if (k >= nsub) return;  // uniform over the warp

  const uint8_t* s = stream + k * SUB + lane;
  const int sv = (int)(int8_t)s[0];
  const int start = (M[k * SUB + lane] >> (e32[k] & 31)) & 1;
  const int cnt = start ? token_count(sv, s[1], s[2], s[3], cells) : 0;
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += n;
  }
  const int cur = min(c32[k] + (inc - cnt), cells);
  const int64_t blk = sub_block[k];
  if (!start || cur >= cells || blk < 0 || blk >= nnn) return;

  float* o = out + blk * (int64_t)cells;
  const float sf = scalefac[blk];
  if (sv > -125 && sv < 125) {
    put(o, cur, cells, (float)sv, sf);
  } else if (sv == -125) {  // VLESC2: i16
    put(o, cur, cells, (float)(int16_t)(s[1] | (s[2] << 8)), sf);
  } else if (sv == -127) {  // VLESC3: i24
    const int v = (int)((uint32_t)(s[1] | (s[2] << 8) | (s[3] << 16)) << 8) >> 8;
    put(o, cur, cells, (float)v, sf);
  } else if (sv == -128) {  // VLESC4: the scaled f32 itself
    const uint32_t bits = (uint32_t)s[1] | ((uint32_t)s[2] << 8) |
                          ((uint32_t)s[3] << 16) | ((uint32_t)s[4] << 24);
    put(o, cur, cells, __uint_as_float(bits), sf);
  } else if (sv == -126) {  // VLESC2_8x: eight i16
#pragma unroll
    for (int j = 0; j < 8; ++j)
      put(o, cur + j, cells,
          (float)(int16_t)(s[1 + 2 * j] | (s[2 + 2 * j] << 8)), sf);
  } else if (sv == 126) {  // VLESC3_8x: eight i24
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u =
          s[1 + 3 * j] | (s[2 + 3 * j] << 8) | (s[3 + 3 * j] << 16);
      put(o, cur + j, cells, (float)((int)(u << 8) >> 8), sf);
    }
  }
  // RLESC1 (127) and RLESC3 (125): zero runs, nothing to write
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
  const int64_t grid = (nsub + DEC_WARPS - 1) / DEC_WARPS;
  decode_emit_kernel<<<(unsigned)grid, DEC_WARPS * 32, 0,
                       (cudaStream_t)stream_>>>(stream, M, e32, c32,
                                                sub_block, nsub, scalefac,
                                                cells,
                                                nnn, out);
  return (int)cudaGetLastError();
}
