// decode_maps: stage 1 of the parallel entropy parse.  For every 32-byte
// subsegment k of the aligned stream:
//   M[k][p]  25-bit mask, bit e set when byte p starts a token under the
//            hypothesis "the subsegment is entered at offset e";
//   P[k][e]  = min(NV, cells) * 32 + T: under entry e, the offset T at which
//            the token chain leaves the subsegment and the cells NV its
//            tokens cover.
//
// Replaces the XLA stage of cvxcompress_tpu/ops/entropy_decode.py
// `_parse_stages` (:336; the bit-DP :367-379, the per-entry reductions
// :384-394, the packing :444).  There is no Pallas kernel behind it; as
// PyTorch ops it is some 250 small launches on the decompress path.
//
// One warp per subsegment, lane p = byte p.  A lane reads its token's first
// four bytes (the stream is contiguous, so reads past the subsegment reach
// the next one or the zero padding after the stream), knows its token's
// length and cell count, and the DP pushes each lane's mask to the lane its
// token ends at, in byte order (32 shuffle rounds).  Lane e < 25 then sums
// the 32 lanes' contributions for its entry from shared memory.
// What bounds it on an H100: launch and latency at the main path's sizes
// (0.2 MB of stream at the reference CI config); at scale, the 228 bytes
// of M and P it writes per 32 bytes of stream.

#include "decode_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_maps_kernel(const uint8_t* __restrict__ stream, int64_t nsub,
                   int cells, int32_t* __restrict__ M,
                   int32_t* __restrict__ P) {
  __shared__ int s_mask[DEC_WARPS][SUB];
  __shared__ int s_exit[DEC_WARPS][SUB];
  __shared__ int s_vals[DEC_WARPS][SUB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t k = (int64_t)blockIdx.x * DEC_WARPS + warp;
  if (k >= nsub) return;  // uniform over the warp

  const uint8_t* s = stream + k * SUB + lane;
  const int sv = (int)(int8_t)s[0];
  const int len = token_len(sv);
  const int vals = token_count(sv, s[1], s[2], s[3], cells);
  const int nxt = lane + len;  // where this lane's token ends

  // M: lane p's mask is final once every earlier lane has pushed
  int mask = lane < ENTRIES ? (1 << lane) : 0;
#pragma unroll
  for (int q = 0; q < SUB; ++q) {
    const int m = __shfl_sync(FULL, mask, q);
    const int t = __shfl_sync(FULL, nxt, q);
    if (lane == t) mask |= m;
  }
  M[k * SUB + lane] = mask;
  s_mask[warp][lane] = mask;
  s_exit[warp][lane] = nxt >= SUB ? nxt - SUB : 0;
  s_vals[warp][lane] = vals;
  __syncwarp();

  if (lane < ENTRIES) {
    int t = 0, nv = 0;
#pragma unroll 8
    for (int p = 0; p < SUB; ++p) {
      if ((s_mask[warp][p] >> lane) & 1) {
        t += s_exit[warp][p];
        nv += s_vals[warp][p];
      }
    }
    P[k * ENTRIES + lane] = min(nv, cells) * 32 + t;
  }
}

}  // namespace cvx

extern "C" int cvx_decode_maps(const uint8_t* stream, int64_t nsub, int cells,
                               int32_t* M, int32_t* P, void* stream_) {
  using namespace cvx;
  if (nsub == 0) return 0;
  const int64_t grid = (nsub + DEC_WARPS - 1) / DEC_WARPS;
  decode_maps_kernel<<<(unsigned)grid, DEC_WARPS * 32, 0,
                       (cudaStream_t)stream_>>>(stream, nsub, cells, M, P);
  return (int)cudaGetLastError();
}
