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
// A warp takes MAPS_G consecutive subsegments, lane p = byte p of each; it
// issues the loads of all of them first: two aligned words a lane (the
// word holding byte p and the next one), so that a funnel shift gives the
// token's first four bytes; the stream is contiguous, so the last lanes'
// next word is the next subsegment's or the zero padding after the stream.
// Then, for each subsegment, pointer doubling: lane p holds J (where the
// tokens followed from p end), V (the token starts reached from p, one bit
// each) and S (the cells they cover), and 5 rounds of "if J < 32:
// V |= V[J], S += S[J], J = J[J]" follow every chain of up to 32 tokens:
// two shuffles a round, V, and J and S packed in one word (S saturated at
// `cells` on each addition only for blocks over MAPS_UNSAT_CELLS); the
// group's shuffles interleave.  When every token of the group is one byte
// (dense data) the chains are known without doubling.  Lane e < 25 then
// has P[e] = min(S, cells) * 32 + J - 32, and M is the transpose of the 25
// entry rows V[e] (bit p of V[e] is bit e of M[p]): a 5-stage shuffle
// butterfly, a shuffle, a rotate and a masked merge a stage.
// What bounds it on an H100: at the main path's sizes (0.2 MB of stream at
// the reference CI config) the launch; at scale, the 228 bytes of M and P
// it writes per 32 bytes of stream, and the issue of ~15 shuffles a
// subsegment beside its loads and stores.  The design before this one
// pushed each lane's mask in 32 rounds of two shuffles and summed the
// entries serially from shared memory: ~165 shuffle and shared-memory
// issues a subsegment.

#include "decode_common.cuh"

namespace cvx {

constexpr int MAPS_G = 4;  // subsegments a warp
// Up to this many cells a block, the sums of a chain within a subsegment
// (at most 8 RLESC3 runs of `cells`, 255 a RLESC1 run, 8 a group) stay
// below 2^26 and need no saturation before the end: S and J share a word.
constexpr int MAPS_UNSAT_CELLS = 1 << 22;

template <bool SAT>
__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_maps_kernel(const uint32_t* __restrict__ words, int64_t nsub, int cells,
                   int32_t* __restrict__ M, int32_t* __restrict__ P) {
  const int lane = threadIdx.x & 31;
  const int64_t k0 = ((int64_t)blockIdx.x * DEC_WARPS + (threadIdx.x >> 5)) * MAPS_G;
  if (k0 >= nsub) return;  // uniform over the warp

  // the group's loads first; a subsegment past the end repeats the last
  // one (its results are not stored), so the loops below hold no branch
  // and the group's independent shuffles interleave
  const int n = (int)min((int64_t)MAPS_G, nsub - k0);  // the warp's subsegments
  const uint32_t* w0 = words + k0 * (SUB / 4) + (lane >> 2);
  uint32_t lo[MAPS_G], hi[MAPS_G];
#pragma unroll
  for (int i = 0; i < MAPS_G; ++i) {
    const uint32_t* w = w0 + (n == MAPS_G ? i : min(i, n - 1)) * (SUB / 4);
    lo[i] = __ldg(w);
    hi[i] = __ldg(w + 1);
  }
  // lane p: V, and js = S << 6 | J (J < 64, S < 2^26)
  uint32_t V[MAPS_G], js[MAPS_G];
  bool ones = true;
#pragma unroll
  for (int i = 0; i < MAPS_G; ++i) {
    const Token t = token_at(__funnelshift_r(lo[i], hi[i], (lane & 3) * 8), cells);
    js[i] = ((uint32_t)min(t.cnt, cells) << 6) | (uint32_t)(lane + t.len);
    V[i] = 1u << lane;
    ones &= t.len == 1;
  }
  if (__all_sync(FULL, ones)) {
    // every token of the group one byte (dense data): each chain runs on
    // to the end, one cell a byte
#pragma unroll
    for (int i = 0; i < MAPS_G; ++i) {
      js[i] = ((uint32_t)min(SUB - lane, cells) << 6) | SUB;
      V[i] = ~0u << lane;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 5; ++r) {  // 2^5 = 32 tokens: any chain within 32 bytes
#pragma unroll
      for (int i = 0; i < MAPS_G; ++i) {
        // the source lane is J mod 32; a lane whose J >= 32 is done
        const uint32_t vq = __shfl_sync(FULL, V[i], js[i]);
        const uint32_t jq = __shfl_sync(FULL, js[i], js[i]);
        if (!(js[i] & SUB)) {
          V[i] |= vq;
          js[i] = SAT ? (min((js[i] >> 6) + (jq >> 6), (uint32_t)cells) << 6) | (jq & 63u)
                      : (js[i] & ~63u) + jq;
        }
      }
    }
  }
  int32_t* const Pk = P + k0 * ENTRIES + lane;
#pragma unroll
  for (int i = 0; i < MAPS_G; ++i)
    if (lane < ENTRIES && i < n)
      Pk[i * ENTRIES] = min((int)(js[i] >> 6), cells) * 32 + (int)(js[i] & 63u) - SUB;

  // M: the transpose of the entry rows (row e = V of lane e, 0 past them),
  // a butterfly: at stage j the lane keeps its half of the bits and takes
  // the other half from lane ^ j, rotated into place
  uint32_t x[MAPS_G];
#pragma unroll
  for (int i = 0; i < MAPS_G; ++i) x[i] = lane < ENTRIES ? V[i] : 0u;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const uint32_t m = j == 16 ? 0x0000ffffu : j == 8 ? 0x00ff00ffu
                     : j == 4 ? 0x0f0f0f0fu : j == 2 ? 0x33333333u : 0x55555555u;
    const bool up = lane & j;
    const uint32_t keep = up ? ~m : m;
    const int rot = up ? 32 - j : j;
#pragma unroll
    for (int i = 0; i < MAPS_G; ++i) {
      const uint32_t y = __shfl_xor_sync(FULL, x[i], j);
      x[i] = (x[i] & keep) | (__funnelshift_l(y, y, rot) & ~keep);
    }
  }
  int32_t* const Mk = M + k0 * SUB + lane;
#pragma unroll
  for (int i = 0; i < MAPS_G; ++i)
    if (i < n) Mk[i * SUB] = (int32_t)x[i];
}

}  // namespace cvx

extern "C" int cvx_decode_maps(const uint8_t* stream, int64_t nsub, int cells,
                               int32_t* M, int32_t* P, void* stream_) {
  using namespace cvx;
  if (nsub == 0) return 0;
  const int64_t warps = (nsub + MAPS_G - 1) / MAPS_G;
  const int64_t grid = (warps + DEC_WARPS - 1) / DEC_WARPS;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stream);
  if (cells <= MAPS_UNSAT_CELLS)
    decode_maps_kernel<false><<<(unsigned)grid, DEC_WARPS * 32, 0, (cudaStream_t)stream_>>>(
        words, nsub, cells, M, P);
  else
    decode_maps_kernel<true><<<(unsigned)grid, DEC_WARPS * 32, 0, (cudaStream_t)stream_>>>(
        words, nsub, cells, M, P);
  return (int)cudaGetLastError();
}
