// decode_chase: stage 2 of the parallel entropy parse, the cross-subsegment
// recurrence.  Along a chain of subsegments, with (e, c) = (0, 0) at its
// start:
//   e32[k] = e, c32[k] = c;  then  e = T[k][e], c = min(c + NV[k][e], cells)
// where P[k][e] = NV * 32 + T (decode_maps.cu).
//
// Replaces the TPU kernel entropy_decode._chase_pallas
// (cvxcompress_tpu/ops/entropy_decode.py:258, call :310), whose body
// (:295-304) is these semantics; the JAX default computes the same with a
// Sklansky scan in XLA (:396-487).  On the TPU the chase is one serial chain
// on the scalar core.  Here every block start (and every padding
// subsegment) resets the state, so the chains are independent: the host
// passes their starts, and one warp walks each chain.
//
// The walk's only dependency is e: the next row P[k] does not depend on it.
// So the warp loads 32 rows at a time (lane l < 25 holds P[k + j][l] for
// j < 32: 32 independent, coalesced 100-byte loads in flight), then steps
// through them with one shuffle each (e = P[k][e] is lane e's register).
// Lane j keeps the state of step j and the warp stores 32 states at once.
// What bounds it on an H100: one memory latency per 32 steps plus a
// shuffle per step, along the longest chain (a block of 1,024
// subsegments at the noise container's 4:1 ratio; 4 at the CI config).

#include "decode_common.cuh"

namespace cvx {

constexpr int BATCH = 32;

__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_chase_kernel(const int32_t* __restrict__ P,
                    const int32_t* __restrict__ starts, int64_t nchains,
                    int64_t nsub, int cells, int32_t* __restrict__ e32,
                    int32_t* __restrict__ c32) {
  const int lane = threadIdx.x & 31;
  const int64_t chain = (int64_t)blockIdx.x * DEC_WARPS + (threadIdx.x >> 5);
  if (chain >= nchains) return;  // uniform over the warp
  const int64_t k0 = starts[chain];
  const int64_t k1 = chain + 1 < nchains ? (int64_t)starts[chain + 1] : nsub;

  int e = 0, c = 0;
  for (int64_t kb = k0; kb < k1; kb += BATCH) {
    const int n = (int)min((int64_t)BATCH, k1 - kb);
    int row[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      row[j] = (lane < ENTRIES && j < n) ? P[(kb + j) * ENTRIES + lane] : 0;
    int my_e = 0, my_c = 0;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (j < n) {  // uniform over the warp
        if (lane == j) {
          my_e = e;
          my_c = c;
        }
        const int pk = __shfl_sync(FULL, row[j], e);
        e = pk & 31;
        c = min(c + (pk >> 5), cells);
      }
    }
    if (lane < n) {
      e32[kb + lane] = my_e;
      c32[kb + lane] = my_c;
    }
  }
}

}  // namespace cvx

extern "C" int cvx_decode_chase(const int32_t* P, const int32_t* starts,
                                int64_t nchains, int64_t nsub, int cells,
                                int32_t* e32, int32_t* c32, void* stream) {
  using namespace cvx;
  if (nchains == 0) return 0;
  const int64_t grid = (nchains + DEC_WARPS - 1) / DEC_WARPS;
  decode_chase_kernel<<<(unsigned)grid, DEC_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(P, starts, nchains, nsub,
                                                cells, e32, c32);
  return (int)cudaGetLastError();
}
