// Shared pieces of the entropy decode kernels (decode_maps, decode_chase,
// decode_emit): the stream's geometry and the token grammar of
// Run_Length_Decode_Slow as cvxcompress_tpu/ops/entropy_decode.py states it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cvx {

constexpr int SUB = 32;         // subsegment bytes: one warp, lane = byte
constexpr int ENTRIES = 25;     // entry offsets (the longest token is 25 B)
constexpr int DEC_WARPS = 8;    // warps per CTA of the per-subsegment kernels
constexpr unsigned FULL = 0xffffffffu;

// Token length from its first byte, as a signed byte (_LENGTHS).
__device__ __forceinline__ int token_len(int sv) {
  switch (sv) {
    case 127: return 2;    // RLESC1
    case 125: return 4;    // RLESC3
    case -125: return 3;   // VLESC2
    case -127: return 4;   // VLESC3
    case -126: return 17;  // VLESC2_8x
    case 126: return 25;   // VLESC3_8x
    case -128: return 5;   // VLESC4
    default: return 1;     // a plain byte (0 is a single zero)
  }
}

// Cells a token covers when it starts here: the run of RLESC1 and RLESC3
// (the latter saturated at `cells`), 8 for a group, 1 otherwise.
__device__ __forceinline__ int token_count(int sv, int b1, int b2, int b3,
                                           int cells) {
  if (sv == 127) return b1;
  if (sv == 125) return min(b1 | (b2 << 8) | (b3 << 16), cells);
  if (sv == -126 || sv == 126) return 8;
  return 1;
}

}  // namespace cvx
