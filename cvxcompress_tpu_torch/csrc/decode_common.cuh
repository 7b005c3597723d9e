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

// The token that starts with the four stream bytes in `b` (little endian):
// its length (_LENGTHS) and the cells it covers: the run of RLESC1 and
// RLESC3 (the latter saturated at `cells`), 8 for a group, 1 otherwise.
// The escapes are the bytes 0x7D..0x83, so their lengths come from one
// byte permute of a table, with no branch.
struct Token {
  int len, cnt;
};

__device__ __forceinline__ Token token_at(uint32_t b, int cells) {
  const uint32_t idx = (b - 0x7Du) & 255u;  // 0..6: RLESC3, VLESC3_8x, RLESC1,
  const bool esc = idx < 7;                 // VLESC4, VLESC3, VLESC2_8x, VLESC2
  const int run = (int)(b >> 8);            // bytes 1..3
  Token t;
  t.len = esc ? (int)(__byte_perm(0x05021904u, 0x00031104u, idx) & 255u) : 1;
  t.cnt = idx == 0 ? min(run, cells) : idx == 2 ? (run & 255)
        : idx == 1 || idx == 5 ? 8 : 1;
  return t;
}

}  // namespace cvx
