// The status words of a decoupled look-back (decode_chase.cu, the
// tokenizes of stripe_tok.cuh: tokenize_stripe.cu, tokenize_compact.cu,
// block_encode_local.cu).  Every word carries its own flag beside its
// value, so a word a reader sees published is whole and no fence orders it
// against other data: writers store and readers load at gpu scope,
// relaxed (through L2, past the SM's L1).
#pragma once

#include <cstdint>

namespace cvx {

// A 32-bit status word of a tile: its flag in the top two bits, its value
// in the other 30 (0 until the tile publishes).
constexpr unsigned LB_AGG = 1u << 30;   // the tile's own value (aggregate)
constexpr unsigned LB_INCL = 2u << 30;  // the value up to and including the tile
constexpr unsigned LB_VALUE = LB_AGG - 1;

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Waits until the word at p is non-zero (published) and returns it.  A
// word still unpublished after 2^24 polls (seconds) means a broken launch:
// the kernel traps (the launch fails) rather than hang the card.
__device__ __forceinline__ unsigned wait_status(const unsigned* p) {
  unsigned v;
  for (unsigned polls = 0; (v = ld_relaxed(p)) == 0; ++polls) {
    if (polls >> 24) __trap();
    __nanosleep(32);
  }
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// wait_status of a 64-bit word.
__device__ __forceinline__ unsigned long long wait_status64(const unsigned long long* p) {
  unsigned long long v;
  for (unsigned polls = 0; (v = ld_relaxed64(p)) == 0; ++polls) {
    if (polls >> 24) __trap();
    __nanosleep(32);
  }
  return v;
}

// The first 32-word window of tile t's walk back to `lo` (warp-wide, a
// lane a word: status[t - 1 - lane], LB_INCL below lo), read ahead of the
// walk so that its latency hides under other work; 0 where a word was not
// yet published.
__device__ __forceinline__ unsigned peek_window(const unsigned* status, int64_t t,
                                                int64_t lo) {
  const int64_t r = t - 1 - (threadIdx.x & 31);
  return r >= lo ? ld_relaxed(&status[r]) : LB_INCL;
}

// The exclusive prefix sum of the tiles' counts, by a decoupled look-back
// (warp-wide, the lanes of one warp).  prefix_publish: tile t's own count
// (LB_AGG; the first tile's is inclusive).  prefix_walk, once the tile has
// published: reads the earlier tiles' words 32 at a time (a lane each; the
// first window may come from peek_window), adds their values up to and
// including the nearest inclusive one (a shuffle reduction), steps back 32
// until it meets one, then publishes its inclusive sum (LB_INCL) and
// returns the exclusive one.  Every tile publishes its count before it
// waits on anything, so the walk ends.  Counts and sums below 2^30.
__device__ __forceinline__ void prefix_publish(unsigned* status, int64_t t, unsigned count) {
  if ((threadIdx.x & 31) == 0) st_relaxed(&status[t], (t ? LB_AGG : LB_INCL) | count);
}

__device__ __forceinline__ unsigned prefix_walk(unsigned* status, int64_t t, unsigned count,
                                                unsigned pre) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int64_t base = t - 1; base >= 0; base -= 32) {
    const int64_t r = base - lane;
    const unsigned f =
        base == t - 1 && pre ? pre : r >= 0 ? wait_status(&status[r]) : LB_INCL;
    const unsigned incl = __ballot_sync(~0u, (f & LB_INCL) != 0);
    // the lanes up to the first inclusive one (all 32 when there is none)
    unsigned v = incl == 0 || lane < __ffs(incl) ? f & LB_VALUE : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
    excl += v;
    if (incl) break;
  }
  if (t && lane == 0) st_relaxed(&status[t], LB_INCL | (excl + count));
  return excl;
}

}  // namespace cvx
