// The status words of a decoupled look-back (decode_chase.cu,
// tokenize_stripe.cu).  Every word carries its own flag beside its value,
// so a word a reader sees published is whole and no fence orders it
// against other data: writers store and readers load at gpu scope,
// relaxed (through L2, past the SM's L1).
#pragma once

namespace cvx {

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

}  // namespace cvx
