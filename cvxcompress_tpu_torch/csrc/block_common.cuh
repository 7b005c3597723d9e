// Shared pieces of the 128^3 whole-block kernels (block_encode,
// block_encode_local, block_encode_w, block_inverse).
//
// A 128^3 f32 block is 8 MiB: it fits neither a CTA's shared memory nor a
// cluster's, so each kernel works on one 128 x 128 slice of a block at a
// time and the three axis passes split into two launches through device
// memory.  The slice sits in shared memory at a padded pitch of 129 words
// (64.5 KiB), so three CTAs of 256 threads share an SM and one CTA's copies
// overlap another's cascades.  Rows of 512 B move as float4s
// (load_slice / store_slice).
//
// One axis pass is the multi-level Antonini 7/9 cascade along the 128
// lines of the slice, rows or columns (cascade_lines): the levels 128, 64,
// ..., 2 forward, 2, ..., 128 inverse, each output pair computed by
// cascade.cuh's `fwd_pair` / `inv_pair` as the native library's parity
// cascade does it.  About 23 FLOP per cell and axis against the 256 of a
// dense 128-tap product.
//
// Mapping.  One lane per line, walking along it: a warp holds 32 lines,
// and the four warps of a group split each of the levels 128, 64 and 32
// into quarters,
// each lane computing its quarter's output pairs into registers with a
// window of taps that slides along the line (two shared-memory reads and
// two writes per pair).  Every tap is read before any output is written
// (the level works in place): the group's four warps meet at a named
// barrier between the reads and the writes.  With the 129-word pitch a
// word's bank is (line + position) mod 32 in either orientation, so the 32
// lanes of a warp, on 32 consecutive lines at one position, fall on 32
// banks for rows and columns alike.  The four outputs at each end of a
// level read mirrored taps, taken from small tables built once per CTA;
// which pairs those are is the same across a warp, so nothing diverges.
// The levels 16 to 2 (30 of a line's 254 outputs) run in one warp's
// registers, which spares them eight of the group's barriers.
#pragma once

#include "cascade.cuh"
#include "tokens.cuh"

namespace cvx {

constexpr int BB = 128;                  // block edge
constexpr int BB_CELLS = BB * BB * BB;   // 2^21 cells, 8 MiB of f32
constexpr int SLICE = BB * BB;           // cells of one 128 x 128 slice
constexpr int PITCH = BB + 1;            // padded row pitch in shared memory
constexpr int MAT = BB * PITCH;          // one padded 128 x 128 slice
constexpr int BT = 256;                  // threads per CTA (8 warps)
// one slice, dynamic shared memory (the launcher raises the limit)
constexpr size_t BSMEM = (size_t)MAT * sizeof(float);

// The levels n = 32 << i (i = 0..2) run in shared memory, the levels 16 to
// 2 in one thread's registers.  The shared-memory levels' mirrored tap
// positions, indexed by the virtual position v + 4: forward fwd = mirr(v,
// n) for v in [-4, n + 4); inverse lo = mirr_sl(v, n/2) and hi =
// mirr_sh(n/2 + v, n/2, n/2) (absolute) for v in [-4, n/2 + 4).
constexpr int SMALL = 16;  // the largest level held in registers
struct MirrorTables {
  unsigned char fwd[3][BB + 8];
  unsigned char lo[3][BB / 2 + 8];
  unsigned char hi[3][BB / 2 + 8];
};

// Every thread fills its share; the caller's next __syncthreads publishes.
__device__ __forceinline__ void build_tables(MirrorTables* t) {
  constexpr int NF = 3 * (BB + 8), NI = 3 * (BB / 2 + 8);
  for (int i = threadIdx.x; i < NF + 2 * NI; i += BT) {
    if (i < NF) {
      const int lv = i / (BB + 8), v = i % (BB + 8) - 4;
      t->fwd[lv][v + 4] = (unsigned char)mirr(v, 2 * SMALL << lv);
    } else {
      const int k = (i - NF) % NI, lv = k / (BB / 2 + 8);
      const int v = k % (BB / 2 + 8) - 4, h = SMALL << lv;
      if (i - NF < NI)
        t->lo[lv][v + 4] = (unsigned char)mirr_sl(v, h);
      else
        t->hi[lv][v + 4] = (unsigned char)mirr_sh(h + v, h, h);
    }
  }
}

// The four warps of a line group meet here (named barrier 1 + group, 128
// threads): a level's reads are done before any of its writes, and its
// writes before the next level's reads.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

// One analysis level of length N (32, 64 or 128) in place on the line at
// `p` (positions at a stride of PS): lowpass outputs to [0, N/2), highpass
// to [N/2, N).  This thread computes the output pairs j = s * S + m, m < S,
// of its quarter s with a window of the 9 taps 2j - 4 .. 2j + 4 that slides
// by 2 a pair.
template <int N, int PS>
__device__ __forceinline__ void fwd_level(float* p, int s, int group,
                                          const unsigned char* tab) {
  constexpr int P = N / 2, S = P / 4;
  float lo[S], hi[S], x[9];
#pragma unroll
  for (int m = 0; m < S; ++m) {
    const int j = s * S + m;
    if (m == 0) {
      if (j >= 2 && j < P - 2) {
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = p[(2 * j - 4 + k) * PS];
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = p[tab[2 * j + k] * PS];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 7; ++k) x[k] = x[k + 2];
      if (j < P - 2) {
        x[7] = p[(2 * j + 3) * PS];
        x[8] = p[(2 * j + 4) * PS];
      } else {
        x[7] = p[tab[2 * j + 7] * PS];
        x[8] = p[tab[2 * j + 8] * PS];
      }
    }
    fwd_pair(x, lo[m], hi[m]);
  }
  group_sync(group);
#pragma unroll
  for (int m = 0; m < S; ++m) {
    p[(s * S + m) * PS] = lo[m];
    p[(P + s * S + m) * PS] = hi[m];
  }
  group_sync(group);
}

// One synthesis level of length N (32, 64 or 128) in place: the bands
// [0, N/2) and [N/2, N) interleave into even and odd outputs.  The pairs
// k = s * S + m of quarter s, with windows of the 4 lowpass taps k - 1 ..
// k + 2 and the 5 highpass taps N/2 + k - 2 .. N/2 + k + 2, each sliding by
// 1 a pair.
template <int N, int PS>
__device__ __forceinline__ void inv_level(float* p, int s, int group,
                                          const unsigned char* tlo,
                                          const unsigned char* thi) {
  constexpr int P = N / 2, S = P / 4;
  float ev[S], od[S], L[4], H[5];
#pragma unroll
  for (int m = 0; m < S; ++m) {
    const int k = s * S + m;
    if (m == 0) {
      if (k >= 2 && k < P - 2) {
#pragma unroll
        for (int c = 0; c < 4; ++c) L[c] = p[(k - 1 + c) * PS];
#pragma unroll
        for (int c = 0; c < 5; ++c) H[c] = p[(P + k - 2 + c) * PS];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) L[c] = p[tlo[k + 3 + c] * PS];
#pragma unroll
        for (int c = 0; c < 5; ++c) H[c] = p[thi[k + 2 + c] * PS];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) L[c] = L[c + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) H[c] = H[c + 1];
      if (k < P - 2) {
        L[3] = p[(k + 2) * PS];
        H[4] = p[(P + k + 2) * PS];
      } else {
        L[3] = p[tlo[k + 6] * PS];
        H[4] = p[thi[k + 6] * PS];
      }
    }
    inv_pair(L, H, ev[m], od[m]);
  }
  group_sync(group);
#pragma unroll
  for (int m = 0; m < S; ++m) {
    p[2 * (s * S + m) * PS] = ev[m];
    p[(2 * (s * S + m) + 1) * PS] = od[m];
  }
  group_sync(group);
}

// The levels 16, 8, 4, 2 forward (or 2 .. 16 inverse) of one line in one
// thread's registers.
template <int PS, bool INVERSE>
__device__ __forceinline__ void small_levels(float* p) {
  float v[SMALL];
#pragma unroll
  for (int i = 0; i < SMALL; ++i) v[i] = p[i * PS];
  reg_cascade<INVERSE>(v);
#pragma unroll
  for (int i = 0; i < SMALL; ++i) p[i * PS] = v[i];
}

// The whole multi-level cascade along every line of the slice `s`: line i
// starts at s + i * LS, its positions at a stride of PS (rows: <PITCH, 1>,
// columns: <1, PITCH>).  Warps 4g .. 4g + 3 own lines 64g .. 64g + 63, 32
// at a time, lane l line 64g + 32r + l, warp 4g + q its quarter q of each
// shared-memory level's outputs; warp 4g alone runs the levels in
// registers.  The caller synchronises the CTA before (the slice is loaded)
// and after.
template <int LS, int PS, bool INVERSE>
__device__ __forceinline__ void cascade_lines(float* s, const MirrorTables& t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, q = warp & 3;
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    float* p = s + (64 * group + 32 * r + lane) * LS;
    if constexpr (INVERSE) {
      if (q == 0) small_levels<PS, true>(p);
      group_sync(group);
      inv_level<32, PS>(p, q, group, t.lo[0], t.hi[0]);
      inv_level<64, PS>(p, q, group, t.lo[1], t.hi[1]);
      inv_level<128, PS>(p, q, group, t.lo[2], t.hi[2]);
    } else {
      fwd_level<128, PS>(p, q, group, t.fwd[2]);
      fwd_level<64, PS>(p, q, group, t.fwd[1]);
      fwd_level<32, PS>(p, q, group, t.fwd[0]);
      if (q == 0) small_levels<PS, false>(p);
    }
  }
}

// Lane l of warp w moves, at step i, the float4 at row
// 4 * ((w + 8i) >> 2) + (l & 3), column 32 * ((w + 8i) & 3) + 4 * (l >> 2):
// 8 lanes cover 128 contiguous bytes of a row, and the four scalar
// shared-memory accesses of each float4 fall on 32 banks per warp.
__device__ __forceinline__ int slice_step(int i, int& c) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, step = w + 8 * i;
  c = 32 * (step & 3) + 4 * (l >> 2);
  return 4 * (step >> 2) + (l & 3);
}

// s[r * PITCH + c] = src[r * stride + c] for the 128 x 128 slice (src and
// stride 16-byte aligned), eight float4 loads in flight per thread.
__device__ __forceinline__ void load_slice(float* s, const float* src,
                                           int64_t stride) {
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int c;
      const int r = slice_step(8 * h + i, c);
      v[i] = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int c;
      float* d = s + slice_step(8 * h + i, c) * PITCH;
      d[c] = v[i].x;
      d[c + 1] = v[i].y;
      d[c + 2] = v[i].z;
      d[c + 3] = v[i].w;
    }
  }
}

// dst[r * stride + c] = s[r * PITCH + c], float4 stores.
__device__ __forceinline__ void store_slice(float* dst, int64_t stride,
                                            const float* s) {
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    int c;
    const int r = slice_step(i, c);
    const float* q = s + r * PITCH + c;
    *reinterpret_cast<float4*>(dst + r * stride + c) =
        make_float4(q[0], q[1], q[2], q[3]);
  }
}

// The block's volume origin from its raster index (nx, ny multiples of 128).
struct BlockOrigin {
  int64_t x0, y0, z0;
};
__device__ __forceinline__ BlockOrigin block_origin(int64_t blk, int nx,
                                                    int ny) {
  const int64_t nbx = nx / BB, nby = ny / BB;
  return {(blk % nbx) * BB, ((blk / nbx) % nby) * BB, (blk / (nbx * nby)) * BB};
}

// The x, then y forward cascade of one z-slice: the slice of `src` (16,384
// contiguous cells) into `s` at the padded pitch, the two passes; the
// slice's coefficients are left in `s`.  `t` is built and published by the
// __syncthreads after the load.
__device__ __forceinline__ void slice_xy(const float* src,
                                         const MirrorTables& t, float* s) {
  load_slice(s, src, BB);
  __syncthreads();
  cascade_lines<PITCH, 1, false>(s, t);  // x: along each row y
  __syncthreads();
  cascade_lines<1, PITCH, false>(s, t);  // y: along each column x
  __syncthreads();
}

__device__ __forceinline__ int32_t quantized(const float* s, int c,
                                             float mulfac) {
  return cvtt(__fmul_rn(s[(c >> 7) * PITCH + (c & (BB - 1))], mulfac));
}

// The tokenize of one z-slice, shared by block_encode_xy and block_encode_y
// (the global RMS).  `s` holds the slice's UNSCALED coefficients
// at the padded pitch, `tile` = block * 128 + z comes from the launch's
// atomic ticket, `mulfac` is the block's.  fv = c * mulfac (one f32
// rounding), cvttps, the classes, group-of-8 modes and per-cell descriptors
// (cost | run_end << 3 | min(run_len, 2^24-1) << 4), per 128-cell chunk its
// byte count and per block its size (atomic integer adds into zeroed
// counters, exact in any order); the z = 0 slice writes the block's mulfac
// into the table.
//
// The zero-run carry.  A run crosses z-slices and chunks and resets only at
// a block start, so a slice's leading zeros need the last non-zero cell of
// the slices before it.  Single-pass decoupled look-back: the CTA publishes
// its own last non-zero cell in status[tile], then walks back over the
// published slices of its block until one holds a non-zero cell (or the
// block starts).  The ticket order means every earlier slice's CTA has
// started, and a CTA publishes before it waits on anything, so the walk
// always ends.  The last cell of a slice, when zero and not the block's
// last, belongs to the next slice's CTA: only that CTA knows whether the run
// ends there; it writes the descriptor and adds its cost to the chunk and
// the block.  Every slice of a block has the block's one mulfac, so that
// CTA quantizes its own first cell with the same factor.
__device__ __forceinline__ void slice_tokenize(
    const float* s, float mulfac, int tile, int* __restrict__ status,
    int32_t* __restrict__ desc, int32_t* __restrict__ chunk_bytes,
    int32_t* __restrict__ sizes, float* __restrict__ mulfacs, int* scan_buf,
    int* s_carry) {
  const int64_t blk = tile >> 7;
  const int z = tile & (BB - 1);
  const int gbase = z * SLICE;  // the slice's first cell in its block
  const int64_t off = blk * BB_CELLS + gbase;
  if (z == 0 && threadIdx.x == 0) mulfacs[blk] = mulfac;

  // thread t owns the slice's cells [64t, 64t + 64): eight whole groups
  constexpr int PER = SLICE / BT;
  const int c0 = threadIdx.x * PER;
  uint64_t nonzero = 0;
  for (int i = 0; i < PER; ++i)
    nonzero |= (uint64_t)(quantized(s, c0 + i, mulfac) != 0) << i;
  const int last_local = nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
  const bool next_zero =
      c0 + PER < SLICE && quantized(s, c0 + PER, mulfac) == 0;
  int slice_last;
  const int excl =
      block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &slice_last);

  if (threadIdx.x == 0) {
    atomicExch(&status[tile], slice_last + 2);  // 1: no non-zero cell
    int carry = -1;  // last non-zero cell before the slice, in the block
    for (int p = 1; p <= z; ++p) {
      int v;
      while ((v = atomicAdd(&status[tile - p], 0)) == 0) __nanosleep(64);
      if (v >= 2) {
        carry = (z - p) * SLICE + v - 2;
        break;
      }
    }
    *s_carry = carry;
    // the previous slice's last cell, when zero, is this CTA's to write
    if (z > 0 && carry < gbase - 1) {
      const bool run_end = quantized(s, 0, mulfac) != 0;
      const int32_t d = zero_desc(run_end, gbase - 1 - carry);
      desc[off - 1] = d;
      if (d & 7) {
        atomicAdd(&chunk_bytes[(off - 1) >> 7], d & 7);
        atomicAdd(&sizes[blk], d & 7);
      }
    }
  }
  __syncthreads();

  int last = excl >= 0 ? gbase + excl : *s_carry;
  // the slice's last cell when zero and z < 127: the next CTA's (above)
  const bool hand_off = z < BB - 1 && threadIdx.x == BT - 1 && !(nonzero >> 63);
  int total_cost = 0;
  int32_t* dst = desc + off + c0;
  for (int g = 0; g < PER / 8; ++g) {
    int32_t iv[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) iv[l] = quantized(s, c0 + 8 * g + l, mulfac);
    const int mode = group_mode(iv);
    int32_t d[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int i = 8 * g + l;
      const int gc = gbase + c0 + i;
      if (iv[l] != 0) {
        last = gc;
        d[l] = value_cost(mode, l, iv[l]);
      } else {
        // the block's end also ends a run (z == 127, last thread)
        const bool nz_next = i + 1 < PER ? ((nonzero >> (i + 1)) & 1) != 0
                                         : !next_zero;
        d[l] = zero_desc(nz_next, gc - last);
      }
      total_cost += d[l] & 7;
    }
    if (hand_off && g == PER / 8 - 1) {
      total_cost -= d[7] & 7;
#pragma unroll
      for (int l = 0; l < 7; ++l) dst[8 * g + l] = d[l];
    } else {
      int4* v = reinterpret_cast<int4*>(dst + 8 * g);
      v[0] = make_int4(d[0], d[1], d[2], d[3]);
      v[1] = make_int4(d[4], d[5], d[6], d[7]);
    }
  }
  // two threads per 128-cell chunk
  const int pair = total_cost + __shfl_xor_sync(0xffffffffu, total_cost, 1);
  if ((threadIdx.x & 1) == 0 && pair)
    atomicAdd(&chunk_bytes[(off + c0) >> 7], pair);
  int wsum = total_cost;
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1)
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o2);
  if ((threadIdx.x & 31) == 0 && wsum) atomicAdd(&sizes[blk], wsum);
}

// Zero the look-back ticket and status words, the chunk counters and the
// block sizes of an encode launch over nnn blocks (on every call).
__host__ inline cudaError_t reset_encode_counters(int* scratch,
                                                  int32_t* chunk_bytes,
                                                  int32_t* sizes, int64_t nnn,
                                                  cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(scratch, 0, (1 + nnn * BB) * sizeof(int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(chunk_bytes, 0,
                        nnn * (BB_CELLS / 128) * sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  return e;
}

}  // namespace cvx
