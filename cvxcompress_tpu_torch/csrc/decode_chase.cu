// decode_chase: stage 2 of the parallel entropy parse, the cross-subsegment
// recurrence.  Along a chain of subsegments, with (e, c) = (0, 0) at its
// start (every subsegment with sub_reset, and subsegment 0):
//   e32[k] = e, c32[k] = c;  then  e = T[k][e], c = min(c + NV[k][e], cells)
// where P[k][e] = NV * 32 + T (decode_maps.cu).
//
// Replaces the TPU kernel entropy_decode._chase_pallas
// (cvxcompress_tpu/ops/entropy_decode.py:258, call :310), whose body
// (:295-304) is these semantics; on the TPU one serial chain on the scalar
// core.  The JAX default computes the same with a Sklansky scan in XLA
// (:396-487), because a step is a map over the 25 entry states and maps
// compose associatively; the saturating count composes too,
// min(min(c + a, cells) + b, cells) = min(c + a + b, cells) for a, b >= 0.
//
// Two routes, one launch each; ops/entropy_decode.py `chase_walks` picks
// one from the stream's chain count, its length and the block's cells.
//
// The walk (short chains, as a smooth volume's 32^3 blocks give: ~4
// subsegments a block).  Every block start (and every padding subsegment)
// resets the state, so the chains are independent: the host passes their
// starts, and one warp walks each chain.  The walk's only dependency is e:
// the next row P[k] does not depend on it.  So the warp loads 32 rows at a
// time (lane l < 25 holds P[k + j][l] for j < 32: 32 independent,
// coalesced 100-byte loads in flight), then steps through them with one
// shuffle each (e = P[k][e] is lane e's register).  Lane j keeps the state
// of step j and the warp stores 32 states at once.  It is bound by one
// memory latency per 32 steps plus a shuffle per step, along the longest
// chain, and needs no workspace.
//
// The pieces (long chains).  The subsegments are cut into pieces of `piece`
// rows (at most PIECE; fewer for a short stream, so that its pieces fill
// the card), whatever the chains.  A CTA takes a unit of consecutive pieces
// (8, or fewer for a short stream) from an atomic ticket, a warp a piece:
// 1. Lane x < 25 walks the piece from entry x, all 25 trajectories at once
//    (one shuffle a row: lane l holds P[k][l], the next 32 rows' loads in
//    flight), and keeps each row's state (count since the piece's start
//    << 5 | offset) in shared memory.  A reset sets every lane to (0, 0), so
//    after one the trajectories agree and the piece's map is constant.
// 2. Warp 0 composes the unit's map from its pieces' maps (a shared-memory
//    gather each) and publishes it at once in 25 status words (lane x word
//    x, its flag beside its value, so a reader needs no fence): the exit
//    state, flagged inclusive, when a piece holds a reset, else entry x's
//    exit and count (saturated at cells), flagged as an aggregate.
// 3. Unless the unit starts with a reset, warp 0 then finds its entry by a
//    decoupled look-back over earlier units: it loads 32 units' words at
//    once (a lane an entry), waits, nearest first, until each is published,
//    up to the nearest inclusive one, composes the aggregates after it (a
//    shuffle each) and, if none of the 32 was inclusive, carries their
//    composite map on to the 32 before.  It publishes the unit's own
//    inclusive state over its map, and each piece's entry state in turn.
//    The ticket order means every earlier unit's CTA has started, and it
//    publishes before it waits, so the walk ends.
// 4. Row r's output is the trajectory of lane e_in (its piece's entry): e32
//    its offset, c32 min(c_in + its count, cells), or the count alone after
//    a reset in the piece: a gather from shared memory, a row a lane.
// P is read once from device memory (the look-back reads 100 bytes a unit),
// e32 and c32 written once.  What bounds it on an H100: bytes (100 B of P,
// 1 B of reset in, 8 B out per subsegment); the walk is one dependent
// shuffle a row in each piece, so the pieces in flight (16 warps an SM, a
// 12.8 KiB trajectory each) must cover the latency, and the unit of 8
// pieces keeps the look-backs few (in the first wave of a long chain each
// walks back over the units of the wave).  The launcher zeroes the ticket
// and the status words (the caller's scratch) before every launch.

#include "decode_common.cuh"
#include "lookback.cuh"

namespace cvx {

// ---- the walk: a warp a chain ----------------------------------------------

constexpr int BATCH = 32;

__global__ void __launch_bounds__(DEC_WARPS * 32)
decode_walk_kernel(const int32_t* __restrict__ P, const int32_t* __restrict__ starts,
                   int64_t nchains, int64_t nsub, int cells, int32_t* __restrict__ e32,
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

// ---- the pieces: a piecewise map scan ---------------------------------------

constexpr int PIECE = 128;     // rows a warp walks, at most
constexpr int CH_WARPS = 8;    // pieces a unit (a CTA), at most
constexpr int TRAJ_WORDS = PIECE * ENTRIES;
constexpr unsigned ST_AGG = 1u << 30;   // the word is an entry of the map
constexpr unsigned ST_INCL = 2u << 30;  // the word is the unit's exit state
constexpr unsigned ST_PAYLOAD = ST_AGG - 1u;  // count << 5 | offset

// One step of state (e, c) through the packed word pk = count << 5 | exit.
__device__ __forceinline__ void step(int pk, int cells, int& e, int& c) {
  e = pk & 31;
  c = min(c + (pk >> 5), cells);
}

// Warp 0: the entry state (e_in, c_in) of unit u from the status words of
// the units before it (the decoupled look-back).
__device__ __forceinline__ void look_back(const unsigned* words, int64_t u, int cells,
                                          int& e_in, int& c_in) {
  const int lane = threadIdx.x & 31;
  // the composite of the maps between the window and unit u (lane x: where
  // entry x leads), the identity at first
  int acc_e = lane, acc_c = 0;
#pragma unroll 1
  for (int64_t base = u - 1;; base -= 32) {
    unsigned w[32];  // lane x < 25: word x of unit base - j (0: not yet)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (base - j < 0)
        w[j] = ST_INCL;  // before unit 0: the start, (0, 0)
      else if (lane < ENTRIES)
        w[j] = ld_relaxed(&words[(base - j) * ENTRIES + lane]);
      else
        w[j] = ST_AGG;
    }
    // nearest first: each unit's words published, up to an inclusive one
    int jq = 32, we = lane, wc = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (jq == 32) {  // uniform
        if (w[j] == 0) w[j] = wait_status(&words[(base - j) * ENTRIES + lane]);
        const unsigned incl = __ballot_sync(FULL, (w[j] & ST_INCL) != 0);
        if (incl) {
          const unsigned v = __shfl_sync(FULL, w[j], __ffs(incl) - 1) & ST_PAYLOAD;
          jq = j;
          we = v & 31;
          wc = v >> 5;
        }
      }
    }
    // the window's maps after it, oldest first, then the nearer ones
#pragma unroll
    for (int j = 31; j >= 0; --j)
      if (j < jq) step(__shfl_sync(FULL, (int)(w[j] & ST_PAYLOAD), we), cells, we, wc);
    const int ae = __shfl_sync(FULL, acc_e, we);
    acc_c = min(wc + __shfl_sync(FULL, acc_c, we), cells);
    acc_e = ae;
    if (jq < 32) {  // a constant state: every lane holds it
      e_in = acc_e;
      c_in = acc_c;
      return;
    }
  }
}

__global__ void __launch_bounds__(CH_WARPS * 32)
decode_chase_kernel(const int32_t* __restrict__ P, const uint8_t* __restrict__ reset,
                    int64_t nsub, int piece, int64_t nunits, int cells,
                    unsigned* ticket, unsigned* words, int32_t* __restrict__ e32,
                    int32_t* __restrict__ c32) {
  extern __shared__ unsigned traj_all[];
  __shared__ unsigned s_map[CH_WARPS][32];  // each piece's map (count << 5 | exit)
  __shared__ int s_first[CH_WARPS];         // its first row with a reset (PIECE: none)
  __shared__ int s_entry[CH_WARPS][2];      // its entry state
  __shared__ int64_t s_unit;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned* traj = traj_all + wp * TRAJ_WORDS;
  if (threadIdx.x == 0) s_unit = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t u = s_unit;
  if (u >= nunits) return;  // uniform over the CTA
  const int64_t k0 = (u * nw + wp) * piece;
  const int n = (int)max((int64_t)0, min((int64_t)piece, nsub - k0));  // 0: past the end

  // 1. the 25 trajectories; past the piece's rows the identity (lane l
  // holds l), so the walk needs no bounds
  auto load = [&](int b, int (&row)[32], unsigned& rmask) {
    const int nb = min(32, n - b);
#pragma unroll
    for (int j = 0; j < 32; ++j)
      row[j] = j >= nb ? lane : lane < ENTRIES ? P[(k0 + b + j) * ENTRIES + lane] : 0;
    rmask = __ballot_sync(FULL, lane < nb && reset[k0 + b + lane]);
  };
  int e = lane, c = 0;
  int first_reset = n;  // the piece's first row with a reset (n: none)
  int row[32];
  unsigned rmask = 0;
  if (n > 0) load(0, row, rmask);
#pragma unroll 1
  for (int b = 0; b < n; b += 32) {
    int next[32];  // the next 32 rows' loads in flight under this walk
    unsigned nmask = 0;
    if (b + 32 < n) load(b + 32, next, nmask);
    unsigned* tb = traj + b * ENTRIES + lane;
    if (rmask == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (lane < ENTRIES) tb[j * ENTRIES] = (unsigned)c << 5 | e;
        step(__shfl_sync(FULL, row[j], e), cells, e, c);
      }
    } else {
      if (first_reset == n) first_reset = b + __ffs(rmask) - 1;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if ((rmask >> j) & 1) e = c = 0;
        if (lane < ENTRIES) tb[j * ENTRIES] = (unsigned)c << 5 | e;
        step(__shfl_sync(FULL, row[j], e), cells, e, c);
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) row[j] = next[j];
    rmask = nmask;
  }
  s_map[wp][lane] = (unsigned)c << 5 | e;
  if (lane == 0) s_first[wp] = first_reset < n ? first_reset : PIECE;
  __syncthreads();

  // 2. and 3. warp 0: the unit's map, its entry, the pieces' entries
  if (wp == 0) {
    // the unit's map, lane x from entry x; a piece with a reset makes it
    // constant
    int ue = lane, uc = 0;
    bool constant = false;
    for (int w = 0; w < nw; ++w) {
      if (s_first[w] < PIECE) {
        constant = true;
        ue = (int)(s_map[w][0] & 31);
        uc = (int)(s_map[w][0] >> 5);
      } else {
        step((int)s_map[w][ue], cells, ue, uc);
      }
    }
    unsigned* const mine = words + u * ENTRIES;
    if (lane < ENTRIES)
      st_relaxed(&mine[lane], (constant ? ST_INCL : ST_AGG) | ((unsigned)uc << 5 | ue));
    int e_in = 0, c_in = 0;
    if (s_first[0] > 0) {  // the unit does not start with a reset
      look_back(words, u, cells, e_in, c_in);
      if (!constant && lane < ENTRIES) {
        const int ex = __shfl_sync(0x1ffffffu, ue, e_in);
        const int cx = min(c_in + __shfl_sync(0x1ffffffu, uc, e_in), cells);
        st_relaxed(&mine[lane], ST_INCL | ((unsigned)cx << 5 | ex));
      }
    }
    if (lane == 0)
      for (int w = 0; w < nw; ++w) {
        s_entry[w][0] = e_in;
        s_entry[w][1] = c_in;
        if (s_first[w] < PIECE) {
          e_in = (int)(s_map[w][0] & 31);
          c_in = (int)(s_map[w][0] >> 5);
        } else {
          step((int)s_map[w][e_in], cells, e_in, c_in);
        }
      }
  }
  __syncthreads();

  // 4. the rows' states: the trajectory of the piece's entry
  const int e_in = s_entry[wp][0], c_in = s_entry[wp][1];
#pragma unroll 1
  for (int r = lane; r < n; r += 32) {
    const unsigned v = traj[r * ENTRIES + e_in];
    const int cnt = (int)(v >> 5);
    e32[k0 + r] = (int32_t)(v & 31);
    c32[k0 + r] = r >= first_reset ? cnt : min(c_in + cnt, cells);
  }
}

}  // namespace cvx

// `piece` 0: the walk, a warp a chain from each of the `nchains` `starts`
// (`warps` and `scratch` unused).  Else `piece` in 1 .. 128 rows and `warps`
// in 1 .. 8 pieces a unit (ops/entropy_decode.py `chase_shape`); `scratch`
// holds 1 + nunits * 25 words, nunits = ceil(nsub / (warps * piece)): the
// ticket counter, then 25 status words a unit, zeroed here.
extern "C" int cvx_decode_chase(const int32_t* P, const uint8_t* reset, const int32_t* starts,
                                int64_t nchains, int64_t nsub, int piece, int warps, int cells,
                                unsigned* scratch, int32_t* e32, int32_t* c32, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  if (piece == 0) {
    if (nchains == 0) return 0;
    decode_walk_kernel<<<(unsigned)((nchains + DEC_WARPS - 1) / DEC_WARPS), DEC_WARPS * 32,
                         0, st>>>(P, starts, nchains, nsub, cells, e32, c32);
    return (int)cudaGetLastError();
  }
  if (nsub == 0) return 0;
  if (piece < 1 || piece > PIECE || warps < 1 || warps > CH_WARPS)
    return (int)cudaErrorInvalidValue;
  const int64_t unit = (int64_t)warps * piece;
  const int64_t nunits = (nsub + unit - 1) / unit;
  // the largest shared memory a launch asks for, allowed once per card
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !allowed[dev])) {
    e = cudaFuncSetAttribute(decode_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(CH_WARPS * TRAJ_WORDS * sizeof(unsigned)));
    if (e == cudaSuccess && dev < 64) allowed[dev] = true;
  }
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, (1 + nunits * ENTRIES) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)warps * TRAJ_WORDS * sizeof(unsigned);
  decode_chase_kernel<<<(unsigned)nunits, warps * 32, smem, st>>>(
      P, reset, nsub, piece, nunits, cells, scratch, scratch + 1, e32, c32);
  return (int)cudaGetLastError();
}
