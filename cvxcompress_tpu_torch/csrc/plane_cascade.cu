// plane_cascade: the multi-level Antonini 7/9 cascade of every block of a
// volume-order plane, x, then y, then z, forward (`plane_cascade_fwd`) and
// inverse (`plane_cascade_inv`).
//
// Replaces no Pallas kernel.  It replaces the XLA products the JAX package
// runs on the stripe, patch and compact routes: `forward_3d_volume`
// (cvxcompress_tpu/ops/wavelet.py:249), three dense-operator contractions
// on the MXU, and the inverse's (cvxcompress_tpu/ops/codec.py:1151-1169),
// as decode_maps replaced the XLA `_parse_stages`.  A dense n x n product
// multiplies every cell of a line by every operator entry, so one NaN or
// inf reaches the whole line (0 x NaN) and a cell near FLT_MAX overflows
// where the lifting does not; the cascade touches a filter's taps only,
// and with it the stripe, patch and compact routes give native's parity
// codec (`cvx_compress_parity_th`, `cvx_decompress_inplace_parity_th`)
// bit for bit, as the 32^3, 128^3 and fused stripe routes already do.
//
// The arithmetic is cascade.cuh's `fwd_pair` / `inv_pair` (pair sums
// first, taps from the outside in, every multiply and add rounded on its
// own), over the levels of `wavelet.level_schedule`; an axis of length 1
// (bz = 1) is skipped.  `wavelet.forward_3d_volume_plain` and
// `wavelet.cascade_3d` are the plain versions, bit-equal.
//
// Design (simple first): one launch per axis, a CTA a tile of 8,192 cells
// (32 KiB of shared memory) made of NL = 8192 / b whole lines of the axis
// (b its length), 256 threads.
// - The x pass reads the volume through its strides (any view, any
//   alignment: 4-byte loads) and writes the zero-padded plane: the padding
//   is written as zeros here, no separate pad copy.  Its tile is NL
//   consecutive lines along x, each padded to b + 1 cells in shared memory
//   so a warp's threads (a line each) hit 32 banks.
// - The y and z passes work in place on the plane, viewed as (G, b, C):
//   lines of b cells along the middle axis, line L = g C + col.  A tile is
//   NL consecutive lines, across g where C is small (a block batch's y
//   pass has C = bx = 8), cell-major in shared memory: the loads are
//   coalesced along the columns and a warp's threads hit 32 banks.  Lines
//   are disjoint across CTAs, so in place is safe.
// - Each line's offset (64-bit, the strides' and the grid's divisions) is
//   computed once into shared memory, not once a cell.
// - b is a template parameter (8 .. 256: one kernel each), so every index
//   of a level is a constant or a shift.  The levels 32 .. 2 run a thread
//   a line in registers (cascade.cuh `reg_cascade`, as the 32^3 kernels);
//   the levels above 32 (b = 64 .. 256) in shared memory: each thread's
//   output pairs into registers, a sync, written back in place, a sync.
//   A warp's threads share one output index j there (NL >= 32 lines), so
//   the mirrored taps at a line's ends are one branch a warp.
//
// What bounds it on an H100: bytes.  The function reads each input cell
// once and writes each output cell once (8 B a cell); the three passes move
// 24 B a cell.  About 22 FLOP a cell and axis.

#include <cstdint>

#include "cascade.cuh"

namespace cvx {

constexpr int PC_TILE = 8192;  // cells a CTA holds
constexpr int PC_THREADS = 256;

// Cell c of line l of a tile of NL = PC_TILE / B lines: line-major, each
// line padded to B + 1 cells (the x pass), or cell-major (the y and z
// passes).
template <int B, bool CELL_MAJOR>
__device__ __forceinline__ float& cell(float* s, int l, int c) {
  constexpr int NL = PC_TILE / B;
  return CELL_MAJOR ? s[c * NL + l] : s[l * (B + 1) + c];
}

// One level of length N > 32 on every line of the tile, in shared memory:
// each thread's output pairs into registers, a sync, written back in
// place, a sync.  A warp's threads share one output index j (NL >= 32), so
// the mirrored taps at a line's ends are one branch a warp.
template <bool INVERSE, int B, bool CELL_MAJOR, int N>
__device__ __forceinline__ void smem_level(float* s) {
  constexpr int NL = PC_TILE / B, H = N / 2;
  constexpr int Q = NL * H / PC_THREADS;  // pairs a thread (NL * H >= 1024)
  float r0[Q], r1[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + q * PC_THREADS;
    const int l = p % NL, j = p / NL;
    if constexpr (INVERSE) {
      float L[4], Hi[5];
      if (j >= 2 && j + 2 < H) {  // no tap mirrored
#pragma unroll
        for (int c = 0; c < 4; ++c) L[c] = cell<B, CELL_MAJOR>(s, l, j - 1 + c);
#pragma unroll
        for (int c = 0; c < 5; ++c) Hi[c] = cell<B, CELL_MAJOR>(s, l, H + j - 2 + c);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) L[c] = cell<B, CELL_MAJOR>(s, l, mirr_sl(j - 1 + c, H));
#pragma unroll
        for (int c = 0; c < 5; ++c)
          Hi[c] = cell<B, CELL_MAJOR>(s, l, mirr_sh(H + j - 2 + c, H, H));
      }
      inv_pair(L, Hi, r0[q], r1[q]);
    } else {
      float x[9];
      if (j >= 2 && 2 * j + 4 < N) {
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = cell<B, CELL_MAJOR>(s, l, 2 * j - 4 + k);
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) x[k] = cell<B, CELL_MAJOR>(s, l, mirr(2 * j - 4 + k, N));
      }
      fwd_pair(x, r0[q], r1[q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int p = threadIdx.x + q * PC_THREADS;
    const int l = p % NL, j = p / NL;
    if constexpr (INVERSE) {
      cell<B, CELL_MAJOR>(s, l, 2 * j) = r0[q];
      cell<B, CELL_MAJOR>(s, l, 2 * j + 1) = r1[q];
    } else {
      cell<B, CELL_MAJOR>(s, l, j) = r0[q];
      cell<B, CELL_MAJOR>(s, l, H + j) = r1[q];
    }
  }
  __syncthreads();
}

// The levels min(B, 32) .. 2 of every line (forward), or 2 .. min(B, 32)
// (inverse), a thread a line in registers (cascade.cuh `reg_cascade`:
// every index a constant), then a sync.
template <bool INVERSE, int B, bool CELL_MAJOR>
__device__ __forceinline__ void reg_levels_tile(float* s) {
  constexpr int NL = PC_TILE / B, R = B < 32 ? B : 32;
#pragma unroll
  for (int k = 0; k < (NL + PC_THREADS - 1) / PC_THREADS; ++k) {
    const int l = threadIdx.x + k * PC_THREADS;
    if (l < NL) {
      float v[R];
#pragma unroll
      for (int c = 0; c < R; ++c) v[c] = cell<B, CELL_MAJOR>(s, l, c);
      reg_cascade<INVERSE>(v);
#pragma unroll
      for (int c = 0; c < R; ++c) cell<B, CELL_MAJOR>(s, l, c) = v[c];
    }
  }
  __syncthreads();
}

// The levels above 32 in shared memory, N = B, B/2, ..., 64.
template <bool INVERSE, int B, bool CELL_MAJOR, int N>
__device__ __forceinline__ void smem_levels(float* s) {
  if constexpr (N > 32) {
    if constexpr (!INVERSE) smem_level<false, B, CELL_MAJOR, N>(s);
    smem_levels<INVERSE, B, CELL_MAJOR, N / 2>(s);
    if constexpr (INVERSE) smem_level<true, B, CELL_MAJOR, N>(s);
  }
}

// The whole cascade of every line of the tile: forward B .. 2, inverse
// 2 .. B (the shared-memory levels, then the register ones, or back).
template <bool INVERSE, int B, bool CELL_MAJOR>
__device__ __forceinline__ void tile_cascade(float* s) {
  if constexpr (INVERSE) {
    reg_levels_tile<true, B, CELL_MAJOR>(s);
    smem_levels<true, B, CELL_MAJOR, B>(s);
  } else {
    smem_levels<false, B, CELL_MAJOR, B>(s);
    reg_levels_tile<false, B, CELL_MAJOR>(s);
  }
}

// The x pass: lines of BX cells along x of the padded (nzp, nyp,
// nbx * BX) plane, `nlines` = nzp * nyp * nbx; the input (nz, ny, nx) read
// through its strides (elements), zero outside it.
template <bool INVERSE, int BX>
__global__ void __launch_bounds__(PC_THREADS)
    plane_x_pass(const float* __restrict__ in, int64_t sz, int64_t sy, int64_t sx, int nz,
                 int ny, int nx, int nyp, int nbx, int64_t nlines, float* __restrict__ out) {
  constexpr int NL = PC_TILE / BX;
  __shared__ float s[NL * (BX + 1)];
  __shared__ int64_t off[NL];   // the line's first cell in `in`
  __shared__ uint16_t lim[NL];  // its cells inside the volume
  const int64_t l0 = (int64_t)blockIdx.x * NL;
  for (int l = threadIdx.x; l < NL; l += PC_THREADS) {
    const int64_t L = l0 + l;
    int64_t o = 0;
    int m = 0;
    if (L < nlines) {
      const int64_t row = L / nbx;
      const int x0 = (int)(L - row * nbx) * BX;
      const int64_t z = row / nyp;
      const int y = (int)(row - z * nyp);
      if (z < nz && y < ny) {
        m = nx - x0 < BX ? nx - x0 : BX;
        o = z * sz + y * sy + x0 * sx;
      }
    }
    off[l] = o;
    lim[l] = (uint16_t)m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PC_TILE; i += PC_THREADS) {
    const int l = i / BX, c = i % BX;
    s[l * (BX + 1) + c] = c < lim[l] ? in[off[l] + c * sx] : 0.0f;
  }
  __syncthreads();
  tile_cascade<INVERSE, BX, false>(s);
  for (int i = threadIdx.x; i < PC_TILE; i += PC_THREADS) {
    const int l = i / BX, c = i % BX;
    if (l0 + l < nlines) out[(l0 + l) * BX + c] = s[l * (BX + 1) + c];
  }
}

// A y or z pass in place on the plane viewed as (G, B, C): a tile is
// PC_TILE / B consecutive lines L = g C + col of the `nlines` = G C lines.
template <bool INVERSE, int B>
__global__ void __launch_bounds__(PC_THREADS)
    plane_yz_pass(float* __restrict__ p, int64_t C, int64_t nlines) {
  constexpr int NL = PC_TILE / B;
  __shared__ float s[PC_TILE];
  __shared__ int64_t off[NL];  // the line's first cell, -1 past the end
  const int64_t l0 = (int64_t)blockIdx.x * NL;
  for (int l = threadIdx.x; l < NL; l += PC_THREADS) {
    const int64_t L = l0 + l;
    const int64_t g = L / C;
    off[l] = L < nlines ? g * B * C + (L - g * C) : -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PC_TILE; i += PC_THREADS) {
    const int c = i / NL, l = i % NL;
    s[i] = off[l] >= 0 ? p[off[l] + c * C] : 0.0f;
  }
  __syncthreads();
  tile_cascade<INVERSE, B, true>(s);
  for (int i = threadIdx.x; i < PC_TILE; i += PC_THREADS) {
    const int c = i / NL, l = i % NL;
    if (off[l] >= 0) p[off[l] + c * C] = s[i];
  }
}

// The launches of one direction at the block's line lengths.
template <bool INVERSE, int B>
__host__ cudaError_t x_launch(const float* in, int64_t sz, int64_t sy, int64_t sx, int nz,
                              int ny, int nx, int nyp, int nbx, int64_t nlines, float* out,
                              cudaStream_t st) {
  constexpr int NL = PC_TILE / B;
  const int64_t grid = (nlines + NL - 1) / NL;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  plane_x_pass<INVERSE, B><<<(unsigned)grid, PC_THREADS, 0, st>>>(
      in, sz, sy, sx, nz, ny, nx, nyp, nbx, nlines, out);
  return cudaGetLastError();
}

template <bool INVERSE, int B>
__host__ cudaError_t yz_launch(float* plane, int64_t G, int64_t C, cudaStream_t st) {
  constexpr int NL = PC_TILE / B;
  const int64_t grid = (G * C + NL - 1) / NL;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  plane_yz_pass<INVERSE, B><<<(unsigned)grid, PC_THREADS, 0, st>>>(plane, C, G * C);
  return cudaGetLastError();
}

__host__ inline bool axis_ok(int b, bool may_be_one) {
  return (may_be_one && b == 1) || b == 8 || b == 16 || b == 32 || b == 64 || b == 128 ||
         b == 256;
}

// Dispatch on a line length b in {8, ..., 256}: F<B>::run(args...).
template <template <int> class F, typename... A>
__host__ cudaError_t by_length(int b, A... a) {
  switch (b) {
    case 8: return F<8>::run(a...);
    case 16: return F<16>::run(a...);
    case 32: return F<32>::run(a...);
    case 64: return F<64>::run(a...);
    case 128: return F<128>::run(a...);
    case 256: return F<256>::run(a...);
  }
  return cudaErrorInvalidValue;
}

template <bool INVERSE>
struct XL {
  template <int B>
  struct At {
    static cudaError_t run(const float* in, int64_t sz, int64_t sy, int64_t sx, int nz, int ny,
                           int nx, int nyp, int nbx, int64_t nlines, float* out,
                           cudaStream_t st) {
      return x_launch<INVERSE, B>(in, sz, sy, sx, nz, ny, nx, nyp, nbx, nlines, out, st);
    }
  };
};

template <bool INVERSE>
struct YZ {
  template <int B>
  struct At {
    static cudaError_t run(float* plane, int64_t G, int64_t C, cudaStream_t st) {
      return yz_launch<INVERSE, B>(plane, G, C, st);
    }
  };
};

// The three passes: x from `in` (through its strides) into `out`, the
// (nzp, nyp, nxp) plane of whole blocks; then y and z in place on `out`.
template <bool INVERSE>
__host__ int plane_cascade(const float* in, int64_t sz, int64_t sy, int64_t sx, int nz,
                           int ny, int nx, int bx, int by, int bz, float* out, void* stream) {
  if (!axis_ok(bx, false) || !axis_ok(by, false) || !axis_ok(bz, true) || nz < 0 ||
      ny < 0 || nx < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nbz = (nz + bz - 1) / bz, nby = (ny + by - 1) / by, nbx = (nx + bx - 1) / bx;
  const int64_t nzp = nbz * bz, nyp = nby * by, nxp = nbx * bx;
  if (nzp * nyp * nxp == 0) return 0;
  if (nyp > 0x7fffffff || nxp > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = by_length<XL<INVERSE>::template At>(
      bx, in, sz, sy, sx, nz, ny, nx, (int)nyp, (int)nbx, nzp * nyp * nbx, out, st);
  if (e == cudaSuccess)
    e = by_length<YZ<INVERSE>::template At>(by, out, nzp * nby, nxp, st);
  if (e == cudaSuccess && bz > 1)
    e = by_length<YZ<INVERSE>::template At>(bz, out, nbz, nyp * nxp, st);
  return (int)e;
}

}  // namespace cvx

// The forward cascade of every (bx, by, bz) block of the (nz, ny, nx) f32
// volume `vol` (strides sz, sy, sx in elements) into the zero-padded
// (nzp, nyp, nxp) plane `plane`, each block's coefficients at its place.
extern "C" int cvx_plane_cascade_fwd(const float* vol, int64_t sz, int64_t sy, int64_t sx,
                                     int nz, int ny, int nx, int bx, int by, int bz,
                                     float* plane, void* stream) {
  return cvx::plane_cascade<false>(vol, sz, sy, sx, nz, ny, nx, bx, by, bz, plane, stream);
}

// The inverse cascade of every block of the (nz, ny, nx) coefficient plane
// `coeffs` (whole blocks; a block-major (n, bz, by, bx) batch is the plane
// (n * bz, by, bx)) into `out`, of the same shape.
extern "C" int cvx_plane_cascade_inv(const float* coeffs, int64_t sz, int64_t sy, int64_t sx,
                                     int nz, int ny, int nx, int bx, int by, int bz,
                                     float* out, void* stream) {
  return cvx::plane_cascade<true>(coeffs, sz, sy, sx, nz, ny, nx, bx, by, bz, out, stream);
}
