// plane_cascade: the multi-level Antonini 7/9 cascade of every block of a
// volume, x, then y, then z, forward (`plane_cascade_fwd`: the volume in,
// its coefficients out as the zero-padded volume-order plane or as the
// block-major batch) and inverse (`plane_cascade_inv`: the block-major
// coefficients in, the volume out, clipped at its edges).
//
// Replaces no Pallas kernel.  It replaces the XLA products the JAX package
// runs on the stripe, patch and compact routes: `forward_3d_volume`
// (cvxcompress_tpu/ops/wavelet.py:249), three dense-operator contractions
// on the MXU, and the inverse's (cvxcompress_tpu/ops/codec.py:1151-1169),
// as decode_maps replaced the XLA `_parse_stages`, with the block <->
// volume relayouts around them.  A dense n x n product multiplies every
// cell of a line by every operator entry, so one NaN or inf reaches the
// whole line (0 x NaN) and a cell near FLT_MAX overflows where the lifting
// does not; the cascade touches a filter's taps only, and with it the
// stripe, patch and compact routes give native's parity codec
// (`cvx_compress_parity_th`, `cvx_decompress_inplace_parity_th`) bit for
// bit.  Tensor cores do not apply for the same reason: the contract is
// native's operation order, and a wgmma product is that dense contraction.
//
// The arithmetic is cascade.cuh's `fwd_pair` / `inv_pair` (pair sums
// first, taps from the outside in, every multiply and add rounded on its
// own), over the levels of `wavelet.level_schedule`; an axis of length 1
// (bz = 1) is skipped.  `wavelet.forward_3d_volume_plain`,
// `forward_blocks_of_volume_plain` and `inverse_to_volume_plain` are the
// plain versions, bit-equal.
//
// What bounds it on an H100: bytes.  The function reads each input cell
// once and writes each output cell once (8 B a cell).  Its ~22 separately
// rounded f32 operations a cell and axis (no FMA: native's order) and the
// shared-memory traffic around them take about as long as those bytes, so
// the design moves each cell through device memory as few times as the
// shared memory allows and keeps the cascades' instructions few.
//
// Design.
// - Passes by how much of a block fits in a tile of 16,384 cells (64 KiB),
//   planned in Python (ops/wavelet.py `pass_plan`) and passed in: (a) a
//   block of at most 16,384 cells: tiles of whole blocks, x, y and z in one
//   pass (8 B a cell); (b) a (by, bx) face of at most 16,384 cells: x + y
//   on tiles of whole faces, then z on tiles of whole z-lines (16 B a
//   cell); (c) a 256 x 128, 128 x 256 or 256 x 256 face: x, y and z apart
//   (24 B a cell).  The passes run in order, each a launch.  A pass reads and writes one of four layouts: the volume
//   through its strides, zero outside it; the padded volume-order plane;
//   the block-major batch; the volume clipped at its edges.  The inverse's
//   passes before its last write a block-major scratch the wrapper
//   allocates.  Forward into the batch and inverse into the volume, the
//   kernels do the block <-> volume relayouts themselves.
// - Persistent CTAs of 512 threads, one an SM (two 64 KiB tile buffers):
//   a CTA copies its next tile (16-byte cp.async, zero-filled past the
//   volume's edges; 4-byte cp.async for a strided or misaligned view) while
//   it computes and stores this one.  A table a tile holds each block's
//   origin and its offsets in the source and the destination, so a copy
//   is a few integer operations a 16-byte chunk.  (Measured no faster,
//   PERF.md: two or three CTAs an SM of 256 threads and 32 KiB tiles; a
//   cluster of 2 or 4 CTAs sharing a class (c) face, x + y in one pass
//   through distributed shared memory, was 2x slower than the passes
//   apart.)
// - Every tile holds 16,384 cells, so a line length fixes the lines of an
//   axis.  Lines of 8 to 32 cells: a thread a line in registers
//   (cascade.cuh reg_cascade; rows read as float4s).  Lines of 64, 128 and
//   256: N / 32 lanes of a warp a line, 32 cells a lane in registers, each
//   level on the lane's cells and a halo from its neighbours by shuffles,
//   no barrier; every thread has a line at every level (lines_lanes).
// - Shared memory word w lives at psw(w) = w ^ ((((w >> 5) ^ (w >> 8) ^
//   (w >> 11)) & 7) << 2): 16-byte groups stay whole, and psw is linear
//   over XOR, so a line's address for position i is the line's base XOR a
//   constant built from the axis' steps (PcLine): an XOR or two an access.
//   A warp's 32 lanes take consecutive lines.  The cells of every line
//   (rows read as float4s, y- and z-lines) meet at most 2 lanes to a bank,
//   and so do the highpass cells of y- and z-lines; those of rows of 64 to
//   256 cells meet 4 to a bank (modelled by
//   tests/test_torch_plane_cascade.py `test_swizzle_banks`).
//
// Tensor cores do not apply (above); the card's asynchronous copies,
// shared memory and warp shuffles do.

#include <cstdint>

#include "cascade.cuh"
#include "common.cuh"

namespace cvx {

constexpr int PC_LTILE = 14;
constexpr int PC_TILE = 1 << PC_LTILE;  // cells of a tile buffer (64 KiB)
constexpr int PC_NT = 512;              // threads of a CTA
constexpr int PC_MAXNB = PC_TILE / 64;  // blocks a tile, at most ((8, 8, 1): 64 cells)
// two tables (32 bytes a block), two tile buffers and the slack to align
// them to 1,024 bytes
constexpr size_t PC_SMEM = 2 * 32 * PC_MAXNB + 2 * PC_TILE * sizeof(float) + 1024;

// The layouts a pass reads (VOL, PLANE, BLOCKS) or writes (PLANE, BLOCKS,
// CLIP); a plan names one as buffer * 4 + layout, the buffers being the
// input (0), the output (1) and the scratch (2).
enum : int { PC_VOL = 0, PC_PLANE = 1, PC_BLOCKS = 2, PC_CLIP = 3 };

// The swizzle: word w of a tile lives at psw(w).  It moves 16-byte groups
// only, and it is linear over XOR: psw(a ^ b) = psw(a) ^ psw(b).
__host__ __device__ constexpr int psw(int w) {
  return w ^ ((((w >> 5) ^ (w >> 8) ^ (w >> 11)) & 7) << 2);
}

// A line of the tile: position i at word off ^ (i << L), off holding no bit
// of a position (every line of the tile's axes is such).  By the swizzle's
// linearity position i lives at psw(off) ^ the XOR of u[k] over i's bits
// k, u[k] = psw(1 << (k + L)): with i a constant, an XOR or two an access.
template <int NB>  // bits of a position
struct PcLine {
  float* s;
  int base;  // psw(off)
  int u[NB];
  __device__ __forceinline__ int word(int i) const {
    int w = base;
#pragma unroll
    for (int k = 0; k < NB; ++k) w ^= (i >> k) & 1 ? u[k] : 0;
    return w;
  }
  __device__ __forceinline__ float& operator()(int i) const { return s[word(i)]; }
  // the line seen from position p on (p and the later positions sharing no
  // bit)
  __device__ __forceinline__ PcLine from(int p) const {
    PcLine r = *this;
    r.base = word(p);
    return r;
  }
};

// The steps u of the lines of an axis whose positions are L bits up.
template <int NB>
__device__ __forceinline__ void pc_steps(int L, int (&u)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) u[k] = psw(1 << (k + L));
}

template <int NB>
__device__ __forceinline__ PcLine<NB> pc_line(float* s, int off, const int (&u)[NB]) {
  PcLine<NB> a;
  a.s = s;
  a.base = psw(off);
#pragma unroll
  for (int k = 0; k < NB; ++k) a.u[k] = u[k];
  return a;
}

struct PcGeom {
  int lbx, lby, lbz;  // log2 of the block edges (lbz 0: bz == 1)
  int nx, ny, nz;     // the volume
  int nbx, nby;       // blocks along x and y
  int64_t nnn;        // blocks
};

// A pass's source or destination: its layout and the element strides of a
// box's z, y and x in it (the volume's for VOL; the plane's; a block's for
// BLOCKS; the clipped volume's for CLIP).
struct PcSide {
  float* p;
  int kind;
  int vec;  // 16-byte copies
  int64_t sz, sy, sx;
};

struct PcPass {
  int axes;           // 1 x, 2 y, 4 z
  int ltz, lty, ltx;  // log2 of the tile's box in a block
  int lnb;            // log2 of the whole blocks a tile (the box is then the block)
  int lux, luy, lu;   // log2 of the boxes a block along x, along y, in all
  int64_t ntiles;
};

// cp.async of 16 bytes, of which the first `bytes` come from src and the
// rest are zeros (src not read when bytes is 0).
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}

// Tile t: its first block, its blocks, and its box's origin in the block.
struct PcTile {
  int64_t blk;
  int nb, oz, oy, ox;
};
__device__ __forceinline__ PcTile pc_tile(const PcGeom& g, const PcPass& p, int64_t t) {
  PcTile r;
  if (p.lu == 0) {
    r.blk = t << p.lnb;
    r.nb = (int)min((int64_t)1 << p.lnb, g.nnn - r.blk);
    r.oz = r.oy = r.ox = 0;
  } else {
    const int u = (int)(t & ((1 << p.lu) - 1));
    r.blk = t >> p.lu;
    r.nb = 1;
    r.ox = (u & ((1 << p.lux) - 1)) << p.ltx;
    r.oy = ((u >> p.lux) & ((1 << p.luy) - 1)) << p.lty;
    r.oz = (u >> (p.lux + p.luy)) << p.ltz;
  }
  return r;
}

// A tile slot's table, a row a block of the tile: its box's volume origin
// (w: the box lies inside the volume), and the element offset of the box's
// first cell in the source and in the destination.
struct PcSlot {
  int4 org[PC_MAXNB];
  int64_t off[2][PC_MAXNB];
};
static_assert(sizeof(PcSlot) == 32 * PC_MAXNB, "PC_SMEM counts 32 bytes a block");

__device__ __forceinline__ int64_t pc_base(const PcSide& d, const PcGeom& g, const PcTile& tl,
                                           int k, int3 o) {
  if (d.kind == PC_BLOCKS)
    return ((tl.blk + k) << (g.lbx + g.lby + g.lbz)) +
           ((((int64_t)tl.oz << g.lby) + tl.oy) << g.lbx) + tl.ox;
  return o.z * d.sz + o.y * d.sy + o.x * d.sx;
}

// Threads k < nb: the table of tile tl.
__device__ __forceinline__ void pc_prep(PcSlot& sl, const PcTile& tl, const PcPass& p,
                                        const PcGeom& g, const PcSide& src,
                                        const PcSide& dst) {
  for (int k = threadIdx.x; k < tl.nb; k += PC_NT) {
    const unsigned b = (unsigned)(tl.blk + k), t = b / (unsigned)g.nbx;
    const int3 o = make_int3(((int)(b - t * g.nbx) << g.lbx) + tl.ox,
                             ((int)(t % (unsigned)g.nby) << g.lby) + tl.oy,
                             ((int)(t / (unsigned)g.nby) << g.lbz) + tl.oz);
    const bool in = o.z + (1 << p.ltz) <= g.nz && o.y + (1 << p.lty) <= g.ny &&
                    o.x + (1 << p.ltx) <= g.nx;
    sl.org[k] = make_int4(o.x, o.y, o.z, in);
    sl.off[0][k] = pc_base(src, g, tl, k, o);
    sl.off[1][k] = pc_base(dst, g, tl, k, o);
  }
}

// Chunk k of this thread (4 cells; tile cell 4 tid + 4 PC_NT k): its block
// of the tile and its box coordinates.
struct PcChunk {
  int kk, z, y, x;
};
__device__ __forceinline__ PcChunk pc_chunk(const PcPass& p, int c) {
  return {c >> (p.ltx + p.lty + p.ltz), (c >> (p.ltx + p.lty)) & ((1 << p.ltz) - 1),
          (c >> p.ltx) & ((1 << p.lty) - 1), c & ((1 << p.ltx) - 1)};
}

constexpr int PC_CHUNKS = PC_TILE / (4 * PC_NT);  // chunks a thread, a full tile

// Every thread: the tile's cells into buf, zero outside the volume for VOL;
// no commit.
__device__ __forceinline__ void pc_load(float* buf, const PcSlot& sl, const PcTile& tl,
                                        const PcPass& p, const PcGeom& g, const PcSide& src) {
  const int n = tl.nb << (p.ltx + p.lty + p.ltz), w0 = psw(4 * threadIdx.x);
  if (src.vec) {
#pragma unroll 2
    for (int k = 0; k < PC_CHUNKS; ++k) {
      const int c = 4 * threadIdx.x + 4 * PC_NT * k;
      if (c >= n) break;
      const PcChunk q = pc_chunk(p, c);
      const int4 o = sl.org[q.kk];
      int bytes = 16;
      if (src.kind == PC_VOL && !o.w)
        bytes = o.z + q.z < g.nz && o.y + q.y < g.ny ? 4 * max(0, min(4, g.nx - o.x - q.x))
                                                     : 0;
      const float* a = src.p + sl.off[0][q.kk] + q.z * src.sz + q.y * src.sy + q.x * src.sx;
      cp16(buf + (w0 ^ psw(4 * PC_NT * k)), bytes ? a : src.p, bytes);
    }
  } else {
    for (int c = threadIdx.x; c < n; c += PC_NT) {
      const PcChunk q = pc_chunk(p, c);
      const int4 o = sl.org[q.kk];
      const bool in = src.kind != PC_VOL || o.w ||
                      (o.z + q.z < g.nz && o.y + q.y < g.ny && o.x + q.x < g.nx);
      const float* a = src.p + sl.off[0][q.kk] + q.z * src.sz + q.y * src.sy + q.x * src.sx;
      cp_async<4>(buf + psw(c), in ? a : src.p, in);
    }
  }
}

// Every thread: the tile's cells from buf to the destination, clipped to
// the volume for CLIP.
__device__ __forceinline__ void pc_store(const float* buf, const PcSlot& sl, const PcTile& tl,
                                         const PcPass& p, const PcGeom& g, const PcSide& dst) {
  const int n = tl.nb << (p.ltx + p.lty + p.ltz), w0 = psw(4 * threadIdx.x);
#pragma unroll 2
  for (int k = 0; k < PC_CHUNKS; ++k) {
    const int c = 4 * threadIdx.x + 4 * PC_NT * k;
    if (c >= n) break;
    const PcChunk q = pc_chunk(p, c);
    const int4 o = sl.org[q.kk];
    int m = 4;
    if (dst.kind == PC_CLIP && !o.w) {
      if (o.z + q.z >= g.nz || o.y + q.y >= g.ny || o.x + q.x >= g.nx) continue;
      m = g.nx - o.x - q.x;
    }
    const float4 v = *reinterpret_cast<const float4*>(buf + (w0 ^ psw(4 * PC_NT * k)));
    float* d = dst.p + sl.off[1][q.kk] + q.z * dst.sz + q.y * dst.sy + q.x;
    if (dst.vec && m >= 4) {
      *reinterpret_cast<float4*>(d) = v;
    } else {
      d[0] = v.x;
      if (m > 1) d[1] = v.y;
      if (m > 2) d[2] = v.z;
      if (m > 3) d[3] = v.w;
    }
  }
}

// ---- line engines (the tile always holds PC_TILE cells) -----------------

// Lines of N <= 32 cells, a thread a line in registers.
template <bool INV, int N, class MK>
__device__ __forceinline__ void lines_short(const MK& mk) {
#pragma unroll 1
  for (int l = threadIdx.x; l < PC_TILE / N; l += PC_NT) {
    const auto a = mk(l);
    float v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = a(i);
    reg_cascade<INV>(v);
#pragma unroll
    for (int i = 0; i < N; ++i) a(i) = v[i];
  }
}

// Rows of N <= 32 cells, a thread a row, read and written as float4s.
template <bool INV, int N>
__device__ __forceinline__ void rows_short(float* s) {
#pragma unroll 1
  for (int r = threadIdx.x; r < PC_TILE / N; r += PC_NT) {
    const int b = psw(r * N);
    float v[N];
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 q = *reinterpret_cast<const float4*>(s + (b ^ psw(4 * c)));
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
    reg_cascade<INV>(v);
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      *reinterpret_cast<float4*>(s + (b ^ psw(4 * c))) =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Lines of N = 64, 128 or 256 cells (PC_TILE / N of them, so every
// thread works): S = N / 32 consecutive lanes of a warp a line, lane s
// holding the line's cells [32 s, 32 s + 32) in registers.  A level of
// length n = M S (M = 32, 16, 8, 4) runs on each lane's M cells of the
// band and a halo from its neighbours by shuffles (mirrored at the line's
// ends from the lane's own cells and halo), every index a constant, no
// barrier: forward, 4 cells before and 3 after, the lowpass outputs kept,
// the highpass ones stored at once; inverse, the lowpass cells with 1
// before and 2 after, the highpass cells loaded with 2 and 2.  The last 2S
// lowpass cells (levels 2S .. 2) go through every lane of the line in
// registers.  ROWS: rows, read and written as float4s.
constexpr unsigned PC_ALL = 0xffffffffu;

template <int M, int S, class A>
__device__ __forceinline__ void lanes_fwd(const A& a, int s, float (&v)[32]) {
  constexpr int h = M * S / 2, Q = M / 2;
  float r[3], e[M + 7];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = __shfl_down_sync(PC_ALL, v[k], 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // positions -4 + k: mirrored to 4 - k at the start
    const float t = __shfl_up_sync(PC_ALL, v[M - 4 + k], 1);
    e[k] = s != 0 ? t : 4 - k < M ? v[(4 - k) % M] : r[(4 - k) % M];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) e[4 + i] = v[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) e[M + 4 + k] = s == S - 1 ? v[M - 2 - k] : r[k];
  const auto hb = a.from(h + Q * s);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float x[9], hi;
#pragma unroll
    for (int k = 0; k < 9; ++k) x[k] = e[2 * q + k];
    fwd_pair(x, v[q], hi);
    hb(q) = hi;
  }
  if constexpr (M > 4) lanes_fwd<M / 2, S>(a, s, v);
}

template <int M, int S, class A>
__device__ __forceinline__ void lanes_inv(const A& a, int s, float (&v)[32]) {
  constexpr int h = M * S / 2, Q = M / 2;
  if constexpr (M > 4) lanes_inv<M / 2, S>(a, s, v);
  float hi[Q], lr[2], hl[2], hr[2], eL[Q + 3], eH[Q + 4];
  const auto hb = a.from(h + Q * s);
#pragma unroll
  for (int i = 0; i < Q; ++i) hi[i] = hb(i);
  const float ll = __shfl_up_sync(PC_ALL, v[Q - 1], 1);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    lr[k] = __shfl_down_sync(PC_ALL, v[k], 1);
    hl[k] = __shfl_up_sync(PC_ALL, hi[Q - 2 + k], 1);
    hr[k] = __shfl_down_sync(PC_ALL, hi[k], 1);
  }
  eL[0] = s == 0 ? v[1] : ll;  // lowpass position -1: mirrored to 1
#pragma unroll
  for (int i = 0; i < Q; ++i) eL[1 + i] = v[i];
#pragma unroll
  for (int k = 0; k < 2; ++k)  // h + k: mirrored to h - 1 - k
    eL[Q + 1 + k] = s == S - 1 ? v[Q - 1 - k] : lr[k];
#pragma unroll
  for (int k = 0; k < 2; ++k)  // highpass -2 + k: mirrored to 1 - k
    eH[k] = s == 0 ? hi[1 - k] : hl[k];
#pragma unroll
  for (int i = 0; i < Q; ++i) eH[2 + i] = hi[i];
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // h + k: mirrored to h - 2 - k, the lane's Q - 2 - k
    const int p = Q - 2 - k;
    eH[Q + 2 + k] = s != S - 1 ? hr[k] : p >= 0 ? hi[(p + Q) % Q] : hl[(p + 2) % 2];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float L[4], H[5];
#pragma unroll
    for (int c = 0; c < 4; ++c) L[c] = eL[q + c];
#pragma unroll
    for (int c = 0; c < 5; ++c) H[c] = eH[q + c];
    inv_pair(L, H, v[2 * q], v[2 * q + 1]);
  }
}

template <bool INV, int N, bool ROWS, class MK>
__device__ __forceinline__ void lines_lanes(const MK& mk) {
  constexpr int S = N / 32;
  const int lane = threadIdx.x & 31, s = lane & (S - 1);
  const auto a = mk((threadIdx.x >> 5) * (32 / S) + lane / S);
  const auto own = a.from(32 * s);  // the lane's cells
  auto q4 = [&](int c) { return reinterpret_cast<float4*>(own.s + own.word(4 * c)); };
  float v[32];
  if constexpr (INV) {
    float g[2 * S];
    const auto low = a.from(0);
#pragma unroll
    for (int i = 0; i < 2 * S; ++i) g[i] = low(i);
    reg_cascade<true>(g);
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (t == s) {
        v[0] = g[2 * t];
        v[1] = g[2 * t + 1];
      }
    lanes_inv<32, S>(a, s, v);
    __syncwarp();  // every lane of the line has read its cells
    if constexpr (ROWS) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *q4(c) = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) own(i) = v[i];
    }
  } else {
    if constexpr (ROWS) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 q = *q4(c);
        v[4 * c] = q.x;
        v[4 * c + 1] = q.y;
        v[4 * c + 2] = q.z;
        v[4 * c + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = own(i);
    }
    __syncwarp();  // every lane of the line has read its cells
    lanes_fwd<32, S>(a, s, v);
    float g[2 * S];
    const int base = lane - s;
#pragma unroll
    for (int t = 0; t < S; ++t)
#pragma unroll
      for (int k = 0; k < 2; ++k) g[2 * t + k] = __shfl_sync(PC_ALL, v[k], base + t);
    reg_cascade<false>(g);
    if (s == 0) {
      const auto low = a.from(0);
#pragma unroll
      for (int i = 0; i < 2 * S; ++i) low(i) = g[i];
    }
  }
}

// The lines of length 2^LN of an axis, positions L bits up; line l's first
// word is off(l).
template <bool INV, bool ROWS, int LN, class OFF>
__device__ __forceinline__ void axis_lines_of(float* s, int L, const OFF& off) {
  int u[LN];
  pc_steps(L, u);
  const auto mk = [&](int l) { return pc_line(s, off(l), u); };
  if constexpr (LN <= 5)
    lines_short<INV, 1 << LN>(mk);
  else
    lines_lanes<INV, 1 << LN, ROWS>(mk);
}

template <bool INV, bool ROWS, class OFF>
__device__ __forceinline__ void axis_lines(float* s, int ln, int L, const OFF& off) {
  switch (ln) {
    case 3: axis_lines_of<INV, ROWS, 3>(s, L, off); break;
    case 4: axis_lines_of<INV, ROWS, 4>(s, L, off); break;
    case 5: axis_lines_of<INV, ROWS, 5>(s, L, off); break;
    case 6: axis_lines_of<INV, ROWS, 6>(s, L, off); break;
    case 7: axis_lines_of<INV, ROWS, 7>(s, L, off); break;
    case 8: axis_lines_of<INV, ROWS, 8>(s, L, off); break;
  }
}

// The pass's axes on the tile at s, x, then y, then z; a CTA barrier
// after each.
template <bool INV>
__device__ __forceinline__ void pc_axes(float* s, const PcPass& p) {
  const int ltx = p.ltx, lty = p.lty, lf = p.ltx + p.lty, ltz = p.ltz;
  if (p.axes & 1) {
    switch (ltx) {
      case 3: rows_short<INV, 8>(s); break;
      case 4: rows_short<INV, 16>(s); break;
      case 5: rows_short<INV, 32>(s); break;
      default: axis_lines<INV, true>(s, ltx, 0, [=](int l) { return l << ltx; });
    }
    __syncthreads();
  }
  if (p.axes & 2) {
    axis_lines<INV, false>(s, lty, ltx, [=](int l) {
      return ((l >> ltx) << lf) + (l & ((1 << ltx) - 1));
    });
    __syncthreads();
  }
  if (p.axes & 4) {
    axis_lines<INV, false>(s, ltz, lf, [=](int l) {
      return ((l >> lf) << (lf + ltz)) + (l & ((1 << lf) - 1));
    });
    __syncthreads();
  }
}

// One pass: persistent CTAs over the tiles, the next tile's copy in flight
// under this tile's cascades and store.  src and dst may be one buffer
// (tiles are disjoint).
template <bool INV>
__global__ void __launch_bounds__(PC_NT, 1)
    pc_pass(PcGeom g, PcPass p, PcSide src, PcSide dst) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  PcSlot* const slot = reinterpret_cast<PcSlot*>(block_buffer(dsmem));  // a table a buffer
  float* const buf0 = reinterpret_cast<float*>(slot + 2);
  int64_t t = blockIdx.x;
  if (t >= p.ntiles) return;
  PcTile cur = pc_tile(g, p, t);
  pc_prep(slot[0], cur, p, g, src, dst);
  __syncthreads();
  pc_load(buf0, slot[0], cur, p, g, src);
  cp_async_commit();
  for (int i = 0; t < p.ntiles; t += gridDim.x, ++i) {
    const int b = i & 1;
    const int64_t tn = t + gridDim.x;
    PcTile next = cur;
    if (tn < p.ntiles) {
      next = pc_tile(g, p, tn);
      pc_prep(slot[b ^ 1], next, p, g, src, dst);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (tn < p.ntiles) {
      pc_load(buf0 + (b ^ 1) * PC_TILE, slot[b ^ 1], next, p, g, src);
      cp_async_commit();
    }
    float* s = buf0 + b * PC_TILE;
    pc_axes<INV>(s, p);
    pc_store(s, slot[b], cur, p, g, dst);
    __syncthreads();
    cur = next;
  }
}

// ---- launcher ----------------------------------------------------------

__host__ inline int log2_edge(int b, bool may_be_one) {
  if (may_be_one && b == 1) return 0;
  for (int l = 3; l <= 8; ++l)
    if (b == 1 << l) return l;
  return -1;
}

// Runs the plan's passes: 7 ints each, (axes, ltz, lty, ltx, lnb, src,
// dst), src and dst as buffer * 4 + layout (ops/wavelet.py `pass_plan`,
// `launch_plan`).  `in` is the volume (strides sz, sy, sx in elements) or
// the block-major coefficients; (nz, ny, nx) the volume.
template <bool INV>
__host__ int plane_cascade(const float* in, int64_t sz, int64_t sy, int64_t sx, int nz,
                           int ny, int nx, int bx, int by, int bz, const int32_t* plan,
                           int npasses, float* out, float* scratch, void* stream) {
  PcGeom g;
  g.lbx = log2_edge(bx, false);
  g.lby = log2_edge(by, false);
  g.lbz = log2_edge(bz, true);
  if (g.lbx < 0 || g.lby < 0 || g.lbz < 0 || nz < 0 || ny < 0 || nx < 0 || npasses < 1)
    return (int)cudaErrorInvalidValue;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.nbx = (nx + bx - 1) / bx;
  g.nby = (ny + by - 1) / by;
  g.nnn = (int64_t)g.nbx * g.nby * ((nz + bz - 1) / bz);
  if (g.nnn == 0) return 0;
  if (g.nnn > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pc_pass<INV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)PC_SMEM);
  if (e != cudaSuccess) return (int)e;
  float* bufs[3] = {const_cast<float*>(in), out, scratch};
  int done = 0;  // axes run so far
  for (int k = 0; k < npasses; ++k) {
    const int32_t* q = plan + 7 * k;
    PcPass p;
    p.axes = q[0];
    p.ltz = q[1];
    p.lty = q[2];
    p.ltx = q[3];
    p.lnb = q[4];
    p.lux = g.lbx - p.ltx;
    p.luy = g.lby - p.lty;
    p.lu = p.lux + p.luy + g.lbz - p.ltz;
    const bool whole = p.lu == 0;
    // every tile holds PC_TILE cells; an axis runs on whole lines, once,
    // in the order x, y, z; only whole-block tiles hold several blocks
    const int all = done | p.axes;
    if (p.axes < 1 || p.axes > 7 || (p.axes & done) || (all & (all + 1)) ||
        p.lux < 0 || p.luy < 0 || g.lbz < p.ltz || p.ltz < 0 || p.lty < 0 || p.ltx < 3 ||
        p.lnb < 0 || (p.lnb && !whole) || p.lnb + p.ltx + p.lty + p.ltz != PC_LTILE ||
        ((p.axes & 1) && p.lux) || ((p.axes & 2) && p.luy) ||
        ((p.axes & 4) && p.ltz != g.lbz) || (g.lbz == 0 && (p.axes & 4)))
      return (int)cudaErrorInvalidValue;
    done |= p.axes;
    p.ntiles = whole ? (g.nnn + (1 << p.lnb) - 1) >> p.lnb : g.nnn << p.lu;
    PcSide sd[2];
    for (int w = 0; w < 2; ++w) {
      const int code = q[5 + w], buf = code >> 2, kind = code & 3;
      if (code < 0 || buf > 2 || bufs[buf] == nullptr || (w == 0 && kind == PC_CLIP) ||
          (w == 1 && kind == PC_VOL) || (kind == PC_VOL && buf != 0))
        return (int)cudaErrorInvalidValue;
      PcSide& d = sd[w];
      d.p = bufs[buf];
      d.kind = kind;
      const int64_t nxp = (int64_t)g.nbx * bx, plane = nxp * g.nby * by;
      const int64_t st[4][3] = {{sz, sy, sx}, {plane, nxp, 1}, {(int64_t)by * bx, bx, 1},
                                {(int64_t)ny * nx, nx, 1}};
      d.sz = st[kind][0];
      d.sy = st[kind][1];
      d.sx = st[kind][2];
      const bool aligned = reinterpret_cast<uintptr_t>(d.p) % 16 == 0;
      d.vec = aligned && (kind == PC_PLANE || kind == PC_BLOCKS ||
                          (kind == PC_VOL && sx == 1 && sy % 4 == 0 && sz % 4 == 0) ||
                          (kind == PC_CLIP && nx % 4 == 0));
    }
    if (k == npasses - 1 && (q[6] >> 2) != 1) return (int)cudaErrorInvalidValue;
    const int64_t grid = p.ntiles < sms ? p.ntiles : sms;
    pc_pass<INV><<<(unsigned)grid, PC_NT, PC_SMEM, st>>>(g, p, sd[0], sd[1]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return done == (g.lbz ? 7 : 3) ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace cvx

// The forward cascade of every (bx, by, bz) block of the (nz, ny, nx) f32
// volume `vol` (strides sz, sy, sx in elements, any view) by the passes of
// `plan` into `out`: the zero-padded (nzp, nyp, nxp) plane or the
// block-major (nnn, bz, by, bx) batch, as the plan's last layout says.
extern "C" int cvx_plane_cascade_fwd(const float* vol, int64_t sz, int64_t sy, int64_t sx,
                                     int nz, int ny, int nx, int bx, int by, int bz,
                                     const int32_t* plan, int npasses, float* out,
                                     float* scratch, void* stream) {
  return cvx::plane_cascade<false>(vol, sz, sy, sx, nz, ny, nx, bx, by, bz, plan, npasses,
                                   out, scratch, stream);
}

// The inverse cascade of the block-major (nnn, bz, by, bx) coefficients
// `coeffs` into the (nz, ny, nx) volume `out`, clipped at its edges; the
// plan's passes before its last write `scratch` (nnn blocks).
extern "C" int cvx_plane_cascade_inv(const float* coeffs, int nz, int ny, int nx, int bx,
                                     int by, int bz, const int32_t* plan, int npasses,
                                     float* out, float* scratch, void* stream) {
  return cvx::plane_cascade<true>(coeffs, 0, 0, 0, nz, ny, nx, bx, by, bz, plan, npasses,
                                  out, scratch, stream);
}
