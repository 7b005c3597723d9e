// Shared pieces of the 32^3 block kernels (fused_encode, fused_inverse): the swizzled shared-memory block, its asynchronous
// copies, the passes of the 7/9 cascade over it and the row-wise tokenize.
// The cascade's arithmetic is cascade.cuh's, the token grammar tokens.cuh's.
//
// The block in shared memory: 32,768 words, no padding.  Cell (z, y, x)
// sits in row r = 32 z + y (128 bytes) with its 16-byte quarter x / 4
// XORed with y mod 8, which is exactly the layout a TMA tile copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes into a 1,024-byte aligned buffer.  Its
// bank is ((x / 4) ^ (y % 8)) * 4 + x % 4, so a warp's 32 lanes never meet
// on a bank: along x (a lane per line, y = lane) eight lanes of a quarter
// warp read eight distinct 16-byte quarters as float4s; along y and z (a
// lane per x) the 32 words of a row position land on 32 banks.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no link to libcuda)

#include "cascade.cuh"
#include "tokens.cuh"

namespace cvx {

constexpr int B = 32;                  // block edge (32^3 blocks only)
constexpr int CELLS = B * B * B;       // 32768 cells, 128 KiB of f32
constexpr int THREADS = 512;           // 16 warps
constexpr int CHUNK = 128;             // decode chunk: 128 cells, 4 x-rows
constexpr int CHUNKS_PER_BLOCK = CELLS / CHUNK;
constexpr int LINES = B * B / THREADS;  // z-lines per thread
constexpr int HALF = B / 2;            // z-planes in each half of a copy
// the block, and the slack to align it to 1,024 bytes (the swizzle's
// period), as dynamic shared memory (the launcher raises the limit)
constexpr size_t SMEM_BYTES = CELLS * sizeof(float) + 1024;

// Word offset of cell (z, y, x) in the swizzled block.
__device__ __forceinline__ int swz(int z, int y, int x) {
  return ((z * B + y) << 5) | ((((x >> 2) ^ (y & 7)) << 2) | (x & 3));
}

// The block's buffer: the dynamic shared memory, rounded up to 1,024 bytes.
__device__ __forceinline__ float* block_buffer(unsigned char* dsmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dsmem);
  return reinterpret_cast<float*>(dsmem + ((1024u - (a & 1023u)) & 1023u));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16) from src, or zeros when `valid` is false
// (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The mbarrier of a TMA copy: one arrival (the issuing thread's) a phase.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Orders this thread's earlier shared-memory accesses (the generic proxy)
// before a later TMA copy into the same bytes (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The block's raster index -> its volume origin.
struct Origin {
  int x0, y0, z0;
};
__device__ __forceinline__ Origin origin32(int64_t blk, int nx, int ny) {
  const int nbx = (nx + B - 1) / B, nby = (ny + B - 1) / B;
  return {(int)(blk % nbx) * B, (int)((blk / nbx) % nby) * B,
          (int)(blk / ((int64_t)nbx * nby)) * B};
}

// One thread: half h (the z-planes 16h .. 16h + 15) of the 32^3 box at `o`
// of the volume that `tmap` (a CUtensorMap: f32, dims (nx, ny, nz), box
// 32 x 32 x 16, SWIZZLE_128B, zero fill) describes, into its place in the
// 1,024-byte aligned buffer `s`, completing on `bar`.
__device__ __forceinline__ void load_tma(float* s, const void* tmap, Origin o, int h,
                                         unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(CELLS * 2) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(s + h * HALF * B * B)),
      "l"(tmap), "r"(o.x0), "r"(o.y0), "r"(o.z0 + h * HALF), "r"(bar)
      : "memory");
}

// Every thread: the same half by 4-byte cp.async (any nx, any alignment),
// zero-filled past the volume's edges; one commit group.
__device__ __forceinline__ void load_async4(float* s, const float* vol, int nx, int ny,
                                            int nz, Origin o, int h) {
  for (int c = h * CELLS / 2 + threadIdx.x; c < (h + 1) * CELLS / 2; c += THREADS) {
    const int z = c >> 10, y = (c >> 5) & 31, x = c & 31;
    const int gz = o.z0 + z, gy = o.y0 + y, gx = o.x0 + x;
    const bool in = gz < nz && gy < ny && gx < nx;
    cp_async<4>(s + swz(z, y, x), in ? vol + ((int64_t)gz * ny + gy) * nx + gx : vol, in);
  }
  cp_async_commit();
}

// The x and y passes in place over the z-plane w + 16 h that warp w owns:
// lane l its x-line (y = l), read and written as eight float4s, then its
// y-line (x = l).  The plane is the warp's alone, so a __syncwarp orders
// the two passes; the planes of half h need only that half's copy.
template <bool INVERSE>
__device__ __forceinline__ void passes_xy(float* s, int h) {
  const int lane = threadIdx.x & 31, z = (threadIdx.x >> 5) + HALF * h;
  {
    float4* row = reinterpret_cast<float4*>(s + ((z * B + lane) << 5));
    float v[B];
#pragma unroll
    for (int k = 0; k < B / 4; ++k) {
      const float4 q = row[k ^ (lane & 7)];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    reg_cascade<INVERSE>(v);
#pragma unroll
    for (int k = 0; k < B / 4; ++k)
      row[k ^ (lane & 7)] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  __syncwarp();
  float v[B];
#pragma unroll
  for (int y = 0; y < B; ++y) v[y] = s[swz(z, y, lane)];
  reg_cascade<INVERSE>(v);
#pragma unroll
  for (int y = 0; y < B; ++y) s[swz(z, y, lane)] = v[y];
}

// The z pass's input: thread t's z-lines (y, x) = (2 w + i, lane), each
// into registers (the pass itself runs there, after the buffer is free).
__device__ __forceinline__ void read_z(const float* s, float (&v)[LINES][B]) {
  const int x = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);
#pragma unroll
  for (int i = 0; i < LINES; ++i)
#pragma unroll
    for (int z = 0; z < B; ++z) v[i][z] = s[swz(z, y0 + i, x)];
}

// Thread t's z-lines back to where read_z took them.
__device__ __forceinline__ void write_z(float* s, const float (&v)[LINES][B]) {
  const int x = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);
#pragma unroll
  for (int i = 0; i < LINES; ++i)
#pragma unroll
    for (int z = 0; z < B; ++z) s[swz(z, y0 + i, x)] = v[i][z];
}

// A block's cells from thread t's z-lines (read_z) to the block-major
// buffer `dst`: lane x of warp w at (z, 2w + i, x), 128 bytes per warp and
// row.
__device__ __forceinline__ void store_lines(const float (&v)[LINES][B], float* dst) {
  const int x = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);
#pragma unroll
  for (int i = 0; i < LINES; ++i)
#pragma unroll
    for (int z = 0; z < B; ++z) dst[(z * B + y0 + i) * B + x] = v[i][z];
}

// The descriptor of lane `lane`'s cell of a segment of 32 consecutive
// block-order cells, one cell a lane: q its quantized value, m the
// segment's ballot of non-zero cells (warp-uniform), c the cell's
// block-local index, carry the block-local index of the last non-zero
// cell before the segment (-1: none), end_last whether a zero run in the
// segment's last cell ends there (the block's end, or a non-zero cell
// next).  A group of 8 cells is 8 lanes, its mode from ballots of the four
// classes; a segment of zeros skips those.  mb, where the caller has it:
// the segment's ballot of byte-sized values.
__device__ __forceinline__ int32_t seg_desc(int32_t q, unsigned m, unsigned mb, int lane,
                                            int c, int carry, bool end_last) {
  if (m == 0) return zero_desc(lane == 31 && end_last, c - carry);
  const unsigned grp = 0xffu << (lane & 24), below = (1u << lane) - 1u;
  const unsigned ms = __ballot_sync(~0u, is_short(q));
  const unsigned m3 = __ballot_sync(~0u, is_i3(q));
  const int mode = group_mode_counts(8 - __popc(m & grp), __popc(mb & grp),
                                     __popc(ms & grp), __popc(m3 & grp));
  const unsigned lower = m & below;
  const int last = lower ? c - lane + 31 - __clz((int)lower) : carry;
  const bool end = lane < 31 ? ((m >> (lane + 1)) & 1) != 0 : end_last;
  return q != 0 ? value_cost(mode, lane & 7, q) : zero_desc(end, c - last);
}

__device__ __forceinline__ int32_t seg_desc(int32_t q, unsigned m, int lane, int c,
                                            int carry, bool end_last) {
  if (m == 0) return zero_desc(lane == 31 && end_last, c - carry);
  return seg_desc(q, m, __ballot_sync(~0u, is_byte(q)), lane, c, carry, end_last);
}

// The tokenize of one block from its UNSCALED coefficients in the
// swizzled buffer `s`, row by row: lane x of warp w takes cell x of the
// x-rows (z, 2w) and (z, 2w + 1), r = 32 z + y, cell c = 32 r + x in block
// order (word reads on 32 banks), 8 rows at a time (their reads and
// ballots first, then the rows one by one).  q = cvtt(coeff * mulfac) (one
// f32 rounding).  tokenize_carries: each row's last non-zero cell (a ballot
// and clz) into `rows` (1 + c, 0 for none; bit 16: the row's first cell is
// non-zero), a block-wide max-scan over the 1,024 rows, and each row's
// 1 + last non-zero cell before it back into `rows`.  Then tokenize_half
// for each half of the rows (so the copy of the next block's first half
// can start between the two): a zero cell's run reaches back to the last
// non-zero cell before it, in its row (a ballot below its lane) or before
// the row (its carry), and ends at a non-zero cell or the block's end; a
// group of 8 cells is 8 lanes, its mode from ballots of the four classes;
// a row of zeros (the same on every lane) skips those.  The descriptors
// (cost | run_end << 3 | min(run_len, 2^24-1) << 4) go to `dblk`, 128 bytes
// per warp and row.
// The costs also go to the shared `halves`, 2 * CHUNKS_PER_BLOCK ints laid
// out [warp][z]: warp w sums, lane by lane, its two rows (z, 2w) and
// (z, 2w + 1) of 8 z-planes in registers, then each plane's sum over the
// warp (a reduce each), stored by lane 0 as two int4s; the 128-cell chunk j
// (rows 4j .. 4j + 3: z = j / 8, warps 2 (j % 8) and 2 (j % 8) + 1) holds
// halves[2 (j % 8) B + j / 8] + halves[(2 (j % 8) + 1) B + j / 8] bytes
// once the block is tokenized, and the chunks' sum is the block's size.
// The loops stay rolled: unrolled over the block, the kernel's code
// outgrows the instruction cache.  `rows` holds 1,024 ints, `scan_buf` 32,
// both shared; the caller has published `s` (a barrier).
__device__ __forceinline__ void tokenize_carries(const float* s, float mulfac, int* rows,
                                                 int* scan_buf) {
  const int lane = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);
#pragma unroll 1
  for (int i = 0; i < LINES; ++i)
#pragma unroll 1
    for (int z0 = 0; z0 < B; z0 += 8) {
      unsigned m[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[k] = __ballot_sync(~0u, cvtt(__fmul_rn(s[swz(z0 + k, y0 + i, lane)], mulfac)) != 0);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int r = (z0 + k) * B + y0 + i;
          rows[r] = (m[k] ? r * B + B - __clz((int)m[k]) : 0) | (int)((m[k] & 1) << 16);
        }
    }
  __syncthreads();
  {  // thread t: the carries of the rows 2t and 2t + 1
    const int a = rows[2 * threadIdx.x], b = rows[2 * threadIdx.x + 1];
    const int la = (a & 0xffff) - 1, lb = (b & 0xffff) - 1;
    int unused;
    const int excl =
        block_exclusive_scan(la > lb ? la : lb, -1, MaxOp(), scan_buf, &unused);
    rows[2 * threadIdx.x] = (excl + 1) | (a & 0x10000);
    rows[2 * threadIdx.x + 1] = ((excl > la ? excl : la) + 1) | (b & 0x10000);
  }
  __syncthreads();
}

// The descriptors of the rows of half h (z in [16h, 16h + 16)), and their
// costs' sums into `halves`.  Not inlined: one copy of the code serves both
// halves (inlined twice, the count's few instructions a row cost the local
// RMS encode 13 % through the instruction cache: PERF.md).
static __device__ __noinline__ void tokenize_half(const float* s, float mulfac, const int* rows,
                                              int h, int32_t* __restrict__ dblk,
                                              int* __restrict__ halves) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, y0 = 2 * warp;
#pragma unroll 1
  for (int z0 = HALF * h; z0 < HALF * (h + 1); z0 += 8) {
    int cc[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // the lane's cost in plane z0 + k
#pragma unroll 1
    for (int i = 0; i < LINES; ++i) {
      int32_t q[8];
      unsigned m[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        q[k] = cvtt(__fmul_rn(s[swz(z0 + k, y0 + i, lane)], mulfac));
        m[k] = __ballot_sync(~0u, q[k] != 0);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = (z0 + k) * B + y0 + i, c = r * B + lane;
        const int carry = (rows[r] & 0xffff) - 1;
        // the first cell of the next row, or the block's end, ends a run
        // in this row's last cell
        const bool end_last = r == B * B - 1 || (rows[r < B * B - 1 ? r + 1 : r] >> 16) != 0;
        const int32_t d = seg_desc(q[k], m[k], lane, c, carry, end_last);
        dblk[c] = d;
        cc[k] += d & 7;
      }
    }
    const int4 lo = make_int4(__reduce_add_sync(~0u, cc[0]), __reduce_add_sync(~0u, cc[1]),
                              __reduce_add_sync(~0u, cc[2]), __reduce_add_sync(~0u, cc[3]));
    const int4 hi = make_int4(__reduce_add_sync(~0u, cc[4]), __reduce_add_sync(~0u, cc[5]),
                              __reduce_add_sync(~0u, cc[6]), __reduce_add_sync(~0u, cc[7]));
    if (lane == 0) {
      int4* p = reinterpret_cast<int4*>(halves + warp * B + z0);
      p[0] = lo;
      p[1] = hi;
    }
  }
}

// Chunk j's byte count from `halves` (tokenize_half), j < CHUNKS_PER_BLOCK.
__device__ __forceinline__ int chunk_cost(const int* halves, int j) {
  return halves[2 * (j & 7) * B + (j >> 3)] + halves[(2 * (j & 7) + 1) * B + (j >> 3)];
}

// cuTensorMapEncodeTiled from libcuda, looked up at run time so that the
// library needs no link to it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

}  // namespace cvx
