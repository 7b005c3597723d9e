// block_encode: 128^3 forward wavelet + scale + quantize + tokenize, in two
// launches.
//
// Replaces the TPU kernel fused_compress.tokenize_block_fused, global branch
// (cvxcompress_tpu/ops/fused_compress.py:422, call :562; kernel
// _kernel_block :291 with the tokenize tail _block_tokenize_tail :259).
// There the whole 8 MiB block sits in VMEM for one grid step.  On Hopper it
// does not fit on chip, so the cascades split into two passes through
// device memory, in _kernel_block's axis order z, then x, then y:
//   1. block_fwd_z: one CTA per (block, y).  It loads the (z, x) slab of
//      the volume (128 x-rows of 512 B at a stride), runs the z cascade and
//      writes the slab into the coefficient buffer, block-major (z, y, x).
//   2. block_encode_xy: one CTA per (block, z), on the z-slice's 16,384
//      contiguous cells: the x cascade, then the y cascade; the UNSCALED
//      coefficients go out (in place: the CTA holds its slice in shared
//      memory before it writes); then fv = c * mulfac (one f32 rounding),
//      cvttps, the classes, group-of-8 modes and per-cell descriptors
//      (cost | run_end << 3 | min(run_len, 2^24-1) << 4), and per 128-cell
//      chunk its byte count (atomic adds into zeroed counters).
//
// The zero-run carry.  A run crosses z-slices and chunks and resets only
// at a block start, so a slice's leading zeros need the last non-zero cell
// of the slices before it.  Single-pass decoupled look-back: each CTA takes
// its slice from an atomic ticket (so every earlier slice's CTA has
// started), publishes its own last non-zero cell as soon as its transform
// is done, then walks back over the published slices of its block until
// one holds a non-zero cell (or the block starts).  A CTA waits only on
// CTAs that publish before they wait on anything, so the walk always ends.
// The last cell of a slice, when it is zero and not the block's last,
// belongs to the next slice's CTA: only that CTA knows whether the run ends
// there; it writes the descriptor and adds its cost to the chunk and the
// block.  Per-block sizes are atomic integer sums, exact in any order; the
// raw-fallback decision (size > 4 * cells) follows in the wrapper.
//
// What bounds it on an H100: the three 128-tap dot products per cell
// (768 FLOP per cell) on the CUDA cores; one CTA of 132 KiB per SM runs
// each slice's load, two products and tokenize back to back.

#include "block_common.cuh"

namespace cvx {

__global__ void __launch_bounds__(BT, 1)
block_fwd_z_kernel(const float* __restrict__ vol, int nx, int ny,
                   const float* __restrict__ op_g, float* __restrict__ tmp) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + MAT;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);

  load_slice(op, op_g, BB);
  const int64_t zstride = (int64_t)ny * nx;
  load_slice(s, vol + o.z0 * zstride + (o.y0 + y) * nx + o.x0, zstride);
  __syncthreads();
  float acc[8][8];
  mm128<PITCH, 1, PITCH, 1>(op, s, acc);  // out[z'][x] = sum_z W[z'][z] s[z][x]
  store_tile(tmp + blk * BB_CELLS + y * BB, SLICE, acc);
}

__device__ __forceinline__ int32_t quantized(const float* s, int c,
                                             float mulfac) {
  return cvtt(__fmul_rn(s[(c >> 7) * PITCH + (c & (BB - 1))], mulfac));
}

__global__ void __launch_bounds__(BT, 1)
block_encode_xy_kernel(const float* src, const float* __restrict__ op_g,
                       float mulfac, int* __restrict__ ticket,
                       int* __restrict__ status, float* coeffs,
                       int32_t* __restrict__ desc,
                       int32_t* __restrict__ chunk_bytes,
                       int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + MAT;
  __shared__ int s_tile, s_carry, scan_buf[32];

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;  // (block, z) in block-major, z-ascending order
  const int64_t blk = tile >> 7;
  const int z = tile & (BB - 1);
  const int gbase = z * SLICE;  // the slice's first cell in its block
  const int64_t off = blk * BB_CELLS + gbase;

  load_slice(op, op_g, BB);
  load_slice(s, src + off, BB);
  __syncthreads();
  float acc[8][8];
  mm128<PITCH, 1, 1, PITCH>(s, op, acc);  // x: out[y][x'] = sum_x s[y][x] W[x'][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
  mm128<PITCH, 1, PITCH, 1>(op, s, acc);  // y: out[y'][x] = sum_y W[y'][y] s[y][x]
  __syncthreads();
  store_tile(s, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < SLICE; i += BT)
    coeffs[off + i] = s[(i >> 7) * PITCH + (i & (BB - 1))];

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
    s_carry = carry;
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

  int last = excl >= 0 ? gbase + excl : s_carry;
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

}  // namespace cvx

extern "C" int cvx_block_fwd_z(const float* vol, int nx, int ny, int nz,
                               const float* op, float* tmp, void* stream) {
  using namespace cvx;
  cudaError_t e = cudaFuncSetAttribute(
      block_fwd_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  block_fwd_z_kernel<<<(unsigned)(nnn * BB), BT, BSMEM,
                       (cudaStream_t)stream>>>(vol, nx, ny, op, tmp);
  return (int)cudaGetLastError();
}

// `scratch` holds 1 + nnn * 128 ints: the ticket and the slices' status.
extern "C" int cvx_block_encode_xy(const float* src, const float* op,
                                   float mulfac, int64_t nnn, int* scratch,
                                   float* coeffs, int32_t* desc,
                                   int32_t* chunk_bytes, int32_t* sizes,
                                   void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(
      block_encode_xy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BSMEM);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(scratch, 0, (1 + nnn * BB) * sizeof(int), st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(chunk_bytes, 0, nnn * (BB_CELLS / 128) * sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, nnn * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  block_encode_xy_kernel<<<(unsigned)(nnn * BB), BT, BSMEM, st>>>(
      src, op, mulfac, scratch, scratch + 1, coeffs, desc, chunk_bytes,
      sizes);
  return (int)cudaGetLastError();
}
