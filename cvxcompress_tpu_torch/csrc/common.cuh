// Shared pieces of the 32^3 block kernels (fused_encode, emit_payload,
// fused_inverse): the padded shared-memory block layout, one axis of the
// dense-operator wavelet, the cvttps quantizer, the token classes and a
// block-wide scan.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cvx {

constexpr int B = 32;                  // block edge (32^3 blocks only)
constexpr int CELLS = B * B * B;       // 32768 cells, 128 KiB of f32
constexpr int ROWP = B + 1;            // padded x-row pitch in shared memory
constexpr int PLANEP = B * ROWP;       // padded (y, x) plane pitch
constexpr int BLOCK_FLOATS = B * PLANEP;
constexpr int THREADS = 512;           // 16 warps; each thread owns 64 cells
constexpr int CELLS_PER_THREAD = CELLS / THREADS;
constexpr int CHUNK = 128;             // decode chunk: 128 cells, 4 x-rows
constexpr int CHUNKS_PER_BLOCK = CELLS / CHUNK;
// block + one 32x32 operator, dynamic shared memory (over the 48 KB static
// limit, so the launcher raises the kernel's limit first)
constexpr size_t SMEM_BYTES = (BLOCK_FLOATS + B * B) * sizeof(float);

// Cell (z, y, x) of the block in shared memory.  The odd row pitch keeps a
// warp's 32 lines of every axis on 32 distinct banks: x-lines step 33
// words, y- and z-lines step 1 word.
__device__ __forceinline__ int sidx(int z, int y, int x) {
  return z * PLANEP + y * ROWP + x;
}

// Cell index (z*1024 + y*32 + x) -> shared-memory offset.
__device__ __forceinline__ int sidx_flat(int c) {
  return sidx(c >> 10, (c >> 5) & 31, c & 31);
}

// One axis of the 3D transform in place: every line v along `axis`
// (0 = x, 1 = y, 2 = z) becomes op @ v, in full f32.  A thread owns whole
// lines, so it reads its 32 values into registers before writing any.
// The operator reads are warp-wide broadcasts from shared memory.
__device__ __forceinline__ void transform_axis(float* s, const float* op,
                                               int axis) {
  for (int line = threadIdx.x; line < B * B; line += blockDim.x) {
    const int a = line >> 5, b = line & 31;
    int base, stride;
    if (axis == 0) {
      base = a * PLANEP + b * ROWP;
      stride = 1;
    } else if (axis == 1) {
      base = a * PLANEP + b;
      stride = ROWP;
    } else {
      base = a * ROWP + b;
      stride = PLANEP;
    }
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = s[base + j * stride];
#pragma unroll 2
    for (int k = 0; k < B; ++k) {
      const float4* row = reinterpret_cast<const float4*>(op + k * B);
      float acc = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < B / 4; ++j4) {
        const float4 w = row[j4];
        acc = fmaf(w.x, v[4 * j4 + 0], acc);
        acc = fmaf(w.y, v[4 * j4 + 1], acc);
        acc = fmaf(w.z, v[4 * j4 + 2], acc);
        acc = fmaf(w.w, v[4 * j4 + 3], acc);
      }
      s[base + k * stride] = acc;
    }
  }
}

// x86 cvttss2si: truncate toward zero; NaN and out-of-range give INT32_MIN.
// __float2int_rz alone saturates and maps NaN to 0, hence the mask.
__device__ __forceinline__ int32_t cvtt(float f) {
  return (f >= -2147483648.0f && f < 2147483648.0f) ? __float2int_rz(f)
                                                     : INT32_MIN;
}

__device__ __forceinline__ bool is_byte(int32_t v) { return v > -125 && v < 125; }
__device__ __forceinline__ bool is_short(int32_t v) { return v >= -32768 && v <= 32767; }
__device__ __forceinline__ bool is_i3(int32_t v) { return v >= -8388608 && v <= 8388607; }

// Group-of-8 mode: 0 mixed, 1 eight plain bytes, 2 VLESC2_8x, 3 VLESC3_8x,
// with the reference's selection guards (Run_Length_Encode_Slow.cpp:216,
// 231, 246).
__device__ __forceinline__ int group_mode(const int32_t iv[8]) {
  int nzero = 0, nb = 0, ns = 0, n3 = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    nzero += iv[l] == 0;
    nb += is_byte(iv[l]);
    ns += is_short(iv[l]);
    n3 += is_i3(iv[l]);
  }
  if (nzero != 0) return 0;
  if (nb == 8) return 1;
  if (ns == 8 && nb + (8 - nb) * 3 > 17) return 2;
  if (n3 == 8 && nb + (ns - nb) * 3 + (8 - ns) * 4 > 25) return 3;
  return 0;
}

constexpr int32_t MAX_RUN24 = (1 << 24) - 1;

// Byte cost of a non-zero cell's token, given its group mode and lane.
__device__ __forceinline__ int value_cost(int mode, int lane, int32_t v) {
  if (mode == 1) return 1;
  if (mode == 2) return lane == 0 ? 3 : 2;
  if (mode == 3) return lane == 0 ? 4 : 3;
  if (is_byte(v)) return 1;
  if (is_short(v)) return 3;
  if (is_i3(v)) return 4;
  return 5;
}

// Byte cost of the token that flushes a zero run of `len` cells.
__device__ __forceinline__ int run_cost(int32_t len) {
  return len == 1 ? 1 : len < 256 ? 2 : len <= MAX_RUN24 ? 4 : 5;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Block-wide exclusive scan over the THREADS threads' values; `*total`
// receives the combination of all of them.  `buf` holds 32 ints of shared
// memory.  Every thread of the block must call it.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* buf,
                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = op(inc, n);
  }
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? buf[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, n);
    }
    buf[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = identity;
  const int res = op(warp == 0 ? identity : buf[warp - 1], excl);
  *total = buf[nwarps - 1];
  __syncthreads();  // buf may be reused by the next scan
  return res;
}

}  // namespace cvx
