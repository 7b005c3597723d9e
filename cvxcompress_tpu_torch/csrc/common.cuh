// Shared pieces of the 32^3 block kernels (fused_encode, emit_payload,
// fused_inverse): the padded shared-memory block layout and one axis of the
// dense-operator wavelet.  The token grammar is in tokens.cuh.
#pragma once

#include "tokens.cuh"

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

}  // namespace cvx
