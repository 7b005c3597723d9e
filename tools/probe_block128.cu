// Probe kernels for tools/probe_block128.py: what holds the 128^3
// transform launches (csrc/block_encode.cu, csrc/block_inverse.cu) back.
// Not part of the package; built only by the probe script.
//
//   probe_slab<REPS, ROWS, INVERSE>: block_fwd_z's slab round trip (the
//     (z, x) slab of a (block, y) in, written block-major) with REPS
//     cascade passes in between (REPS = 0: the copies alone), along the
//     columns or, with ROWS, the rows of the slab.
//   probe_fwd_z_persistent: block_fwd_z as one persistent CTA per SM that
//     double-buffers the slabs in shared memory, the next slab's copy in
//     flight (cp.async, 4 bytes a thread: the 129-word pitch allows no
//     16-byte copy) while the current one cascades.
#include "block_common.cuh"

namespace cvx {

template <int REPS, bool ROWS, bool INVERSE>
__global__ void __launch_bounds__(BT, 3)
probe_slab_kernel(const float* __restrict__ vol, int nx, int ny,
                  float* __restrict__ tmp) {
  extern __shared__ __align__(16) float s[];
  __shared__ MirrorTables tabs;
  const int64_t blk = blockIdx.x >> 7;
  const int y = blockIdx.x & (BB - 1);
  const BlockOrigin o = block_origin(blk, nx, ny);
  build_tables(&tabs);
  const int64_t zstride = (int64_t)ny * nx;
  load_slice(s, vol + o.z0 * zstride + (o.y0 + y) * nx + o.x0, zstride);
  __syncthreads();
#pragma unroll 1
  for (int r = 0; r < REPS; ++r) {
    if (ROWS)
      cascade_lines<PITCH, 1, INVERSE>(s, tabs);
    else
      cascade_lines<1, PITCH, INVERSE>(s, tabs);
    __syncthreads();
  }
  store_slice(tmp + blk * BB_CELLS + y * BB, SLICE, s);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void slab_async(float* s, const float* src,
                                           int64_t stride) {
  for (int i = threadIdx.x; i < SLICE; i += BT)
    cp_async4(s + (i >> 7) * PITCH + (i & (BB - 1)), src + (i >> 7) * stride + (i & (BB - 1)));
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(BT, 1)
probe_fwd_z_persistent_kernel(const float* __restrict__ vol, int nx, int ny,
                              int nslabs, float* __restrict__ tmp) {
  extern __shared__ __align__(16) float smem[];  // two slabs
  __shared__ MirrorTables tabs;
  build_tables(&tabs);
  const int64_t zstride = (int64_t)ny * nx;
  auto src = [&](int slab) {
    const BlockOrigin o = block_origin(slab >> 7, nx, ny);
    return vol + o.z0 * zstride + (o.y0 + (slab & (BB - 1))) * nx + o.x0;
  };
  if (blockIdx.x < nslabs) slab_async(smem, src(blockIdx.x), zstride);
  int buf = 0;
  for (int slab = blockIdx.x; slab < nslabs; slab += gridDim.x, buf ^= 1) {
    float* s = smem + buf * MAT;
    const int next = slab + gridDim.x;
    if (next < nslabs) {
      slab_async(smem + (buf ^ 1) * MAT, src(next), zstride);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    cascade_lines<1, PITCH, false>(s, tabs);
    __syncthreads();
    store_slice(tmp + (int64_t)(slab >> 7) * BB_CELLS + (slab & (BB - 1)) * BB,
                SLICE, s);
    __syncthreads();  // the buffer is the prefetch target two slabs on
  }
}

template <int REPS, bool ROWS, bool INVERSE>
int launch_slab(const float* vol, int nx, int ny, int nz, float* tmp,
                cudaStream_t st) {
  auto k = probe_slab_kernel<REPS, ROWS, INVERSE>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BSMEM);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = (int64_t)(nx / BB) * (ny / BB) * (nz / BB);
  k<<<(unsigned)(nnn * BB), BT, BSMEM, st>>>(vol, nx, ny, tmp);
  return (int)cudaGetLastError();
}

}  // namespace cvx

// variant: 0..3 = column cascades repeated 0, 1, 2, 4 times (forward);
// 4 = one row cascade (forward); 5 = one column cascade (inverse)
extern "C" int probe_slab(int variant, const float* vol, int nx, int ny, int nz,
                          float* tmp, void* stream) {
  using namespace cvx;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch_slab<0, false, false>(vol, nx, ny, nz, tmp, st);
    case 1: return launch_slab<1, false, false>(vol, nx, ny, nz, tmp, st);
    case 2: return launch_slab<2, false, false>(vol, nx, ny, nz, tmp, st);
    case 3: return launch_slab<4, false, false>(vol, nx, ny, nz, tmp, st);
    case 4: return launch_slab<1, true, false>(vol, nx, ny, nz, tmp, st);
    case 5: return launch_slab<1, false, true>(vol, nx, ny, nz, tmp, st);
  }
  return -1;
}

extern "C" int probe_fwd_z_persistent(const float* vol, int nx, int ny, int nz,
                                      int ctas, float* tmp, void* stream) {
  using namespace cvx;
  const size_t smem = 2 * BSMEM;
  cudaError_t e = cudaFuncSetAttribute(
      probe_fwd_z_persistent_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nslabs = (nx / BB) * (ny / BB) * (nz / BB) * BB;
  probe_fwd_z_persistent_kernel<<<ctas, BT, smem, (cudaStream_t)stream>>>(
      vol, nx, ny, nslabs, tmp);
  return (int)cudaGetLastError();
}
