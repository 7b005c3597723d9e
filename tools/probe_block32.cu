// Probe kernels for tools/probe_block32.py: where the 32^3 kernels' time
// goes.  Not part of the package; built only by the probe script.
//
//   old_fwd<PASSES, TOKS, STORE>: the dense-operator design that the 32^3
//     kernels had before the cascade (one CTA of 512 threads per block, the
//     block in shared memory at a row pitch of 33 words, a scalar load
//     loop, three 32x32 f32 operator passes, a 64-cell tokenize walk per
//     thread), cut into its phases: PASSES (0 or 3) operator passes, TOKS tokenize walks
//     (with their descriptor stores), STORE the coefficient store.
//   old_inv<PASSES>: that design's inverse, the chunk gather, PASSES
//     operator passes and the clipped volume store.
//   new_fwd<MODE>, new_inv_copies: the persistent kernels of csrc/
//     (fused_encode.cu, fused_inverse.cu) cut the same way, from
//     common.cuh's pieces; the encode on its TMA route only.
#include <cuda.h>

#include <cstring>

#include "common.cuh"

namespace old32 {

using namespace cvx;

constexpr int B = 32;
constexpr int CELLS = B * B * B;
constexpr int ROWP = B + 1;
constexpr int PLANEP = B * ROWP;
constexpr int BLOCK_FLOATS = B * PLANEP;
constexpr int THREADS = 512;
constexpr int PER = CELLS / THREADS;
constexpr size_t SMEM_BYTES = (BLOCK_FLOATS + B * B) * sizeof(float);

__device__ __forceinline__ int sidx(int z, int y, int x) {
  return z * PLANEP + y * ROWP + x;
}
__device__ __forceinline__ int sidx_flat(int c) {
  return sidx(c >> 10, (c >> 5) & 31, c & 31);
}

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

template <int PASSES, int TOKS, bool STORE>
__global__ void __launch_bounds__(THREADS, 1)
old_fwd(const float* __restrict__ vol, int nx, int ny, int nz,
        const float* __restrict__ op_g, float mulfac, float* __restrict__ coeffs,
        int32_t* __restrict__ desc, int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + B * B;
  __shared__ int scan_buf[32];
  const int nbx = (nx + B - 1) / B, nby = (ny + B - 1) / B;
  const int64_t blk = blockIdx.x;
  const int x0 = (int)(blk % nbx) * B, y0 = (int)((blk / nbx) % nby) * B;
  const int z0 = (int)(blk / ((int64_t)nbx * nby)) * B;
  for (int i = threadIdx.x; i < B * B; i += blockDim.x) op[i] = op_g[i];
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) {
    const int z = c >> 10, y = (c >> 5) & 31, x = c & 31;
    const int gz = z0 + z, gy = y0 + y, gx = x0 + x;
    float v = 0.0f;
    if (gz < nz && gy < ny && gx < nx) v = vol[((int64_t)gz * ny + gy) * nx + gx];
    s[sidx(z, y, x)] = v;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < PASSES; ++a) {
    transform_axis(s, op, a);
    __syncthreads();
  }
  if (!STORE && !TOKS && threadIdx.x == 0)  // keeps the load alive
    sizes[blk] = __float_as_int(s[sidx(threadIdx.x, 1, 2)]);
  if (STORE) {
    float* cblk = coeffs + blk * CELLS;
    for (int c = threadIdx.x; c < CELLS; c += blockDim.x) cblk[c] = s[sidx_flat(c)];
  }
  const int c0 = threadIdx.x * PER;
  int total_cost = 0;
  for (int rep = 0; rep < TOKS; ++rep) {
    uint64_t nonzero = 0;
    for (int i = 0; i < PER; ++i) {
      const int32_t v = cvtt(__fmul_rn(s[sidx_flat(c0 + i)], mulfac));
      nonzero |= (uint64_t)(v != 0) << i;
    }
    const int last_local = nonzero ? c0 + 63 - __clzll((long long)nonzero) : -1;
    const bool next_zero = c0 + PER < CELLS &&
                           cvtt(__fmul_rn(s[sidx_flat(c0 + PER)], mulfac)) == 0;
    int unused;
    const int last = block_exclusive_scan(last_local, -1, MaxOp(), scan_buf, &unused);
    total_cost += tokenize64(
        [&](int i) { return cvtt(__fmul_rn(s[sidx_flat(c0 + i)], mulfac)); },
        nonzero, last, c0, !next_zero, desc + blk * CELLS + c0);
  }
  if (TOKS) {
    int size;
    block_exclusive_scan(total_cost, 0, SumOp(), scan_buf, &size);
    if (threadIdx.x == 0) sizes[blk] = size;
  }
}

template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
old_inv(const float* __restrict__ rows, const float* __restrict__ op_g, int nx,
        int ny, int nz, float* __restrict__ vol) {
  extern __shared__ __align__(16) float smem[];
  float* op = smem;
  float* s = smem + B * B;
  const int nbx = (nx + B - 1) / B, nby = (ny + B - 1) / B;
  const int64_t blk = blockIdx.x;
  const int x0 = (int)(blk % nbx) * B, y0 = (int)((blk / nbx) % nby) * B;
  const int z0 = (int)(blk / ((int64_t)nbx * nby)) * B;
  for (int i = threadIdx.x; i < B * B; i += blockDim.x) op[i] = op_g[i];
  const float* src = rows + blk * CELLS;
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) s[sidx_flat(c)] = src[c];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < PASSES; ++a) {
    transform_axis(s, op, a);
    __syncthreads();
  }
  for (int c = threadIdx.x; c < CELLS; c += blockDim.x) {
    const int z = c >> 10, y = (c >> 5) & 31, x = c & 31;
    const int gz = z0 + z, gy = y0 + y, gx = x0 + x;
    if (gz < nz && gy < ny && gx < nx)
      vol[((int64_t)gz * ny + gy) * nx + gx] = s[sidx(z, y, x)];
  }
}

template <class K>
int launch(K k, int64_t nnn, cudaStream_t st, const float* a, int nx, int ny,
           int nz, const float* op, float mf, float* c, int32_t* d, int32_t* s) {
  cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)nnn, THREADS, SMEM_BYTES, st>>>(a, nx, ny, nz, op, mf, c, d, s);
  return (int)cudaGetLastError();
}

}  // namespace old32

static int64_t nblocks(int nx, int ny, int nz) {
  return (int64_t)((nx + 31) / 32) * ((ny + 31) / 32) * ((nz + 31) / 32);
}

// The earlier design's phases, forward.  variant: 0 load alone; 1 load and
// coefficient store; 2 load, three passes, store; 3 the whole kernel (the
// global-RMS fused_encode before the cascade); 4 load and one tokenize
// walk (give it the coefficient plane in volume order); 5 load and two
// tokenize walks.
extern "C" int probe_old_fwd(int variant, const float* vol, int nx, int ny, int nz,
                             const float* op, float mulfac, float* coeffs,
                             int32_t* desc, int32_t* sizes, void* stream) {
  const int64_t n = nblocks(nx, ny, nz);
  cudaStream_t st = (cudaStream_t)stream;
#define L(P, T, S)                                                                  \
  old32::launch(old32::old_fwd<P, T, S>, n, st, vol, nx, ny, nz, op, mulfac, coeffs, \
                desc, sizes)
  switch (variant) {
    case 0: return L(0, 0, false);
    case 1: return L(0, 0, true);
    case 2: return L(3, 0, true);
    case 3: return L(3, 1, true);
    case 4: return L(0, 1, false);
    case 5: return L(0, 2, false);
  }
#undef L
  return -1;
}

// The earlier design's inverse (dense rows): variant 0 gather and store
// alone, 1 the whole kernel.
extern "C" int probe_old_inv(int variant, const float* rows, const float* op, int nx,
                             int ny, int nz, float* vol, void* stream) {
  auto k = variant ? old32::old_inv<3> : old32::old_inv<0>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)old32::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)nblocks(nx, ny, nz), old32::THREADS, old32::SMEM_BYTES,
      (cudaStream_t)stream>>>(rows, op, nx, ny, nz, vol);
  return (int)cudaGetLastError();
}

namespace new32 {

using namespace cvx;

// MODE 0: the copies and the coefficient store alone; 1: the copies, the
// three cascades and the store (no tokenize); 2: the copies, the store and
// one tokenize of the input as it is (give it the coefficient plane), no
// cascade; 3: as 2 with two tokenizes.  The copies in halves, as
// fused_encode's.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
new_fwd(const __grid_constant__ CUtensorMap tmap, int nx, int ny, int64_t nnn,
        float mulfac, float* coeffs, int32_t* __restrict__ desc,
        int32_t* __restrict__ sizes) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* s = block_buffer(dsmem);
  __shared__ uint64_t full[2];
  __shared__ int rows[B * B];
  __shared__ __align__(16) int halves[2 * CHUNKS_PER_BLOCK];
  __shared__ int scan_buf[32];
  auto load = [&](int64_t blk, int h) {
    if (threadIdx.x == 0) load_tma(s, &tmap, origin32(blk, nx, ny), h, smem_addr(&full[h]));
  };
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&full[0]));
    mbar_init(smem_addr(&full[1]));
  }
  __syncthreads();
  load(blockIdx.x, 0);
  load(blockIdx.x, 1);
  unsigned parity = 0;
  for (int64_t blk = blockIdx.x; blk < nnn; blk += gridDim.x, parity ^= 1) {
    const bool more = blk + gridDim.x < nnn;
    mbar_wait(smem_addr(&full[0]), parity);
    if (MODE == 1) passes_xy<false>(s, 0);
    mbar_wait(smem_addr(&full[1]), parity);
    if (MODE == 1) passes_xy<false>(s, 1);
    __syncthreads();
    float v[LINES][B];
    read_z(s, v);
    if (MODE == 1) {
      for (int i = 0; i < LINES; ++i) reg_cascade<false>(v[i]);
      write_z(s, v);
    }
    store_lines(v, coeffs + blk * CELLS);
    __syncthreads();
#pragma unroll 1
    for (int rep = 0; rep < MODE - 1; ++rep) {
      tokenize_carries(s, mulfac, rows, scan_buf);
      tokenize_half(s, mulfac, rows, 0, desc + blk * CELLS, halves);
      if (rep == MODE - 2) {
        fence_proxy_async();
        __syncthreads();
        if (more) load(blk + gridDim.x, 0);
      }
      tokenize_half(s, mulfac, rows, 1, desc + blk * CELLS, halves);
    }
    if (MODE < 2) {
      fence_proxy_async();
      __syncthreads();
      if (more) load(blk + gridDim.x, 0);
    }
    fence_proxy_async();
    __syncthreads();
    if (more) load(blk + gridDim.x, 1);
    if (MODE >= 2 && threadIdx.x < 32) sizes[blk] = halves[threadIdx.x];  // keeps the work
  }
}

// The inverse's copies (16-byte cp.async of the dense rows) and the
// clipped volume store alone.
__global__ void __launch_bounds__(THREADS, 1)
new_inv_copies(const float* __restrict__ rows, int nx, int ny, int nz, int64_t nnn,
               float* __restrict__ vol) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* s = block_buffer(dsmem);
  const int lane = threadIdx.x & 31, y0 = 2 * (threadIdx.x >> 5);
  auto load = [&](int64_t blk) {
    for (int i = 0; i < CELLS / 4 / THREADS; ++i) {
      const int p = threadIdx.x + THREADS * i, r = p >> 3, k = p & 7;
      cp_async<16>(s + (r << 5) + ((k ^ (r & 7)) << 2), rows + blk * CELLS + 4 * p, true);
    }
    cp_async_commit();
  };
  load(blockIdx.x);
  for (int64_t blk = blockIdx.x; blk < nnn; blk += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();
    float v[LINES][B];
    read_z(s, v);
    __syncthreads();
    if (blk + gridDim.x < nnn) load(blk + gridDim.x);
    const Origin o = origin32(blk, nx, ny);
    const int gx = o.x0 + lane;
    for (int i = 0; i < LINES; ++i) {
      const int gy = o.y0 + y0 + i;
      if (gx >= nx || gy >= ny) continue;
      for (int z = 0; z < B; ++z)
        if (o.z0 + z < nz) vol[((int64_t)(o.z0 + z) * ny + gy) * nx + gx] = v[i][z];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static int grid(int64_t nnn) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(nnn < sms ? nnn : sms);
}

template <int MODE>
int launch_fwd(const float* vol, int nx, int ny, int nz, float mf, float* c, int32_t* d,
               int32_t* sz, cudaStream_t st) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                   &q);
#else
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (p == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmap;
  std::memset(&tmap, 0, sizeof tmap);
  const cuuint64_t dims[3] = {(cuuint64_t)nx, (cuuint64_t)ny, (cuuint64_t)nz};
  const cuuint64_t strides[2] = {(cuuint64_t)nx * 4, (cuuint64_t)nx * ny * 4};
  const cuuint32_t box[3] = {B, B, HALF}, one[3] = {1, 1, 1};
  if (((EncodeTiled)p)(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)vol, dims, strides,
                       box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(new_fwd<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)cvx::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = nblocks(nx, ny, nz);
  new_fwd<MODE><<<grid(nnn), THREADS, cvx::SMEM_BYTES, st>>>(tmap, nx, ny, nnn, mf, c, d,
                                                             sz);
  return (int)cudaGetLastError();
}

}  // namespace new32

// This design's phases, forward (TMA route; see new_fwd's MODE).
extern "C" int probe_new_fwd(int mode, const float* vol, int nx, int ny, int nz,
                             float mulfac, float* coeffs, int32_t* desc, int32_t* sizes,
                             void* stream) {
  using namespace new32;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: return launch_fwd<0>(vol, nx, ny, nz, mulfac, coeffs, desc, sizes, st);
    case 1: return launch_fwd<1>(vol, nx, ny, nz, mulfac, coeffs, desc, sizes, st);
    case 2: return launch_fwd<2>(vol, nx, ny, nz, mulfac, coeffs, desc, sizes, st);
    case 3: return launch_fwd<3>(vol, nx, ny, nz, mulfac, coeffs, desc, sizes, st);
  }
  return -1;
}

// This design's inverse copies and volume store alone (dense rows).
extern "C" int probe_new_inv(const float* rows, int nx, int ny, int nz, float* vol,
                             void* stream) {
  using namespace new32;
  cudaError_t e = cudaFuncSetAttribute(new_inv_copies,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)cvx::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int64_t nnn = nblocks(nx, ny, nz);
  new_inv_copies<<<grid(nnn), THREADS, cvx::SMEM_BYTES, (cudaStream_t)stream>>>(
      rows, nx, ny, nz, nnn, vol);
  return (int)cudaGetLastError();
}
