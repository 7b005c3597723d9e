// patch_extract, design (b): the copy by TMA bulk copies, for timing
// against the shipped design (csrc/patch_extract.cu, a lane a float4 and an
// int4 of each chunk in registers).  tools/ab_patch.py builds this file in
// place of csrc/patch_extract.cu (same C interface, same outputs) and times
// both in one call.
//
// The count, the ranks and the look-back are the shipped kernel's.  The
// copy differs: a warp owns PS stage slots of 1 KiB in shared memory (the
// chunk's 128 coefficients, then its 128 descriptors) with an mbarrier
// each.  A live chunk's loads are cp.async.bulk global -> shared, one per
// x-row segment of min(bx, 128) floats (a lane each, at its stripe-map
// address) and one of the 512 descriptor bytes, completing on the slot's
// barrier; lane 0 waits on it and stores the slot with two cp.async.bulk
// shared -> global of 512 bytes.  Up to PS - 1 chunks' loads are in flight
// behind the one being stored, and no register holds the data.

#include "stripe_map.cuh"
#include "stripe_tok.cuh"

namespace cvx {

constexpr int PX_WARPS = 8;
constexpr int PX_TILE = 32 * PX_WARPS;
constexpr int PS = 4;  // stage slots a warp

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores: at most N groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(PX_WARPS * 32, 4)
patch_extract_kernel(const float* __restrict__ plane, const int32_t* __restrict__ desc,
                     const int32_t* __restrict__ chunk_bytes, int nchunks, int ntiles,
                     int nlive, StripeMap map, unsigned* __restrict__ ticket,
                     unsigned* __restrict__ status, float* __restrict__ rows,
                     int32_t* __restrict__ drows, int32_t* __restrict__ ids) {
  __shared__ __align__(128) float stage[PX_WARPS][PS][256];
  __shared__ uint64_t bars[PX_WARPS][PS];
  __shared__ int s_cnt[PX_WARPS];
  __shared__ int s_tile;
  __shared__ unsigned s_first;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lcpb = map.lbx + map.lby + map.lbz - 7;
  const int seg = map.lbx < 7 ? 1 << map.lbx : 128;  // floats a load
  const int nseg = 128 / seg;
  auto count_of = [&](int t) {
    const int c = (t * PX_WARPS + warp) * 32 + lane;
    return t < ntiles && c < nchunks ? chunk_bytes[c] : 0;
  };

  if (lane == 0)
    for (int s = 0; s < PS; ++s) mbar_init(smem_addr(&bars[warp][s]));
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  int t = s_tile;
  int cnt = count_of(t);
  int prev = -1, pbase = 0;
  unsigned pmask = 0, pcount = 0;
  int64_t porigin = 0;
  unsigned kk = 0;  // the chunks this warp has copied: slot kk % PS, phase kk / PS
#pragma unroll 1
  for (;;) {
    const bool cur = t < ntiles;
    if (!cur && prev < 0) break;
    const unsigned nt = threadIdx.x == 0 && cur ? atomicAdd(ticket, 1u) : 0u;
    const unsigned pre = warp == 0 && prev > 0 ? peek_window(status, prev, 0) : 0u;
    const unsigned mask = __ballot_sync(~0u, cnt != 0);
    if (lane == 0) s_cnt[warp] = __popc(mask);
    const int c = (t * PX_WARPS + warp) * 32 + lane;
    const int64_t origin = cnt != 0 ? map_origin<true>(map, c >> lcpb) : 0;
    __syncthreads();
    int base = 0;
    unsigned count = 0;
    if (cur) {
#pragma unroll
      for (int w = 0; w < PX_WARPS; ++w) {
        const int v = s_cnt[w];
        base += w < warp ? v : 0;
        count += v;
      }
      if (warp == 0) prefix_publish(status, t, count);
    }
    if (warp == 0 && prev >= 0) {
      const unsigned first = prefix_walk(status, prev, pcount, pre);
      if (lane == 0) s_first = first;
    }
    if (threadIdx.x == 0) s_tile = cur && nt < (unsigned)ntiles ? (int)nt : ntiles;
    __syncthreads();
    const int tn = s_tile;
    cnt = count_of(tn);
    if (prev >= 0 && pmask) {
      const int w0 = (prev * PX_WARPS + warp) * 32;
      const int r0 = (int)s_first + pbase;
      if ((pmask >> lane) & 1) {
        const int rl = r0 + __popc(pmask & ((1u << lane) - 1));
        if (rl < nlive) ids[rl] = w0 + lane;
      }
      const int nl = __popc(pmask);
      // the loads of the window's j-th live chunk into slot (kk + j) % PS
      unsigned m = pmask;
      auto issue = [&](int j) {
        const int src = __ffs((int)m) - 1;
        m &= m - 1;
        const int s = (kk + j) % PS;
        const unsigned bar = smem_addr(&bars[warp][s]);
        float* dst = stage[warp][s];
        const int ch = w0 + src;
        const int64_t o = __shfl_sync(~0u, porigin, src);
        if (lane == 0) mbar_expect(bar, 1024);
        __syncwarp();
        if (lane < nseg) {
          const int l = ((ch & ((1 << lcpb) - 1)) << 7) + lane * seg;
          bulk_copy(dst + lane * seg, plane + o + map_cell<true>(map, l), seg * 4u, bar);
        }
        if (lane == 31)
          bulk_copy(dst + 128, reinterpret_cast<const float*>(desc) + (int64_t)ch * 128, 512u,
                    bar);
      };
      if (lane == 0) bulk_wait_read<0>();  // the slots' earlier stores have read them
      __syncwarp();
      for (int j = 0; j < nl && j < PS; ++j) issue(j);
      for (int j = 0; j < nl; ++j) {
        const int s = (kk + j) % PS;
        if (lane == 0) {
          mbar_wait(smem_addr(&bars[warp][s]), ((kk + j) / PS) & 1);
          if (r0 + j < nlive) {
            bulk_store(rows + (int64_t)(r0 + j) * 128, stage[warp][s], 512u);
            bulk_store(drows + (int64_t)(r0 + j) * 128, stage[warp][s] + 128, 512u);
          }
          bulk_commit();
          if (j >= 1 && j - 1 + PS < nl) bulk_wait_read<1>();  // chunk j - 1's slot is free
        }
        __syncwarp();
        if (j >= 1 && j - 1 + PS < nl) issue(j - 1 + PS);
      }
      kk += nl;
    }
    prev = cur ? t : -1;
    pmask = mask;
    pbase = base;
    pcount = count;
    porigin = origin;
    t = tn;
  }
  if (lane == 0) bulk_wait_all();
}

}  // namespace cvx

extern "C" int cvx_patch_extract(const float* plane, const int32_t* desc,
                                 const int32_t* chunk_bytes, int64_t nchunks, int64_t nlive,
                                 int lbx, int lby, int lbz, int64_t nbx, int64_t nby,
                                 int64_t nxp, int64_t nyp, unsigned* scratch, float* rows,
                                 int32_t* drows, int32_t* ids, void* stream) {
  using namespace cvx;
  if (nchunks == 0 || nlive == 0) return 0;
  if (lbx + lby + lbz < 7 || lbx < 3 || nchunks > (int64_t)LB_VALUE || nlive > nchunks)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(plane) % 16 || reinterpret_cast<uintptr_t>(desc) % 16 ||
      reinterpret_cast<uintptr_t>(rows) % 16 || reinterpret_cast<uintptr_t>(drows) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (int)((nchunks + PX_TILE - 1) / PX_TILE);
  static int per_sm = 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_extract_kernel,
                                                      PX_WARPS * 32, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, (1 + ntiles) * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  patch_extract_kernel<<<(unsigned)(ntiles < most ? ntiles : most), PX_WARPS * 32, 0, st>>>(
      plane, desc, chunk_bytes, (int)nchunks, ntiles, (int)nlive,
      make_map(lbx, lby, lbz, nbx, nby, nxp, nyp), scratch, scratch + 1, rows, drows, ids);
  return (int)cudaGetLastError();
}
