// plan_layout: the device entropy decoder's plan blob, laid out on the card.
//
// Replaces no TPU kernel: the JAX package, and this port until it, built
// the blob on the host (ops/entropy_decode.py `plan`: a zeroed blob, the
// ragged copy of every block's payload to its W-aligned subsegments, the
// per-subsegment tables) and uploaded it whole.  Now the host sends the
// container's payload as it is and a small head (`plan_head`: a copy table
// of O(blocks) rows, its chunk prefix and the O(blocks) fields), and this
// kernel writes every byte of the blob exactly as `plan` lays it out:
//   - each RLE block's payload at its W-aligned base, its tail to W zeroed,
//     and sub_block (the block) and sub_reset (its first subsegment) for its
//     subsegments;
//   - the padding subsegments (zero bytes, sub_block nnn, each a reset) and
//     the PAD zero bytes after the stream;
//   - each raw block's 4 * cells bytes into its raw_rows row;
//   - the small fields (starts, scalefac, raw_ids) from the head, and the
//     alignment gaps between fields, zeroed.
// Each head row is (src, dst, n, fill, blk): copy n bytes of the upload
// from src to blob + dst, zero the rest up to fill bytes; blk >= 0 marks a
// stream row whose fill / W subsegments belong to block blk.
//
// What bounds it on an H100: bytes.  It reads the payload once (S bytes)
// and writes ~S + 5 bytes a subsegment: ~78 MB at a 36 MB container,
// 0.023 ms at 3.35 TB/s.  The design: one thread a 16-byte chunk of the
// output, numbered over the rows in turn (the head's chunk prefix), so a
// 128 KiB raw row spreads over 8,192 threads as a 32-byte row over two;
// the thread finds its row by a binary search of the prefix (cached: the
// threads of a CTA search the same few rows), reads its source bytes,
// which start at any byte, as up to five aligned words joined by funnel
// shifts, and writes one 16-byte store (four word stores where the row's
// destination is only word aligned, as a raw row of a block with cells not
// a multiple of 4).  No shared memory, no atomics: every byte has one
// writer.

#include <cstdint>
#include <cuda_runtime.h>

namespace cvx {

constexpr int PL_THREADS = 256;
constexpr int PL_SUB = 32;    // subsegment bytes (entropy_decode.W)
constexpr int PL_CHUNK = 16;  // output bytes a thread (entropy_decode.CHUNK)

struct PlanRow {  // entropy_decode._ROW, 32 bytes
  int64_t src, dst;
  int32_t n, fill, blk, pad;
};

// The low `rem` bytes of a word (all of it from 4 on, none at 0 or below).
__device__ __forceinline__ uint32_t low_bytes(int64_t rem) {
  return rem >= 4 ? 0xffffffffu : rem <= 0 ? 0u : (1u << (8 * (int)rem)) - 1u;
}

__global__ void __launch_bounds__(PL_THREADS)
plan_layout_kernel(const uint8_t* __restrict__ up, int64_t nrow, int64_t nchunk,
                   uint8_t* __restrict__ blob, int64_t o_sb, int64_t o_sr) {
  const PlanRow* rows = reinterpret_cast<const PlanRow*>(up);
  const int64_t* cum = reinterpret_cast<const int64_t*>(up + sizeof(PlanRow) * nrow);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(up);
  const int64_t stride = (int64_t)gridDim.x * PL_THREADS;
  for (int64_t g = (int64_t)blockIdx.x * PL_THREADS + threadIdx.x; g < nchunk; g += stride) {
    int64_t lo = 0, hi = nrow;  // cum[lo] <= g < cum[hi]
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) <= g) lo = mid;
      else hi = mid;
    }
    const PlanRow r = rows[lo];
    const int64_t c = g - __ldg(cum + lo);  // the chunk within its row
    const int64_t off = (int64_t)PL_CHUNK * c;
    const int64_t rem = (int64_t)r.n - off;  // source bytes left at the chunk

    uint32_t out[4] = {0u, 0u, 0u, 0u};
    if (rem > 0) {
      const int64_t s = r.src + off;
      const int lead = (int)(s & 3);
      const int64_t need = lead + (rem < PL_CHUNK ? rem : PL_CHUNK);  // bytes from the word
      const uint32_t* w = words + (s >> 2);
      uint32_t v[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) v[k] = 4 * k < need ? __ldg(w + k) : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out[k] = __funnelshift_r(v[k], v[k + 1], 8 * lead) & low_bytes(rem - 4 * k);
    }
    uint8_t* d = blob + r.dst + off;
    const int64_t left = (int64_t)r.fill - off;  // the row's bytes from here, > 0
    if (left >= PL_CHUNK && ((uintptr_t)d & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {  // destinations and fills are multiples of 4 bytes
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * k < left) reinterpret_cast<uint32_t*>(d)[k] = out[k];
    }
    if (r.blk >= 0 && (c & 1) == 0) {  // a stream row: its subsegment's entries
      const int64_t q = r.dst / PL_SUB + c / 2;
      reinterpret_cast<int32_t*>(blob + o_sb)[q] = r.blk;
      blob[o_sr + q] = c == 0;
    }
  }
}

}  // namespace cvx

extern "C" int cvx_plan_layout(const uint8_t* up, int64_t nrow, int64_t nchunk, uint8_t* blob,
                               int64_t o_sb, int64_t o_sr, void* stream_) {
  using namespace cvx;
  if (nchunk == 0) return 0;
  const int64_t grid = (nchunk + PL_THREADS - 1) / PL_THREADS;
  plan_layout_kernel<<<(unsigned)(grid < (1 << 30) ? grid : (1 << 30)), PL_THREADS, 0,
                       (cudaStream_t)stream_>>>(up, nrow, nchunk, blob, o_sb, o_sr);
  return (int)cudaGetLastError();
}
