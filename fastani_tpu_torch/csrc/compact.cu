// K2: stable per-row stream compaction.
//
// Replaces fastani_tpu/ops/pallas_compact.py::_compact_block_kernel
// (wrapped by compact_rows).  Per row: the elements of 1-4 payloads at
// flagged positions move to the front in their original order; slots past
// the row's flagged count take a per-payload fill.  Only the first `width`
// output columns are written (callers keep a capped prefix).
//
// Bound on this card: bytes (a flag byte plus each payload read once, the
// capped prefix written once; a few integer ops per element).  Design: the
// butterfly network of the Pallas kernel existed to avoid scatters on the
// TPU; here it is a prefix count plus a scatter.  One block per row walks
// the row in block-wide tiles: a warp ballot and popcount rank the flags
// inside each warp, one warp scans the per-warp totals, and the flagged
// elements are stored at their rank.  Reads are coalesced; the stores of a
// tile land in one contiguous run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Payloads {
  const void* in[4];
  void* out[4];
  int esize[4];          // 4 or 8 bytes
  long long fill[4];
};

__device__ __forceinline__ void copy_elem(const Payloads& p, int q,
                                          size_t src, size_t dst) {
  if (p.esize[q] == 8) {
    static_cast<long long*>(p.out[q])[dst] =
        static_cast<const long long*>(p.in[q])[src];
  } else {
    static_cast<int*>(p.out[q])[dst] = static_cast<const int*>(p.in[q])[src];
  }
}

__device__ __forceinline__ void fill_elem(const Payloads& p, int q,
                                          size_t dst) {
  if (p.esize[q] == 8) {
    static_cast<long long*>(p.out[q])[dst] = p.fill[q];
  } else {
    static_cast<int*>(p.out[q])[dst] = (int)p.fill[q];
  }
}

__global__ void compact_rows_kernel(const uint8_t* __restrict__ flags, int n,
                                    int width, int npay, Payloads p) {
  __shared__ int warp_off[32];
  __shared__ int tile_total;
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t in_row = (size_t)r * n;
  const size_t out_row = (size_t)r * width;
  int running = 0;
  for (int t0 = 0; t0 < n; t0 += blockDim.x) {
    const int i = t0 + tid;
    const bool f = i < n && flags[in_row + i] != 0;
    const unsigned m = __ballot_sync(kFull, f);
    const int pre = __popc(m & ((1u << lane) - 1u));
    if (lane == 0) warp_off[wid] = __popc(m);
    __syncthreads();
    if (wid == 0) {
      const int c = lane < nwarps ? warp_off[lane] : 0;
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      if (lane < nwarps) warp_off[lane] = incl - c;
      if (lane == 31) tile_total = incl;
    }
    __syncthreads();
    if (f) {
      const int dst = running + warp_off[wid] + pre;
      if (dst < width) {
        for (int q = 0; q < npay; ++q) copy_elem(p, q, in_row + i, out_row + dst);
      }
    }
    running += tile_total;
    __syncthreads();
  }
  for (int j = running + tid; j < width; j += blockDim.x) {
    for (int q = 0; q < npay; ++q) fill_elem(p, q, out_row + j);
  }
}

}  // namespace

// flags (R, n) uint8; payload q: input (R, n) and output (R, width) of
// element size esize[q] (4 or 8); fill[q] the value past the count.
extern "C" int fa_compact_rows(const void* flags, int R, int n, int width,
                               int npay, const void* const* in,
                               void* const* out, const int* esize,
                               const long long* fill, void* stream) {
  Payloads p;
  for (int q = 0; q < 4; ++q) {
    p.in[q] = q < npay ? in[q] : nullptr;
    p.out[q] = q < npay ? out[q] : nullptr;
    p.esize[q] = q < npay ? esize[q] : 4;
    p.fill[q] = q < npay ? fill[q] : 0;
  }
  compact_rows_kernel<<<R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), n, width, npay, p);
  return (int)cudaGetLastError();
}
