// K2: stable per-row stream compaction.
//
// Replaces fastani_tpu/ops/pallas_compact.py::_compact_block_kernel
// (wrapped by compact_rows).  Per row: the elements of 1-4 payloads (4- or
// 8-byte words) at flagged positions move to the front in their original
// order; slots past the row's flagged count take a per-payload fill.  Only
// the first `width` output columns are written (callers keep a capped
// prefix).
//
// Bound on this card: bytes.  The least traffic is the flag bytes, one
// word per payload at each flagged position below the width, and the
// (R, width) outputs; flags are sparse on the main path (0.4-25 %), so the
// flag bytes dominate.  Design: the butterfly network of the Pallas kernel
// existed to avoid scatters on the TPU; here it is a prefix count plus a
// scatter.  A thread takes 16 flags with one 16-byte load (byte loads
// where a row is not 16-byte aligned) and ranks them in the thread by the
// popcount of a 16-bit mask, the warp ranks its threads by __shfl_up_sync
// and the block its warps after one barrier, so a tile of 16 flags a
// thread costs one barrier.  Payload words are read only at flagged
// positions.  Rows are cut into chunks of whole tiles: with many rows a
// block walks one row's tiles in order; with few long rows (the valid-unit
// compaction is one row of 262144) a first launch counts each chunk's
// flags and the second scans the counts of the chunks before its own, so
// a row spreads over up to `chunks` blocks and the order stays stable.
// The slots past the count are split over the row's chunks and written
// with 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 8;               // blocks of at most 256 threads

struct Payloads {
  const void* in[4];
  void* out[4];
  int esize[4];          // 4 or 8 bytes
  long long fill[4];
};

struct Geometry {
  const uint8_t* flags;
  int n;                 // row length
  int chunks;            // chunks per row
  int chunk_len;         // flags per chunk, a multiple of 16 * blockDim.x
  bool vec;              // rows 16-byte aligned: 16-byte flag loads
};

// bit b set for flag p0 + b != 0 of the row at `f`, p0 + b < end
__device__ __forceinline__ unsigned flag_mask(const Geometry& g,
                                             const uint8_t* f, int p0,
                                             int end) {
  if (p0 >= end) return 0u;
  unsigned m = 0u;
  if (g.vec) {
    const uint4 w = *reinterpret_cast<const uint4*>(f + p0);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      m |= (((ws[j >> 2] >> (8 * (j & 3))) & 0xFFu) != 0u) << j;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      m |= (p0 + j < end && f[p0 + j] != 0) << j;
    }
  }
  return m;
}

__device__ __forceinline__ void copy_elem(const Payloads& p, int q,
                                          size_t src, size_t dst) {
  if (p.esize[q] == 8) {
    static_cast<long long*>(p.out[q])[dst] =
        static_cast<const long long*>(p.in[q])[src];
  } else {
    static_cast<int*>(p.out[q])[dst] = static_cast<const int*>(p.in[q])[src];
  }
}

// out[lo, hi) = v, 16-byte stores between a scalar head and tail
template <typename T>
__device__ void fill_range(T* out, int lo, int hi, T v) {
  constexpr int kV = 16 / sizeof(T);
  if (lo >= hi) return;
  const int head = min(hi - lo, (int)(((16 - (reinterpret_cast<uintptr_t>(
                                                out + lo) & 15)) & 15) /
                                      sizeof(T)));
  const int a = lo + head;
  const int nv = (hi - a) / kV;
  for (int i = threadIdx.x; i < head; i += blockDim.x) out[lo + i] = v;
  int4 w;
  if constexpr (sizeof(T) == 8) {
    const int v_lo = (int)(v & 0xFFFFFFFFll);
    const int v_hi = (int)(v >> 32);
    w = make_int4(v_lo, v_hi, v_lo, v_hi);
  } else {
    w = make_int4(v, v, v, v);
  }
  int4* o4 = reinterpret_cast<int4*>(out + a);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) o4[i] = w;
  for (int i = a + nv * kV + threadIdx.x; i < hi; i += blockDim.x) out[i] = v;
}

// flags in each chunk: one block per chunk, the counts to cnt
__global__ void count_chunks_kernel(Geometry g, int* __restrict__ cnt) {
  __shared__ int warp_tot[kMaxWarps];
  const int r = blockIdx.x / g.chunks;
  const int c = blockIdx.x % g.chunks;
  const uint8_t* f = g.flags + (size_t)r * g.n;
  const int c0 = c * g.chunk_len;
  const int end = min(g.n, c0 + g.chunk_len);
  int k = 0;
  for (int p0 = c0 + 16 * threadIdx.x; p0 < end; p0 += 16 * blockDim.x) {
    k += __popc(flag_mask(g, f, p0, end));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) k += __shfl_xor_sync(kFull, k, d);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_tot[w];
    cnt[blockIdx.x] = s;
  }
}

// one block per chunk: scan and scatter its tiles, then its share of the
// row's fill.  The payload count is a template argument, so the payload
// loops unroll and Payloads stays in the parameter bank (a runtime index
// would copy it to local memory in every thread).
template <int NPAY>
__global__ void compact_chunks_kernel(Geometry g, const int* __restrict__ cnt,
                                      int width, Payloads p) {
  __shared__ int warp_tot[2][kMaxWarps];
  __shared__ int sums[2][kMaxWarps];
  const int r = blockIdx.x / g.chunks;
  const int c = blockIdx.x % g.chunks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const uint8_t* f = g.flags + (size_t)r * g.n;
  const size_t in_row = (size_t)r * g.n;
  const size_t out_row = (size_t)r * width;

  // flags in the chunks before this one, and in the whole row
  int before = 0;
  int total = 0;
  if (g.chunks > 1) {
    int sb = 0, sa = 0;
    for (int j = tid; j < g.chunks; j += blockDim.x) {
      const int v = cnt[(size_t)r * g.chunks + j];
      sa += v;
      if (j < c) sb += v;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sb += __shfl_xor_sync(kFull, sb, d);
      sa += __shfl_xor_sync(kFull, sa, d);
    }
    if (lane == 0) {
      sums[0][wid] = sb;
      sums[1][wid] = sa;
    }
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      before += sums[0][w];
      total += sums[1][w];
    }
  }

  const int c0 = c * g.chunk_len;
  const int end = min(g.n, c0 + g.chunk_len);
  int running = before;
  int par = 0;
  for (int t0 = c0; t0 < end && running < width; t0 += 16 * blockDim.x) {
    const int p0 = t0 + 16 * tid;
    unsigned m = flag_mask(g, f, p0, end);
    const int k = __popc(m);
    int incl = k;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_tot[par][wid] = incl;
    __syncthreads();           // one barrier a tile: warp_tot alternates
    int dst = running + incl - k;
    int tile = 0;
    for (int w = 0; w < nw; ++w) {
      const int v = warp_tot[par][w];
      if (w < wid) dst += v;
      tile += v;
    }
    while (m && dst < width) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
#pragma unroll
      for (int q = 0; q < NPAY; ++q) copy_elem(p, q, in_row + p0 + b,
                                               out_row + dst);
      ++dst;
    }
    running += tile;
    par ^= 1;
  }
  if (g.chunks == 1) {
    total = running;         // (a chunk stopped at the width: total >= width)
  }

  // the fill past the row's count, split over its chunks
  const int lo_all = min(total, width);
  const int per = (width - lo_all + g.chunks - 1) / g.chunks;
  const int lo = lo_all + c * per;
  const int hi = min(width, lo + per);
#pragma unroll
  for (int q = 0; q < NPAY; ++q) {
    if (p.esize[q] == 8) {
      fill_range(static_cast<long long*>(p.out[q]) + out_row, lo, hi,
                 p.fill[q]);
    } else {
      fill_range(static_cast<int*>(p.out[q]) + out_row, lo, hi,
                 (int)p.fill[q]);
    }
  }
}

}  // namespace

// flags (R, n) uint8; payload q: input (R, n) and output (R, width) of
// element size esize[q] (4 or 8); fill[q] the value past the count.
// Blocks of `threads` (a multiple of 32, at most 256) take tiles of 16 *
// threads flags; each row is cut into `chunks` chunks of whole tiles, one
// block each.  counts: R * chunks ints of scratch when chunks > 1.
extern "C" int fa_compact_rows(const void* flags, int R, int n, int width,
                               int threads, int chunks, int npay,
                               const void* const* in, void* const* out,
                               const int* esize, const long long* fill,
                               void* counts, void* stream) {
  if (threads % 32 || threads < 32 || threads > 32 * kMaxWarps || chunks < 1 ||
      npay < 1 || npay > 4 || (chunks > 1 && counts == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Payloads p;
  for (int q = 0; q < 4; ++q) {
    p.in[q] = q < npay ? in[q] : nullptr;
    p.out[q] = q < npay ? out[q] : nullptr;
    p.esize[q] = q < npay ? esize[q] : 4;
    p.fill[q] = q < npay ? fill[q] : 0;
  }
  const int tile = 16 * threads;
  const int tiles = (n + tile - 1) / tile;
  Geometry g;
  g.flags = static_cast<const uint8_t*>(flags);
  g.n = n;
  g.chunks = chunks;
  g.chunk_len = ((tiles + chunks - 1) / chunks) * tile;
  g.vec = n % 16 == 0 && (reinterpret_cast<uintptr_t>(flags) & 15) == 0;
  const int blocks = R * chunks;
  if (chunks > 1) {
    count_chunks_kernel<<<blocks, threads, 0, s>>>(g, static_cast<int*>(counts));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int* cnt = static_cast<const int*>(counts);
  void (*kernel)(Geometry, const int*, int, Payloads) =
      npay == 1   ? compact_chunks_kernel<1>
      : npay == 2 ? compact_chunks_kernel<2>
      : npay == 3 ? compact_chunks_kernel<3>
                  : compact_chunks_kernel<4>;
  kernel<<<blocks, threads, 0, s>>>(g, cnt, width, p);
  return (int)cudaGetLastError();
}
