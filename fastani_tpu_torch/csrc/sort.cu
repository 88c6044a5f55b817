// K3 and K4: per-row ascending sort of u32 keys, keys only (K3) or with a
// u32 payload permuted alongside (K4).  Both arrive and leave as int32
// words holding u32 bit patterns (8 bytes of device traffic a key for K3,
// 16 an element for K4); a row of any width up to the limit sorts as if
// padded with UMAX to a power of two, and only its n outputs are written.
//
// K3 replaces fastani_tpu/ops/pallas_sort.py::_sort_block_kernel (wrapped
// by sort_rows_u32); K4 replaces _sort_kv_block_kernel (sort_rows_u32_kv).
// Both are bound on this card by bytes (each word read and written once).
//
// The bitonic network (`bitonic` below; K4, and K3 on rows up to 2048)
// runs in registers, one block a row.  Each thread holds E elements, the
// row's E-aligned slice; strides below E compare-exchange inside the
// thread, strides E .. 16E between the lanes of one warp by
// __shfl_xor_sync with no barrier, and only strides of 32E and up exchange
// through shared memory between two __syncthreads.  Shared memory is
// addressed through an XOR swizzle of the low index bits with the thread
// index, so a warp's E-strided accesses hit distinct banks.  (A network
// in shared memory alone spends 91 barrier-separated stages and four
// shared-memory accesses per compare-exchange on a row of 8192.)
//
// K3: equal u32 keys are indistinguishable, so K3 needs no stability and
// takes its keys in any order.  Each thread loads E keys by coalesced
// (16-byte where aligned) loads, a block scan counts the non-pad keys, and
// they go to the front of shared memory; only those c keys are sorted
// (UMAX pads sort last), and the row goes out as the c sorted keys and n -
// c pads.  The main path's rows are mostly pads: ~240 keys in the sketch's
// 2048 slots, ~4300 in the L1 hit row's 8192.  Rows up to 2048 take the
// network over the next power of two above c (the sketch's: 256 keys in
// one warp, no shared-memory stage); wider rows an LSD radix sort with
// 8-bit digits (`sort_rows_radix_kernel`), which does 4 passes over c keys
// where the network does 91 stages over 8192.  On an H100 SXM the radix
// sort took 0.23 ms against the network's 0.355 on the L1 hit rows, and
// 0.042 against 0.018 on the sketch's (scripts/torch_kernel_versions.py).
//
// K4 sorts 64-bit composites (key << 32 | column), so it is a STABLE sort:
// every payload moves exactly once, ties included.  (The Pallas bitonic K4
// duplicated one payload and dropped the other on tied keys,
// pallas_sort.py:187-193; its callers mask those slots.)  The row's
// payload is staged in shared memory with one coalesced load, so the final
// permutation reads it there, and the sorted composites go out through
// shared memory, so every device access is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kPad = 0xFFFFFFFFu;

// shared-memory slot of element i of a row held E to a thread: the low
// bits XOR the thread index, so lane t's k-th element lands in a bank (an
// 8-byte slot pair for 64-bit words) of its own
template <typename W, int E>
__device__ __forceinline__ int swz(int i) {
  static_assert(E == 8 || E == 16 || E == 32, "E is 8, 16 or 32");
  constexpr int kShift = E == 8 ? 3 : E == 16 ? 4 : 5;
  constexpr int kMask = sizeof(W) == 8 ? 15 : 31;
  return i ^ ((i >> kShift) & kMask);
}

// one side of a compare-exchange: v keeps the smaller (keep_min) or the
// larger of itself and its partner w
template <typename W>
__device__ __forceinline__ void keep(W& v, W w, bool keep_min) {
  if ((w < v) == keep_min) v = w;
}

template <typename W>
__device__ __forceinline__ void cmp_swap(W& a, W& b, bool asc) {
  const W lo = a < b ? a : b;
  const W hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Ascending bitonic sort of the first N elements of the block's row, held
// E to a thread in v (thread t holds [tE, tE + E)); N is a power of two.
// sc is scratch of at least N words.  Every thread of the block calls it
// (the barriers).  With kPartial, N may be less than the block's row: the
// elements at or past N are pads that stay where they are, and warps
// wholly at or past N skip the work (without it, K4's loop compiled to
// 8 % slower code).
template <typename W, int E, bool kPartial>
__device__ __forceinline__ void bitonic(W (&v)[E], W* sc, int N) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int base = tid * E;
  const bool active = !kPartial || (tid & ~31) * E < N;
  for (int size = 2; size <= N; size <<= 1) {
    const bool asc_t = (base & size) == 0;     // for strides >= E
    // strides 32E and up: through shared memory
    for (int st = size >> 1; st >= 32 * E; st >>= 1) {
      __syncthreads();                        // the last readers are done
      if (active) {
#pragma unroll
        for (int k = 0; k < E; ++k) sc[swz<W, E>(base + k)] = v[k];
      }
      __syncthreads();
      const bool keep_min = ((base & st) == 0) == asc_t;
      if (active) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          keep(v[k], sc[swz<W, E>((base + k) ^ st)], keep_min);
        }
      }
    }
    if (!active) continue;
    // strides E .. 16E: between the lanes of a warp
    for (int st = min(size >> 1, 16 * E); st >= E; st >>= 1) {
      const int d = st / E;
      const bool keep_min = ((lane & d) == 0) == asc_t;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        keep(v[k], __shfl_xor_sync(kFull, v[k], d), keep_min);
      }
    }
    // strides below E: inside the thread
#pragma unroll
    for (int st = E / 2; st > 0; st >>= 1) {
      if (st < size) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          if ((k & st) == 0) {
            cmp_swap(v[k], v[k + st], ((base + k) & size) == 0);
          }
        }
      }
    }
  }
}

// K3's shared row: slot of position i, swizzled for the network's
// E-strided accesses, plain for the radix sort's
template <int E, bool kSwz>
__device__ __forceinline__ int slot(int i) {
  return kSwz ? swz<uint32_t, E>(i) : i;
}

// K3's prologue: the block's row, E keys a thread by coalesced (16-byte
// where aligned) loads; the non-pad keys go to slots 0 .. c of sc, in any
// order.  Returns c, the same in every thread.
template <int E, bool kSwz>
__device__ __forceinline__ int gather_keys(const uint32_t* __restrict__ keys,
                                           int n, bool vec, uint32_t* sc,
                                           int* warp_tot) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  uint32_t x[E];
  if (vec) {
    const uint4* k4 = reinterpret_cast<const uint4*>(keys);
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const int q = tid + j * nt;
      const uint4 w = 4 * q < n ? k4[q] : make_uint4(kPad, kPad, kPad, kPad);
      x[4 * j] = w.x;
      x[4 * j + 1] = w.y;
      x[4 * j + 2] = w.z;
      x[4 * j + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = tid + k * nt;
      x[k] = i < n ? keys[i] : kPad;
    }
  }
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < E; ++k) cnt += x[k] != kPad;
  // block scan of the counts: each thread's offset, the row's count c
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  int off = incl - cnt;
  int c = 0;
  for (int w = 0; w < (nt >> 5); ++w) {
    const int t = warp_tot[w];
    if (w < wid) off += t;
    c += t;
  }
#pragma unroll
  for (int k = 0; k < E; ++k) {
    if (x[k] != kPad) sc[slot<E, kSwz>(off++)] = x[k];
  }
  __syncthreads();
  return c;
}

// K3's epilogue: the c sorted keys of sc, then n - c pads, coalesced
template <int E, bool kSwz>
__device__ __forceinline__ void write_row(uint32_t* __restrict__ out, int n,
                                          bool vec, const uint32_t* sc,
                                          int c) {
  auto at = [&](int i) { return i < c ? sc[slot<E, kSwz>(i)] : kPad; };
  if (vec) {
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int q = threadIdx.x; 4 * q < n; q += blockDim.x) {
      o4[q] = make_uint4(at(4 * q), at(4 * q + 1), at(4 * q + 2),
                         at(4 * q + 3));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = at(i);
  }
}

// K3 for rows up to 2048: the network over the next power of two above
// the row's non-pad count
template <int E>
__global__ void __launch_bounds__(1024)
    sort_rows_net_kernel(const uint32_t* __restrict__ keys, int n, bool vec,
                         uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sc = reinterpret_cast<uint32_t*>(smem);       // blockDim * E
  __shared__ int warp_tot[32];
  const size_t row = (size_t)blockIdx.x * n;
  const int c = gather_keys<E, true>(keys + row, n, vec, sc, warp_tot);
  int cp = 2;
  while (cp < c) cp <<= 1;
  const int base = threadIdx.x * E;
  uint32_t v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    v[k] = base + k < c ? sc[swz<uint32_t, E>(base + k)] : kPad;
  }
  bitonic<uint32_t, E, true>(v, sc, cp);
  __syncthreads();
  if (base < cp) {
#pragma unroll
    for (int k = 0; k < E; ++k) sc[swz<uint32_t, E>(base + k)] = v[k];
  }
  __syncthreads();
  write_row<E, true>(out + row, n, vec, sc, c);
}

// K3 for rows above 2048: an LSD radix sort of the non-pad keys, 8-bit
// digits, skipping the passes whose digit is the same in every key.  Warp
// w owns positions [w S, (w + 1) S) of the row, in registers (lane l holds
// w S + 32 j + l).  A pass ranks each warp's keys within its own (digit,
// warp) bucket in position order (__match_any_sync over the chunk of 32),
// scans the digit-major (digit, warp) counts for every bucket's offset,
// and writes each key to its bucket's offset plus its rank, so the pass is
// stable.  The pads that fill the last warp's segment past c keep digit
// 0xFF and stay at the end of the last bucket, past c.  (Double-buffered
// counts, cleared for the next pass during the scan, took 0.276 ms on the
// L1 hit rows against 0.229 for this.)
template <int E>
__global__ void __launch_bounds__(1024)
    sort_rows_radix_kernel(const uint32_t* __restrict__ keys, int n,
                           bool vec, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  uint32_t* sc = reinterpret_cast<uint32_t*>(smem);       // nt * E keys
  int* hist = reinterpret_cast<int*>(sc + nt * E);        // 256 * nw
  __shared__ int warp_tot[32];
  __shared__ uint32_t warp_or[32];
  const size_t row = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int c = gather_keys<E, false>(keys + row, n, vec, sc, warp_tot);

  // this warp's segment; the bits in which the keys differ
  const int S = (c + 32 * nw - 1) / (32 * nw) * 32;
  const int J = S / 32;
  const uint32_t k0 = c ? sc[0] : 0u;
  uint32_t r[E];
  uint32_t diff = 0u;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int pos = wid * S + 32 * j + lane;
    r[j] = j < J && pos < c ? sc[pos] : kPad;
    if (j < J && pos < c) diff |= r[j] ^ k0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) diff |= __shfl_xor_sync(kFull, diff, d);
  if (lane == 0) warp_or[wid] = diff;
  __syncthreads();
  diff = 0u;
  for (int w = 0; w < nw; ++w) diff |= warp_or[w];

  for (int sh = 0; sh < 32; sh += 8) {
    if (((diff >> sh) & 0xFFu) == 0u) continue;          // block-uniform
    for (int i = tid; i < 256 * nw; i += nt) hist[i] = 0;
    __syncthreads();
    // rank in the warp's (digit, warp) bucket, chunk by chunk in order
    int loc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < J) {
        const int d = (r[j] >> sh) & 0xFF;
        const unsigned peers = __match_any_sync(kFull, d);
        const int lt = __popc(peers & lt_mask);
        const int old = hist[d * nw + wid];
        loc[j] = old + lt;
        __syncwarp();
        if (lt == 0) hist[d * nw + wid] = old + __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    // exclusive scan of the 256 * nw counts, 8 a thread
    int h[8];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      h[i] = hist[8 * tid + i];
      sum += h[i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_tot[wid] = incl;
    __syncthreads();
    int pre = incl - sum;
    for (int w = 0; w < wid; ++w) pre += warp_tot[w];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hist[8 * tid + i] = pre;
      pre += h[i];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < J) sc[hist[((r[j] >> sh) & 0xFF) * nw + wid] + loc[j]] = r[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < J) r[j] = sc[wid * S + 32 * j + lane];
    }
  }
  // sc[0, c) holds the sorted keys (with no pass: c equal keys)
  write_row<E, false>(out + row, n, vec, sc, c);
}

template <int E>
__global__ void __launch_bounds__(1024)
    sort_rows_kv_kernel(const uint32_t* __restrict__ keys,
                        const uint32_t* __restrict__ pay, int n, int N,
                        uint32_t* __restrict__ keys_out,
                        uint32_t* __restrict__ pay_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* sc = reinterpret_cast<uint64_t*>(smem);       // N composites
  uint32_t* sp = reinterpret_cast<uint32_t*>(sc + N);     // n payload words
  const size_t row = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;                              // N / E
  const int base = tid * E;
  for (int i = tid; i < N; i += nt) {
    const uint64_t key = i < n ? keys[row + i] : kPad;
    sc[swz<uint64_t, E>(i)] = (key << 32) | (uint32_t)i;
  }
  for (int i = tid; i < n; i += nt) sp[i] = pay[row + i];
  __syncthreads();
  uint64_t v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = sc[swz<uint64_t, E>(base + k)];
  bitonic<uint64_t, E, false>(v, sc, N);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) sc[swz<uint64_t, E>(base + k)] = v[k];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const uint64_t c = sc[swz<uint64_t, E>(i)];
    keys_out[row + i] = (uint32_t)(c >> 32);
    pay_out[row + i] = sp[(uint32_t)c];
  }
}

int pow2_at_least(int n) {
  int N = 2;
  while (N < n) N <<= 1;
  return N;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename Kernel>
int launch_keys(Kernel kernel, size_t smem, int threads, const void* keys,
                void* out, int R, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 4 == 0 && aligned16(keys) && aligned16(out);
  kernel<<<R, threads, smem, stream>>>(static_cast<const uint32_t*>(keys), n,
                                       vec, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

template <int E>
int launch_kv(const void* keys, const void* pay, void* keys_out, void* pay_out,
              int R, int n, int N, cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * (size_t)N + sizeof(uint32_t) * n;
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kv_kernel<E><<<R, N / E, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(pay),
      n, N, static_cast<uint32_t*>(keys_out), static_cast<uint32_t*>(pay_out));
  return (int)cudaGetLastError();
}

}  // namespace

// keys (R, n) int32 holding u32 bit patterns; out (R, n) int32.
// n <= 32768.  Rows up to 2048 take the network (8 keys a thread), wider
// rows the radix sort (16 keys a thread, 32 above 16384).
extern "C" int fa_sort_rows_u32(const void* keys, void* out, int R, int n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int N = pow2_at_least(n);
  if (N > 32768) return (int)cudaErrorInvalidValue;
  if (N <= 2048) {
    N = N < 256 ? 256 : N;       // at least one warp of 8 keys each
    return launch_keys(sort_rows_net_kernel<8>, sizeof(uint32_t) * N, N / 8,
                       keys, out, R, n, s);
  }
  // N keys and a (digit, warp) count table of 256 * N / E / 32 ints
  if (N <= 16384)
    return launch_keys(sort_rows_radix_kernel<16>, 4 * N + 1024 * (N / 512),
                       N / 16, keys, out, R, n, s);
  return launch_keys(sort_rows_radix_kernel<32>, 4 * N + 1024 * (N / 1024),
                     N / 32, keys, out, R, n, s);
}

// keys, payload (R, n) int32 holding u32 bit patterns; keys_out, pay_out
// (R, n) int32.  n <= 16384.
extern "C" int fa_sort_rows_u32_kv(const void* keys, const void* pay,
                                   void* keys_out, void* pay_out, int R, int n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = pow2_at_least(n);
  if (N > 16384) return (int)cudaErrorInvalidValue;
  if (N <= 8192)        // at least one warp of 8 composites each
    return launch_kv<8>(keys, pay, keys_out, pay_out, R, n, N < 256 ? 256 : N,
                        s);
  return launch_kv<16>(keys, pay, keys_out, pay_out, R, n, N, s);
}
