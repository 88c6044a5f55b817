// K3 and K4: per-row ascending sort of u32 keys, keys only (K3) or with a
// u32 payload permuted alongside (K4).
//
// K3 replaces fastani_tpu/ops/pallas_sort.py::_sort_block_kernel (wrapped
// by sort_rows_u32); K4 replaces _sort_kv_block_kernel (sort_rows_u32_kv).
// A row of n keys is padded with UMAX to a power of two; only the first n
// outputs are written.
//
// K3: keys arrive as int64 holding u32 values (the port's u32 carrier).
// Bound on this card: bytes by the roofline count (16 bytes of device
// traffic per key against log2(n) (log2(n) + 1) / 4 compare-exchanges per
// key, ~46 at n = 8192); what limits this design is the log2(n) (log2(n) +
// 1) / 2 barrier-separated network stages over shared memory.  Design: one
// block per row, the whole row in shared memory (a 32768-key row is 128 KB
// of the 227 KB a block may use), one __syncthreads per network stage;
// device memory is read and written once.
//
// K4: keys and payload arrive as int32 words holding u32 bit patterns (16
// bytes of device traffic per element).  It sorts 64-bit composites
// (key << 32 | column), so it is a STABLE sort: every payload moves exactly
// once, ties included.  (The Pallas bitonic K4 duplicated one payload and
// dropped the other on tied keys, pallas_sort.py:187-193; its callers mask
// those slots.)  Bound on this card: bytes by the roofline count, against
// the network's compare-exchanges; what limits a shared-memory network is
// its 66 barrier-separated stages at n = 2048.  Design: the network runs in
// registers.  Each thread holds E = 8 composites (E = 16 for rows above
// 8192), the row's E-aligned slice; strides below E compare-exchange
// inside the thread, strides E .. 16E between the lanes of one warp by
// __shfl_xor_sync with no barrier, and only strides of 32E and up (6 of the
// 66 stages at n = 2048) exchange through shared memory between two
// __syncthreads.  The row's payload is staged in shared memory with one
// coalesced load, so the final permutation reads it there; the sorted
// composites go out through shared memory too, so every device access is
// coalesced.  Shared memory is addressed through an XOR swizzle of the low
// four index bits, which spreads a warp's E-strided accesses over the banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename T>
__device__ __forceinline__ void bitonic_sort(T* s, int N) {
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (N >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const T a = s[lo];
        const T b = s[hi];
        if ((a > b) == asc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void sort_rows_kernel(const long long* __restrict__ keys, int n,
                                 int N, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const size_t row = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    s[i] = i < n ? (uint32_t)keys[row + i] : 0xFFFFFFFFu;
  }
  __syncthreads();
  bitonic_sort(s, N);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    out[row + i] = (long long)s[i];
  }
}

// shared-memory slot of composite i: the low four bits XOR bits 3..6
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

// one side of a compare-exchange: v keeps the smaller (keep_min) or the
// larger of itself and its partner w
__device__ __forceinline__ void keep(uint64_t& v, uint64_t w, bool keep_min) {
  if ((w < v) == keep_min) v = w;
}

__device__ __forceinline__ void cmp_swap(uint64_t& a, uint64_t& b, bool asc) {
  const uint64_t lo = a < b ? a : b;
  const uint64_t hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
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
  const int lane = tid & 31;
  const int base = tid * E;
  for (int i = tid; i < N; i += nt) {
    const uint64_t key = i < n ? keys[row + i] : 0xFFFFFFFFu;
    sc[swz(i)] = (key << 32) | (uint32_t)i;
  }
  for (int i = tid; i < n; i += nt) sp[i] = pay[row + i];
  __syncthreads();
  uint64_t v[E];
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = sc[swz(base + k)];

  for (int size = 2; size <= N; size <<= 1) {
    const bool asc_t = (base & size) == 0;     // for strides >= E
    // strides 32E and up: through shared memory
    for (int st = size >> 1; st >= 32 * E; st >>= 1) {
      __syncthreads();                        // the last readers are done
#pragma unroll
      for (int k = 0; k < E; ++k) sc[swz(base + k)] = v[k];
      __syncthreads();
      const bool keep_min = ((base & st) == 0) == asc_t;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        keep(v[k], sc[swz((base + k) ^ st)], keep_min);
      }
    }
    // strides E .. 16E: between the lanes of a warp
    for (int st = min(size >> 1, 16 * E); st >= E; st >>= 1) {
      const int d = st / E;
      const bool keep_min = ((lane & d) == 0) == asc_t;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        keep(v[k], __shfl_xor_sync(0xFFFFFFFFu, v[k], d), keep_min);
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

  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) sc[swz(base + k)] = v[k];
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const uint64_t c = sc[swz(i)];
    keys_out[row + i] = (uint32_t)(c >> 32);
    pay_out[row + i] = sp[(uint32_t)c];
  }
}

int pow2_at_least(int n) {
  int N = 2;
  while (N < n) N <<= 1;
  return N;
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

// keys (R, n) int64 holding u32; out (R, n) int64.
extern "C" int fa_sort_rows_u32(const void* keys, void* out, int R, int n,
                                void* stream) {
  const int N = pow2_at_least(n);
  const size_t smem = sizeof(uint32_t) * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, N, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

// keys, payload (R, n) int32 holding u32 bit patterns; keys_out, pay_out
// (R, n) int32.  n <= 16384.
extern "C" int fa_sort_rows_u32_kv(const void* keys, const void* pay,
                                   void* keys_out, void* pay_out, int R, int n,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = pow2_at_least(n);
  if (N <= 8192)        // at least one warp of 8 composites each
    return launch_kv<8>(keys, pay, keys_out, pay_out, R, n, N < 256 ? 256 : N,
                        s);
  return launch_kv<16>(keys, pay, keys_out, pay_out, R, n, N, s);
}
