// K3 and K4: per-row ascending sort of u32 keys, keys only (K3) or with a
// u32 payload permuted alongside (K4).
//
// K3 replaces fastani_tpu/ops/pallas_sort.py::_sort_block_kernel (wrapped
// by sort_rows_u32); K4 replaces _sort_kv_block_kernel (sort_rows_u32_kv).
// Keys arrive as int64 holding u32 values (the port's u32 carrier) and are
// sorted as u32.  A row of n keys is padded in shared memory with UMAX to
// the next power of two; only the first n outputs are written.
//
// Bound on this card: bytes by the roofline count (16 bytes of device
// traffic per key against log2(n) (log2(n) + 1) / 4 compare-exchanges per
// key, ~46 at n = 8192); what limits this design is the log2(n) (log2(n) +
// 1) / 2 barrier-separated network stages over shared memory.  Design: one
// block per row, the whole row in shared memory (a 32768-key row is 128 KB
// of the 227 KB a block may use), one __syncthreads per network stage;
// device memory is read and written once.  K4 sorts 64-bit composites (key << 32 | column), so it is a
// STABLE sort: every payload moves exactly once, ties included.  (The
// Pallas bitonic K4 duplicated one payload and dropped the other on tied
// keys, pallas_sort.py:187-193; its callers mask those slots.)

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

__global__ void sort_rows_kv_kernel(const long long* __restrict__ keys,
                                    const long long* __restrict__ pay, int n,
                                    int N, long long* __restrict__ keys_out,
                                    long long* __restrict__ pay_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem);
  const size_t row = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const uint64_t key = i < n ? (uint64_t)(uint32_t)keys[row + i]
                               : 0xFFFFFFFFull;
    s[i] = (key << 32) | (uint64_t)(uint32_t)i;
  }
  __syncthreads();
  bitonic_sort(s, N);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t c = s[i];
    keys_out[row + i] = (long long)(c >> 32);
    pay_out[row + i] = pay[row + (c & 0xFFFFFFFFull)];
  }
}

int pow2_at_least(int n) {
  int N = 2;
  while (N < n) N <<= 1;
  return N;
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

// keys, payload (R, n) int64 holding u32; keys_out, pay_out (R, n) int64.
extern "C" int fa_sort_rows_u32_kv(const void* keys, const void* pay,
                                   void* keys_out, void* pay_out, int R, int n,
                                   void* stream) {
  const int N = pow2_at_least(n);
  const size_t smem = sizeof(uint64_t) * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kv_kernel<<<R, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const long long*>(pay),
      n, N, static_cast<long long*>(keys_out),
      static_cast<long long*>(pay_out));
  return (int)cudaGetLastError();
}
