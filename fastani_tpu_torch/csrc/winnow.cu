// K1: fused winnowing of haloed sequence rows.
//
// Replaces fastani_tpu/ops/pallas_winnow.py::_winnow_row_kernel (launched by
// _winnow_call, wrapped by winnow_rows).  Per position: uppercase, murmur3
// x64_128 low 32 bits (seed 42) of the forward k-mer and of its reverse
// complement, drop palindromes and positions outside the contig, canonical
// min, rightmost argmin over the trailing w-window, emit when the selected
// position changes (the deque of reference commonFunc.hpp:92-167, as
// restated by ops/minimizer.py::winnow_model).
//
// Row r covers global positions [base[r] - (w-1), base[r] - (w-1) + W) of
// contig ctg[r]; its scored positions are base[r] + i, i in [0, seg) with
// seg = W - (w-1) - (k-1).  Rows of one contig are consecutive and ordered.
//
// Bound on this card: integer operations (two 64-bit murmur3 per position,
// ~200 integer ops, plus a w-long window scan), not bytes (1 byte in, 9 out
// per position).  Design: one block per row; the row's bytes, canonical
// hashes and valid flags live in shared memory, so each byte is read from
// device memory once.  Hashing uses native uint64_t arithmetic (the hi/lo
// u32 split of the Pallas kernel was a TPU workaround).
//
// The emit selection carries from row to row within a contig.  The Pallas
// kernel carried it through SMEM across its sequential grid; CUDA blocks run
// in no order, so the carry is resolved explicitly: the row pass computes
// every emit except the row's first event, and records that event and the
// row's last selection; a second, per-row chain pass finds the nearest
// earlier row of the same contig that had an event and settles the first
// event against its last selection (-2 when none, i.e. a fresh contig).
// Contigs of any length work; no row-count ceiling.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kC1 = 0x87C37B91114253D5ULL;
constexpr uint64_t kC2 = 0x4CF5AD432745937FULL;
constexpr uint64_t kF1 = 0xFF51AFD7ED558CCDULL;
constexpr uint64_t kF2 = 0xC4CEB9FE1A85EC53ULL;
constexpr uint32_t kUMax = 0xFFFFFFFFu;
constexpr int kNone = -3;        // "no event" (selections are >= 0, seed -2)
constexpr int kThreads = 512;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= kF1;
  h ^= h >> 33;
  h *= kF2;
  h ^= h >> 33;
  return h;
}

// low 32 bits of murmur3 x64_128 (seed 42) of a k-byte key given as its
// two little-endian words (bytes past k are zero)
__device__ __forceinline__ uint32_t murmur3_low32(uint64_t w1, uint64_t w2,
                                                  int k) {
  uint64_t h1 = 42, h2 = 42;
  if (k == 16) {
    uint64_t k1 = rotl64(w1 * kC1, 31) * kC2;
    h1 ^= k1;
    h1 = rotl64(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52DCE729ULL;
    uint64_t k2 = rotl64(w2 * kC2, 33) * kC1;
    h2 ^= k2;
    h2 = rotl64(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495AB5ULL;
  } else {
    if (k > 8) h2 ^= rotl64(w2 * kC2, 33) * kC1;
    h1 ^= rotl64(w1 * kC1, 31) * kC2;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return (uint32_t)h1;
}

__device__ __forceinline__ uint8_t complement(uint8_t b) {
  if (b == 'A') return 'T';
  if (b == 'T') return 'A';
  if (b == 'C') return 'G';
  if (b == 'G') return 'C';
  return b;
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

__global__ void winnow_row_kernel(const uint8_t* __restrict__ rows,
                                  const int* __restrict__ base,
                                  const int* __restrict__ tlen,
                                  int W, int k, int w,
                                  uint8_t* __restrict__ emit,
                                  long long* __restrict__ hash_out,
                                  int* __restrict__ row_first,
                                  int* __restrict__ row_first_sel,
                                  int* __restrict__ row_last_sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int halo = w - 1;
  const int seg = W - halo - (k - 1);
  const int npos = halo + seg;          // k-mer starts needed: [0, npos)
  uint8_t* x = smem;
  uint32_t* kh = reinterpret_cast<uint32_t*>(smem + round16(W));
  uint8_t* kv = reinterpret_cast<uint8_t*>(kh + round16(npos));
  int* tlast = reinterpret_cast<int*>(kv + round16(npos));

  const uint8_t* row = rows + (size_t)r * W;
  for (int i = tid; i < W; i += nt) {
    uint8_t b = row[i];
    x[i] = (b >= 'a' && b <= 'z') ? (uint8_t)(b - 32) : b;
  }
  __syncthreads();

  const int base_r = base[r];
  const int tlen_r = tlen[r];
  for (int f = tid; f < npos; f += nt) {
    uint64_t f1 = 0, f2 = 0, b1 = 0, b2 = 0;
    for (int j = 0; j < k; ++j) {
      uint64_t fb = x[f + j];
      uint64_t bb = complement(x[f + k - 1 - j]);
      if (j < 8) {
        f1 |= fb << (8 * j);
        b1 |= bb << (8 * j);
      } else {
        f2 |= fb << (8 * (j - 8));
        b2 |= bb << (8 * (j - 8));
      }
    }
    uint32_t hf = murmur3_low32(f1, f2, k);
    uint32_t hb = murmur3_low32(b1, b2, k);
    int g = f + base_r - halo;
    bool valid = (hf != hb) && g >= 0 && g <= tlen_r - k;
    kh[f] = valid ? (hf < hb ? hf : hb) : kUMax;
    kv[f] = valid ? 1 : 0;
  }
  __syncthreads();

  // each thread scans a contiguous chunk of scored positions
  const int chunk = (seg + nt - 1) / nt;
  const int lo = tid * chunk;
  const int hi = min(lo + chunk, seg);
  const size_t o = (size_t)r * seg;
  int prev = kNone, first_i = -1, first_sel = 0;
  for (int i = lo; i < hi; ++i) {
    const int f = halo + i;
    uint32_t bh = kUMax;
    int bq = -1;
    for (int q = i; q <= f; ++q) {    // window [f-w+1, f]; ties -> rightmost
      if (kv[q] && kh[q] <= bh) {
        bh = kh[q];
        bq = q;
      }
    }
    hash_out[o + i] = (long long)bh;
    uint8_t e = 0;
    if (kv[f] && base_r + i >= w - 1) {            // an event
      const int sel = bq + base_r - halo;          // global position
      if (prev == kNone) {
        first_i = i;
        first_sel = sel;
      } else {
        e = (sel != prev) ? 1 : 0;
      }
      prev = sel;
    }
    emit[o + i] = e;
  }

  // block scan: last event selection of threads [0, tid]
  int v = prev;
  for (int d = 1; d < nt; d <<= 1) {
    tlast[tid] = v;
    __syncthreads();
    int other = tid >= d ? tlast[tid - d] : kNone;
    __syncthreads();
    if (v == kNone) v = other;
  }
  tlast[tid] = v;
  __syncthreads();
  const int carry = tid > 0 ? tlast[tid - 1] : kNone;
  if (first_i >= 0) {
    if (carry != kNone) {
      emit[o + first_i] = (first_sel != carry) ? 1 : 0;
    } else {                    // the row's first event: settled by the chain
      row_first[r] = first_i;
      row_first_sel[r] = first_sel;
    }
  }
  if (tid == nt - 1) {
    row_last_sel[r] = v;
    if (v == kNone) row_first[r] = -1;
  }
}

// per row: settle the first event against the last selection of the
// nearest earlier row of the same contig that had an event (seed -2)
__global__ void winnow_chain_kernel(const int* __restrict__ ctg, int R,
                                    int seg,
                                    const int* __restrict__ row_first,
                                    const int* __restrict__ row_first_sel,
                                    const int* __restrict__ row_last_sel,
                                    uint8_t* __restrict__ emit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || row_first[r] < 0) return;
  int carry = -2;
  for (int p = r - 1; p >= 0 && ctg[p] == ctg[r]; --p) {
    if (row_last_sel[p] != kNone) {
      carry = row_last_sel[p];
      break;
    }
  }
  emit[(size_t)r * seg + row_first[r]] = (row_first_sel[r] != carry) ? 1 : 0;
}

}  // namespace

// rows (R, W) uint8; ctg/base/tlen (R,) int32; outputs emit (R, seg) uint8
// and hash (R, seg) int64; row_first/row_first_sel/row_last_sel (R,) int32
// scratch.  seg = W - (w-1) - (k-1).
extern "C" int fa_winnow_rows(const void* rows, const void* ctg,
                              const void* base, const void* tlen, int R,
                              int W, int k, int w, void* emit, void* hash,
                              void* row_first, void* row_first_sel,
                              void* row_last_sel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int halo = w - 1;
  const int seg = W - halo - (k - 1);
  const int npos = halo + seg;
  const size_t smem = (size_t)round16(W) + 4 * (size_t)round16(npos) +
                      (size_t)round16(npos) + 4 * (size_t)kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      winnow_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  winnow_row_kernel<<<R, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int*>(base),
      static_cast<const int*>(tlen), W, k, w, static_cast<uint8_t*>(emit),
      static_cast<long long*>(hash), static_cast<int*>(row_first),
      static_cast<int*>(row_first_sel), static_cast<int*>(row_last_sel));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  winnow_chain_kernel<<<(R + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(ctg), R, seg,
      static_cast<const int*>(row_first), static_cast<const int*>(row_first_sel),
      static_cast<const int*>(row_last_sel), static_cast<uint8_t*>(emit));
  return (int)cudaGetLastError();
}
