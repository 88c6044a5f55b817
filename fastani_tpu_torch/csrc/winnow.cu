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
// Bound on this card: integer operations.  Each k-mer start needs two
// murmur3 hashes of 64-bit words (each 64-bit multiply lowers to several
// 32-bit multiply-adds), against 1 byte read and 5 bytes written.  Design:
//   * a row is cut into tiles of at most `tile` scored positions (the
//     wrapper's choice, ops/winnow.py::tile_geometry), one 256-thread block
//     each, with a (w-1)+(k-1) halo: many small blocks in flight instead of
//     one 100-KB block per row;
//   * the tile's bytes are uppercased once and its reverse complement built
//     once (arithmetic, no branches: 149 - b for A/T, 138 - b for C/G), as
//     bytes in shared memory; a k-mer's two little-endian 8-byte words come
//     from five aligned 32-bit words by __funnelshift_r, and the backward
//     k-mer at f is the forward k-mer of the reverse complement at n-k-f;
//   * consecutive positions on consecutive lanes for the hashing and every
//     store (1-byte emits, 4-byte hashes: coalesced);
//   * the window minimum by sparse-table doubling (5 steps at w = 24) over
//     64-bit keys (invalid bit, hash, inverted position), so the plain
//     minimum is the rightmost argmin and an invalid position loses to
//     every valid hash, 0xFFFFFFFF included;
//   * emit-on-change without a serial loop: each warp walks a contiguous
//     chunk of the tile 32 positions at a time, finds each lane's nearest
//     earlier event by a ballot and a shuffle, and carries the last
//     selection to its next step; a warp's first event is settled against
//     the warps before it after one barrier.
//
// The emit selection carries from tile to tile within a contig.  Blocks run
// in no order, so the carry is resolved explicitly: the tile pass computes
// every emit except the tile's first event, and records that event and the
// tile's last selection; a second, per-tile chain pass finds the nearest
// earlier tile of the same contig that had an event and settles the first
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
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPosBits = 20;     // the key's low bits: tile-local k-mer start
constexpr uint64_t kPosMask = (1ULL << kPosBits) - 1;

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

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// uppercase and complement of one byte, without branches
__device__ __forceinline__ uint32_t upper_byte(uint32_t b) {
  return b - (((b - 'a') < 26u) ? 32u : 0u);
}
__device__ __forceinline__ uint32_t complement_byte(uint32_t b) {
  const bool at = (b == 'A') | (b == 'T');
  const bool cg = (b == 'C') | (b == 'G');
  return at ? 149u - b : (cg ? 138u - b : b);
}

// the k-mer of the byte string held in 32-bit words ``s`` at byte f, as
// two little-endian 64-bit words with the bytes past k zeroed
__device__ __forceinline__ void kmer_words(const uint32_t* s, int f, int k,
                                           uint64_t& lo, uint64_t& hi) {
  const int a = f >> 2;
  const uint32_t sh = 8u * (f & 3);
  const uint32_t v0 = s[a], v1 = s[a + 1], v2 = s[a + 2], v3 = s[a + 3],
                 v4 = s[a + 4];
  const uint32_t b0 = __funnelshift_r(v0, v1, sh);
  const uint32_t b1 = __funnelshift_r(v1, v2, sh);
  const uint32_t b2 = __funnelshift_r(v2, v3, sh);
  const uint32_t b3 = __funnelshift_r(v3, v4, sh);
  lo = ((uint64_t)b1 << 32) | b0;
  hi = ((uint64_t)b3 << 32) | b2;
  if (k < 16) {
    if (k <= 8) {
      hi = 0;
      if (k < 8) lo &= (1ULL << (8 * k)) - 1;
    } else {
      hi &= (1ULL << (8 * (k - 8))) - 1;
    }
  }
}

// Shared memory of one tile (n bytes, nk = tile + w - 1 k-mer starts):
// fwd and rev bytes as words (n rounded up, + 6 words for the 5-word reads
// of kmer_words), two key buffers of nk 64-bit words, the valid bits of the
// k-mer starts, and the warps' first/last events.
struct TileLayout {
  int n_words, nk;
  __host__ __device__ TileLayout(int tile, int k, int w) {
    nk = tile + w - 1;
    n_words = round_up(nk + k - 1, 4) / 4 + 6;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * (size_t)n_words * 4 + 2 * (size_t)round_up(nk, 2) * 8 +
           (size_t)round_up(nk, 32) / 8 + 3 * kWarps * 4 + 16;
  }
};

// K = 16 compiles the k-mer extraction and the hash for k = 16 alone (the
// main path's k); K = 0 takes k at run time
template <int K>
__global__ void __launch_bounds__(kThreads)
winnow_tile_kernel(const uint8_t* __restrict__ rows,
                   const int* __restrict__ base,
                   const int* __restrict__ tlen, int W, int k_arg, int w,
                   int tile, int n_tiles, uint8_t* __restrict__ emit,
                   uint32_t* __restrict__ hash_out,
                   int* __restrict__ tile_first,
                   int* __restrict__ tile_first_sel,
                   int* __restrict__ tile_last_sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = K ? K : k_arg;
  const int r = blockIdx.x / n_tiles;
  const int t = blockIdx.x - r * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int halo = w - 1;
  const int seg = W - halo - (k - 1);
  const int t0 = t * tile;                      // first scored position
  const int tn = min(tile, seg - t0);           // scored positions here
  const int nk = tn + halo;                     // k-mer starts [t0, t0+nk)
  const int n = nk + k - 1;                     // bytes [t0, t0+n)
  const TileLayout lay(tile, k, w);
  uint32_t* fwd = reinterpret_cast<uint32_t*>(smem);
  uint32_t* rev = fwd + lay.n_words;
  uint64_t* keyA = reinterpret_cast<uint64_t*>(rev + lay.n_words);
  uint64_t* keyB = keyA + round_up(lay.nk, 2);
  uint32_t* vbits = reinterpret_cast<uint32_t*>(keyB + round_up(lay.nk, 2));
  int* w_first = reinterpret_cast<int*>(vbits + round_up(lay.nk, 32) / 32);
  int* w_first_sel = w_first + kWarps;
  int* w_last = w_first_sel + kWarps;

  // 1. the tile's bytes, uppercased, and their reverse complement (bytes
  // past n are read by kmer_words only into the zeroed part of a k-mer)
  uint8_t* fb = reinterpret_cast<uint8_t*>(fwd);
  uint8_t* rb = reinterpret_cast<uint8_t*>(rev);
  const uint8_t* row = rows + (size_t)r * W + t0;
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t b = upper_byte(row[i]);
    fb[i] = (uint8_t)b;
    rb[n - 1 - i] = (uint8_t)complement_byte(b);
  }
  __syncthreads();

  // 2. canonical hash keys of the k-mer starts, lanes on consecutive starts
  const int base_r = base[r];
  const int tlen_r = tlen[r];
  for (int q0 = 0; q0 < nk; q0 += kThreads) {
    const int q = q0 + tid;
    bool valid = false;
    if (q < nk) {
      uint64_t f1, f2, b1, b2;
      kmer_words(fwd, q, k, f1, f2);
      kmer_words(rev, n - k - q, k, b1, b2);
      const uint32_t hf = murmur3_low32(f1, f2, k);
      const uint32_t hb = murmur3_low32(b1, b2, k);
      const int g = t0 + q + base_r - halo;        // global k-mer start
      valid = (hf != hb) && g >= 0 && g <= tlen_r - k;
      const uint32_t h = valid ? min(hf, hb) : kUMax;
      keyA[q] = ((uint64_t)(valid ? 0 : 1) << 52) |
                ((uint64_t)h << kPosBits) | (kPosMask - (uint64_t)q);
    }
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, valid);
    if (lane == 0 && q < round_up(nk, 32)) vbits[q >> 5] = bits;
  }
  __syncthreads();

  // 3. sparse-table doubling: m_S[q] = min key over [q, q + S)
  uint64_t* cur = keyA;
  uint64_t* nxt = keyB;
  int span = 1;
  while (2 * span <= w) {
    for (int q = tid; q <= nk - 2 * span; q += kThreads)
      nxt[q] = min(cur[q], cur[q + span]);
    __syncthreads();
    uint64_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    span *= 2;
  }
  const int tail = w - span;                      // final shift, 0 if w = 2^j

  // 4. window minimum, hash out, events and emits: warp `warp` walks scored
  // positions [lo, hi) of the tile 32 at a time
  const int chunk = round_up((tn + kWarps - 1) / kWarps, 32);
  const int lo = min(warp * chunk, tn);
  const int hi = min(lo + chunk, tn);
  const size_t o = (size_t)r * seg + t0;
  const int ev_lo = w - 1 - (base_r + t0);        // events from here on
  const int sel_off = t0 + base_r - halo + (int)kPosMask;
  int carry = kNone, first_i = -1, first_sel = 0;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    // every lane runs the same code (the collectives stay converged);
    // lanes past hi read position lo and store nothing
    const int i = i0 + lane;
    const bool in = i < hi;
    const int ic = in ? i : lo;
    const uint64_t m = min(cur[ic], cur[ic + tail]);
    const int f = ic + halo;                      // the position's k-mer start
    const bool ev = in & (bool)((vbits[f >> 5] >> (f & 31)) & 1u) &
                    (ic >= ev_lo);
    const int sel = sel_off - (int)(m & kPosMask);
    const uint32_t evs = __ballot_sync(0xFFFFFFFFu, ev);
    const uint32_t before = evs & ((1u << lane) - 1u);
    const int prev_in =
        __shfl_sync(0xFFFFFFFFu, sel, before ? 31 - __clz(before) : lane);
    const int prev = before ? prev_in : carry;
    // the warp's first event (no earlier one in its chunk) is settled below
    const bool first = ev && prev == kNone;
    if (first) {
      first_i = i;
      first_sel = sel;
    }
    if (in) {
      hash_out[o + i] = (uint32_t)(m >> kPosBits);
      emit[o + i] = (ev && !first && sel != prev) ? 1 : 0;
    }
    if (evs) carry = __shfl_sync(0xFFFFFFFFu, sel, 31 - __clz(evs));
  }
  // the warp's first event sits in one lane; publish it and the last
  // selection, then settle each warp's first event against the warps before
  const uint32_t has = __ballot_sync(0xFFFFFFFFu, first_i >= 0);
  if (lane == 0) {
    w_first[warp] = -1;
    w_last[warp] = carry;
  }
  __syncwarp();
  if (has && lane == __ffs(has) - 1) {
    w_first[warp] = first_i;
    w_first_sel[warp] = first_sel;
  }
  __syncthreads();
  if (tid < kWarps && w_first[tid] >= 0) {
    int c = kNone;
    for (int p = tid - 1; p >= 0; --p) {
      if (w_last[p] != kNone) {
        c = w_last[p];
        break;
      }
    }
    if (c != kNone) {
      emit[o + w_first[tid]] = (w_first_sel[tid] != c) ? 1 : 0;
    } else {                      // the tile's first event: the chain's
      tile_first[blockIdx.x] = w_first[tid];
      tile_first_sel[blockIdx.x] = w_first_sel[tid];
    }
  }
  if (tid == 0) {
    int last = kNone;
    for (int p = kWarps - 1; p >= 0 && last == kNone; --p) last = w_last[p];
    tile_last_sel[blockIdx.x] = last;
    if (last == kNone) tile_first[blockIdx.x] = -1;
  }
}

// per tile: settle the first event against the last selection of the
// nearest earlier tile of the same contig that had an event (seed -2)
__global__ void winnow_chain_kernel(const int* __restrict__ ctg, int n_all,
                                    int n_tiles, int seg, int tile,
                                    const int* __restrict__ tile_first,
                                    const int* __restrict__ tile_first_sel,
                                    const int* __restrict__ tile_last_sel,
                                    uint8_t* __restrict__ emit) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_all || tile_first[b] < 0) return;
  const int c = ctg[b / n_tiles];
  int carry = -2;
  for (int p = b - 1; p >= 0 && ctg[p / n_tiles] == c; --p) {
    if (tile_last_sel[p] != kNone) {
      carry = tile_last_sel[p];
      break;
    }
  }
  const int r = b / n_tiles, t = b - r * n_tiles;
  emit[(size_t)r * seg + t * tile + tile_first[b]] =
      (tile_first_sel[b] != carry) ? 1 : 0;
}

}  // namespace

// Shared memory bytes a tile of ``tile`` scored positions needs.
extern "C" int fa_winnow_smem(int tile, int k, int w) {
  return (int)TileLayout(tile, k, w).bytes();
}

// rows (R, W) uint8; ctg/base/tlen (R,) int32; outputs emit (R, seg) uint8
// and hash (R, seg) uint32 bits; tile_first/tile_first_sel/tile_last_sel
// (R * n_tiles,) int32 scratch.  seg = W - (w-1) - (k-1) is cut into
// n_tiles = ceil(seg / tile) tiles; 1 <= k <= 16, tile + w - 1 < 2^20.
extern "C" int fa_winnow_tiles(const void* rows, const void* ctg,
                               const void* base, const void* tlen, int R,
                               int W, int k, int w, int tile, void* emit,
                               void* hash, void* tile_first,
                               void* tile_first_sel, void* tile_last_sel,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int seg = W - (w - 1) - (k - 1);
  const int n_tiles = (seg + tile - 1) / tile;
  const size_t smem = TileLayout(tile, k, w).bytes();
  auto kernel = k == 16 ? winnow_tile_kernel<16> : winnow_tile_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_all = R * n_tiles;
  kernel<<<n_all, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int*>(base),
      static_cast<const int*>(tlen), W, k, w, tile, n_tiles,
      static_cast<uint8_t*>(emit), static_cast<uint32_t*>(hash),
      static_cast<int*>(tile_first), static_cast<int*>(tile_first_sel),
      static_cast<int*>(tile_last_sel));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  winnow_chain_kernel<<<(n_all + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(ctg), n_all, n_tiles, seg, tile,
      static_cast<const int*>(tile_first),
      static_cast<const int*>(tile_first_sel),
      static_cast<const int*>(tile_last_sel), static_cast<uint8_t*>(emit));
  return (int)cudaGetLastError();
}

// One murmur3 (k = 16) a thread over n key pairs: a straight-line probe of
// the hash's instruction count in the compiled code (cuobjdump -sass), for
// the operations bound of K1; not used by the winnow.
extern "C" __global__ void fa_winnow_murmur_probe(
    const unsigned long long* __restrict__ in, unsigned int* __restrict__ out,
    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = murmur3_low32(in[2 * i], in[2 * i + 1], 16);
}
