// The device CGI's finalize of finished query genomes: per (query row,
// reference genome), the count of occupied bins and the float32 sum of
// their identities, added into the (Gq, Gr) accumulators, and the query's
// slot row of the bin table cleared, in one launch.
//
// Replaces the XLA code of fastani_tpu/models/device_cgi.py:194
// finalize_rows (no Pallas kernel: the JAX package gathers the slot rows,
// segment-sums them by genome, scatter-adds into the accumulators and
// clears the slots, one XLA computation), and the port's plain
// composition of it, models/device_cgi.py::finalize_rows_plain (a gather,
// fold_rows_plain, two index_add_ and an index_fill_).
//
// rows (FIN, B_tot) int32 words: a bin's best identity as float32 bits,
// or -1 for an empty bin.  A reference genome's bins are one contiguous
// range [start[g], start[g] + len[g]) of a row (device_cgi.genome_bins),
// and the ranges cover the row.  The sum is the contract's: a float32
// left fold from +0.0 over the genome's occupied bins in bin order, the
// order of device_cgi.fold_sequential and of the reference
// (computeCoreIdentity.hpp:267-297), so it is the plain version's bits.
// Skipping an empty bin keeps those bits: an occupied word is >= 0, so
// its float has the sign bit clear, the sum never becomes -0.0 under
// round-to-nearest, and x + 0.0f == x for every other x.  __fadd_rn
// keeps the compiler from contracting or reordering the adds.
//
// Bound on this card: by the roofline, the bytes (FIN x B_tot words read
// once, and written once more by the clear); below that, the contract's
// chain of one dependent add per occupied bin of the longest genome,
// which no parallelism shortens.  The design keeps everything but those
// adds off the chain:
// - one warp per (row, genome), blocks of kWarps warps;
// - the warp reads its range in tiles of 32 consecutive words, one a
//   lane (128 bytes, coalesced), aligned on 128 bytes, the first and last
//   tiles masked, so no lane reads a word of another genome (its warp
//   may be clearing it);
// - kTiles tiles a group, the next group's loads issued before this
//   group is consumed;
// - a tile's occupied count is a ballot's popcount; the group's occupied
//   values are appended in bin order to the warp's ring in shared memory,
//   each at its rank among the occupied lanes;
// - the adds run over the ring's whole chunks of 16 values, four 16-byte
//   reads a chunk, the next chunk read while this one's adds run, so the
//   chain holds only the adds; fewer than 16 values wait for the next
//   group, and only the genome's last ones take predicated adds; every
//   lane runs the same warp-uniform loop, and lane 0 writes the result.
//
// fold_rows reads rows and writes (FIN, Gr) counts and sums.  The
// finalize form reads row f of rows, or with no rows the table row of
// slot fin_qnos[f] % n_slots; adds into acc[fin_qnos[f], g] by one
// read-add-write (each element has one writer: the host checks that the
// call's slots, hence its query genomes, are distinct; the accumulators
// are read at the start, so no load waits after the chain), the
// index_add_'s bits but for a subnormal sum, which the card's
// index_add_ (a float atomic) flushes to zero and this add keeps, as the
// CPU does; and writes -1 over the warp's own range of the slot's row
// after reading it, so the genomes' warps clear the whole row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // warps a block
constexpr int kTiles = 32;                 // tiles of 32 words a group
// a warp's ring of occupied values (a power of two): fewer than 16 left
// over from the groups before, a group's values and a chunk read ahead
// fit in it; its float kRing, past the ring, takes the empty lanes'
// stores, and kStride keeps each warp's ring 16-byte aligned
constexpr int kRing = 2048;
constexpr int kStride = kRing + 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add4(float acc, float4 v) {
  acc = __fadd_rn(acc, v.x);
  acc = __fadd_rn(acc, v.y);
  acc = __fadd_rn(acc, v.z);
  return __fadd_rn(acc, v.w);
}

template <bool kFinalize>
__global__ void __launch_bounds__(32 * kWarps)
fold_rows_kernel(const int* rows, int* tab,
                 const long long* __restrict__ fin_qnos,
                 const int* __restrict__ start, const int* __restrict__ len,
                 int fin, int n_slots, int b_tot, int gr, int gq,
                 int* counts, float* sums) {
  __shared__ __align__(16) float buf[kWarps * kStride];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + wib;
  if (w >= (long long)fin * gr) return;      // the whole warp
  const int f = (int)(w / gr), g = (int)(w % gr);
  long long out = w;                         // (f, g) of counts, sums
  const int* src = tab;
  int* clear = nullptr;
  int c_in = 0;
  float s_in = 0.0f;
  if (kFinalize) {
    const long long q = fin_qnos[f];
    if (q < 0 || q >= gq) return;            // the host rejects these
    int* slot_row = tab + (long long)((int)q % n_slots) * b_tot;
    clear = slot_row + start[g];
    src = slot_row;
    out = q * gr + g;
    // the accumulators' values, read now so no load waits after the
    // chain (this warp is their one writer)
    c_in = counts[out];
    s_in = sums[out];
  }
  if (rows != nullptr) src = rows + (long long)f * b_tot;
  const int n = len[g];
  const int* p = src + start[g];             // the genome's first bin
  // words between the 128-byte boundary at or before p and p
  const int lead = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 31);
  const int n_tiles = (lead + n + 31) >> 5;
  const unsigned lt = (1u << lane) - 1u;     // lanes below this one
  float* ring = buf + wib * kStride;
  auto chunk = [&](int i, int k) {           // float4 k of the chunk at i
    return reinterpret_cast<const float4*>(ring + (i & (kRing - 1)))[k];
  };

  int cur[kTiles], nxt[kTiles];
  // tiles t0 .. t0 + kTiles - 1: bin i = 32 t + lane - lead of the genome,
  // -1 (empty) outside [0, n); nothing outside is read
  auto load = [&](int t0, int (&v)[kTiles]) {
#pragma unroll
    for (int k = 0; k < kTiles; ++k) {
      const int i = (t0 + k) * 32 + lane - lead;
      v[k] = (i >= 0 && i < n) ? p[i] : -1;
    }
  };
  load(0, cur);
  int head = 0, tail = 0;                    // the ring's unadded values
  float acc = 0.0f;
  for (int t0 = 0; t0 < n_tiles; t0 += kTiles) {
    load(t0 + kTiles, nxt);                  // past n: no reads
#pragma unroll
    for (int k = 0; k < kTiles; ++k) {
      const unsigned ballot = __ballot_sync(kFull, cur[k] >= 0);
      // an empty lane stores past the ring: no branch around the store
      ring[cur[k] >= 0 ? (tail + __popc(ballot & lt)) & (kRing - 1)
                       : kRing] = __int_as_float(cur[k]);
      tail += __popc(ballot);
    }
    if (kFinalize) {
      // this lane's words of the group are read: clear them
#pragma unroll
      for (int k = 0; k < kTiles; ++k) {
        const int i = (t0 + k) * 32 + lane - lead;
        if (i >= 0 && i < n) clear[i] = -1;
      }
    }
    __syncwarp();
    // the whole chunks of 16, in order, the next one read while this
    // one's adds run; fewer than 16 values wait for the next group
    const int n_chunks = (tail - head) >> 4;
    if (n_chunks > 0) {
      float4 x0 = chunk(head, 0), x1 = chunk(head, 1), x2 = chunk(head, 2),
             x3 = chunk(head, 3);
      for (int ch = 0; ch < n_chunks; ++ch) {
        const float4 y0 = x0, y1 = x1, y2 = x2, y3 = x3;
        head += 16;
        x0 = chunk(head, 0);
        x1 = chunk(head, 1);
        x2 = chunk(head, 2);
        x3 = chunk(head, 3);
        acc = add4(add4(add4(add4(acc, y0), y1), y2), y3);
      }
    }
    __syncwarp();                            // the ring is free again
#pragma unroll
    for (int k = 0; k < kTiles; ++k) cur[k] = nxt[k];
  }
  // the last values, fewer than 16, once a warp
  const int rest = tail - head;
  if (rest > 0) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x = chunk(head, k);
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
#pragma unroll
    for (int k = 0; k < 15; ++k)
      if (k < rest) acc = __fadd_rn(acc, v[k]);
  }
  if (lane == 0) {
    if (kFinalize) {
      counts[out] = c_in + tail;
      sums[out] = __fadd_rn(s_in, acc);
    } else {
      counts[out] = tail;
      sums[out] = acc;
    }
  }
}

int blocks_for(int fin, int gr) {
  return (int)(((long long)fin * gr + kWarps - 1) / kWarps);
}

}  // namespace

// rows (fin, b_tot) int32; start, len (gr,) int32; outputs counts (fin, gr)
// int32 and sums (fin, gr) float32.  Reads rows only.
extern "C" int fa_fold_rows(const void* rows, const void* start,
                            const void* len, int fin, int b_tot, int gr,
                            void* counts, void* sums, void* stream) {
  if ((long long)fin * gr > 0) {
    fold_rows_kernel<false><<<blocks_for(fin, gr), 32 * kWarps, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), nullptr, nullptr,
        static_cast<const int*>(start), static_cast<const int*>(len), fin, 1,
        b_tot, gr, 0, static_cast<int*>(counts), static_cast<float*>(sums));
  }
  return (int)cudaGetLastError();
}

// tab (n_slots, b_tot) int32, cleared in place at the listed slots;
// rows (fin, b_tot) int32 or null (then each query's slot row is read);
// fin_qnos (fin,) int64, distinct slots, each in [0, gq); start, len (gr,)
// int32; acc_counts (gq, gr) int32 and acc_sums (gq, gr) float32, added
// into in place.
extern "C" int fa_finalize_rows(void* tab, const void* rows,
                                const void* fin_qnos, const void* start,
                                const void* len, int fin, int n_slots,
                                int b_tot, int gr, int gq, void* acc_counts,
                                void* acc_sums, void* stream) {
  if ((long long)fin * gr > 0) {
    fold_rows_kernel<true><<<blocks_for(fin, gr), 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<int*>(tab),
        static_cast<const long long*>(fin_qnos),
        static_cast<const int*>(start), static_cast<const int*>(len), fin,
        n_slots, b_tot, gr, gq, static_cast<int*>(acc_counts),
        static_cast<float*>(acc_sums));
  }
  return (int)cudaGetLastError();
}
