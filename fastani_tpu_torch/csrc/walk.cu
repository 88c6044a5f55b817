// K5: the L2 event walk, O(1) work per event.
//
// Replaces the inner `kernel` of fastani_tpu/models/l2walk.py::
// _walk_pallas_call (wrapped by walk_pallas); the plain version is
// models/l2walk.py::walk_plain, a loop restatement of walk_scan.  Per work
// unit, a sequential walk over its n_ev events with state m[j], pres[j]
// for query ranks j < scap (m starts at j, pres at 0):
//   m[j] += dn for j >= jr;  pres[jm] += dq;
//   j* = #{j : m[j] < s};    cnt = #{j < j* : pres[j] > 0};
//   on scored events track best = max cnt and the first and last position
//   at which best was reached.
//
// Precondition: m is strictly increasing in j and every pres is 0 or 1 at
// every step.  This is the invariant the JAX package states at
// fastani_tpu/models/l2walk.py:15 (m_j is the rank of q_j in the union of
// the sketch and the window's distinct hashes; pres flips only when a
// query hash enters or leaves the window's distinct set).  It holds for
// the streams models/l2walk.py::build_events makes, the kernel's only
// caller; an arbitrary stream of +-1 events breaks it.
//
// The recurrence.  With m strictly increasing, {j : m[j] < s} is the prefix
// [0, j*), and one event moves j* by at most one rank.  Writing
// m[j] = j + sum_{i <= j} diff[i] (an event adds dn to diff[jr]) and keeping
// P = sum_{i < j*} diff[i], the two values that decide a move are
// m[j*-1] = j*-1 + P and m[j*] = j* + P + diff[j*].  Per event:
//   1. diff[jr] += dn, and P += dn when jr < j*;
//   2. pres[jm] += dq, and cnt follows when jm < j* and presence flips;
//   3. dn > 0: j* steps down when m[j*-1] >= s; dn < 0: j* steps up when
//      m[j*] < s;
//   4. P and cnt take or drop the diff and presence of the rank crossed;
//   5. score as walk_plain does (sc > best sets posf, sc >= best posl).
//
// Bound on this card: bytes by the roofline count (24 bytes per event read
// once against ~30 integer operations per event); what limits this design
// is the dependent chain of n_ev steps per unit: each step is one
// shared-memory load (the word at the rank j* may cross) and a dozen
// dependent integer operations deep, and with one warp per SM nothing else
// fills the scheduler while it waits.  Design: one thread walks one unit,
// 32 units to a block of one warp, so the chain runs 32 units at once and
// the time is set by the chain's length, not by the unit count (up to one
// full wave of blocks, which is what the map step launches:
// fa_walk_blocks_per_sm, models/jitmap.py::chunk_width).  Per-unit state
// lives in shared memory, diff (high 16 bits, |diff| <= ncap) and pres
// (low 16 bits) packed in one word per rank, laid out [rank][lane]: each
// lane's random rank falls in its own bank.
// j*, P, cnt, best, posf and posl stay in registers, and the step is
// branch-free.  The event rows are (U, T) row-major, so a lane's own row is
// strided for the warp: tiles of 32 units x 32 events of the six arrays
// are staged into shared memory with 16-byte cp.async copies (TMA would
// need 16-byte row strides; T = 2033 words is odd), three buffers deep, so
// tile i + 2 loads, spread over tile i's first six event groups, while
// tile i is walked and tile i + 1 lands.  (4-byte copies, one per event and
// row, cost more than the walk itself.)  A lane reads its next four events
// from the staged tile before it updates the state.  Each unit stops at
// its own n_ev.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoScore = -5;
constexpr int kLanes = 32;               // units per block (one warp)
constexpr int kTile = 32;                // events per staged tile
constexpr int kArrays = 6;               // dn, dq, jr, jm, scored, pos
constexpr int kChunks = 9;               // 16-byte chunks over 32 events
constexpr int kRowWords = 4 * kChunks;   // a staged row of one array
constexpr int kTileWords = kArrays * kLanes * kRowWords;
constexpr int kBufs = 3;                 // tiles i, i+1 landed, i+2 loading
constexpr int kGroup = 4;                // events prefetched together
static_assert(kTile / kGroup >= kArrays,
              "tile i + 2 is staged one array per event group of tile i");

struct Events {
  const int* a[kArrays];
};

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the staged slot of unit row r: rows 4 apart share a bank group, and the
// four rows of a group start at four different word offsets within a
// 16-byte chunk when T is odd, so lane r's reads fall in 32 distinct banks
__device__ __forceinline__ int row_slot(int r) { return (r >> 2) + 8 * (r & 3); }

// The staging of one array of a tile: the row of unit u0 + r, events
// [t0, t0 + 32), is covered by the 9 aligned 16-byte chunks from its first
// word rounded down to 16 bytes (rows are (U, T) int32, so a row is only
// 4-byte aligned; the arrays themselves are 16-byte aligned).  Each lane
// holds 9 of the 288 (row, chunk) pairs.  A chunk never leaves the
// 16-byte block of a word of the array, so it stays inside the allocation.
struct Chunk {
  unsigned off;        // chunk start, bytes from the array's event t0 = 0
  int rel;             // chunk start - row's first needed byte (> 2^30: none)
  unsigned dst;        // bytes within one array's staged rows
};

__device__ __forceinline__ void stage_array(unsigned dst, const int* base,
                                            const Chunk (&ch)[kChunks],
                                            int t0, int cnt) {
  const char* src = reinterpret_cast<const char*>(base + t0);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (ch[c].rel < 4 * cnt) cp_async16(dst + ch[c].dst, src + ch[c].off);
  }
}

struct Event {
  int dn, dq, jr, jm, scored, pos;
};

// this lane's events e0 .. e0 + kGroup - 1 of a staged tile; rd[a] is the
// word offset of its row of array a, shift included
__device__ __forceinline__ void load_group(Event (&g)[kGroup],
                                           const int* tile,
                                           const int (&rd)[kArrays], int e0) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    g[k].dn = tile[rd[0] + e0 + k];
    g[k].dq = tile[rd[1] + e0 + k];
    g[k].jr = tile[rd[2] + e0 + k];
    g[k].jm = tile[rd[3] + e0 + k];
    g[k].scored = tile[rd[4] + e0 + k];
    g[k].pos = tile[rd[5] + e0 + k];
  }
}

struct Walk {
  int jstar, P, cnt, best, posf, posl;
};

// one event, branch-free; an event past the unit's n_ev is made inert
__device__ __forceinline__ void step(Walk& w, const Event& f, bool live,
                                     int* col, int scap, int s) {
  const int dn = live ? f.dn : 0;
  const int dq = live ? f.dq : 0;
  // the word this event changes (diff[jr] or pres[jm]; dn and dq are never
  // both nonzero) and the word a move of j* reads, which is j*-1 for a
  // step down (dn > 0) and j* for a step up (dn < 0)
  const int a = (int)min((unsigned)(dn != 0 ? f.jr : f.jm), (unsigned)scap);
  const int delta = dn * 65536 + dq;
  const int c = max(w.jstar - (dn > 0), 0);
  int wc = col[c * kLanes];
  atomicAdd(col + a * kLanes, delta);
  wc += (a == c) ? delta : 0;
  // 1-2: the prefix sum and the count below j* (pres flips 0 <-> 1, so a
  // nonzero dq below j* moves cnt by dq)
  w.P += (f.jr < w.jstar) ? dn : 0;
  w.cnt += (f.jm < w.jstar) ? dq : 0;
  // 3-4: j* moves at most one rank: down when m[j*-1] = j*-1+P >= s, up
  // when m[j*] = j*+P+diff[j*] < s; P and cnt take the rank crossed
  const int dc = wc >> 16;
  const int pc = (wc & 0xFFFF) != 0;
  const int x = w.jstar + w.P;
  const int sgn = (int)(dn < 0 && w.jstar < scap && x + dc < s) -
                  (int)(dn > 0 && w.jstar > 0 && x > s);
  w.jstar += sgn;
  w.P += sgn * dc;
  w.cnt += sgn * pc;
  // 5: score
  const int sc = (live && f.scored) ? w.cnt : kNoScore;
  w.posf = sc > w.best ? f.pos : w.posf;
  w.posl = sc >= w.best ? f.pos : w.posl;
  w.best = max(w.best, sc);
}

__global__ void __launch_bounds__(kLanes)
    walk_kernel(Events ev, const int* __restrict__ s_u,
                const int* __restrict__ n_ev, int U, int T, int scap,
                int* __restrict__ best_out, int* __restrict__ posf_out,
                int* __restrict__ posl_out) {
  extern __shared__ __align__(16) int smem[];
  int* tiles = smem;                          // [kBufs][kArrays][32][36]
  int* state = smem + kBufs * kTileWords;     // [scap + 1][kLanes]
  const int lane = threadIdx.x;
  const int u0 = blockIdx.x * kLanes;
  const int rows = min(kLanes, U - u0);
  const bool have = lane < rows;
  const int s = have ? s_u[u0 + lane] : 0;
  const int n = have ? min(max(n_ev[u0 + lane], 0), T) : 0;
  const int n_max = (int)__reduce_max_sync(kFull, (unsigned)n);
  const int n_tiles = (n_max + kTile - 1) / kTile;

  Chunk ch[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int q = lane + kLanes * c;          // (row, chunk) pair 0 .. 287
    const int r = q / kChunks;
    const int k = q - r * kChunks;
    const unsigned row_bytes = 4u * (unsigned)(u0 + r) * (unsigned)T;
    ch[c].off = (row_bytes & ~15u) + 16u * k;
    ch[c].rel = r < rows ? 16 * k - (int)(row_bytes & 15u) : (1 << 30);
    ch[c].dst = 4u * (row_slot(r) * kRowWords + 4 * k);
  }
  // this lane's row of array a in a staged tile, shifted by its first
  // word's offset within a 16-byte chunk (the same in every tile)
  int rd[kArrays];
  const int shift = (int)(((unsigned)(have ? u0 + lane : u0) * (unsigned)T) & 3u);
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    rd[a] = (a * kLanes + row_slot(lane)) * kRowWords + shift;
  }
  const unsigned tiles_at = static_cast<unsigned>(__cvta_generic_to_shared(tiles));
  auto stage = [&](int buf, int a, int tile) {
    const int t0 = tile * kTile;
    stage_array(tiles_at + 4u * (buf * kTileWords + a * kLanes * kRowWords),
                ev.a[a], ch, t0, min(kTile, n_max - t0));
  };

  // prologue: tiles 0 and 1 in flight; tile i + 2 is staged one array per
  // event group during tile i, into the buffer tile i - 1 released
  for (int t = 0; t < 2; ++t) {
    if (t < n_tiles) {
      for (int a = 0; a < kArrays; ++a) stage(t, a, t);
    }
    cp_async_commit();
  }
  int* col = state + lane;                    // this unit's words
  for (int r = 0; r <= scap; ++r) col[r * kLanes] = 0;
  Walk w{min(max(s, 0), scap), 0, 0, -1, 0, 0};

  // events are walked in groups of kGroup; the next group's fields load
  // before this group's state updates, so the walk never waits on them
  Event cur[kGroup], nxt[kGroup];
  cp_async_wait<1>();
  __syncwarp();
  if (n_tiles > 0) load_group(cur, tiles, rd, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int* tl = tiles + (i % kBufs) * kTileWords;
    const bool ahead = i + 2 < n_tiles;
    // warp-uniform; a group's slots past n_max hold stale words, inert
    const int ng = (min(kTile, n_max - i * kTile) + kGroup - 1) / kGroup;
    for (int g = 0; g < ng; ++g) {
      if (ahead && g < kArrays) stage((i + 2) % kBufs, g, i + 2);
      if (g + 1 < ng) {
        load_group(nxt, tl, rd, (g + 1) * kGroup);
      } else if (i + 1 < n_tiles) {
        cp_async_wait<0>();     // tile i + 1; tile i + 2 is not committed
        __syncwarp();
        load_group(nxt, tiles + ((i + 1) % kBufs) * kTileWords, rd, 0);
      }
      const int t0 = i * kTile + g * kGroup;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        step(w, cur[k], t0 + k < n, col, scap, s);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    }
    cp_async_commit();   // tile i + 2 (empty near the end)
    __syncwarp();        // every lane is done with this buffer
  }
  if (have) {
    best_out[u0 + lane] = w.best;
    posf_out[u0 + lane] = w.posf;
    posl_out[u0 + lane] = w.posl;
  }
}

// K5's dynamic shared memory at sketch width scap: the staged tiles and
// one word a rank and lane
size_t walk_smem(int scap) {
  return sizeof(int) *
         (kBufs * (size_t)kTileWords + (size_t)(scap + 1) * kLanes);
}

}  // namespace

// six (U, T) int32 event arrays (dn, dq, jr, jm, scored, pos), s_u and n_ev
// (U,) int32; outputs best, posf, posl (U,) int32.  scap <= 1024.
// The six event arrays must be 16-byte aligned and U * T * 4 < 2^32.
extern "C" int fa_walk(const void* dn, const void* dq, const void* jr,
                       const void* jm, const void* scored, const void* pos,
                       const void* s_u, const void* n_ev, int U, int T,
                       int scap, void* best, void* posf, void* posl,
                       void* stream) {
  Events ev;
  const void* arrs[kArrays] = {dn, dq, jr, jm, scored, pos};
  for (int a = 0; a < kArrays; ++a) ev.a[a] = static_cast<const int*>(arrs[a]);
  const size_t smem = walk_smem(scap);
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (U + kLanes - 1) / kLanes;
  walk_kernel<<<blocks, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      ev, static_cast<const int*>(s_u), static_cast<const int*>(n_ev), U, T,
      scap, static_cast<int*>(best), static_cast<int*>(posf),
      static_cast<int*>(posl));
  return (int)cudaGetLastError();
}

// the K5 blocks (of kLanes units each) one SM of the current device holds
// at once at sketch width scap, by the occupancy calculator, into *blocks
extern "C" int fa_walk_blocks_per_sm(int scap, int* blocks) {
  const size_t smem = walk_smem(scap);
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, walk_kernel, kLanes, smem);
}
