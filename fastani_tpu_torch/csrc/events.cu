// E1 and E2: the L2 event build of one chunk of work units, on either side
// of K4's key-value row sort.
//
// No Pallas kernel is replaced: the JAX package builds the events in XLA
// code, fastani_tpu/models/l2walk.py::build_events, which XLA fuses inside
// the jitted map step.  The plain versions are models/l2walk.py::
// events_plain (E1) and events_scan_plain (E2), the torch ops that
// build_events ran before these kernels; build_events runs E1 -> K4 -> E2.
//
// E1 (events_kernel), per unit: clamp b0 to [0, M - ncap]; read the
// unit's ncap index entries [b0, b0 + ncap) (hash, seqId, wpos and the
// prev/next same-(hash, seqId) links); the entry is in the unit's contig
// when its seqId is the unit's.  Its query ranks ql = #{q < h} and
// jr = #{q <= h} over the unit's sorted, UMAX-padded sketch row (at most
// MAX_SCAP = 1023 words, staged in shared memory once a block) come from
// one search: the sketch's hashes are unique and strictly increasing
// before the pads, so jr = ql + (q[ql] == h), and jr = scap for h = UMAX
// (the JAX package's own jr = ql + #{q == h}).  It writes the (U, T =
// 2 ncap + 1) int32 key and payload rows K4 sorts: enter events (value
// lp - C + 1, code 0), leave events (value lp, entries 1.., code 1) and
// the scoring event at sw0 (code 2), keys min(value + C, CLAMP) << 2 |
// code; payload records ql | jr << 10 | inq << 20 | nonq << 21 | link <<
// 22, the leave records shifted right by one (the j-th leave evicts entry
// j - 1), and the per-unit s_u, sw0, eL_loc, overflow and lp[0].
//
// E2 (events_scan_kernel), per unit, the ordered pass over its T sorted
// events: the running leave and enter counts lb_t and le_t (inclusive),
// eff, dn and dq, run_end by a one-event look-ahead, scored, and the
// position of the most recent leave (lp[0] before any), the six (U, T)
// int32 rows K5 walks, and n_ev (the real events: value below CLAMP).
//
// Bound on this card: bytes by the roofline count (E1 reads ncap entries
// of 32 bytes and writes 8 bytes an event; E2 reads 8 and writes 24 bytes
// an event).  The design against it:
//
// E1 runs one block of 256 threads a unit, each thread at most four
// entries (ncap <= 1022), at most 64 registers a thread (four blocks an
// SM: mid's chunk of 512 units in one wave).  A thread issues all of its
// entries' loads (the hash's low word only) before it stages the sketch
// row, so their latency overlaps the row's and each other's; its one
// search an entry is a binary search of the whole staged row (a table of
// bucket starts over the hashes' top bits, to start each search inside
// one bucket, did not pay once the loads went first: PERF.md).  What
// limits it: the bound counts each distinct entry once, but each unit
// reads its own window, and on the main path the windows overlap (mid's
// chunk: 520192 entry reads of 140176 distinct entries), so E1 moves ~26
// MB through L2 a chunk (32 bytes an entry read, 16 written) against the
// bound's 12.9 MB from memory: an estimate from the entry counts, not a
// measurement of the L2 traffic (PERF.md).
//
// E2 runs one block of kWarpsE2 (16) warps a unit, a two-level scan.
// Each warp owns a segment of 32 * ceil(ceil(T / 32) / kWarpsE2) events
// (128 at mid's T 2033), loads it once into registers (4 events a lane),
// reduces it to its leave, enter and real counts and its last leave by
// ballots and popcounts, and posts them and its first key to shared
// memory; after one barrier each warp sums the earlier warps' tuples (the
// last leave: the last earlier warp that has one, else lp[0]) and passes
// its segment again from that carry, writing the six rows coalesced; its
// look-ahead at its last event reads the next warp's first key.  A unit's
// chain is two passes of 4 steps and one barrier, not 64 dependent steps,
// so the card holds U * kWarpsE2 warps.  What limits it: its bytes (24 of
// its 32 an event written, 4 bytes a lane at the odd offsets of T), and
// at mid's chunk of 512 units two blocks an SM (56 registers a thread),
// so about two waves.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kUmax = 0xFFFFFFFFu;
constexpr long long kPinf = 1LL << 30;   // position infinity (xputils.PINF)
constexpr long long kClamp = 1LL << 28;  // l2walk.CLAMP
constexpr int kMaxScap = 1023;           // l2walk.MAX_SCAP
constexpr int kMaxNcap = 1022;           // l2walk.MAX_NCAP
constexpr int kMaxT = 2 * kMaxNcap + 1;
constexpr int kThreadsE1 = 256;
constexpr int kMinBlocksE1 = 4;         // 64 registers a thread
constexpr int kEntriesE1 = (kMaxNcap + kThreadsE1 - 1) / kThreadsE1;
constexpr int kWarpsE2 = 16;
constexpr int kMinBlocksE2 = 1;
// 32-event steps a warp of E2 takes at most (T <= kMaxT)
constexpr int kStepsE2 = ((kMaxT + 31) / 32 + kWarpsE2 - 1) / kWarpsE2;

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  // torch.clamp(x, lo, hi): max first, then min
  return x < lo ? (lo < hi ? lo : hi) : (x > hi ? hi : x);
}

// #{j < n : q[j] < h} over an ascending row
__device__ __forceinline__ int lower_bound(const unsigned* q, int n,
                                           unsigned h) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (q[lo + half] < h) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ int pack(long long v, int c, int code) {
  const long long x = v + c;
  return (int)(((x < kClamp ? x : kClamp) << 2) | code);
}

__global__ void __launch_bounds__(kThreadsE1, kMinBlocksE1)
    events_kernel(
    const long long* __restrict__ qh, const long long* __restrict__ s,
    const long long* __restrict__ frag, const int* __restrict__ u_sid,
    const bool* __restrict__ u_valid, const long long* __restrict__ b0,
    const long long* __restrict__ eL, const long long* __restrict__ mi_hash,
    const int* __restrict__ mi_sid, const int* __restrict__ mi_wpos,
    const long long* __restrict__ prev, const long long* __restrict__ nxt,
    long long m, int scap, int ncap, int c, int* __restrict__ keys0,
    int* __restrict__ pay0, int* __restrict__ s_u, int* __restrict__ sw0,
    int* __restrict__ el_loc, bool* __restrict__ overflow,
    int* __restrict__ lp0) {
  __shared__ unsigned q[kMaxScap];
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = clampll(b0[u], 0, m - ncap);
  const long long f = frag[u];

  // every entry load of this thread first: they wait on b0 only
  const unsigned* hash_lo = reinterpret_cast<const unsigned*>(mi_hash);
  int e_sid[kEntriesE1], e_wpos[kEntriesE1];
  unsigned e_h[kEntriesE1];
  long long e_pv[kEntriesE1], e_nx[kEntriesE1];
#pragma unroll
  for (int k = 0; k < kEntriesE1; ++k) {
    const int i = tid + k * kThreadsE1;
    if (i < ncap) {
      const long long idx = base + i;
      e_sid[k] = mi_sid[idx];
      e_h[k] = hash_lo[2 * idx];        // the u32 value's word
      e_wpos[k] = mi_wpos[idx];
      e_pv[k] = prev[idx];
      e_nx[k] = nxt[idx];
    }
  }
  const long long* qrow = qh + f * scap;
  for (int j = tid; j < scap; j += kThreadsE1) q[j] = (unsigned)qrow[j];
  const bool valid = u_valid[u];
  const long long sid = valid ? (long long)u_sid[u] : 0;
  const long long s_f = s[f];
  __syncthreads();

  const long long T = 2LL * ncap + 1;
  int* krow = keys0 + (long long)u * T;
  int* prow = pay0 + (long long)u * T;
#pragma unroll
  for (int k = 0; k < kEntriesE1; ++k) {
    const int i = tid + k * kThreadsE1;
    if (i >= ncap) break;
    const bool inc = (long long)e_sid[k] == sid;
    const unsigned h = inc ? e_h[k] : kUmax;
    const long long lp = inc ? (long long)e_wpos[k] : kPinf;
    const long long pv = e_pv[k] - base;
    const long long nx = e_nx[k] - base;
    const int ql = lower_bound(q, scap, h);
    const unsigned q_at = q[ql < scap - 1 ? ql : scap - 1];
    // #{q <= h}: the sketch is unique below its pads
    const int jr = h == kUmax ? scap : ql + (ql < scap && q_at == h);
    const bool inq = (ql < s_f) && (q_at == h) && inc;
    const bool nonq = inc && !inq;
    const unsigned rec = (unsigned)ql | ((unsigned)jr << 10) |
                         ((unsigned)inq << 20) | ((unsigned)nonq << 21);
    const unsigned link_en = (unsigned)(clampll(pv, -1, ncap) + 1);
    const unsigned link_lv = (unsigned)clampll(nx, 0, ncap);
    krow[i] = pack(inc ? lp - c + 1 : kPinf, c, 0);
    krow[ncap + i] = pack((i >= 1 && inc) ? lp : kPinf, c, 1);
    prow[i] = (int)(rec | (link_en << 22));
    if (i + 1 < ncap) prow[ncap + 1 + i] = (int)(rec | (link_lv << 22));
    if (i == 0) {
      const long long w0 = inc ? lp : 0;
      const long long span = eL[u] - base;
      prow[ncap] = 0;
      krow[2 * ncap] = pack(w0, c, 2);
      prow[2 * ncap] = 0;
      s_u[u] = (int)s_f;
      sw0[u] = (int)w0;
      el_loc[u] = (int)clampll(span, 0, ncap);
      overflow[u] = valid && span > ncap;
      lp0[u] = (int)lp;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarpsE2, kMinBlocksE2)
    events_scan_kernel(
    const int* __restrict__ keys, const int* __restrict__ rec,
    const int* __restrict__ sw0, const int* __restrict__ el_loc,
    const bool* __restrict__ u_valid, const int* __restrict__ lp0, int T,
    int c, int* __restrict__ dn, int* __restrict__ dq, int* __restrict__ jr,
    int* __restrict__ jm, int* __restrict__ scored, int* __restrict__ pos,
    int* __restrict__ n_ev) {
  // each warp's (leaves, enters, real events, has a leave, last leave,
  // first key)
  __shared__ int w_lb[32], w_le[32], w_real[32], w_has[32], w_last[32],
      w_first[32];
  const int u = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long off = (long long)u * T;
  const int* krow = keys + off;
  const int* rrow = rec + off;
  const int pad = (int)(kClamp << 2);        // not a real event
  const int steps = ((T + 31) / 32 + kWarpsE2 - 1) / kWarpsE2;
  const int seg = warp * steps * 32;         // the warp's first event

  // 1. the segment, once, into registers
  int key[kStepsE2], r[kStepsE2];
#pragma unroll
  for (int j = 0; j < kStepsE2; ++j) {
    const int t = seg + 32 * j + lane;
    const bool in = j < steps && t < T;
    key[j] = in ? krow[t] : pad;
    r[j] = in ? rrow[t] : 0;
  }
  const int thr = sw0[u] + c;
  const int eloc = el_loc[u];
  const bool valid = u_valid[u];
  const int lp_first = lp0[u];

  // 2. the segment's tuple
  int nl = 0, ne = 0, nr = 0, last = 0;
  bool has = false;
#pragma unroll
  for (int j = 0; j < kStepsE2; ++j) {
    const int vt = key[j] >> 2;
    const int code = key[j] & 3;
    const bool real = vt < kClamp;
    const unsigned bl = __ballot_sync(kFull, code == 1 && real);
    nl += __popc(bl);
    ne += __popc(__ballot_sync(kFull, code == 0 && real));
    nr += __popc(__ballot_sync(kFull, real));
    if (bl) {
      last = __shfl_sync(kFull, vt - c, 31 - __clz(bl));
      has = true;
    }
  }
  if (lane == 0) {
    w_lb[warp] = nl;
    w_le[warp] = ne;
    w_real[warp] = nr;
    w_has[warp] = has;
    w_last[warp] = last;
    w_first[warp] = key[0];
  }
  __syncthreads();

  // 3. the carry into this segment: the earlier warps' sums, and the last
  // leave of the last earlier warp that has one (else lp[0])
  const bool earlier = lane < warp;
  int lb = __reduce_add_sync(kFull, earlier ? w_lb[lane] : 0);
  int le = __reduce_add_sync(kFull, earlier ? w_le[lane] : 0);
  const unsigned hb = __ballot_sync(kFull, earlier && w_has[lane]);
  int lastv = hb ? w_last[31 - __clz(hb)] : lp_first;
  if (warp == 0) {
    const int total = __reduce_add_sync(kFull,
                                        lane < kWarpsE2 ? w_real[lane] : 0);
    if (lane == 0) n_ev[u] = total;
  }
  // the event after this segment's last: the next warp's first
  const int next_first = warp + 1 < kWarpsE2 ? w_first[warp + 1] : pad;

  // 4. the segment again from its carry, the six rows written
  const unsigned upto = (2u << lane) - 1u;   // lanes <= this one
#pragma unroll
  for (int j = 0; j < kStepsE2; ++j) {
    if (j >= steps) break;                   // the whole warp
    const int t = seg + 32 * j + lane;
    const int k = key[j];
    const int rr = r[j];
    // look-ahead: the next event's key (lane 31: the next step's lane 0,
    // or the next segment's first event)
    int nk = __shfl_down_sync(kFull, k, 1);
    const int nk0 = __shfl_sync(kFull, key[j + 1 < kStepsE2 ? j + 1 : j], 0);
    if (lane == 31) nk = j + 1 < steps ? nk0 : next_first;
    const int vt = k >> 2;
    const int code = k & 3;
    const bool real = vt < kClamp;
    const bool enter = code == 0 && real;
    const bool leave = code == 1 && real;
    const unsigned bl = __ballot_sync(kFull, leave);
    const unsigned be = __ballot_sync(kFull, enter);
    const int lb_t = lb + __popc(bl & upto);
    const int le_t = le + __popc(be & upto);
    const int pvnx = (rr >> 22) & 0x3FF;
    const bool eff = enter ? (pvnx - 1) < lb_t : pvnx >= le_t;
    const int sign = enter ? 1 : -1;
    const bool live = enter || leave;
    const bool run_end = t + 1 >= T || vt != (nk >> 2);
    // the most recent leave at or before this event: the highest leave
    // lane at or below this one, else the carry
    const int lv = vt - c;
    const unsigned mine = bl & upto;
    const int src = mine ? 31 - __clz(mine) : lane;
    const int got = __shfl_sync(kFull, lv, src);
    const int p = mine ? got : lastv;
    if (bl) lastv = __shfl_sync(kFull, lv, 31 - __clz(bl));
    if (t < T) {
      dn[off + t] = (live && eff && ((rr >> 21) & 1)) ? sign : 0;
      dq[off + t] = (live && eff && ((rr >> 20) & 1)) ? sign : 0;
      jr[off + t] = (rr >> 10) & 0x3FF;
      jm[off + t] = rr & 0x3FF;
      scored[off + t] = run_end && real && vt >= thr && le_t < eloc && valid;
      pos[off + t] = p;
    }
    lb += __popc(bl);
    le += __popc(be);
  }
}

}  // namespace

// E1.  qh (F, scap) int64 u32 values, each row ascending and unique before
// its UMAX pads (a sketch), s (F,) int64, frag (U,) int64, u_sid (U,)
// int32, u_valid (U,) bool, b0 and eL (U,) int64; the index tables over m
// entries: mi_hash int64 (u32 values), mi_sid and mi_wpos int32, prev and
// nxt int64.  Outputs: keys0 and pay0 (U, 2 ncap + 1) int32; s_u, sw0,
// eL_loc and lp0 (U,) int32; overflow (U,) bool.  Needs m >= ncap,
// 1 <= scap <= 1023, 1 <= ncap <= 1022 and every frag[u] < F.
extern "C" int fa_events(const void* qh, const void* s, const void* frag,
                         const void* u_sid, const void* u_valid,
                         const void* b0, const void* eL, const void* mi_hash,
                         const void* mi_sid, const void* mi_wpos,
                         const void* prev, const void* nxt, int n_units,
                         long long m, int scap, int ncap, int c, void* keys0,
                         void* pay0, void* s_u, void* sw0, void* el_loc,
                         void* overflow, void* lp0, void* stream) {
  if (scap < 1 || scap > kMaxScap || ncap < 1 || ncap > kMaxNcap) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_units > 0) {
    events_kernel<<<n_units, kThreadsE1, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(qh), static_cast<const long long*>(s),
        static_cast<const long long*>(frag), static_cast<const int*>(u_sid),
        static_cast<const bool*>(u_valid), static_cast<const long long*>(b0),
        static_cast<const long long*>(eL),
        static_cast<const long long*>(mi_hash),
        static_cast<const int*>(mi_sid), static_cast<const int*>(mi_wpos),
        static_cast<const long long*>(prev),
        static_cast<const long long*>(nxt), m, scap, ncap, c,
        static_cast<int*>(keys0), static_cast<int*>(pay0),
        static_cast<int*>(s_u), static_cast<int*>(sw0),
        static_cast<int*>(el_loc), static_cast<bool*>(overflow),
        static_cast<int*>(lp0));
  }
  return (int)cudaGetLastError();
}

// E2.  keys and rec (U, T) int32 sorted by K4, T <= 2045; sw0, eL_loc and
// lp0 (U,) int32, u_valid (U,) bool.  Outputs: dn, dq, jr, jm, scored and
// pos (U, T) int32; n_ev (U,) int32.
extern "C" int fa_events_scan(const void* keys, const void* rec,
                              const void* sw0, const void* el_loc,
                              const void* u_valid, const void* lp0,
                              int n_units, int T, int c, void* dn, void* dq,
                              void* jr, void* jm, void* scored, void* pos,
                              void* n_ev, void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  if (n_units > 0) {
    events_scan_kernel<<<n_units, 32 * kWarpsE2, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(rec),
        static_cast<const int*>(sw0), static_cast<const int*>(el_loc),
        static_cast<const bool*>(u_valid), static_cast<const int*>(lp0), T,
        c, static_cast<int*>(dn), static_cast<int*>(dq),
        static_cast<int*>(jr), static_cast<int*>(jm),
        static_cast<int*>(scored), static_cast<int*>(pos),
        static_cast<int*>(n_ev));
  }
  return (int)cudaGetLastError();
}
