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
// jr = #{q <= h} come from two binary searches over the unit's sorted,
// UMAX-padded sketch row, staged in shared memory once a block (at most
// MAX_SCAP = 1023 words).  It writes the (U, T = 2 ncap + 1) int32 key
// and payload rows K4 sorts: enter events (value lp - C + 1, code 0),
// leave events (value lp, entries 1.., code 1) and the scoring event at
// sw0 (code 2), keys min(value + C, CLAMP) << 2 | code; payload records
// ql | jr << 10 | inq << 20 | nonq << 21 | link << 22, the leave records
// shifted right by one (the j-th leave evicts entry j - 1), and the
// per-unit s_u, sw0, eL_loc, overflow and lp[0].
//
// E2 (events_scan_kernel), per unit, one ordered pass over its T sorted
// events: the running leave and enter counts lb_t and le_t (inclusive),
// eff, dn and dq, run_end by a one-event look-ahead, scored, and the
// position of the most recent leave (lp[0] before any), the six (U, T)
// int32 rows K5 walks, and n_ev (the real events: value below CLAMP).
//
// Bound on this card: bytes by the roofline count (E1 reads ncap entries
// of 32 bytes and writes 8 bytes an event; E2 reads 8 and writes 24 bytes
// an event).  What limits this design: E1 runs one block of 256 threads a
// unit, each thread a few entries with coalesced loads along the unit's
// contiguous entry window, and its two binary searches are ~20 dependent
// shared-memory loads an entry.  E2 runs one warp a unit, 32 events a
// step with coalesced loads along the row: the counts are ballots and a
// popcount prefix, the last leave's value comes by a shuffle from the
// highest leave lane at or below each lane, the look-ahead by a shuffle
// down (lane 31 takes the next step's lane 0, loaded one step ahead), and
// the running totals are carried from step to step.  A unit's pass is a
// chain of T / 32 steps, so E2's time is set by that chain's latency and
// the warps in flight (U warps), not by bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kUmax = 0xFFFFFFFFu;
constexpr long long kPinf = 1LL << 30;   // position infinity (xputils.PINF)
constexpr long long kClamp = 1LL << 28;  // l2walk.CLAMP
constexpr int kMaxScap = 1023;           // l2walk.MAX_SCAP
constexpr int kThreadsE1 = 256;
constexpr int kUnitsE2 = 4;              // warps (units) a block of E2

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

// #{j < n : q[j] <= h} over an ascending row
__device__ __forceinline__ int upper_bound(const unsigned* q, int n,
                                           unsigned h) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (q[lo + half] <= h) {
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

__global__ void __launch_bounds__(kThreadsE1) events_kernel(
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
  const long long f = frag[u];
  const long long* qrow = qh + f * scap;
  for (int j = threadIdx.x; j < scap; j += blockDim.x) {
    q[j] = (unsigned)qrow[j];
  }
  const bool valid = u_valid[u];
  const long long sid = valid ? (long long)u_sid[u] : 0;
  const long long base = clampll(b0[u], 0, m - ncap);
  const long long s_f = s[f];
  __syncthreads();

  const long long T = 2LL * ncap + 1;
  int* krow = keys0 + (long long)u * T;
  int* prow = pay0 + (long long)u * T;
  for (int i = threadIdx.x; i < ncap; i += blockDim.x) {
    const long long idx = base + i;
    const bool inc = (long long)mi_sid[idx] == sid;
    const unsigned h = inc ? (unsigned)mi_hash[idx] : kUmax;
    const long long lp = inc ? (long long)mi_wpos[idx] : kPinf;
    const long long pv = prev[idx] - base;
    const long long nx = nxt[idx] - base;
    const int ql = lower_bound(q, scap, h);
    const int jr = upper_bound(q, scap, h);
    const unsigned q_at = q[ql < scap - 1 ? ql : scap - 1];
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

__global__ void __launch_bounds__(32 * kUnitsE2) events_scan_kernel(
    const int* __restrict__ keys, const int* __restrict__ rec,
    const int* __restrict__ sw0, const int* __restrict__ el_loc,
    const bool* __restrict__ u_valid, const int* __restrict__ lp0, int n_units,
    int T, int c, int* __restrict__ dn, int* __restrict__ dq,
    int* __restrict__ jr, int* __restrict__ jm, int* __restrict__ scored,
    int* __restrict__ pos, int* __restrict__ n_ev) {
  const int u = blockIdx.x * kUnitsE2 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= n_units) return;                  // the whole warp leaves
  const long long off = (long long)u * T;
  const int* krow = keys + off;
  const int* rrow = rec + off;
  const int thr = sw0[u] + c;
  const int eloc = el_loc[u];
  const bool valid = u_valid[u];
  const int pad = (int)(kClamp << 2);        // not a real event
  const unsigned upto = (2u << lane) - 1u;   // lanes <= this one

  int lb = 0, le = 0, n_real = 0;
  int last = lp0[u];                         // the last leave's position
  int key = lane < T ? krow[lane] : pad;
  int r = lane < T ? rrow[lane] : 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int tn = t + 32;
    const int key_n = tn < T ? krow[tn] : pad;
    const int r_n = tn < T ? rrow[tn] : 0;
    // look-ahead: the next event's key (lane 31: the next step's lane 0)
    int nk = __shfl_down_sync(kFull, key, 1);
    const int nk0 = __shfl_sync(kFull, key_n, 0);
    if (lane == 31) nk = nk0;
    const int vt = key >> 2;
    const int code = key & 3;
    const bool real = vt < kClamp;
    const bool enter = code == 0 && real;
    const bool leave = code == 1 && real;
    const unsigned bl = __ballot_sync(kFull, leave);
    const unsigned be = __ballot_sync(kFull, enter);
    const unsigned br = __ballot_sync(kFull, real);
    const int lb_t = lb + __popc(bl & upto);
    const int le_t = le + __popc(be & upto);
    const int pvnx = (r >> 22) & 0x3FF;
    const bool eff = enter ? (pvnx - 1) < lb_t : pvnx >= le_t;
    const int sign = enter ? 1 : -1;
    const bool live = enter || leave;
    const bool run_end = t + 1 >= T || vt != (nk >> 2);
    // the most recent leave at or before this event: the highest leave
    // lane at or below this one, else the carry from earlier steps
    const int lv = vt - c;
    const unsigned mine = bl & upto;
    const int src = mine ? 31 - __clz(mine) : lane;
    const int got = __shfl_sync(kFull, lv, src);
    const int p = mine ? got : last;
    if (bl) last = __shfl_sync(kFull, lv, 31 - __clz(bl));
    if (t < T) {
      dn[off + t] = (live && eff && ((r >> 21) & 1)) ? sign : 0;
      dq[off + t] = (live && eff && ((r >> 20) & 1)) ? sign : 0;
      jr[off + t] = (r >> 10) & 0x3FF;
      jm[off + t] = r & 0x3FF;
      scored[off + t] = run_end && real && vt >= thr && le_t < eloc && valid;
      pos[off + t] = p;
    }
    lb += __popc(bl);
    le += __popc(be);
    n_real += __popc(br);
    key = key_n;
    r = r_n;
  }
  if (lane == 0) n_ev[u] = n_real;
}

}  // namespace

// E1.  qh (F, scap) int64 u32 values, s (F,) int64, frag (U,) int64,
// u_sid (U,) int32, u_valid (U,) bool, b0 and eL (U,) int64; the index
// tables over m entries: mi_hash int64, mi_sid and mi_wpos int32, prev and
// nxt int64.  Outputs: keys0 and pay0 (U, 2 ncap + 1) int32; s_u, sw0,
// eL_loc and lp0 (U,) int32; overflow (U,) bool.  Needs m >= ncap,
// scap <= 1023 and every frag[u] < F.
extern "C" int fa_events(const void* qh, const void* s, const void* frag,
                         const void* u_sid, const void* u_valid,
                         const void* b0, const void* eL, const void* mi_hash,
                         const void* mi_sid, const void* mi_wpos,
                         const void* prev, const void* nxt, int n_units,
                         long long m, int scap, int ncap, int c, void* keys0,
                         void* pay0, void* s_u, void* sw0, void* el_loc,
                         void* overflow, void* lp0, void* stream) {
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

// E2.  keys and rec (U, T) int32 sorted by K4; sw0, eL_loc and lp0 (U,)
// int32, u_valid (U,) bool.  Outputs: dn, dq, jr, jm, scored and pos
// (U, T) int32; n_ev (U,) int32.
extern "C" int fa_events_scan(const void* keys, const void* rec,
                              const void* sw0, const void* el_loc,
                              const void* u_valid, const void* lp0,
                              int n_units, int T, int c, void* dn, void* dq,
                              void* jr, void* jm, void* scored, void* pos,
                              void* n_ev, void* stream) {
  if (n_units > 0) {
    const int blocks = (n_units + kUnitsE2 - 1) / kUnitsE2;
    events_scan_kernel<<<blocks, 32 * kUnitsE2, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const int*>(rec),
        static_cast<const int*>(sw0), static_cast<const int*>(el_loc),
        static_cast<const bool*>(u_valid), static_cast<const int*>(lp0),
        n_units, T, c, static_cast<int*>(dn), static_cast<int*>(dq),
        static_cast<int*>(jr), static_cast<int*>(jm),
        static_cast<int*>(scored), static_cast<int*>(pos),
        static_cast<int*>(n_ev));
  }
  return (int)cudaGetLastError();
}
