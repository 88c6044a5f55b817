// K5: the L2 event walk.
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
// Bound on this card: operations by the roofline count (about four per
// event and query rank below s, against 24 bytes per event read once); what
// limits this design is the dependent chain of n_ev steps per unit, two warp
// reductions each.  Design: units are independent, so one warp walks one unit
// with its state in registers — lane l holds ranks l, l+32, ... — and j*
// and cnt are warp reductions (__reduce_add_sync), with no shared memory
// and no block barrier.  The warp reads 32 events at a time, one per lane,
// coalesced, and broadcasts them with shuffles.  Each unit loops to its own
// n_ev (the Pallas kernel ran every unit of a block to the block maximum).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kNoScore = -5;
constexpr int kThreads = 128;     // 4 units per block

template <int NJ>
__global__ void walk_kernel(const int* __restrict__ dn,
                            const int* __restrict__ dq,
                            const int* __restrict__ jr,
                            const int* __restrict__ jm,
                            const int* __restrict__ scored,
                            const int* __restrict__ pos,
                            const int* __restrict__ s_u,
                            const int* __restrict__ n_ev, int U, int T,
                            int scap, int* __restrict__ best_out,
                            int* __restrict__ posf_out,
                            int* __restrict__ posl_out) {
  const int u = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (u >= U) return;                  // uniform across the warp
  const int s = s_u[u];
  const int n = n_ev[u];
  int m[NJ], pres[NJ];
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    m[q] = lane + 32 * q;
    pres[q] = 0;
  }
  int best = -1, posf = 0, posl = 0;
  const size_t row = (size_t)u * T;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    int a_dn = 0, a_dq = 0, a_jr = 0, a_jm = 0, a_sc = 0, a_pos = 0;
    if (t < n) {
      a_dn = dn[row + t];
      a_dq = dq[row + t];
      a_jr = jr[row + t];
      a_jm = jm[row + t];
      a_sc = scored[row + t];
      a_pos = pos[row + t];
    }
    const int cnt_ev = min(32, n - t0);
    for (int e = 0; e < cnt_ev; ++e) {
      const int e_dn = __shfl_sync(kFull, a_dn, e);
      const int e_dq = __shfl_sync(kFull, a_dq, e);
      const int e_jr = __shfl_sync(kFull, a_jr, e);
      const int e_jm = __shfl_sync(kFull, a_jm, e);
      const int e_sc = __shfl_sync(kFull, a_sc, e);
      const int e_pos = __shfl_sync(kFull, a_pos, e);
      unsigned below = 0;
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j >= e_jr) m[q] += e_dn;
        if (j == e_jm) pres[q] += e_dq;
        below += (j < scap && m[q] < s) ? 1u : 0u;
      }
      const int jstar = (int)__reduce_add_sync(kFull, below);
      unsigned present = 0;
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        present += (j < scap && j < jstar && pres[q] > 0) ? 1u : 0u;
      }
      const int cnt = (int)__reduce_add_sync(kFull, present);
      const int sc = e_sc ? cnt : kNoScore;
      if (sc > best) posf = e_pos;
      if (sc >= best) posl = e_pos;
      best = max(best, sc);
    }
  }
  if (lane == 0) {
    best_out[u] = best;
    posf_out[u] = posf;
    posl_out[u] = posl;
  }
}

template <int NJ>
int launch(const int* dn, const int* dq, const int* jr, const int* jm,
           const int* sc, const int* pos, const int* s_u, const int* n_ev,
           int U, int T, int scap, int* best, int* posf, int* posl,
           cudaStream_t s) {
  const int blocks = (U * 32 + kThreads - 1) / kThreads;
  walk_kernel<NJ><<<blocks, kThreads, 0, s>>>(dn, dq, jr, jm, sc, pos, s_u,
                                               n_ev, U, T, scap, best, posf,
                                               posl);
  return (int)cudaGetLastError();
}

}  // namespace

// six (U, T) int32 event arrays (dn, dq, jr, jm, scored, pos), s_u and n_ev
// (U,) int32; outputs best, posf, posl (U,) int32.  scap <= 1024.
extern "C" int fa_walk(const void* dn, const void* dq, const void* jr,
                       const void* jm, const void* scored, const void* pos,
                       const void* s_u, const void* n_ev, int U, int T,
                       int scap, void* best, void* posf, void* posl,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const int*>(p); };
  int* b = static_cast<int*>(best);
  int* pf = static_cast<int*>(posf);
  int* pl = static_cast<int*>(posl);
  if (scap <= 128)
    return launch<4>(c(dn), c(dq), c(jr), c(jm), c(scored), c(pos), c(s_u),
                     c(n_ev), U, T, scap, b, pf, pl, s);
  if (scap <= 256)
    return launch<8>(c(dn), c(dq), c(jr), c(jm), c(scored), c(pos), c(s_u),
                     c(n_ev), U, T, scap, b, pf, pl, s);
  if (scap <= 512)
    return launch<16>(c(dn), c(dq), c(jr), c(jm), c(scored), c(pos), c(s_u),
                      c(n_ev), U, T, scap, b, pf, pl, s);
  return launch<32>(c(dn), c(dq), c(jr), c(jm), c(scored), c(pos), c(s_u),
                    c(n_ev), U, T, scap, b, pf, pl, s);
}
