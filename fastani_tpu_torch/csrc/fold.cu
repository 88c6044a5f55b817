// The device CGI's fold of finished query genomes: per (query row,
// reference genome), the count of occupied bins and the float32 sum of
// their identities.
//
// Replaces the plain version's loop of elementwise adds,
// models/device_cgi.py::fold_rows_plain (FOLD_BLOCK bin columns gathered
// at a time, one add a bin column of the longest reference genome: one
// launch a bin), by one launch a finalize_rows call.  It is no port of a
// Pallas kernel: the JAX package folds in XLA code inside
// fastani_tpu/models/pipeline.py::map_queries_cgi_stream.
//
// rows (FIN, B_tot) int32 words: a bin's best identity as float32 bits,
// or -1 for an empty bin.  A reference genome's bins are one contiguous
// range [start[g], start[g] + len[g]) (device_cgi.genome_bins).  One
// thread per (row, genome) walks that range in bin order, counts the
// occupied bins and sums their identities as a left fold from 0.0, adding
// 0.0 for an empty bin: the order of device_cgi.fold_sequential and of
// the reference (computeCoreIdentity.hpp:267-297), so a sum is the plain
// version's bits.  __fadd_rn keeps the compiler from contracting or
// reordering the adds.
//
// Bound on this card: bytes by the roofline count (FIN x B_tot words read
// once, one add and one compare a word); what limits this design is each
// thread's chain of dependent adds, one a bin of its genome, with only
// FIN x Gr threads to hide it (64 on mid).  A simple kernel that is right:
// the fold it replaces was launch-bound on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void fold_rows_kernel(const int* __restrict__ rows,
                                 const int* __restrict__ start,
                                 const int* __restrict__ len, int fin,
                                 int b_tot, int gr, int* __restrict__ counts,
                                 float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= fin * gr) return;
  const int f = i / gr, g = i % gr;
  const int* row = rows + (long long)f * b_tot + start[g];
  const int n = len[g];
  int c = 0;
  float acc = 0.0f;
  for (int b = 0; b < n; ++b) {
    const int v = row[b];
    c += v >= 0;
    acc = __fadd_rn(acc, v >= 0 ? __int_as_float(v) : 0.0f);
  }
  counts[i] = c;
  sums[i] = acc;
}

}  // namespace

// rows (fin, b_tot) int32; start, len (gr,) int32; outputs counts (fin, gr)
// int32 and sums (fin, gr) float32.
extern "C" int fa_fold_rows(const void* rows, const void* start,
                            const void* len, int fin, int b_tot, int gr,
                            void* counts, void* sums, void* stream) {
  const int total = fin * gr;
  if (total > 0) {
    fold_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<const int*>(start),
        static_cast<const int*>(len), fin, b_tot, gr,
        static_cast<int*>(counts), static_cast<float*>(sums));
  }
  return (int)cudaGetLastError();
}
