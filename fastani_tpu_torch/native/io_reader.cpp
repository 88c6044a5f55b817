// Native FASTA/FASTQ parser of fastani_tpu_torch: the JAX package's
// fastani_tpu/native/io_reader.cpp, parsing a buffer the caller has read
// (and inflated, for .gz) instead of a file, so it builds with no zlib.
//
// Same record semantics as the reference's vendored kseq parser
// (reference: src/common/kseq.h, consumed at winSketch.hpp:141-147 and
// computeMap.hpp:122-132):
//   * records start at '>' (FASTA) or '@' (FASTQ) at line start;
//   * name = header text up to the first whitespace;
//   * sequence = concatenation of sequence lines (CR stripped);
//   * FASTQ '+' line and quality bytes (same count as sequence bytes) skipped.
//
// Output: one contiguous byte buffer plus per-record offsets, so a record
// is a view into the buffer (no per-record Python objects).
//
// C ABI (ctypes-friendly); thread-safe (no globals).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Records {
  std::vector<uint8_t> seq;        // concatenated sequence bytes
  std::vector<int64_t> offsets;    // n+1 prefix offsets into seq
  std::vector<std::string> names;  // record names
};

}  // namespace

extern "C" {

// Parse the n bytes of a FASTA/FASTQ file at d. Returns an opaque handle
// (never null); release it with fai_free().
void* fai_parse(const uint8_t* d, int64_t n) {
  Records* r = new Records();
  int64_t i = 0;
  r->offsets.push_back(0);

  // skip leading junk until the first record marker (kseq behavior)
  while (i < n && d[i] != '>' && d[i] != '@') {
    while (i < n && d[i] != '\n') i++;
    i++;
  }
  while (i < n) {
    const uint8_t marker = d[i];
    // header line
    int64_t eol = i;
    while (eol < n && d[eol] != '\n') eol++;
    int64_t name_beg = i + 1, name_end = name_beg;
    while (name_end < eol && d[name_end] != ' ' && d[name_end] != '\t' &&
           d[name_end] != '\r')
      name_end++;
    r->names.emplace_back(reinterpret_cast<const char*>(d + name_beg),
                          static_cast<size_t>(name_end - name_beg));
    i = eol + 1;

    const size_t seq_beg = r->seq.size();
    if (marker == '>') {  // FASTA: lines until next record marker
      while (i < n && d[i] != '>' && d[i] != '@') {
        eol = i;
        while (eol < n && d[eol] != '\n') eol++;
        int64_t end = eol;
        if (end > i && d[end - 1] == '\r') end--;
        r->seq.insert(r->seq.end(), d + i, d + end);
        i = eol + 1;
      }
    } else {  // FASTQ: sequence lines until '+', then skip qualities
      while (i < n && d[i] != '+') {
        eol = i;
        while (eol < n && d[eol] != '\n') eol++;
        int64_t end = eol;
        if (end > i && d[end - 1] == '\r') end--;
        r->seq.insert(r->seq.end(), d + i, d + end);
        i = eol + 1;
      }
      const int64_t seq_len = static_cast<int64_t>(r->seq.size() - seq_beg);
      // '+' line
      while (i < n && d[i] != '\n') i++;
      i++;
      int64_t qual = 0;
      while (i < n && qual < seq_len) {
        eol = i;
        while (eol < n && d[eol] != '\n') eol++;
        int64_t end = eol;
        if (end > i && d[end - 1] == '\r') end--;
        qual += end - i;
        i = eol + 1;
      }
    }
    r->offsets.push_back(static_cast<int64_t>(r->seq.size()));
  }
  return r;
}

int64_t fai_num_records(void* h) {
  return static_cast<int64_t>(static_cast<Records*>(h)->names.size());
}

int64_t fai_total_len(void* h) {
  return static_cast<int64_t>(static_cast<Records*>(h)->seq.size());
}

// Copy concatenated sequence bytes into caller-allocated buffer.
void fai_copy_seq(void* h, uint8_t* out) {
  Records* r = static_cast<Records*>(h);
  if (!r->seq.empty()) std::memcpy(out, r->seq.data(), r->seq.size());
}

// Copy n+1 prefix offsets into caller-allocated int64 buffer.
void fai_copy_offsets(void* h, int64_t* out) {
  Records* r = static_cast<Records*>(h);
  std::memcpy(out, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
}

const char* fai_name(void* h, int64_t i) {
  Records* r = static_cast<Records*>(h);
  if (i < 0 || i >= static_cast<int64_t>(r->names.size())) return nullptr;
  return r->names[static_cast<size_t>(i)].c_str();
}

void fai_free(void* h) { delete static_cast<Records*>(h); }

}  // extern "C"
