// Fast Matrix Market parser — native data-loading path.
//
// The reference's file I/O hot spot is a per-nonzero strtol/strtod loop
// (CooMatrix::InitMarket, sparse_matrix.h:211-380; the
// comment there notes strtol/strtod is 2x faster than sscanf). This
// implementation keeps that idea and adds:
//   * one mmap-free bulk read + in-place pointer scanning,
//   * OpenMP-parallel chunked parsing (each thread scans a byte range
//     snapped to line boundaries),
//   * symmetric / skew-symmetric expansion and pattern defaults with
//     the same semantics as the reference and the Python parser.
//
// C API (ctypes): see sparsela/utils/native.py.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Header {
  int64_t num_rows = 0;
  int64_t num_cols = 0;
  int64_t nnz_declared = 0;
  bool symmetric = false;
  bool skew = false;
  bool pattern = false;
  bool array = false;
  bool complex_vals = false;
};

// Parse the banner + size line; returns the offset where entries start,
// or -1 on error.
int64_t parse_header(const char* buf, int64_t len, Header* h) {
  const char* p = buf;
  const char* end = buf + len;
  if (len < 14 || strncmp(p, "%%MatrixMarket", 14) != 0) return -1;
  const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
  if (!eol) return -1;
  std::string banner(p, eol - p);
  for (auto& c : banner) c = static_cast<char>(tolower(c));
  h->symmetric = banner.find("symmetric") != std::string::npos &&
                 banner.find("skew") == std::string::npos;
  h->skew = banner.find("skew") != std::string::npos;
  h->pattern = banner.find("pattern") != std::string::npos;
  h->array = banner.find("array") != std::string::npos;
  h->complex_vals = banner.find("complex") != std::string::npos;
  if (banner.find("hermitian") != std::string::npos) h->symmetric = true;
  p = eol + 1;
  while (p < end && *p == '%') {  // comments
    eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) return -1;
    p = eol + 1;
  }
  char* q = nullptr;
  h->num_rows = strtoll(p, &q, 10);
  if (q == p) return -1;
  p = q;
  h->num_cols = strtoll(p, &q, 10);
  if (q == p) return -1;
  p = q;
  if (h->array) {
    h->nnz_declared = h->num_rows * h->num_cols;
  } else {
    h->nnz_declared = strtoll(p, &q, 10);
    if (q == p) return -1;
    p = q;
  }
  eol = static_cast<const char*>(memchr(p, '\n', end - p));
  return eol ? (eol + 1 - buf) : len;
}

// Parse newline-separated entries in [start, end), writing at most
// `cap` of them (MM coordinate format, one per line). Stopping at cap
// bounds the writes for malformed/adversarial files whose body holds
// more entries than the header declares; the caller then rejects the
// file when the total differs from the declared nnz.
void parse_range(const char* p, const char* end, bool pattern,
                 double default_value, int32_t* rows, int32_t* cols,
                 double* vals, int64_t cap, int64_t* count) {
  int64_t n = 0;
  while (p < end && n < cap) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' ||
                       *p == '\t'))
      p++;
    if (p >= end) break;
    char* q = nullptr;
    long r = strtol(p, &q, 10);
    if (q == p) break;
    p = q;
    long c = strtol(p, &q, 10);
    if (q == p) break;
    p = q;
    double v = default_value;
    if (!pattern) {
      v = strtod(p, &q);
      if (q == p) v = default_value;  // reference fallback semantics
      p = q;
    }
    // skip rest of line (e.g. imaginary part of complex values)
    const char* eol =
        static_cast<const char*>(memchr(p, '\n', end - p));
    p = eol ? eol + 1 : end;
    rows[n] = static_cast<int32_t>(r - 1);
    cols[n] = static_cast<int32_t>(c - 1);
    vals[n] = v;
    n++;
  }
  *count = n;
}

}  // namespace

extern "C" {

// Reads a coordinate-format .mtx file. Returns 0 on success.
// Outputs are malloc'd by the library; caller frees via mtx_free.
// On output *nnz is the entry count after symmetric expansion.
int mtx_read(const char* path, double default_value, int64_t* num_rows,
             int64_t* num_cols, int64_t* nnz, int32_t** out_rows,
             int32_t** out_cols, double** out_vals, int32_t* is_array) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  int64_t len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(len) + 1);
  if (fread(buf.data(), 1, static_cast<size_t>(len), f) !=
      static_cast<size_t>(len)) {
    fclose(f);
    return 2;
  }
  fclose(f);
  buf[static_cast<size_t>(len)] = '\0';

  Header h;
  int64_t off = parse_header(buf.data(), len, &h);
  if (off < 0) return 3;
  *is_array = h.array ? 1 : 0;
  if (h.array) return 4;  // array format handled by the Python path

  const int64_t decl = h.nnz_declared;
  const char* body = buf.data() + off;
  const char* body_end = buf.data() + len;

  // Chunked parallel parse: split the byte range, snap chunk starts to
  // line boundaries, parse independently, then compact.
#ifdef _OPENMP
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  if (decl < 100000) nthreads = 1;
  std::vector<const char*> starts(nthreads + 1);
  int64_t body_len = body_end - body;
  for (int t = 0; t <= nthreads; t++) {
    const char* p = body + (body_len * t) / nthreads;
    if (t > 0 && t < nthreads) {
      const char* eol =
          static_cast<const char*>(memchr(p, '\n', body_end - p));
      p = eol ? eol + 1 : body_end;
    }
    starts[static_cast<size_t>(t)] = (t == nthreads) ? body_end : p;
  }

  std::vector<int64_t> counts(nthreads, 0);
  std::vector<std::vector<int32_t>> trows(nthreads), tcols(nthreads);
  std::vector<std::vector<double>> tvals(nthreads);
#ifdef _OPENMP
#pragma omp parallel for num_threads(nthreads) schedule(static, 1)
#endif
  for (int t = 0; t < nthreads; t++) {
    // Size per-thread buffers by the chunk's byte share, not the full
    // declared nnz (an entry line is >= 4 bytes: "1 1\n"), capped by
    // decl+16 so a malformed over-long body cannot overflow anything.
    int64_t chunk_bytes = starts[t + 1] - starts[t];
    int64_t cap64 = chunk_bytes / 4 + 2;
    if (cap64 > decl + 16) cap64 = decl + 16;
    size_t cap = static_cast<size_t>(cap64);
    trows[t].resize(cap);
    tcols[t].resize(cap);
    tvals[t].resize(cap);
    parse_range(starts[t], starts[t + 1], h.pattern, default_value,
                trows[t].data(), tcols[t].data(), tvals[t].data(),
                cap64, &counts[t]);
  }

  int64_t total = 0;
  for (int t = 0; t < nthreads; t++) total += counts[t];
  // Reject files whose parsed entry count differs from the declared
  // nnz (the reference and the Python fast path both error on excess
  // entries; short counts indicate a truncated/corrupt body).
  if (total != decl) return 6;

  // worst case doubling from symmetric expansion
  int64_t cap = (h.symmetric || h.skew) ? total * 2 : total;
  int32_t* rows =
      static_cast<int32_t*>(malloc(sizeof(int32_t) * cap));
  int32_t* cols =
      static_cast<int32_t*>(malloc(sizeof(int32_t) * cap));
  double* vals = static_cast<double*>(malloc(sizeof(double) * cap));
  if (!rows || !cols || !vals) return 5;

  int64_t w = 0;
  for (int t = 0; t < nthreads; t++) {
    memcpy(rows + w, trows[t].data(), sizeof(int32_t) * counts[t]);
    memcpy(cols + w, tcols[t].data(), sizeof(int32_t) * counts[t]);
    memcpy(vals + w, tvals[t].data(), sizeof(double) * counts[t]);
    w += counts[t];
  }

  if (h.symmetric || h.skew) {
    double sgn = h.skew ? -1.0 : 1.0;
    int64_t extra = 0;
    for (int64_t i = 0; i < total; i++) {
      if (rows[i] != cols[i]) {
        rows[total + extra] = cols[i];
        cols[total + extra] = rows[i];
        vals[total + extra] = sgn * vals[i];
        extra++;
      }
    }
    w = total + extra;
  }

  *num_rows = h.num_rows;
  *num_cols = h.num_cols;
  *nnz = w;
  *out_rows = rows;
  *out_cols = cols;
  *out_vals = vals;
  return 0;
}

void mtx_free(int32_t* rows, int32_t* cols, double* vals) {
  free(rows);
  free(cols);
  free(vals);
}

}  // extern "C"
