// Native parallel sparse-file parser (PIGO-equivalent).
//
// JAX-native analogue of the reference's vendored PIGO layer
// (reference: src/sparsebase/external/pigo/pigo.hpp, 3.9 kLoC;
// io/pigo_mtx_reader.cc, io/pigo_edge_list_reader.cc): memory-mapped
// input + OpenMP chunked numeric parsing. Exposed to Python through a
// plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Strategy: mmap the file; split the body into per-thread byte ranges
// aligned to line boundaries; two passes (count entries, then parse into
// preallocated arrays at per-chunk offsets). Integer and floating
// parsing are hand-rolled (strtod-free hot loop).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  madvise(p, st.st_size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  m.size = static_cast<size_t>(st.st_size);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = neg ? -v : v;
  return p;
}

inline const char* parse_f64(const char* p, const char* end, double* out) {
  p = skip_ws(p, end);
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  double v = 0.0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10.0 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double frac = 0.0, scale = 1.0;
    while (p < end && *p >= '0' && *p <= '9') {
      frac = frac * 10.0 + (*p - '0');
      scale *= 10.0;
      ++p;
    }
    v += frac / scale;
  }
  if (p < end && (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
    ++p;
    int64_t ex = 0;
    p = parse_i64(p, end, &ex);
    v *= std::pow(10.0, static_cast<double>(ex));
  }
  if (p == start) *out = 0.0;
  else *out = neg ? -v : v;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Split [begin, end) into nchunks line-aligned ranges.
std::vector<std::pair<const char*, const char*>> chunk_lines(
    const char* begin, const char* end, int nchunks) {
  std::vector<std::pair<const char*, const char*>> out;
  size_t total = static_cast<size_t>(end - begin);
  const char* cur = begin;
  for (int i = 0; i < nchunks && cur < end; ++i) {
    const char* target = begin + total * (i + 1) / nchunks;
    const char* stop = (i == nchunks - 1 || target >= end)
                           ? end
                           : next_line(target, end);
    if (stop < cur) stop = cur;
    out.emplace_back(cur, stop);
    cur = stop;
  }
  return out;
}

inline bool is_comment_or_blank(const char* p, const char* end) {
  p = skip_ws(p, end);
  return p >= end || *p == '\n' || *p == '%' || *p == '#';
}

int threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // namespace

extern "C" {

// Count data lines (non-comment, non-blank) after `offset` bytes.
// Returns -1 on error.
int64_t sbtpu_count_entries(const char* path, int64_t offset) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  if (offset >= static_cast<int64_t>(m.size)) {
    unmap(m);
    return 0;
  }
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  int64_t total = 0;
#pragma omp parallel for reduction(+ : total) schedule(dynamic)
  for (size_t c = 0; c < chunks.size(); ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    total += local;
  }
  unmap(m);
  return total;
}

// Parse whitespace-separated numeric triplets/pairs after `offset` bytes.
// ncols_data: numbers per line to read (2 = pattern, 3 = weighted).
// rows/cols: int64 output arrays of length n; vals: double array or null.
// Returns number of parsed entries, or -1 on error.
int64_t sbtpu_parse_entries(const char* path, int64_t offset, int ncols_data,
                            int64_t n, int64_t* rows, int64_t* cols,
                            double* vals) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  if (offset >= static_cast<int64_t>(m.size)) {
    unmap(m);
    return 0;
  }
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  size_t nchunk = chunks.size();
  // pass 1: per-chunk entry counts -> offsets
  std::vector<int64_t> counts(nchunk, 0);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    counts[c] = local;
  }
  std::vector<int64_t> offsets(nchunk + 1, 0);
  for (size_t c = 0; c < nchunk; ++c) offsets[c + 1] = offsets[c] + counts[c];
  int64_t total = std::min<int64_t>(offsets[nchunk], n);
  // pass 2: parse
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t at = offsets[c];
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) {
        if (at < n) {
          int64_t r = 0, cc = 0;
          const char* q = parse_i64(p, stop, &r);
          q = parse_i64(q, stop, &cc);
          rows[at] = r;
          cols[at] = cc;
          if (ncols_data >= 3 && vals != nullptr) {
            double v = 0.0;
            parse_f64(q, stop, &v);
            vals[at] = v;
          }
        }
        ++at;
      }
      p = next_line(p, stop);
    }
  }
  unmap(m);
  return total;
}

// Parse a dense column of numbers (MTX array format body).
int64_t sbtpu_parse_values(const char* path, int64_t offset, int64_t n,
                           double* vals) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* begin = m.data + offset;
  const char* end = m.data + m.size;
  auto chunks = chunk_lines(begin, end, threads() * 4);
  size_t nchunk = chunks.size();
  std::vector<int64_t> counts(nchunk, 0);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t local = 0;
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) ++local;
      p = next_line(p, stop);
    }
    counts[c] = local;
  }
  std::vector<int64_t> offsets(nchunk + 1, 0);
  for (size_t c = 0; c < nchunk; ++c) offsets[c + 1] = offsets[c] + counts[c];
  int64_t total = std::min<int64_t>(offsets[nchunk], n);
#pragma omp parallel for schedule(dynamic)
  for (size_t c = 0; c < nchunk; ++c) {
    const char* p = chunks[c].first;
    const char* stop = chunks[c].second;
    int64_t at = offsets[c];
    while (p < stop) {
      if (!is_comment_or_blank(p, stop)) {
        if (at < n) {
          double v = 0.0;
          parse_f64(p, stop, &v);
          vals[at] = v;
        }
        ++at;
      }
      p = next_line(p, stop);
    }
  }
  unmap(m);
  return total;
}

// Parallel binary write/read (SBFF data plane; PIGO WFile/ROFile analogue).
int64_t sbtpu_write_file(const char* path, const char* data, int64_t size) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t written = fwrite(data, 1, static_cast<size_t>(size), f);
  fclose(f);
  return static_cast<int64_t>(written);
}

// Parallel argsort by (major, minor) — the host-side row-major COO sort
// (PIGO's reading path ends in the same sort inside the reference's COO
// ctor, format/coo.cc:112-140). np.lexsort is single-threaded and costs
// ~35 s at 50M entries on this box; packing both keys into one uint64
// and gnu-parallel-sorting (key, index) pairs runs the same sort in a
// few seconds on the available cores. Sorting (key, idx) pairs makes
// ties resolve by original position = exactly np.lexsort's stability.
// width flags: 1 = int64 input, 0 = int32.
int64_t sbtpu_argsort_pairs(int64_t n, const void* major, const void* minor,
                            int major64, int minor64, int64_t* order) {
  if (n <= 0) return 0;
  auto get = [](const void* p, int is64, int64_t i) -> int64_t {
    return is64 ? static_cast<const int64_t*>(p)[i]
                : static_cast<int64_t>(static_cast<const int32_t*>(p)[i]);
  };
  // packable iff both keys fit in uint32 (nonnegative < 2^32)
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int64_t a = get(major, major64, i);
    int64_t b = get(minor, minor64, i);
    packable = packable && a >= 0 && a < (int64_t(1) << 32) && b >= 0 &&
               b < (int64_t(1) << 32);
  }
  using P = std::pair<uint64_t, int64_t>;
  std::vector<P> buf(static_cast<size_t>(n));
  if (packable) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
      buf[i] = {(static_cast<uint64_t>(get(major, major64, i)) << 32) |
                    static_cast<uint32_t>(get(minor, minor64, i)),
                i};
#ifdef _OPENMP
    __gnu_parallel::sort(buf.begin(), buf.end());
#else
    std::sort(buf.begin(), buf.end());
#endif
  } else {
    for (int64_t i = 0; i < n; ++i) buf[i] = {0, i};
    std::sort(buf.begin(), buf.end(), [&](const P& x, const P& y) {
      int64_t ax = get(major, major64, x.second), ay = get(major, major64, y.second);
      if (ax != ay) return ax < ay;
      int64_t bx = get(minor, minor64, x.second), by = get(minor, minor64, y.second);
      if (bx != by) return bx < by;
      return x.second < y.second;
    });
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) order[i] = buf[i].second;
  return n;
}

// In-place row-major sort of a PATTERN pair list (no payload): pack the
// (major, minor) u32 keys into one uint64, gnu-parallel-sort the packed
// keys directly, unpack. Half the memory traffic of the (key, index)
// argsort (8 B vs 16 B per element), no order array, and callers skip
// the two apply-gathers — duplicates are bit-identical so stability is
// unobservable. Returns 1 on success, 0 if keys don't fit u32 (caller
// falls back to sbtpu_argsort_pairs).
int64_t sbtpu_sort_packed(int64_t n, int64_t* major, int64_t* minor) {
  if (n <= 0) return 1;
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    packable = packable && major[i] >= 0 && major[i] < (int64_t(1) << 32) &&
               minor[i] >= 0 && minor[i] < (int64_t(1) << 32);
  }
  if (!packable) return 0;
  std::vector<uint64_t> buf(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    buf[i] = (static_cast<uint64_t>(major[i]) << 32) |
             static_cast<uint32_t>(minor[i]);
#ifdef _OPENMP
  __gnu_parallel::sort(buf.begin(), buf.end());
#else
  std::sort(buf.begin(), buf.end());
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    major[i] = static_cast<int64_t>(buf[i] >> 32);
    minor[i] = static_cast<int64_t>(buf[i] & 0xffffffffu);
  }
  return 1;
}

// Weighted variant: sort (packed u64 key, f64 value) structs by key in
// place — the value rides the sort, so callers skip the (key, index)
// argsort AND the three apply-gathers. Unstable ties are unobservable
// (duplicate coordinates accumulate). Returns 1, or 0 if keys exceed
// u32 (caller falls back to argsort).
int64_t sbtpu_sort_packed_weighted(int64_t n, int64_t* major, int64_t* minor,
                                   double* vals) {
  if (n <= 0) return 1;
  bool packable = true;
#pragma omp parallel for reduction(&& : packable) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    packable = packable && major[i] >= 0 && major[i] < (int64_t(1) << 32) &&
               minor[i] >= 0 && minor[i] < (int64_t(1) << 32);
  }
  if (!packable) return 0;
  using P = std::pair<uint64_t, double>;
  std::vector<P> buf(static_cast<size_t>(n));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    buf[i] = {(static_cast<uint64_t>(major[i]) << 32) |
                  static_cast<uint32_t>(minor[i]),
              vals[i]};
#ifdef _OPENMP
  __gnu_parallel::sort(buf.begin(), buf.end(),
                       [](const P& a, const P& b) { return a.first < b.first; });
#else
  std::sort(buf.begin(), buf.end(),
            [](const P& a, const P& b) { return a.first < b.first; });
#endif
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    major[i] = static_cast<int64_t>(buf[i].first >> 32);
    minor[i] = static_cast<int64_t>(buf[i].first & 0xffffffffu);
    vals[i] = buf[i].second;
  }
  return 1;
}

int64_t sbtpu_read_file(const char* path, char* out, int64_t size) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t n = std::min<int64_t>(size, static_cast<int64_t>(m.size));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i += (1 << 20)) {
    int64_t len = std::min<int64_t>(1 << 20, n - i);
    memcpy(out + i, m.data + i, static_cast<size_t>(len));
  }
  unmap(m);
  return n;
}

}  // extern "C"
