// cvr_native: native (C++/OpenMP) kernels for the cvr_tpu host runtime.
//
// Re-implementation of the reference's host-side native layer:
//   * MatrixMarket parsing (ref: readMatrix spmv.cpp:311-535 and the
//     vendored mmio.{h,cpp}) — here mmap + parallel newline-partitioned
//     parsing with C++17 from_chars.
//   * COO -> CSR assembly (ref: qsort + scan, spmv.cpp:485-526) — here a
//     parallel counting sort by row (stable within a row).
//   * CSR -> SELL-pack planning + fill (ref: the AVX-512 tracker converter
//     pre_processing, spmv.cpp:565-1014) — here segment splitting, a
//     parallel length sort, and an OpenMP fill of the slot-major planes.
//
// Exposed as a C ABI consumed via ctypes (cvr_tpu/_native.py).  All output
// buffers are allocated by the Python caller (NumPy) so ownership never
// crosses the library boundary; the two-phase plan/fill protocol lets the
// caller size buffers exactly.

#include <algorithm>
#include <atomic>
#include <cstdlib>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Error reporting
// ---------------------------------------------------------------------------
static thread_local char g_err[256];

const char* cvr_last_error() { return g_err; }

static int fail(const char* msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
  return -1;
}

// ---------------------------------------------------------------------------
// MatrixMarket parser
// ---------------------------------------------------------------------------
// Header flags returned by cvr_mtx_open.
enum {
  CVR_FIELD_REAL = 0,
  CVR_FIELD_INTEGER = 1,
  CVR_FIELD_PATTERN = 2,
  CVR_FIELD_COMPLEX = 3,
};
enum {
  CVR_SYM_GENERAL = 0,
  CVR_SYM_SYMMETRIC = 1,
  CVR_SYM_SKEW = 2,
  CVR_SYM_HERMITIAN = 3,
};

struct MtxFile {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  size_t body_off = 0;  // first data byte after the size line
  int64_t nrows = 0, ncols = 0, nnz = 0;
  int field = 0, symmetry = 0;
};

static bool ci_equal(const std::string& a, const char* b) {
  if (a.size() != std::strlen(b)) return false;
  for (size_t i = 0; i < a.size(); i++)
    if (std::tolower((unsigned char)a[i]) != b[i]) return false;
  return true;
}

// Opens + header-parses; returns a handle id (>=0) or -1.
static MtxFile g_files[64];
static std::atomic<int> g_nfiles{0};

int cvr_mtx_open(const char* path, int64_t* nrows, int64_t* ncols,
                 int64_t* nnz, int* field, int* symmetry) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return fail("open() failed");
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return fail("fstat() failed");
  }
  size_t size = (size_t)st.st_size;
  const char* data =
      (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (data == MAP_FAILED) {
    ::close(fd);
    return fail("mmap() failed");
  }

  // Parse banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  // Every post-mmap failure must release the fd and the whole-file
  // mapping (a sweep over many bad files would otherwise exhaust fds).
  auto fail_open = [&](const char* msg) {
    munmap((void*)data, size);
    ::close(fd);
    return fail(msg);
  };
  size_t pos = 0;
  auto read_line = [&](std::string& out) -> bool {
    if (pos >= size) return false;
    size_t end = pos;
    while (end < size && data[end] != '\n') end++;
    out.assign(data + pos, end - pos);
    pos = end + 1;
    return true;
  };
  std::string line;
  if (!read_line(line)) return fail_open("empty file");
  {
    std::vector<std::string> tok;
    size_t i = 0;
    while (i < line.size()) {
      while (i < line.size() && std::isspace((unsigned char)line[i])) i++;
      size_t j = i;
      while (j < line.size() && !std::isspace((unsigned char)line[j])) j++;
      if (j > i) tok.push_back(line.substr(i, j - i));
      i = j;
    }
    if (tok.size() != 5 || tok[0] != "%%MatrixMarket")
      return fail_open("bad MatrixMarket banner");
    if (!ci_equal(tok[1], "matrix")) return fail_open("unsupported object");
    if (!ci_equal(tok[2], "coordinate"))
      return fail_open("native parser handles coordinate format only");
    MtxFile f;
    if (ci_equal(tok[3], "real")) f.field = CVR_FIELD_REAL;
    else if (ci_equal(tok[3], "integer")) f.field = CVR_FIELD_INTEGER;
    else if (ci_equal(tok[3], "pattern")) f.field = CVR_FIELD_PATTERN;
    else if (ci_equal(tok[3], "complex")) f.field = CVR_FIELD_COMPLEX;
    else return fail_open("unsupported field");
    if (ci_equal(tok[4], "general")) f.symmetry = CVR_SYM_GENERAL;
    else if (ci_equal(tok[4], "symmetric")) f.symmetry = CVR_SYM_SYMMETRIC;
    else if (ci_equal(tok[4], "skew-symmetric")) f.symmetry = CVR_SYM_SKEW;
    else if (ci_equal(tok[4], "hermitian")) f.symmetry = CVR_SYM_HERMITIAN;
    else return fail_open("unsupported symmetry");

    // Skip comments/blank lines to the size line.
    while (read_line(line)) {
      if (!line.empty() && line[0] != '%') {
        bool blank = true;
        for (char ch : line)
          if (!std::isspace((unsigned char)ch)) { blank = false; break; }
        if (!blank) break;
      }
    }
    const char* p = line.c_str();
    const char* e = p + line.size();
    auto skip_ws = [&]() { while (p < e && std::isspace((unsigned char)*p)) p++; };
    skip_ws();
    auto r1 = std::from_chars(p, e, f.nrows); p = r1.ptr; skip_ws();
    auto r2 = std::from_chars(p, e, f.ncols); p = r2.ptr; skip_ws();
    auto r3 = std::from_chars(p, e, f.nnz);
    if (r1.ec != std::errc() || r2.ec != std::errc() || r3.ec != std::errc())
      return fail_open("bad size line");

    f.fd = fd;
    f.data = data;
    f.size = size;
    f.body_off = pos;
    // reuse closed slots so long sweeps never exhaust the table
    int id = -1;
    int n = g_nfiles.load();
    for (int k = 0; k < n; k++)
      if (g_files[k].data == nullptr && g_files[k].fd < 0) { id = k; break; }
    if (id < 0) {
      id = g_nfiles.fetch_add(1);
      if (id >= 64) {
        g_nfiles.fetch_sub(1);
        return fail_open("too many open mtx files");
      }
    }
    g_files[id] = f;
    *nrows = f.nrows;
    *ncols = f.ncols;
    *nnz = f.nnz;
    *field = f.field;
    *symmetry = f.symmetry;
    return id;
  }
}

// Parses the body into caller-allocated rows/cols/vals (each length nnz).
// pattern matrices: vals filled with (index % 13) or 1.0 per mode.
// complex: real part kept.  1-based -> 0-based conversion applied.
int cvr_mtx_read(int handle, int32_t* rows, int32_t* cols, float* vals,
                 int pattern_mode /*0=mod13, 1=ones*/) {
  if (handle < 0 || handle >= g_nfiles.load()) return fail("bad handle");
  const MtxFile& f = g_files[handle];
  const char* base = f.data + f.body_off;
  size_t len = f.size - f.body_off;
  const int64_t nnz = f.nnz;
  const bool has_val =
      (f.field == CVR_FIELD_REAL || f.field == CVR_FIELD_INTEGER ||
       f.field == CVR_FIELD_COMPLEX);

  // Find the byte offset of every entry start: entries are separated by
  // newlines; comment lines inside the body are not allowed by the spec.
  // Chunked two-pass: count newlines per chunk, prefix-sum, then parse.
  const int T = std::max(1, omp_get_max_threads());
  std::vector<size_t> chunk_begin(T + 1, len);
  for (int t = 0; t <= T; t++) {
    size_t target = len * (size_t)t / (size_t)T;
    // advance to start of next line
    if (t == 0) { chunk_begin[0] = 0; continue; }
    size_t p = target;
    while (p < len && base[p] != '\n') p++;
    chunk_begin[t] = (p < len) ? p + 1 : len;
  }
  std::vector<int64_t> counts(T + 1, 0);
#pragma omp parallel for schedule(static)
  for (int t = 0; t < T; t++) {
    int64_t c = 0;
    const char* p = base + chunk_begin[t];
    const char* e = base + chunk_begin[t + 1];
    while (p < e) {
      // a line counts if it contains a non-space character
      const char* q = (const char*)memchr(p, '\n', (size_t)(e - p));
      const char* lineend = q ? q : e;
      for (const char* s = p; s < lineend; s++)
        if (!std::isspace((unsigned char)*s)) { c++; break; }
      p = q ? q + 1 : e;
    }
    counts[t + 1] = c;
  }
  for (int t = 0; t < T; t++) counts[t + 1] += counts[t];
  if (counts[T] < nnz) return fail("fewer entries than header nnz");

  std::atomic<int> err{0};
#pragma omp parallel for schedule(static)
  for (int t = 0; t < T; t++) {
    int64_t idx = counts[t];
    const char* p = base + chunk_begin[t];
    const char* e = base + chunk_begin[t + 1];
    while (p < e && idx < nnz) {
      const char* q = (const char*)memchr(p, '\n', (size_t)(e - p));
      const char* lineend = q ? q : e;
      // skip blank lines
      const char* s = p;
      while (s < lineend && std::isspace((unsigned char)*s)) s++;
      if (s < lineend) {
        int64_t r = 0, c = 0;
        auto rr = std::from_chars(s, lineend, r);
        s = rr.ptr;
        while (s < lineend && std::isspace((unsigned char)*s)) s++;
        auto rc = std::from_chars(s, lineend, c);
        s = rc.ptr;
        if (rr.ec != std::errc() || rc.ec != std::errc() ||
            r < 1 || c < 1 || r > f.nrows || c > f.ncols) {
          // range-validate HERE — indices flow unchecked into the
          // pack passes' histogram/flag writes, so an out-of-range
          // entry in an untrusted file must die as a parse error,
          // not as a heap write
          err.store(1);
        } else {
          rows[idx] = (int32_t)(r - 1);
          cols[idx] = (int32_t)(c - 1);
          if (has_val) {
            while (s < lineend && std::isspace((unsigned char)*s)) s++;
            if (s < lineend && *s == '+') s++;  // from_chars rejects '+'
            float v = 0.f;
            auto rv = std::from_chars(s, lineend, v);
            if (rv.ec != std::errc()) {
              // fall back for "1e3."-style oddities; copy to a bounded
              // NUL-terminated buffer — strtof on the raw mmap could
              // scan past the mapping when the file lacks a trailing
              // newline at a page boundary
              char buf[64];
              size_t bl = std::min(
                  (size_t)(lineend - s), sizeof(buf) - 1);
              std::memcpy(buf, s, bl);
              buf[bl] = 0;
              v = strtof(buf, nullptr);
            }
            vals[idx] = v;
          } else {
            vals[idx] = pattern_mode == 0 ? (float)(idx % 13) : 1.0f;
          }
          idx++;
        }
      }
      p = q ? q + 1 : e;
    }
  }
  if (err.load()) return fail("parse error in matrix body");
  return 0;
}

int cvr_mtx_close(int handle) {
  if (handle < 0 || handle >= g_nfiles.load()) return fail("bad handle");
  MtxFile& f = g_files[handle];
  if (f.data) munmap((void*)f.data, f.size);
  if (f.fd >= 0) ::close(f.fd);
  f.data = nullptr;
  f.fd = -1;
  return 0;
}

// ---------------------------------------------------------------------------
// COO -> CSR (parallel counting sort by row; stable, preserves file order
// within a row — same result as the reference's qsort by (row, col) only
// when input columns are presorted; we keep file order like scipy).
// ---------------------------------------------------------------------------
int cvr_coo_to_csr(int64_t nrows, int64_t nnz, const int32_t* rows,
                   const int32_t* cols, const float* vals, int64_t* rowptr,
                   int32_t* out_cols, float* out_vals) {
  std::vector<int64_t> count(nrows + 1, 0);
  for (int64_t i = 0; i < nnz; i++) {
    int32_t r = rows[i];
    if (r < 0 || r >= nrows) return fail("row index out of range");
    // negative cols would index before downstream histogram buffers
    // (the upper bound is checked against ncols by the parser / the
    // Python container; a negative here is always caller error)
    if (cols[i] < 0) return fail("column index out of range");
    count[r + 1]++;
  }
  for (int64_t r = 0; r < nrows; r++) count[r + 1] += count[r];
  std::memcpy(rowptr, count.data(), (size_t)(nrows + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < nnz; i++) {
    int64_t dst = cursor[rows[i]]++;
    out_cols[dst] = cols[i];
    out_vals[dst] = vals[i];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CSR -> SELL-pack
// ---------------------------------------------------------------------------
// Phase 1: count segments.  split_len <= 0 disables splitting.
int64_t cvr_sell_count_segments(int64_t nrows, const int64_t* rowptr,
                                int64_t split_len) {
  int64_t G = 0;
#pragma omp parallel for reduction(+ : G) schedule(static)
  for (int64_t r = 0; r < nrows; r++) {
    int64_t len = rowptr[r + 1] - rowptr[r];
    int64_t s = (split_len > 0) ? std::max<int64_t>(1, (len + split_len - 1) / split_len)
                                : 1;
    G += s;
  }
  return G;
}

// Phase 2: build the sorted segment table.
//   seg_row[G], seg_off[G], order[G] (positions sorted by desc seg length,
//   stable), sorted_len[G].
int cvr_sell_plan(int64_t nrows, const int64_t* rowptr, int64_t split_len,
                  int64_t G, int32_t* seg_row, int32_t* seg_off,
                  int32_t* sorted_len, int64_t* order) {
  // Emit segments row by row (sequential write; cheap).
  std::vector<int32_t> seg_len((size_t)G);
  int64_t g = 0;
  for (int64_t r = 0; r < nrows; r++) {
    int64_t len = rowptr[r + 1] - rowptr[r];
    if (split_len > 0 && len > split_len) {
      int64_t off = 0;
      while (off < len) {
        int64_t l = std::min(split_len, len - off);
        seg_row[g] = (int32_t)r;
        seg_off[g] = (int32_t)off;
        seg_len[(size_t)g] = (int32_t)l;
        off += split_len;
        g++;
      }
    } else {
      seg_row[g] = (int32_t)r;
      seg_off[g] = 0;
      seg_len[(size_t)g] = (int32_t)len;
      g++;
    }
  }
  if (g != G) return fail("segment count mismatch");

  // Stable sort positions by descending length.  Counting sort on length
  // (lengths are bounded by split_len or max row len) => O(G + L).
  int32_t maxlen = 0;
  for (int64_t i = 0; i < G; i++) maxlen = std::max(maxlen, seg_len[(size_t)i]);
  std::vector<int64_t> buckets((size_t)maxlen + 2, 0);
  for (int64_t i = 0; i < G; i++) buckets[(size_t)(maxlen - seg_len[(size_t)i])]++;
  int64_t acc = 0;
  for (size_t b = 0; b < buckets.size(); b++) {
    int64_t cnt = buckets[b];
    buckets[b] = acc;
    acc += cnt;
  }
  for (int64_t i = 0; i < G; i++) {
    int64_t dst = buckets[(size_t)(maxlen - seg_len[(size_t)i])]++;
    order[dst] = i;
    sorted_len[dst] = seg_len[(size_t)i];
  }
  return 0;
}

// Phase 3: fill the slot-major planes.
//   For sorted position p (0..G-1): lane = p % C, slice = p / C; the
//   segment's j-th nnz lands at flat ((slice_off[slice] + j) * C + lane).
int cvr_sell_fill(int64_t G, int64_t C, const int64_t* rowptr,
                  const int32_t* csr_cols, const float* csr_vals,
                  const int32_t* seg_row, const int32_t* seg_off,
                  const int32_t* sorted_len, const int64_t* order,
                  const int32_t* slice_offsets, float* vals_plane,
                  int32_t* cols_plane) {
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < G; p++) {
    int64_t seg = order[p];
    int64_t lane = p % C;
    int64_t slice = p / C;
    int64_t src = rowptr[seg_row[seg]] + seg_off[seg];
    int64_t base = (int64_t)slice_offsets[slice];
    int32_t len = sorted_len[p];
    for (int32_t j = 0; j < len; j++) {
      int64_t dst = (base + j) * C + lane;
      vals_plane[dst] = csr_vals[src + j];
      cols_plane[dst] = csr_cols[src + j];
    }
  }
  return 0;
}

// BSR-128 densification (formats/bsr.py): enumerate occupied 128x128
// bricks per 128-row block, CSR order exploited so no global sort is
// needed (the epoch-stamped map dedupes within a row block).
int64_t cvr_bsr_count(int64_t nrows, int64_t ncb, const int64_t* rowptr,
                      const int32_t* cols) {
  std::vector<int32_t> stamp((size_t)ncb, -1);
  int64_t nb = 0;
  int64_t nrb = (nrows + 127) >> 7;
  for (int64_t rb = 0; rb < nrb; rb++) {
    int64_t r1 = std::min(nrows, (rb + 1) << 7);
    for (int64_t i = rowptr[rb << 7]; i < rowptr[r1]; i++) {
      int32_t cb = cols[i] >> 7;
      if (stamp[cb] != (int32_t)rb) {
        stamp[cb] = (int32_t)rb;
        nb++;
      }
    }
  }
  return nb;
}

// Second pass: brick coordinates (sorted by (row block, col block)) and
// the dense value planes.  bvals must be zeroed by the caller.
int cvr_bsr_fill(int64_t nrows, int64_t ncb, const int64_t* rowptr,
                 const int32_t* cols, const float* vals, int64_t nbricks,
                 int32_t* brick_row, int32_t* brick_col, float* bvals) {
  std::vector<int32_t> stamp((size_t)ncb, -1);
  std::vector<int64_t> bidx((size_t)ncb, 0);
  std::vector<int32_t> local;
  local.reserve(256);
  int64_t nb = 0;
  int64_t nrb = (nrows + 127) >> 7;
  for (int64_t rb = 0; rb < nrb; rb++) {
    int64_t r0 = rb << 7;
    int64_t r1 = std::min(nrows, r0 + 128);
    local.clear();
    for (int64_t i = rowptr[r0]; i < rowptr[r1]; i++) {
      int32_t cb = cols[i] >> 7;
      if (stamp[cb] != (int32_t)rb) {
        stamp[cb] = (int32_t)rb;
        local.push_back(cb);
      }
    }
    std::sort(local.begin(), local.end());
    for (int32_t cb : local) {
      if (nb >= nbricks)
        return fail("bsr_fill: brick count changed between passes");
      brick_row[nb] = (int32_t)rb;
      brick_col[nb] = cb;
      bidx[cb] = nb;
      nb++;
    }
    for (int64_t r = r0; r < r1; r++) {
      for (int64_t i = rowptr[r]; i < rowptr[r + 1]; i++) {
        int32_t c = cols[i];
        bvals[(bidx[c >> 7] << 14) + ((r & 127) << 7) + (c & 127)] =
            vals[i];
      }
    }
  }
  if (nb != nbricks)
    return fail("bsr_fill: brick count changed between passes");
  return 0;
}

// DIA offset detection: mark every distinct diagonal (col - row) in a
// flag array of length nrows + ncols (index off + nrows).
int cvr_dia_offsets(int64_t nrows, int64_t nnz, const int64_t* rowptr,
                    const int32_t* cols, uint8_t* flags) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrows; r++) {
    for (int64_t i = rowptr[r]; i < rowptr[r + 1]; i++)
      flags[(int64_t)cols[i] - r + nrows] = 1;
  }
  return 0;
}

// DIA band fill (formats/dia.py): bands[k, r] = A[r, r + offsets[k]].
// One streaming pass over CSR; the diagonal index per element comes from
// a binary search over the (tiny, sorted) offsets table.
int cvr_dia_fill(int64_t nrows, int64_t nnz, const int64_t* rowptr,
                 const int32_t* cols, const float* vals, int64_t nd,
                 const int64_t* offsets, float* bands) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrows; r++) {
    for (int64_t i = rowptr[r]; i < rowptr[r + 1]; i++) {
      int64_t off = (int64_t)cols[i] - r;
      const int64_t* it =
          std::lower_bound(offsets, offsets + nd, off);
      bands[(int64_t)(it - offsets) * nrows + r] = vals[i];
    }
  }
  return 0;
}

int cvr_version() { return 18; }

// Threads the OpenMP regions run on; 0 when built without OpenMP.
int cvr_omp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// BELL (banded-ELL) converter passes — single streaming walks over the
// CSR, no O(nnz) temporaries (the numpy formulation spent 10+ s in
// first-touch page faults for road-scale inputs).
// ---------------------------------------------------------------------------

// Per-row count of entries within the reach cap; returns the largest
// |offset| among them (the achieved reach, which sets the kernel's
// candidate count).
int64_t cvr_bell_stats(int64_t nrows, const int64_t* rowptr,
                       const int32_t* cols, int64_t cap,
                       int32_t* near_lens) {
  int64_t reach = 0;
  for (int64_t r = 0; r < nrows; r++) {
    int32_t c = 0;
    for (int64_t i = rowptr[r]; i < rowptr[r + 1]; i++) {
      int64_t off = (int64_t)cols[i] - r;
      if (off < 0) off = -off;
      if (off <= cap) {
        c++;
        if (off > reach) reach = off;
      }
    }
    near_lens[r] = c;
  }
  return reach;
}

// Fill the k (li, val) planes (row-major (k, R_sub*128) each) and the
// compact spill COO.  li = col - 1024*(r>>10) + 128*cr.  Returns the
// spill count, or -1 if it would exceed spill_cap.
int64_t cvr_bell_fill(int64_t nrows, const int64_t* rowptr,
                      const int32_t* cols, const float* vals, int64_t k,
                      int64_t cap, int64_t cr, int64_t R128,
                      int16_t* li_out, float* vals_out,
                      int64_t spill_cap, int32_t* spill_rows,
                      int32_t* spill_cols, float* spill_vals) {
  int64_t ns = 0;
  for (int64_t r = 0; r < nrows; r++) {
    int64_t rank = 0;
    const int64_t base = -((r >> 10) << 10) + 128 * cr;
    for (int64_t i = rowptr[r]; i < rowptr[r + 1]; i++) {
      const int64_t c = (int64_t)cols[i];
      const int64_t off = c - r;
      if (off <= cap && off >= -cap && rank < k) {
        li_out[rank * R128 + r] = (int16_t)(c + base);
        vals_out[rank * R128 + r] = vals[i];
        rank++;
      } else {
        if (ns >= spill_cap) return -1;
        spill_rows[ns] = (int32_t)r;
        spill_cols[ns] = cols[i];
        spill_vals[ns] = vals[i];
        ns++;
      }
    }
  }
  return ns;
}

}  // extern "C"
