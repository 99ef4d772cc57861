// Fast Matrix Market body tokenizer.
//
// The native analog of the reference's walk-pointer parser (reference:
// include/loops/container/detail/mtx_parser.hxx:90-130): a single pass
// over an in-memory buffer using std::from_chars, ~2 orders of magnitude
// faster than fscanf-style parsing. Exposed to Python via ctypes (see
// loops_tpu_torch/native/mtx.py).
#include <cctype>
#include <charconv>
#include <cstdint>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

inline const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Parse up to `nnz` whitespace-separated records of `ncols` numeric
// fields each from buf[0:len] into out[nnz * ncols] (row-major).
// Comment lines beginning with '%' are skipped. Returns the number of
// complete records parsed, or -1 on a malformed field.
long mtx_parse_records(const char* buf, long len, long nnz, int ncols,
                       double* out) {
  const char* p = buf;
  const char* end = buf + len;
  long rec = 0;
  while (rec < nnz) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '%') {  // tolerated mid-body comment
      p = skip_line(p, end);
      continue;
    }
    double* row = out + rec * ncols;
    for (int f = 0; f < ncols; ++f) {
      p = skip_ws(p, end);
      if (p >= end) return (f == 0) ? rec : -1;
      auto [next, ec] = std::from_chars(p, end, row[f]);
      if (ec != std::errc()) return -1;
      p = next;
    }
    ++rec;
  }
  return rec;
}

}  // extern "C"
