// Fast COO -> CSR conversion: counting-sort by row + stable per-row
// column sort.
//
// The native analog of the reference's thrust sort_by_key + offset
// compression pipeline (reference: include/loops/container/coo.hxx:
// 104-122 + detail/convert.hxx:70-78), built for host CPUs: a two-pass
// counting sort is O(nnz + rows) versus numpy lexsort's O(nnz log nnz),
// and it dominates graph-loading time at papers100M scale. Copied from
// loops_tpu/native/src/coo_to_csr.cpp without its unused per-nonzero
// source index (8 bytes a nonzero: 12 GB at 1.5B edges).
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// rows/cols[nnz], vals[nnz] -> offsets[num_rows+1], out_cols/out_vals.
// Stable within (row, col): duplicates keep their input order.
// Returns 0 on success, -1 on a row index out of range.
int coo_to_csr_f32(const int32_t* rows, const int32_t* cols,
                   const float* vals, int64_t nnz, int32_t num_rows,
                   int32_t* offsets, int32_t* out_cols, float* out_vals) {
  std::vector<int64_t> count(static_cast<size_t>(num_rows) + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= num_rows) return -1;
    ++count[r + 1];
  }
  std::partial_sum(count.begin(), count.end(), count.begin());
  for (int32_t r = 0; r <= num_rows; ++r)
    offsets[r] = static_cast<int32_t>(count[r]);

  // counting-sort scatter (stable in input order)
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t pos = cursor[rows[i]]++;
    out_cols[pos] = cols[i];
    out_vals[pos] = vals[i];
  }

  // stable per-row sort by column
  std::vector<int64_t> order;
  std::vector<int32_t> tmp_c;
  std::vector<float> tmp_v;
  for (int32_t r = 0; r < num_rows; ++r) {
    int64_t b = offsets[r], e = offsets[r + 1], n = e - b;
    if (n <= 1) continue;
    bool sorted = true;
    for (int64_t i = b + 1; i < e; ++i)
      if (out_cols[i] < out_cols[i - 1]) { sorted = false; break; }
    if (sorted) continue;
    order.resize(n);
    std::iota(order.begin(), order.end(), int64_t{0});
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t c) {
                       return out_cols[b + a] < out_cols[b + c];
                     });
    tmp_c.assign(out_cols + b, out_cols + e);
    tmp_v.assign(out_vals + b, out_vals + e);
    for (int64_t i = 0; i < n; ++i) {
      out_cols[b + i] = tmp_c[order[i]];
      out_vals[b + i] = tmp_v[order[i]];
    }
  }
  return 0;
}

}  // extern "C"
