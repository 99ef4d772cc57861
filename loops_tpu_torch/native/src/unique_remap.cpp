// Fast unique + remap for out-of-core shard staging.
//
// ShardedCSR.build (io/shards.py) must turn each shard's global column
// ids into (sorted unique gather set, local ids). numpy's
// np.unique(return_inverse=True) is a full O(nnz log nnz) sort; with a
// rank array over the column space this is O(nnz + n_cols) and runs at
// memory speed — the staging analog of the reference's preflight
// conversion probes (reference: include/loops/container/dia.hxx:98-116
// uses the same dense-flag trick to count diagonals in O(nnz)).
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// cols[nnz] over [0, n_cols) -> out_local[nnz] (local id per element)
// and out_uniq[<=min(nnz, n_cols)] (sorted unique values).
// Returns the unique count, or -1 on an out-of-range column.
int64_t unique_remap_i32(const int32_t* cols, int64_t nnz, int64_t n_cols,
                         int32_t* out_local, int32_t* out_uniq) {
  // rank[c]: -1 = unseen, 0 = seen (pass 1), then local id (pass 2)
  std::vector<int32_t> rank(static_cast<size_t>(n_cols));
  std::memset(rank.data(), 0xFF, rank.size() * sizeof(int32_t));
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t c = cols[i];
    if (c < 0 || c >= n_cols) return -1;
    rank[c] = 0;
  }
  int32_t k = 0;
  for (int64_t c = 0; c < n_cols; ++c) {
    if (rank[c] == 0) {
      rank[c] = k;
      out_uniq[k++] = static_cast<int32_t>(c);
    }
  }
  for (int64_t i = 0; i < nnz; ++i) out_local[i] = rank[cols[i]];
  return k;
}

}  // extern "C"
