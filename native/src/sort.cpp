// Host sort for matrix loading: the stable (row, col) order of COO
// entries for COO -> CSR conversion (exported through ctypes, see
// sparsela/utils/native.py).

#include <algorithm>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Stable (row, col) sort order for COO -> CSR conversion
// (sparsela/formats/coo.py sorted_by_row; reference conversion uses
// std::stable_sort, sparse_matrix.h:668-704). Counting sort by row
// (stable by construction), then an in-place per-row stable sort by
// column — O(nnz + M + sum row_len log row_len), ~10x numpy's
// packed-key lexsort at 7M nnz on one core; rows parallelize.
void coo_sort_order(int64_t M, int64_t nnz, const int32_t* rows,
                    const int32_t* cols, int64_t* order) {
  std::vector<int64_t> start(static_cast<size_t>(M) + 1, 0);
  for (int64_t e = 0; e < nnz; e++) start[rows[e] + 1]++;
  for (int64_t r = 0; r < M; r++) start[r + 1] += start[r];
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    for (int64_t e = 0; e < nnz; e++) order[cur[rows[e]]++] = e;
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
  for (int64_t r = 0; r < M; r++) {
    std::stable_sort(order + start[r], order + start[r + 1],
                     [cols](int64_t a, int64_t b) {
                       return cols[a] < cols[b];
                     });
  }
}

}  // extern "C"
