// Dependency-level computation for level-scheduled triangular solves
// (precond/trisolve.py LevelScheduledSolver). The reference solves
// triangular systems row-sequentially (incomplete_cholesky_decomp.hpp:
// 246-345); the device solves group independent rows into levels.
//
// level[i] = 1 + max(level[j] for strict dependencies j of row i), an
// O(nnz) sequential walk in topological (row) order — exactly the loop
// a Python implementation pays per-row interpreter overhead for.

#include <cstdint>

extern "C" {

// ro: (n+1) int64 row offsets; ci: (nnz) int32 column indices of a
// TRIANGULAR matrix (lower: deps have j < i, walk ascending; upper:
// deps have j > i, walk descending — pass lower=0).
// out_level: (n) int32. Returns the number of levels.
int32_t tri_levels(int64_t n, const int64_t* ro, const int32_t* ci,
                   int32_t lower, int32_t* out_level) {
  int32_t nlev = 0;
  if (lower) {
    for (int64_t i = 0; i < n; i++) {
      int32_t lv = 0;
      for (int64_t s = ro[i]; s < ro[i + 1]; s++) {
        const int32_t j = ci[s];
        if (j != i) {
          const int32_t cand = out_level[j] + 1;
          if (cand > lv) lv = cand;
        }
      }
      out_level[i] = lv;
      if (lv + 1 > nlev) nlev = lv + 1;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; i--) {
      int32_t lv = 0;
      for (int64_t s = ro[i]; s < ro[i + 1]; s++) {
        const int32_t j = ci[s];
        if (j != i) {
          const int32_t cand = out_level[j] + 1;
          if (cand > lv) lv = cand;
        }
      }
      out_level[i] = lv;
      if (lv + 1 > nlev) nlev = lv + 1;
    }
  }
  return n > 0 ? nlev : 1;
}

}  // extern "C"
