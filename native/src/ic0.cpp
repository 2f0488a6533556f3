// IC(0) incomplete Cholesky — native sequential factorization.
//
// Same algorithm and retry semantics as the Python implementation in
// sparsela/precond/ic0.py (behavioral parity with the reference's
// IncompleteCholesky, work_2025/cg/
// incomplete_cholesky_decomp.hpp:85-239): up-looking factorization on
// the lower-triangle pattern with sorted-merge partial dot products,
// diagonal stored last per row, and up to `max_attempts` diagonal-shift
// retries (initial_shift, x10 per retry) on pivot breakdown.
//
// The factorization has a sequential row dependency, so the native
// version's win over Python is the tight inner merge loop (~100x).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Factor in place: vals holds the lower-triangle values on input and
// the factor L on output. row_offsets/col_indices describe the
// lower-triangle pattern (columns sorted, diagonal last per row).
// Returns the number of attempts used (>=1), or 0 on failure.
int ic0_factorize(int64_t n, const int64_t* row_offsets,
                  const int64_t* col_indices, const double* vals_in,
                  double* vals_out, int max_attempts,
                  double initial_shift) {
  const int64_t nnz = row_offsets[n];
  double shift = 0.0;

  for (int attempt = 0; attempt < max_attempts; attempt++) {
    memcpy(vals_out, vals_in, sizeof(double) * nnz);
    if (attempt > 0) {
      for (int64_t i = 0; i < n; i++) {
        vals_out[row_offsets[i + 1] - 1] += shift;  // diagonal is last
      }
    }

    bool failed = false;
    for (int64_t i = 0; i < n && !failed; i++) {
      for (int64_t k_off = row_offsets[i]; k_off < row_offsets[i + 1];
           k_off++) {
        const int64_t k = col_indices[k_off];
        double sum = 0.0;
        int64_t jl = row_offsets[i];
        int64_t jk = row_offsets[k];
        const int64_t end_k = row_offsets[k + 1];
        while (jl < k_off && jk < end_k) {
          const int64_t cl = col_indices[jl];
          const int64_t ck = col_indices[jk];
          if (cl == ck) {
            sum += vals_out[jl] * vals_out[jk];
            jl++;
            jk++;
          } else if (cl < ck) {
            jl++;
          } else {
            jk++;
          }
        }
        vals_out[k_off] -= sum;
        if (k == i) {
          if (vals_out[k_off] <= 0.0) {
            failed = true;
            break;
          }
          vals_out[k_off] = sqrt(vals_out[k_off]);
        } else {
          vals_out[k_off] /= vals_out[row_offsets[k + 1] - 1];
        }
      }
    }
    if (!failed) return attempt + 1;
    shift = (shift == 0.0) ? initial_shift : shift * 10.0;
  }
  return 0;
}

}  // extern "C"
