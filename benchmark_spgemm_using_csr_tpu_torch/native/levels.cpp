// Native level-set computation for sparse triangular solves (SpTRSV).
//
// Level of row i = 1 + max(level of its in-triangle dependencies): the
// longest dependency chain ending at i in the triangular-solve DAG. Rows
// sharing a level are independent and solve in one parallel step. This is
// the host-side symbolic phase of the level-scheduled SpTRSV (the TPU
// analogue of the synchronization-free GPU SpTRSV family that accompanies
// the bhSPARSE/SpGEMM benchmark line); the sweep is a trivial sequential
// O(nnz) pass — exactly the kind of host hot loop the reference keeps in
// C++ (SURVEY.md §3: native components get native equivalents).
//
// For a lower solve rows are processed ascending and only cols < row count;
// for an upper solve, descending and cols > row. Entries outside the
// triangle (and the diagonal) are ignored, so combined LU storage (e.g. an
// ILU0 factor) can be level-scheduled directly.
#include <cstdint>

extern "C" int csr_levels(
    int64_t m,
    const int32_t* rowptr,   // (m+1)
    const int32_t* colidx,   // (nnz)
    int upper,               // 0 = lower triangle, 1 = upper triangle
    int32_t* levels          // (m) out; levels start at 0
) {
  if (m < 0) return 1;
  if (!upper) {
    for (int64_t i = 0; i < m; ++i) {
      int32_t lev = 0;
      for (int32_t p = rowptr[i]; p < rowptr[i + 1]; ++p) {
        int32_t c = colidx[p];
        if (c < i && levels[c] >= lev) lev = levels[c] + 1;
      }
      levels[i] = lev;
    }
  } else {
    for (int64_t i = m - 1; i >= 0; --i) {
      int32_t lev = 0;
      for (int32_t p = rowptr[i]; p < rowptr[i + 1]; ++p) {
        int32_t c = colidx[p];
        if (c > i && c < m && levels[c] >= lev) lev = levels[c] + 1;
      }
      levels[i] = lev;
    }
  }
  return 0;
}
