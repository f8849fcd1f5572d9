// The host setup engine of the general-matrix GAMG route: Vanek greedy
// aggregation, CSR SpGEMM and CSR transpose (the Galerkin product
// A_c = P^T (A P), PETSc's MatPtAP).  Setup work runs once per matrix, on
// the host, as PETSc runs it inside KSPSetUp; the solve never calls it.
//
// The decisions are those of tpusparse/amg/unstructured.py's greedy
// aggregation (and of its pure-Python twin in tpusparse_torch/amg/
// unstructured.py), so both packages build the same aggregates.  The
// SpGEMM sums each output entry in the order it meets the products, row
// by row; a scipy product may sum in another order, so coarse levels
// agree with it to rounding.
//
// Plain C ABI for ctypes (tpusparse_torch/native.py).  CSR = (indptr
// int64[n + 1], indices int32[nnz], data f64[nnz]), columns sorted.
// Single-threaded.  Built with g++ -O3 into tpusparse_torch/csrc/build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// agg (int64[n]) <- the aggregate of every node over the strong graph
// (strong: a uint8 per entry, aligned with indices).  Returns the count.
//   pass 1: a node whose strong neighbours are all free roots an aggregate
//           holding itself and them;
//   pass 2: a node still free joins the aggregate of its first aggregated
//           strong neighbour, read from the pass-1 state;
//   pass 3: a node still free roots an aggregate with its free neighbours.
int64_t tps_greedy_aggregate(int64_t n, const int64_t* indptr,
                             const int32_t* indices, const uint8_t* strong,
                             int64_t* agg) {
  std::fill(agg, agg + n, int64_t{-1});
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool free = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1] && free; ++p)
      free = !(strong[p] && agg[indices[p]] != -1);
    if (!free) continue;
    agg[i] = count;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong[p]) agg[indices[p]] = count;
    ++count;
  }
  std::vector<int64_t> joined(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong[p] && agg[indices[p]] != -1) {
        joined[i] = agg[indices[p]];
        break;
      }
    }
  }
  std::memcpy(agg, joined.data(), sizeof(int64_t) * n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = count;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong[p] && agg[indices[p]] == -1) agg[indices[p]] = count;
    ++count;
  }
  return count;
}

// C = A (m x k) B (k x n), first pass: c_indptr (int64[m + 1]) <- the
// running count of each output row's distinct columns.
void tps_spgemm_symbolic(int64_t m, int64_t n, const int64_t* a_indptr,
                         const int32_t* a_indices, const int64_t* b_indptr,
                         const int32_t* b_indices, int64_t* c_indptr) {
  std::vector<int64_t> seen(static_cast<size_t>(n), -1);
  c_indptr[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t row = 0;
    for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
      const int32_t j = a_indices[pa];
      for (int64_t pb = b_indptr[j]; pb < b_indptr[j + 1]; ++pb) {
        const int32_t col = b_indices[pb];
        if (seen[col] != i) {
          seen[col] = i;
          ++row;
        }
      }
    }
    c_indptr[i + 1] = c_indptr[i] + row;
  }
}

// Second pass: the values, through a dense accumulator of width n; each
// row's columns come out sorted.
void tps_spgemm_numeric(int64_t m, int64_t n, const int64_t* a_indptr,
                        const int32_t* a_indices, const double* a_data,
                        const int64_t* b_indptr, const int32_t* b_indices,
                        const double* b_data, const int64_t* c_indptr,
                        int32_t* c_indices, double* c_data) {
  std::vector<double> acc(static_cast<size_t>(n), 0.0);
  std::vector<int64_t> seen(static_cast<size_t>(n), -1);
  std::vector<int32_t> cols;
  for (int64_t i = 0; i < m; ++i) {
    cols.clear();
    for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
      const int32_t j = a_indices[pa];
      const double av = a_data[pa];
      for (int64_t pb = b_indptr[j]; pb < b_indptr[j + 1]; ++pb) {
        const int32_t col = b_indices[pb];
        if (seen[col] != i) {
          seen[col] = i;
          acc[col] = av * b_data[pb];
          cols.push_back(col);
        } else {
          acc[col] += av * b_data[pb];
        }
      }
    }
    std::sort(cols.begin(), cols.end());
    int64_t p = c_indptr[i];
    for (const int32_t col : cols) {
      c_indices[p] = col;
      c_data[p++] = acc[col];
    }
  }
}

// B = A^T by a counting sort on the column; b_indptr int64[n_cols + 1],
// b_indices and b_data of A's nnz.
void tps_csr_transpose(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                       const int32_t* indices, const double* data,
                       int64_t* b_indptr, int32_t* b_indices, double* b_data) {
  const int64_t nnz = indptr[n_rows];
  std::fill(b_indptr, b_indptr + n_cols + 1, int64_t{0});
  for (int64_t p = 0; p < nnz; ++p) ++b_indptr[indices[p] + 1];
  for (int64_t c = 0; c < n_cols; ++c) b_indptr[c + 1] += b_indptr[c];
  std::vector<int64_t> next(b_indptr, b_indptr + n_cols);
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t q = next[indices[p]]++;
      b_indices[q] = static_cast<int32_t>(i);
      b_data[q] = data[p];
    }
  }
}

}  // extern "C"
