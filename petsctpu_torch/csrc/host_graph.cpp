// Host graph code of the port's AMG setup: greedy distance-2 column
// coloring and greedy root-based aggregation.
//
// The port's own copy of the plan-time C++ that petsctpu runs for the
// same work (native/petsctpu_native.cpp: greedy_color, aggregate), so
// the colorings and aggregates of both packages are equal. Reference
// algorithms: MatColoring's greedy coloring (src/mat/color) and the
// serial MIS aggregation of PCGAMGCoarsen_AGG (agg.c:977,
// MatCoarsenApply_MIS mis.c:335).
//
// Built by g++ (-O3 -fPIC -shared) into
// petsctpu_torch/_build/libhost_graph.so at first use
// (petsctpu_torch/ops/_build.py::load_host) and bound with ctypes by
// petsctpu_torch/mat/host_graph.py. ABI: plain C functions over CSR
// arrays (int64 indptr, int32 indices).

#include <cstdint>
#include <vector>

extern "C" {

// Greedy distance-2 column coloring for FD Jacobians and probing.
// Needs the pattern in CSR (row_ptr/row_idx) AND CSC (col_ptr/col_idx).
// Returns the number of colors.
int64_t greedy_color(int64_t n_rows, int64_t n_cols,
                     const int64_t* row_ptr, const int32_t* row_idx,
                     const int64_t* col_ptr, const int32_t* col_idx,
                     int32_t* color) {
    (void)n_rows;
    std::vector<int32_t> mark(n_cols + 1, -1);
    int64_t ncolors = 0;
    for (int64_t j = 0; j < n_cols; ++j) color[j] = -1;
    for (int64_t j = 0; j < n_cols; ++j) {
        // forbid colors of all columns sharing a row with column j
        for (int64_t p = col_ptr[j]; p < col_ptr[j + 1]; ++p) {
            int32_t r = col_idx[p];
            for (int64_t q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
                int32_t c2 = row_idx[q];
                if (color[c2] >= 0) mark[color[c2]] = (int32_t)j;
            }
        }
        int32_t c = 0;
        while (c <= n_cols && mark[c] == (int32_t)j) ++c;
        color[j] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

// Greedy root-based aggregation for smoothed-aggregation AMG.
// S: symmetrized strength graph (CSR). Returns number of aggregates.
int64_t aggregate(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int64_t* agg) {
    for (int64_t i = 0; i < n; ++i) agg[i] = -1;
    int64_t na = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        bool free_nbhd = true;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (agg[indices[p]] != -1) { free_nbhd = false; break; }
        if (free_nbhd) {
            agg[i] = na;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
                agg[indices[p]] = na;
            ++na;
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -1) continue;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (agg[indices[p]] != -1) { agg[i] = agg[indices[p]]; break; }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (agg[i] == -1) agg[i] = na++;
    return na;
}

}  // extern "C"
