// Host factor numerics of the port: numeric ILU(0), triangular-solve
// levels, the symbolic ILU(k) and IC(k) patterns, numeric incomplete
// Cholesky with the MatPivotCheck shift family, and the blocked UᵀDU of
// SBAIJ's Cholesky/IC(k).
//
// The port's own copy of the plan-time C++ that petsctpu runs for the
// same work (native/petsctpu_native.cpp: ilu0_csr, tri_levels,
// iluk_pattern, icck_pattern, icc_numeric, sbaij_block_udu), so the
// factors and levels of
// both packages are equal byte for byte. Reference algorithms:
// MatLUFactorNumeric_SeqAIJ (src/mat/impls/aij/seq/aijfact.c:461), the
// MatILUFactorSymbolic level rule (aijfact.c:122),
// MatICCFactorSymbolic_SeqAIJ (aijfact.c:2405),
// MatCholeskyFactorNumeric_SeqAIJ (aijfact.c:2076) and MatPivotCheck
// (include/petsc-private/matimpl.h:511-585), and
// MatCholeskyFactorNumeric_SeqSBAIJ_N (src/mat/impls/sbaij/seq/
// sbaijfact.c).
//
// Built by g++ (-O3 -fPIC -shared, no -march: no FMA contraction) into
// petsctpu_torch/_build/libhost_factor.so at first use
// (petsctpu_torch/ops/_build.py::load_host) and bound with ctypes by
// petsctpu_torch/mat/host_factor.py. ABI: plain C functions over CSR
// arrays (int64 indptr, int32 indices).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <map>
#include <utility>
#include <vector>

extern "C" {

// Frees an array that iluk_pattern or icck_pattern allocated.
void native_free(void* p) { free(p); }

// ILU(0): in-place numeric factorization restricted to the pattern.
// CSR must have sorted column indices and an explicit diagonal.
// Returns 0 on success, -(i+1) if row i has no diagonal, (i+1) on zero pivot.
int64_t ilu0_csr(int64_t n, const int64_t* indptr, const int32_t* indices,
                 double* data) {
    std::vector<int64_t> diag(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t d = -1;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (indices[p] == i) { d = p; break; }
        if (d < 0) return -(i + 1);
        diag[i] = d;
    }
    // work[j] = position of column j in the current row (or -1)
    std::vector<int64_t> work(n, -1);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            work[indices[p]] = p;
        for (int64_t p = indptr[i]; p < diag[i]; ++p) {
            int64_t k = indices[p];
            double ukk = data[diag[k]];
            if (ukk == 0.0) return k + 1;
            double lik = data[p] / ukk;
            data[p] = lik;
            for (int64_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
                int64_t pos = work[indices[q]];
                if (pos >= 0) data[pos] -= lik * data[q];
            }
        }
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            work[indices[p]] = -1;
    }
    return 0;
}

// Dependency level of each row for a triangular solve (wavefronts).
int64_t tri_levels(int64_t n, const int64_t* indptr, const int32_t* indices,
                   int32_t lower, int64_t* level) {
    int64_t maxlev = 0;
    if (lower) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t lv = 0;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int32_t j = indices[p];
                if (j < i && level[j] + 1 > lv) lv = level[j] + 1;
            }
            level[i] = lv;
            if (lv > maxlev) maxlev = lv;
        }
    } else {
        for (int64_t i = n - 1; i >= 0; --i) {
            int64_t lv = 0;
            for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
                int32_t j = indices[p];
                if (j > i && level[j] + 1 > lv) lv = level[j] + 1;
            }
            level[i] = lv;
            if (lv > maxlev) maxlev = lv;
        }
    }
    return maxlev + 1;
}

// Symbolic ILU(k), Saad level rule. Returns total nnz of the pattern;
// *out_indptr (n+1) and *out_cols (nnz) are malloc'd (caller frees via
// native_free).
int64_t iluk_pattern(int64_t n, const int64_t* indptr, const int32_t* indices,
                     int64_t k, int64_t** out_indptr, int64_t** out_cols) {
    std::vector<std::vector<std::pair<int64_t, int32_t>>> rowpat(n);
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        std::map<int64_t, int32_t> lev;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            lev[indices[p]] = 0;
        // process columns < i in ascending order; fills land strictly
        // to the right of the current pivot so map iteration is safe
        for (auto it = lev.begin(); it != lev.end() && it->first < i; ++it) {
            int64_t kk = it->first;
            int32_t lk = it->second;
            if (lk >= k) continue;
            for (const auto& e : rowpat[kk]) {
                if (e.first <= kk) continue;
                int32_t nl = lk + e.second + 1;
                if (nl <= k) {
                    auto f = lev.find(e.first);
                    if (f == lev.end()) lev[e.first] = nl;
                    else if (nl < f->second) f->second = nl;
                }
            }
        }
        auto& row = rowpat[i];
        row.assign(lev.begin(), lev.end());
        total += (int64_t)row.size();
    }
    int64_t* ip = (int64_t*)malloc((n + 1) * sizeof(int64_t));
    int64_t* cols = (int64_t*)malloc((total > 0 ? total : 1)
                                     * sizeof(int64_t));
    ip[0] = 0;
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (const auto& e : rowpat[i]) cols[w++] = e.first;
        ip[i + 1] = w;
    }
    *out_indptr = ip;
    *out_cols = cols;
    return total;
}

// Symbolic IC(k): column-driven level rule over the strict upper
// triangle (PetscICCLLAddSorted semantics). Output rows EXCLUDE the
// diagonal. Same malloc protocol as iluk_pattern.
int64_t icck_pattern(int64_t n, const int64_t* indptr,
                     const int32_t* indices, int64_t levels,
                     int64_t** out_indptr, int64_t** out_cols) {
    std::vector<std::vector<int64_t>> out_c(n);
    std::vector<std::vector<int32_t>> out_l(n);
    std::vector<int64_t> il(n, 0);
    std::vector<std::vector<int64_t>> bucket(n);
    int64_t total = 0;
    for (int64_t kk = 0; kk < n; ++kk) {
        std::map<int64_t, int32_t> lnk;
        for (int64_t p = indptr[kk]; p < indptr[kk + 1]; ++p)
            if (indices[p] >= kk) lnk[indices[p]] = 0;
        lnk.emplace(kk, 0);          // diagonal always present
        for (int64_t prow : bucket[kk]) {
            int64_t p0 = il[prow];
            const auto& cols_p = out_c[prow];
            const auto& lvls_p = out_l[prow];
            int32_t lev_pk = lvls_p[p0];
            for (size_t t = p0 + 1; t < cols_p.size(); ++t) {
                int32_t inc = lvls_p[t] + lev_pk + 1;
                if (inc > levels) continue;
                int64_t j = cols_p[t];
                auto f = lnk.find(j);
                if (f == lnk.end()) lnk[j] = inc;
                else if (f->second > inc) f->second = inc;
            }
            int64_t nxt = p0 + 1;
            if (nxt < (int64_t)cols_p.size()) {
                il[prow] = nxt;
                bucket[cols_p[nxt]].push_back(prow);
            }
        }
        bucket[kk].clear();
        for (const auto& e : lnk) {
            if (e.first > kk) {
                out_c[kk].push_back(e.first);
                out_l[kk].push_back(e.second);
            }
        }
        total += (int64_t)out_c[kk].size();
        if (!out_c[kk].empty()) {
            il[kk] = 0;
            bucket[out_c[kk][0]].push_back(kk);
        }
    }
    int64_t* ip = (int64_t*)malloc((n + 1) * sizeof(int64_t));
    int64_t* cols = (int64_t*)malloc((total > 0 ? total : 1)
                                     * sizeof(int64_t));
    ip[0] = 0;
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t c : out_c[i]) cols[w++] = c;
        ip[i + 1] = w;
    }
    *out_indptr = ip;
    *out_cols = cols;
    return total;
}

// Numeric incomplete Cholesky A ≈ (I+U)ᵀ D (I+U) restricted to the
// strict-upper pattern (ui, uj), with the MatPivotCheck shift family:
// shift_type: 0=none, 1=nonzero, 2=inblocks, 3=positive_definite.
// Fills uv (STORED AS THE NEGATED UNIT-UPPER FACTOR, matching the
// Python icc_factor return) and d. Returns nshift >= 0 on success,
// -(k+1) on an unshifted zero pivot at row k (shift_type none).
// shift_out[0] = final shift used. The A arrays must be sorted-CSR.
int64_t icc_numeric(int64_t n, const int64_t* ai, const int32_t* aj,
                    const double* aa, const int64_t* ui, const int64_t* uj,
                    double* uv, double* d, int32_t shift_type,
                    double zeropivot, double shift_amount,
                    double* shift_out) {
    double shift_top = 0.0;
    if (shift_type == 3) {
        shift_top = zeropivot;
        for (int64_t i = 0; i < n; ++i) {
            double dval = 0.0, rs = 0.0;
            for (int64_t p = ai[i]; p < ai[i + 1]; ++p) {
                rs += std::fabs(aa[p]);
                if (aj[p] == i) dval = aa[p];
            }
            rs -= std::fabs(dval) + dval;
            if (rs > shift_top) shift_top = rs;
        }
        shift_top *= 1.1;
    }
    int64_t nshift = 0;
    const int64_t nshift_max = 5;
    double shift_lo = 0.0, shift_hi = 1.0, shift_fraction = 0.0;
    double cur_shift = 0.0;
    std::vector<double> rtmp(n, 0.0);
    std::vector<int64_t> il(n, 0);
    std::vector<std::vector<int64_t>> bucket(n);
    for (;;) {
        bool newshift = false;
        for (int64_t i = 0; i < n; ++i) { il[i] = 0; bucket[i].clear(); }
        for (int64_t k = 0; k < n; ++k) {
            for (int64_t p = ui[k]; p < ui[k + 1]; ++p) rtmp[uj[p]] = 0.0;
            double dk = cur_shift;
            for (int64_t p = ai[k]; p < ai[k + 1]; ++p) {
                if (aj[p] == k) dk += aa[p];
                else if (aj[p] > k) rtmp[aj[p]] = aa[p];
            }
            for (int64_t i : bucket[k]) {
                int64_t ili = il[i];
                double stored = uv[ili];
                double uikdi = -stored / d[i];
                dk += uikdi * stored;
                uv[ili] = uikdi;
                int64_t nxt = ili + 1;
                if (nxt < ui[i + 1]) {
                    for (int64_t p = nxt; p < ui[i + 1]; ++p)
                        rtmp[uj[p]] += uikdi * uv[p];
                    il[i] = nxt;
                    bucket[uj[nxt]].push_back(i);
                }
            }
            bucket[k].clear();
            double rs = 0.0;
            for (int64_t p = ui[k]; p < ui[k + 1]; ++p) {
                uv[p] = rtmp[uj[p]];
                rs += std::fabs(uv[p]);
            }
            if (ui[k + 1] > ui[k]) {
                il[k] = ui[k];
                bucket[uj[ui[k]]].push_back(k);
            }
            if (shift_type == 3) {                      // positive_definite
                if (dk <= zeropivot * rs) {
                    if (nshift == nshift_max) shift_fraction = shift_hi;
                    else {
                        shift_lo = shift_fraction;
                        shift_fraction = (shift_hi + shift_lo) / 2.0;
                    }
                    cur_shift = shift_fraction * shift_top;
                    ++nshift;
                    newshift = true;
                    break;
                }
            } else if (shift_type == 1) {               // nonzero
                if (std::fabs(dk) <= zeropivot * rs) {
                    cur_shift = (nshift == 0) ? shift_amount
                                              : cur_shift * 2.0;
                    ++nshift;
                    newshift = true;
                    break;
                }
            } else if (shift_type == 2) {               // inblocks
                if (std::fabs(dk) <= zeropivot) {
                    dk += shift_amount;
                    ++nshift;
                }
            } else {                                    // none
                if (std::fabs(dk) <= zeropivot) return -(k + 1);
            }
            d[k] = dk;
        }
        if (!newshift) break;
    }
    // negate to return the unit-upper factor (matching icc_factor)
    for (int64_t p = 0; p < ui[n]; ++p) uv[p] = -uv[p];
    shift_out[0] = cur_shift;
    return nshift;
}

// Blocked UᵀDU over a strict-upper block pattern (ui, uj): nb block
// rows of bs×bs blocks, A's upper blocks (diagonal included) in block
// CSR (ai, aj, av: [nnzb, bs, bs] row-major). Row k accumulates
//   acc_j = A_kj (+ shift·I at j = k) − Σ_{i<k, k∈pat(i)} U_ikᵀ D_i U_ij
// over the pattern's slots, then D_k = acc_k and U_kj = D_k⁻¹ acc_j (a
// Gauss-Jordan inverse with partial pivoting). Writes uv [nnzU, bs, bs]
// and dv [nb, bs, bs]; returns 0, or k + 1 when block pivot k is
// singular.
int64_t sbaij_block_udu(int64_t nb, int64_t bs,
                        const int64_t* ai, const int64_t* aj,
                        const double* av,
                        const int64_t* ui, const int64_t* uj,
                        double* uv, double* dv, double shift) {
    const int64_t b2 = bs * bs;
    std::vector<double> w(b2), inv(b2);
    auto invert = [&](const double* M, double* out) -> bool {
        std::copy(M, M + b2, w.begin());
        for (int64_t i = 0; i < bs; ++i)
            for (int64_t j = 0; j < bs; ++j)
                out[i * bs + j] = (i == j) ? 1.0 : 0.0;
        for (int64_t c = 0; c < bs; ++c) {
            int64_t p = c;
            for (int64_t r = c + 1; r < bs; ++r)
                if (std::fabs(w[r * bs + c]) > std::fabs(w[p * bs + c]))
                    p = r;
            if (w[p * bs + c] == 0.0) return false;
            if (p != c) {
                for (int64_t j = 0; j < bs; ++j) {
                    std::swap(w[p * bs + j], w[c * bs + j]);
                    std::swap(out[p * bs + j], out[c * bs + j]);
                }
            }
            const double d = w[c * bs + c];
            for (int64_t j = 0; j < bs; ++j) {
                w[c * bs + j] /= d;
                out[c * bs + j] /= d;
            }
            for (int64_t r = 0; r < bs; ++r) {
                if (r == c) continue;
                const double f = w[r * bs + c];
                if (f == 0.0) continue;
                for (int64_t j = 0; j < bs; ++j) {
                    w[r * bs + j] -= f * w[c * bs + j];
                    out[r * bs + j] -= f * out[c * bs + j];
                }
            }
        }
        return true;
    };
    // the current row's accumulator blocks, keyed by block column
    std::vector<int64_t> accpos(nb, -1);
    std::vector<double> accbuf;
    std::vector<int64_t> acccols;
    std::vector<double> D((size_t)nb * b2, 0.0);
    std::vector<double> M(b2);
    // bucket[k]: (row i < k, slot of (i, k) in the pattern)
    std::vector<std::vector<std::pair<int64_t, int64_t>>> bucket(nb);
    for (int64_t k = 0; k < nb; ++k) {
        acccols.clear();
        accbuf.clear();
        auto acc_of = [&](int64_t j) -> double* {
            if (accpos[j] < 0) {
                accpos[j] = (int64_t)acccols.size();
                acccols.push_back(j);
                accbuf.resize(accbuf.size() + b2, 0.0);
            }
            return accbuf.data() + accpos[j] * b2;
        };
        {
            double* d = acc_of(k);
            for (int64_t t = 0; t < bs; ++t) d[t * bs + t] += shift;
        }
        for (int64_t t = ai[k]; t < ai[k + 1]; ++t) {
            if (aj[t] < k) continue;
            double* d = acc_of(aj[t]);
            for (int64_t q = 0; q < b2; ++q) d[q] += av[t * b2 + q];
        }
        // the pattern's slots exist even where A has no block
        for (int64_t t = ui[k]; t < ui[k + 1]; ++t) (void)acc_of(uj[t]);
        for (auto& pr : bucket[k]) {
            const int64_t i = pr.first, tik = pr.second;
            const double* Uik = uv + tik * b2;
            const double* Di = D.data() + i * b2;
            for (int64_t r = 0; r < bs; ++r)             // M = U_ikᵀ D_i
                for (int64_t c = 0; c < bs; ++c) {
                    double s = 0.0;
                    for (int64_t q = 0; q < bs; ++q)
                        s += Uik[q * bs + r] * Di[q * bs + c];
                    M[r * bs + c] = s;
                }
            for (int64_t t = ui[i]; t < ui[i + 1]; ++t) {
                const int64_t j = uj[t];
                if (j < k || accpos[j] < 0) continue;
                const double* Uij = uv + t * b2;
                double* d = accbuf.data() + accpos[j] * b2;
                for (int64_t r = 0; r < bs; ++r)
                    for (int64_t c = 0; c < bs; ++c) {
                        double s = 0.0;
                        for (int64_t q = 0; q < bs; ++q)
                            s += M[r * bs + q] * Uij[q * bs + c];
                        d[r * bs + c] -= s;
                    }
            }
        }
        std::copy(accbuf.data() + accpos[k] * b2,
                  accbuf.data() + accpos[k] * b2 + b2,
                  D.data() + k * b2);
        if (!invert(D.data() + k * b2, inv.data())) return k + 1;
        for (int64_t t = ui[k]; t < ui[k + 1]; ++t) {
            const double* a = accbuf.data() + accpos[uj[t]] * b2;
            double* u = uv + t * b2;
            for (int64_t r = 0; r < bs; ++r)
                for (int64_t c = 0; c < bs; ++c) {
                    double s = 0.0;
                    for (int64_t q = 0; q < bs; ++q)
                        s += inv[r * bs + q] * a[q * bs + c];
                    u[r * bs + c] = s;
                }
            bucket[uj[t]].push_back({k, t});
        }
        for (int64_t j : acccols) accpos[j] = -1;
    }
    std::copy(D.begin(), D.end(), dv);
    return 0;
}

}  // extern "C"
