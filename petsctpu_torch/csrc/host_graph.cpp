// Host graph code of the port: greedy distance-2 column coloring and
// greedy root-based aggregation (the AMG setup), the multilevel k-way
// partition (MatPartitioning "kway", mat/partition.py) and the
// locality RCM ordering ("rcm_fast", mat/order.py).
//
// The port's own copy of the plan-time C++ that petsctpu runs for the
// same work (native/petsctpu_native.cpp: greedy_color, aggregate, the
// kwaypart namespace, kway_partition and rcm), so the colorings,
// aggregates, partitions and orderings of both packages are equal.
// Reference
// algorithms: MatColoring's greedy coloring (src/mat/color) and the
// serial MIS aggregation of PCGAMGCoarsen_AGG (agg.c:977,
// MatCoarsenApply_MIS mis.c:335).
//
// Built by g++ (-O3 -fPIC -shared) into
// petsctpu_torch/_build/libhost_graph.so at first use
// (petsctpu_torch/ops/_build.py::load_host) and bound with ctypes by
// petsctpu_torch/mat/host_graph.py. ABI: plain C functions over CSR
// arrays (int64 indptr, int32 indices).

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

// Multilevel k-way graph partitioning (the ParMetis analog, pmetis.c):
// coarsen by heavy-edge matching -> greedy-growing initial k-way partition
// on the coarsest graph -> project back, boundary FM-style refinement at
// every level (balance tolerance 3%).
// Deterministic: an xorshift PRNG seeded by the caller drives all tie-breaks.
namespace kwaypart {

struct Rng {
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
    uint64_t next() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    }
    int64_t below(int64_t n) { return (int64_t)(next() % (uint64_t)n); }
};

struct Graph {
    int64_t n = 0;
    std::vector<int64_t> xadj;
    std::vector<int32_t> adj;
    std::vector<int64_t> ew;    // edge weights
    std::vector<int64_t> vw;    // vertex weights
    std::vector<int32_t> cmap;  // this level's vertex -> coarser vertex
};

// Heavy-edge matching coarsening: returns the coarser graph and fills
// fine.cmap. No progress (shrink < 5%) => returns a graph with n == fine.n
// (caller stops). maxvwgt caps merged vertex weight (keeps hub-heavy
// graphs partitionable — the METIS rule).
static Graph coarsen_hem(Graph& g, Rng& rng, int64_t maxvwgt) {
    const int64_t n = g.n;
    std::vector<int32_t> match(n, -1);
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    for (int64_t i = n - 1; i > 0; --i)
        std::swap(perm[i], perm[rng.below(i + 1)]);

    int64_t ncoarse = 0;
    g.cmap.assign(n, -1);
    for (int64_t t = 0; t < n; ++t) {
        int64_t v = perm[t];
        if (match[v] >= 0) continue;
        int64_t best = -1, bw = -1;
        for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
            int32_t u = g.adj[p];
            if (u == v || match[u] >= 0) continue;
            if (g.vw[v] + g.vw[u] > maxvwgt) continue;
            if (g.ew[p] > bw) { bw = g.ew[p]; best = u; }
        }
        if (best >= 0) {
            match[v] = (int32_t)best;
            match[best] = (int32_t)v;
            g.cmap[v] = g.cmap[best] = (int32_t)ncoarse++;
        } else {
            match[v] = (int32_t)v;
            g.cmap[v] = (int32_t)ncoarse++;
        }
    }
    Graph c;
    c.n = ncoarse;
    if (ncoarse > n - n / 20) { c.n = n; return c; }  // too little progress

    c.vw.assign(ncoarse, 0);
    for (int64_t v = 0; v < n; ++v) c.vw[g.cmap[v]] += g.vw[v];
    // coarse adjacency via marker array
    c.xadj.assign(ncoarse + 1, 0);
    std::vector<int64_t> mark(ncoarse, -1);
    std::vector<int32_t> cols;
    std::vector<int64_t> wts;
    c.adj.reserve(g.adj.size());
    c.ew.reserve(g.adj.size());
    // group fine vertices by coarse id
    std::vector<int64_t> head(ncoarse, -1), nxt(n, -1);
    for (int64_t v = n - 1; v >= 0; --v) {
        nxt[v] = head[g.cmap[v]];
        head[g.cmap[v]] = v;
    }
    for (int64_t cv = 0; cv < ncoarse; ++cv) {
        cols.clear(); wts.clear();
        for (int64_t v = head[cv]; v >= 0; v = nxt[v]) {
            for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
                int64_t cu = g.cmap[g.adj[p]];
                if (cu == cv) continue;          // drop self-loops
                if (mark[cu] < 0) {
                    mark[cu] = (int64_t)cols.size();
                    cols.push_back((int32_t)cu);
                    wts.push_back(g.ew[p]);
                } else {
                    wts[mark[cu]] += g.ew[p];
                }
            }
        }
        for (int32_t cu : cols) mark[cu] = -1;
        for (size_t i = 0; i < cols.size(); ++i) {
            c.adj.push_back(cols[i]);
            c.ew.push_back(wts[i]);
        }
        c.xadj[cv + 1] = (int64_t)c.adj.size();
    }
    return c;
}

// Greedy graph-growing initial k-way partition on the coarsest graph.
static void initial_partition(const Graph& g, int64_t nparts, Rng& rng,
                              std::vector<int32_t>& part) {
    const int64_t n = g.n;
    part.assign(n, -1);
    int64_t totw = 0;
    for (int64_t v = 0; v < n; ++v) totw += g.vw[v];
    int64_t remaining = totw;
    int64_t assigned = 0;
    std::vector<int32_t> frontier;
    for (int64_t p = 0; p + 1 < nparts; ++p) {
        int64_t target = remaining / (nparts - p);
        int64_t w = 0;
        // seed: an unassigned vertex adjacent to the assigned region if
        // possible (keeps parts contiguous), else random unassigned
        int64_t seed = -1;
        for (int32_t f : frontier)
            if (part[f] < 0) { seed = f; break; }
        if (seed < 0) {
            int64_t k = rng.below(n - assigned);
            for (int64_t v = 0; v < n; ++v)
                if (part[v] < 0 && k-- == 0) { seed = v; break; }
        }
        frontier.clear();
        std::queue<int32_t> q;
        q.push((int32_t)seed);
        part[seed] = (int32_t)p;
        w += g.vw[seed]; ++assigned;
        while (w < target && (assigned < n)) {
            if (q.empty()) {        // disconnected: jump to a new seed
                int64_t s2 = -1;
                for (int64_t v = 0; v < n; ++v)
                    if (part[v] < 0) { s2 = v; break; }
                if (s2 < 0) break;
                q.push((int32_t)s2);
                part[s2] = (int32_t)p;
                w += g.vw[s2]; ++assigned;
                continue;
            }
            int32_t v = q.front(); q.pop();
            for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                int32_t u = g.adj[e];
                if (part[u] >= 0) continue;
                part[u] = (int32_t)p;
                w += g.vw[u]; ++assigned;
                q.push(u);
                if (w >= target) break;
            }
        }
        // remember boundary for the next part's seeding
        while (!q.empty()) {
            int32_t v = q.front(); q.pop();
            for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
                if (part[g.adj[e]] < 0) frontier.push_back(g.adj[e]);
        }
        remaining -= w;
    }
    for (int64_t v = 0; v < n; ++v)
        if (part[v] < 0) part[v] = (int32_t)(nparts - 1);
}

// Greedy boundary k-way refinement (FM-style, positive-gain moves plus
// zero-gain balance moves), respecting maxw = (1+eps) * avg.
static void refine_kway(const Graph& g, int64_t nparts,
                        std::vector<int32_t>& part, int npasses) {
    const int64_t n = g.n;
    std::vector<int64_t> pw(nparts, 0);
    int64_t totw = 0;
    for (int64_t v = 0; v < n; ++v) { pw[part[v]] += g.vw[v]; totw += g.vw[v]; }
    const int64_t maxw = (int64_t)((1.0 + 0.03) * (double)totw
                                   / (double)nparts) + 1;
    std::vector<int64_t> conn(nparts, 0);
    std::vector<int32_t> touched;
    for (int pass = 0; pass < npasses; ++pass) {
        int64_t moved = 0;
        for (int64_t v = 0; v < n; ++v) {
            const int32_t pv = part[v];
            touched.clear();
            bool boundary = false;
            for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                int32_t pu = part[g.adj[e]];
                if (conn[pu] == 0) touched.push_back(pu);
                conn[pu] += g.ew[e];
                if (pu != pv) boundary = true;
            }
            if (boundary) {
                const int64_t id = conn[pv];
                int32_t best = -1;
                int64_t bestgain = 0;
                const bool overweight = pw[pv] > maxw;
                for (int32_t pu : touched) {
                    if (pu == pv) continue;
                    if (pw[pu] + g.vw[v] > maxw) continue;
                    int64_t gain = conn[pu] - id;
                    if (gain > bestgain ||
                        (gain == bestgain && best >= 0 &&
                         pw[pu] < pw[best]) ||
                        (gain == 0 && best < 0 &&
                         pw[pu] + g.vw[v] < pw[pv]) ||
                        (overweight && best < 0)) {    // forced balance:
                        best = pu; bestgain = gain;    // accept any move
                    }                                  // out of a fat part
                }
                if (best >= 0 && pw[pv] > g.vw[v]) {   // never empty a part
                    part[v] = best;
                    pw[pv] -= g.vw[v];
                    pw[best] += g.vw[v];
                    ++moved;
                }
            }
            for (int32_t pu : touched) conn[pu] = 0;
        }
        if (moved == 0) break;
    }
}

static int64_t cut_of(const Graph& g, const std::vector<int32_t>& part) {
    int64_t cut = 0;
    for (int64_t v = 0; v < g.n; ++v)
        for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
            if (part[g.adj[e]] != part[v]) cut += g.ew[e];
    return cut / 2;
}

}  // namespace kwaypart

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

// Multilevel k-way partition of an undirected CSR graph (symmetric
// pattern assumed; self-loops ignored). ewts may be NULL (unit weights).
// Fills part[n]; returns the weighted edge cut (>= 0) or -1 on error.
int64_t kway_partition(int64_t n, const int64_t* indptr,
                       const int32_t* indices, const int64_t* ewts,
                       int64_t nparts, uint64_t seed, int32_t* part) {
    using namespace kwaypart;
    if (n <= 0 || nparts <= 0) return -1;
    if (nparts == 1) {
        for (int64_t v = 0; v < n; ++v) part[v] = 0;
        return 0;
    }
    Rng rng(seed);
    std::vector<Graph> levels(1);
    Graph& g0 = levels[0];
    g0.n = n;
    g0.xadj.assign(indptr, indptr + n + 1);
    g0.adj.assign(indices, indices + indptr[n]);
    if (ewts) g0.ew.assign(ewts, ewts + indptr[n]);
    else g0.ew.assign(indptr[n], 1);
    g0.vw.assign(n, 1);

    const int64_t coarse_target = std::max<int64_t>(30 * nparts, 200);
    const int64_t maxvwgt = std::max<int64_t>(1, (3 * n) / (2 * coarse_target));
    while (levels.back().n > coarse_target) {
        Graph c = coarsen_hem(levels.back(), rng, maxvwgt);
        if (c.n >= levels.back().n) break;
        levels.push_back(std::move(c));
    }

    // initial partition on the coarsest graph: 4 seeded tries, keep best
    const Graph& gc = levels.back();
    std::vector<int32_t> best, cur;
    int64_t bestcut = -1;
    for (int t = 0; t < 4; ++t) {
        initial_partition(gc, nparts, rng, cur);
        refine_kway(gc, nparts, cur, 10);
        int64_t c = cut_of(gc, cur);
        if (bestcut < 0 || c < bestcut) { bestcut = c; best = cur; }
    }

    // uncoarsen + refine
    for (int64_t l = (int64_t)levels.size() - 2; l >= 0; --l) {
        const Graph& gf = levels[l];
        cur.assign(gf.n, 0);
        for (int64_t v = 0; v < gf.n; ++v) cur[v] = best[gf.cmap[v]];
        refine_kway(gf, nparts, cur, 8);
        best = cur;
    }
    for (int64_t v = 0; v < n; ++v) part[v] = best[v];
    return cut_of(levels[0], best);
}

// Reverse Cuthill-McKee ordering (genrcm.c's shape with locality-only
// tie-breaking): BFS from a minimum-degree root of each component,
// neighbours queued by ascending degree, the visit order reversed.
int64_t rcm(int64_t n, const int64_t* indptr, const int32_t* indices,
            int32_t* perm) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbrs;
    for (int64_t start = 0; start < n; ++start) {
        if (visited[start]) continue;
        // pseudo-peripheral: min-degree unvisited in this sweep
        int64_t root = start;
        for (int64_t i = start; i < n; ++i)
            if (!visited[i] && degree[i] < degree[root]) root = i;
        std::queue<int32_t> q;
        q.push((int32_t)root);
        visited[root] = 1;
        while (!q.empty()) {
            int32_t u = q.front(); q.pop();
            order.push_back(u);
            nbrs.clear();
            for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
                int32_t v = indices[p];
                if (!visited[v]) { visited[v] = 1; nbrs.push_back(v); }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int32_t a, int32_t b) {
                          return degree[a] < degree[b];
                      });
            for (int32_t v : nbrs) q.push(v);
        }
    }
    for (int64_t k = 0; k < n; ++k) perm[k] = order[n - 1 - k];
    return 0;
}

}  // extern "C"
