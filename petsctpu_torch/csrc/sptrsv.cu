// The level-scheduled sparse triangular solve x = T⁻¹ b, for Hopper
// (sm_90a), fp32 and fp64, lower or upper, unit or not: nb stacked plans
// in one launch.
//
// Replaces petsctpu/mat/factor.py::SpTRSVPlan.solve (XLA code in the
// reference: a fori_loop over levels, vmapped over the subdomains of
// bjacobi/ASM). A plan (built on the host by mat/factor.py, its arrays
// petsctpu's) is
//
//   level_rows [nb, nlev, rmax] i32  the rows of each level, ascending,
//                                    then padded with the sentinel n
//   cols, vals [nb, n+1, K]          a row's off-diagonal entries in slot
//                                    order (padding: col n, val 0)
//   dinv [nb, n]                     1/diag (1 for a unit diagonal)
//
// and the solve is, level after level, for every row r of the level,
//
//   x[r] = (b[r] − Σ_k vals[r,k]·x[cols[r,k]]) · dinv[r]
//
// the sum a left fold over k from 0, each product and each add rounded
// once (__fmul_rn/__fadd_rn, __dmul_rn/__dadd_rn: no FMA contraction),
// dinv multiplied last: the arithmetic of the plain version
// (ops/sptrsv.py::sptrsv_plain), so the two agree bit for bit. No
// atomics on x; each row is written once. A padding slot reads the
// sentinel x[n] = 0, here the constant 0 (x has no sentinel entry).
//
// The kernel reads the plan in level order (ops/sptrsv.py::level_order,
// derived once a plan on the host, and all of the plan the device
// holds): position p = lstart[l] + i holds the i-th row of level l, its
// row index, slots and 1/diag, so a warp's loads of a level's rows are
// contiguous and no load of a row's data waits on the load of its row
// index; nlevs [nb] skips padded levels. Slots that are padding in
// every row are dropped there.
//
// One launch a solve, the level loop inside, in one of three shapes:
//   block   (a level of at most kThreads rows): one block a plan,
//           __syncthreads between levels. x is written and read by one
//           SM, so its reads are plain loads (not __ldg, whose
//           non-coherent path could serve a stale line).
//   cluster (stacked plans, wider levels): a thread-block cluster of
//           kCluster blocks a plan, the level's rows spread over them,
//           barrier.cluster (arrive.release / wait.acquire) between
//           levels. Clusters of different plans never wait on each other.
//   grid    (one plan, wider levels): a cooperative launch of one block
//           an SM (cudaLaunchCooperativeKernel refuses a grid that is not
//           all resident), the rows spread over all of them, and a grid
//           barrier between levels: a counter zeroed before the launch,
//           to which each block adds one (red.release) at each barrier,
//           waiting for blocks·(level+1) with acquire loads.
//   In the cluster and grid shapes other blocks' rows reach x through
//   L2, so x is read with ld.global.cg (L2 only).
//
// Bound: the dependency chain, not the bytes. A level costs at least one
// dependent round (the gather of x, the store, the barrier), so nlev
// rounds bound the solve; the bytes (the plan's live entries once, b
// once, x written once) at the measured STREAM rate are tens of
// microseconds for the 128³ bjacobi(8) plans, and their 270 levels set
// the bound (chip_smoke.py measures a round on a chain plan). So before
// each barrier a thread loads its first row of the next level (its first
// kSlots slots, b, 1/diag) and the row index of its first row two levels
// on, leaving the gathers of x, the fold and the store between two
// barriers (and the loads of slots past kSlots, for K > kSlots). The shapes, the
// release barrier and the level order were chosen by measuring the 128³
// plans on the card (PERF.md, Findings).

#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

enum Shape { kBlock = 0, kClusters = 1, kGrid = 2 };   // ops/sptrsv.py SHAPES

constexpr int kThreads = 1024;     // the most threads a block
constexpr int kCluster = 8;        // blocks a cluster (a portable size)
constexpr int kSlots = 4;          // slots of a row loaded ahead

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// x[c]: a plain load when one SM writes all of x, else an L2 load.
template <int kShape, typename T>
__device__ __forceinline__ T load_x(const T* x, int c)
{
    if (kShape != kBlock)
        return __ldcg(x + c);
    return x[c];
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p)
{
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Waits until every block of the grid has arrived here `round` times.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned round)
{
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                     :: "l"(bar) : "memory");
        const unsigned target = round * gridDim.x;
        while (load_acquire(bar) < target) {
        }
    }
    __syncthreads();
}

__device__ __forceinline__ void cluster_barrier()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The plan in level order (ops/sptrsv.py::level_order, derived once a
// plan): lstart [nb, nlev+1] each level's first position, lrows [nb, n]
// the row at each position, lcols/lvals [nb, n, K] and ldinv [nb, n]
// that row's slots and 1/diag. Position p = lstart[l] + i is the i-th
// row of level l, so a warp's loads of a level's slots are contiguous.
template <typename T>
struct Plan {
    const int32_t* lstart;
    const int32_t* lrows;
    const int32_t* lcols;
    const T* lvals;
    const T* ldinv;
    const T* b;
    T* x;
    int n, K;
};

// The row at position p: x[r] = (b[r] − Σ_k vals·x[cols])·dinv, any K.
template <int kShape, typename T>
__device__ __forceinline__ void solve_at(const Plan<T>& P, int p)
{
    const int r = __ldg(P.lrows + p);
    const int64_t at = static_cast<int64_t>(p) * P.K;
    T acc = T(0);
    for (int k = 0; k < P.K; ++k) {
        const int c = __ldg(P.lcols + at + k);
        const T v = __ldg(P.lvals + at + k);
        const T xv = c == P.n ? T(0) : load_x<kShape>(P.x, c);
        acc = add_rn(acc, mul_rn(v, xv));
    }
    P.x[r] = mul_rn(sub_rn(__ldg(P.b + r), acc), __ldg(P.ldinv + p));
}

// A thread's first row of a level, its loads started a level ahead: its
// first kSlots slots, b and 1/diag (slots past kSlots, for K > kSlots,
// are loaded in finish, after the barrier); r = n: none.
template <typename T>
struct Ahead {
    int r;
    int64_t at;
    int c[kSlots];
    T v[kSlots], b, d;

    __device__ __forceinline__ void load(const Plan<T>& P, int p, int row)
    {
        r = row;
        if (r >= P.n)
            return;
        at = static_cast<int64_t>(p) * P.K;
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            const bool on = u < P.K;
            c[u] = on ? __ldg(P.lcols + at + u) : P.n;
            v[u] = on ? __ldg(P.lvals + at + u) : T(0);
        }
        b = __ldg(P.b + r);
        d = __ldg(P.ldinv + p);
    }

    template <int kShape>
    __device__ __forceinline__ void finish(const Plan<T>& P) const
    {
        T acc = T(0);
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            if (u < P.K) {
                const T xv = c[u] == P.n ? T(0) : load_x<kShape>(P.x, c[u]);
                acc = add_rn(acc, mul_rn(v[u], xv));
            }
        }
        for (int k = kSlots; k < P.K; ++k) {
            const int ck = __ldg(P.lcols + at + k);
            const T xv = ck == P.n ? T(0) : load_x<kShape>(P.x, ck);
            acc = add_rn(acc, mul_rn(__ldg(P.lvals + at + k), xv));
        }
        P.x[r] = mul_rn(sub_rn(b, acc), d);
    }
};

// `per` blocks a plan (plan s = blockIdx.x / per; 1 in the block shape),
// a level's positions lstart[l] + t, + stride, ... over the plan's
// threads t. In the grid shape every block walks as many levels as the
// deepest plan (the barrier counts all blocks). Before the barrier a
// thread loads its first row of the next level (its first kSlots slots,
// b and dinv, all from addresses it already holds) and the row index of
// its first row two levels on, so nothing loaded after a barrier waits
// on another load.
template <int kShape, typename T>
__global__ void __launch_bounds__(kThreads)
sptrsv_kernel(const int32_t* __restrict__ lstart,
              const int32_t* __restrict__ nlevs,
              const int32_t* __restrict__ lrows,
              const int32_t* __restrict__ lcols, const T* __restrict__ lvals,
              const T* __restrict__ ldinv, const T* __restrict__ b, T* x,
              unsigned* bar, int nb, int n, int nlev, int K, int per)
{
    const int s = blockIdx.x / per;
    const int64_t sn = static_cast<int64_t>(s) * n;
    lstart += static_cast<int64_t>(s) * (nlev + 1);
    const Plan<T> P{lstart, lrows + sn, lcols + sn * K, lvals + sn * K,
                    ldinv + sn, b + sn, x + sn, n, K};
    const int own = __ldg(nlevs + s);
    int levels = own;
    if (kShape == kGrid)
        for (int k = 0; k < nb; ++k)
            levels = max(levels, __ldg(nlevs + k));
    const int t = (blockIdx.x % per) * blockDim.x + threadIdx.x;
    const int stride = per * blockDim.x;
    // s0, s1, s2: the first positions of levels l, l + 1 and l + 2
    int s0 = 0;
    int s1 = own > 0 ? __ldg(lstart + 1) : 0;
    int s2 = own > 1 ? __ldg(lstart + 2) : s1;
    Ahead<T> a;
    a.load(P, t, t < s1 ? __ldg(P.lrows + t) : n);
    int r1 = s1 + t < s2 ? __ldg(P.lrows + s1 + t) : n;  // position s1 + t's
    for (int l = 0; l < levels; ++l) {
        if (l < own) {
            if (a.r < n)
                a.template finish<kShape>(P);
            for (int p = s0 + t + stride; p < s1; p += stride)
                solve_at<kShape>(P, p);
            const int s3 = l + 3 <= own ? __ldg(lstart + l + 3) : s2;
            a.load(P, s1 + t, r1);
            r1 = s2 + t < s3 ? __ldg(P.lrows + s2 + t) : n;
            s0 = s1;
            s1 = s2;
            s2 = s3;
        }
        if (l + 1 < levels) {
            if (kShape == kGrid)
                grid_barrier(bar, static_cast<unsigned>(l + 1));
            else if (kShape == kClusters)
                cluster_barrier();
            else
                __syncthreads();
        }
    }
}

// A warp's multiple of threads for `rows` rows, at most kThreads.
int threads_for(int rows)
{
    return rows >= kThreads ? kThreads : ((rows + 31) / 32) * 32;
}

// Resident blocks an SM of the grid shape's kernel, asked once a device.
template <typename T>
cudaError_t grid_blocks_per_sm(int dev, int* per_sm)
{
    static card::PerDevice cache;
    return cache.get(dev, per_sm, [](int* out) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, sptrsv_kernel<kGrid, T>, kThreads, 0);
    });
}

template <typename T>
cudaError_t launch(int shape, const int32_t* lstart, const int32_t* nlevs,
                   const int32_t* lrows, const int32_t* lcols,
                   const T* lvals, const T* ldinv, const T* b, T* x,
                   unsigned* bar, int nb, int n, int nlev, int rmax, int K,
                   cudaStream_t stream)
{
    if (shape == kBlock) {
        int per = 1;
        sptrsv_kernel<kBlock, T><<<nb, threads_for(rmax), 0, stream>>>(
            lstart, nlevs, lrows, lcols, lvals, ldinv, b, x, bar, nb, n, nlev,
            K, per);
        return cudaGetLastError();
    }
    if (shape == kClusters) {
        int per = kCluster;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(nb * kCluster);
        cfg.blockDim = dim3(threads_for((rmax + kCluster - 1) / kCluster));
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = kCluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, sptrsv_kernel<kClusters, T>, lstart, nlevs, lrows,
            lcols, lvals, ldinv, b, x, bar, nb, n, nlev, K, per);
        return err != cudaSuccess ? err : cudaGetLastError();
    }
    // the grid: one block an SM, all resident
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = card::sm_count(dev, &sms);
    if (err == cudaSuccess)
        err = grid_blocks_per_sm<T>(dev, &per_sm);
    if (err != cudaSuccess)
        return err;
    if (per_sm < 1)
        return cudaErrorInvalidConfiguration;
    int per = sms;
    err = cudaMemsetAsync(bar, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess)
        return err;
    void* args[] = {&lstart, &nlevs, &lrows, &lcols, &lvals, &ldinv, &b, &x,
                    &bar, &nb, &n, &nlev, &K, &per};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sptrsv_kernel<kGrid, T>),
        dim3(sms), dim3(threads_for((rmax + sms - 1) / sms)), args, 0, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(int shape, const void* lstart, const void* nlevs,
                       const void* lrows, const void* lcols, const void* lvals,
                       const void* ldinv, const void* b, void* x, void* bar,
                       int nb, int n, int nlev, int rmax, int K, void* stream)
{
    const auto* ls = static_cast<const int32_t*>(lstart);
    const auto* nl = static_cast<const int32_t*>(nlevs);
    const auto* lr = static_cast<const int32_t*>(lrows);
    const auto* lc = static_cast<const int32_t*>(lcols);
    const auto* lv = static_cast<const T*>(lvals);
    const auto* ld = static_cast<const T*>(ldinv);
    const auto* bb = static_cast<const T*>(b);
    auto* xx = static_cast<T*>(x);
    auto* br = static_cast<unsigned*>(bar);
    auto* st = static_cast<cudaStream_t>(stream);
    return launch<T>(shape, ls, nl, lr, lc, lv, ld, bb, xx, br, nb, n, nlev,
                     rmax, K, st);
}

}  // namespace

extern "C" int sptrsv_launch(const void* lstart, const void* nlevs,
                             const void* lrows, const void* lcols,
                             const void* lvals, const void* ldinv,
                             const void* b, void* x, void* bar, int nb,
                             int n, int nlev, int rmax, int K, int fp64,
                             int shape, void* stream)
{
    if (nb <= 0 || n <= 0 || nlev <= 0)
        return 0;
    if (shape < kBlock || shape > kGrid || (shape == kGrid && (nb != 1 ||
                                                               bar == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        fp64 ? launch_any<double>(shape, lstart, nlevs, lrows, lcols, lvals,
                                  ldinv, b, x, bar, nb, n, nlev, rmax, K,
                                  stream)
             : launch_any<float>(shape, lstart, nlevs, lrows, lcols, lvals,
                                 ldinv, b, x, bar, nb, n, nlev, rmax, K,
                                 stream);
    return static_cast<int>(err);
}
