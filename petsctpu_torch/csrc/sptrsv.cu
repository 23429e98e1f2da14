// The level-scheduled sparse triangular solve x = T⁻¹ b, for Hopper
// (sm_90a), fp32 and fp64, lower or upper, unit or not: nb stacked plans
// in one launch, and the two triangles of an LU-type apply (x = U⁻¹ L⁻¹ b)
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
// sentinel x[n] = 0: the constant 0, or a zero in shared memory.
//
// The kernel reads the plan in level order (ops/sptrsv.py::level_order,
// derived once a plan on the host, and all of the plan the device
// holds): position p = lstart[l] + i holds the i-th row of level l, its
// row index, slots and 1/diag, so a warp's loads of a level's rows are
// contiguous and no load of a row's data waits on the load of its row
// index; nlevs [nb] skips padded levels. Slots that are padding in
// every row are dropped there.
//
// One launch a solve, the level loop inside, in one of six shapes
// (ops/sptrsv.py::launch_shape picks one from the plan's size, its widest
// level and the card's shared memory; a shape that cannot launch raises):
//   block-smem   (x and the ring below fit one block's shared memory):
//                one block a plan, __syncthreads between levels.
//   cluster-smem (x fits a cluster's): a cluster of kCluster blocks a
//                plan. Rank q owns rows [q·chunk, (q+1)·chunk), chunk =
//                ⌈n / kCluster⌉, keeps their x in its shared memory and
//                solves them itself (a level's rows of rank q are one run
//                of positions, the segment lseg[l·kCluster + q] .. [+1],
//                ops/sptrsv.py::segments), so every write of x is local;
//                x[c] of another rank is read from that block's shared
//                memory (mapa + ld.shared::cluster). Between levels
//                barrier.cluster, split: arrive after the level's x
//                stores, with a release restricted to shared::cta
//                operations (a plain cluster-scope release is a
//                MEMBAR.ALL.GPU, 0.4 µs a level; an assumption about
//                the memory model, see round_arrive), wait after the
//                next level's reads from the ring.
//   cluster16-smem (the fused solve of one plan whose x fits no cluster
//                of kCluster blocks but one of kCluster16, a non-portable
//                cluster size the launch allows on the kernel): the
//                cluster-smem shape over kCluster16 ranks.
//   In these, a block is its consumer warps and one producer warp. b is
//   copied into shared memory at the start and x overwrites it in place
//   (a row reads b[r] and then writes x[r]; no row reads x[r] before a
//   later level); x goes to global memory once, at the end, after a
//   barrier that keeps every block resident while another may still
//   read its shared memory. The first barrier comes before any block
//   reads another's shared memory. A row's index, slots and 1/diag do
//   not depend on x: a ring of kStages stages in shared memory holds
//   them, kStages levels ahead, each stage filled by one producer thread
//   with TMA bulk copies (cp.async.bulk, completion on the stage's
//   mbarrier) of the level's segment for the first `consumers` rows; a
//   consumer reads its row there and the rows past the consumers from
//   global memory. The producer warp stores nothing another block reads
//   and arrives relaxed, so its loads in flight never hold a release.
//   The fused solve (sptrsv_lu_launch) walks L's levels and then U's in
//   one such launch: U starts on the y = L⁻¹ b held in shared memory.
//   block    (a level of at most kThreads rows, x too large for shared
//            memory): one block a plan, __syncthreads between levels. x
//            is written and read by one SM, so its reads are plain loads
//            (not __ldg, whose non-coherent path could serve a stale
//            line).
//   cluster  (stacked plans, wider levels, x too large for a cluster):
//            a cluster of kCluster blocks a plan, the level's rows spread
//            over them, barrier.cluster between levels, x through L2
//            (ld.global.cg). Clusters of different plans never wait on
//            each other.
//   grid     (one plan, wider levels, x too large for a cluster): a
//            cooperative launch of one block an SM (cudaLaunchCooperative
//            Kernel refuses a grid that is not all resident), the rows
//            spread over all of them, and a grid barrier between levels:
//            a counter zeroed before the launch, to which each block adds
//            one (red.release) at each barrier, waiting for
//            blocks·(level+1) with acquire loads; x through L2.
//   In the block, cluster and grid shapes a thread loads its first row of
//   the next level (its first kSlots slots, b, 1/diag) and the row index
//   of its first row two levels on before each barrier.
//
// Bound: the dependency chain, not the bytes. A level costs at least one
// dependent round (the gather of x, the store, the barrier), so nlev
// rounds bound the solve; the bytes (the plan's live entries once, b
// once, x written once) at the measured STREAM rate are tens of
// microseconds for the 128³ bjacobi(8) plans, and their 270 levels set
// the bound (chip_smoke.py measures a round on a chain plan). The shapes,
// the release barrier and the level order were chosen by measuring the
// 128³ plans on the card (PERF.md, Findings).

#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

// ops/sptrsv.py SHAPES
enum Shape { kBlock = 0, kClusters = 1, kGrid = 2, kBlockSmem = 3,
             kClusterSmem = 4, kCluster16Smem = 5 };

constexpr int kThreads = 1024;     // the most threads a block
constexpr int kCluster = 8;        // blocks a cluster (a portable size)
constexpr int kCluster16 = 16;     // the fused solve's wider cluster
                                   // (a non-portable size)
constexpr int kSlots = 4;          // slots of a row loaded ahead
constexpr int kStages = 4;         // levels in the ring (shared shapes)
constexpr unsigned kNone = 0xffffffffu;   // a slot past K: no address

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

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier()
{
    cluster_arrive();
    cluster_wait();
}

__device__ __forceinline__ unsigned cluster_rank()
{
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory offset in block `rank` of the
// cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank)
{
    unsigned d;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(d) : "r"(addr), "r"(rank));
    return d;
}

// x at a shared address: the block's own, or (far) another block's of
// the cluster, chosen by a predicate inside one asm, so the gathers of a
// row go out back to back. volatile: never moved across a barrier.
template <int kRanks>
__device__ __forceinline__ float load_x(unsigned a, bool far, float)
{
    float v;
    if (kRanks == 1)
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
    else
        asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
                     "@p ld.shared::cluster.f32 %0, [%1];\n\t"
                     "@!p ld.shared.f32 %0, [%1];\n\t}"
                     : "=f"(v) : "r"(a), "r"(static_cast<unsigned>(far)));
    return v;
}

template <int kRanks>
__device__ __forceinline__ double load_x(unsigned a, bool far, double)
{
    double v;
    if (kRanks == 1)
        asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
    else
        asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t"
                     "@p ld.shared::cluster.f64 %0, [%1];\n\t"
                     "@!p ld.shared.f64 %0, [%1];\n\t}"
                     : "=d"(v) : "r"(a), "r"(static_cast<unsigned>(far)));
    return v;
}

// nb stacked plans in level order (ops/sptrsv.py::level_order, derived
// once a plan): lstart [nb, nlev+1] each level's first position, lseg
// [nb, nlev·ranks+1] each (level, rank)'s first position (the
// cluster-smem shape), nlevs [nb] each plan's own levels, lrows [nb, n]
// the row at each position, lcols/lvals [nb, n, K] and ldinv [nb, n]
// that row's slots and 1/diag.
template <typename T>
struct Tri {
    const int32_t* lstart;
    const int32_t* lseg;
    const int32_t* nlevs;
    const int32_t* lrows;
    const int32_t* lcols;
    const T* lvals;
    const T* ldinv;
    int nlev, K;
};

// A launch: the triangles solved in order (tri[1] only when ntri is 2,
// the fused L then U of sptrsv_lu_launch), b and x [nb, n].
template <typename T>
struct Solve {
    Tri<T> tri[2];
    const T* b;
    T* x;
    unsigned* bar;
    int nb, n, ntri;
};

// ------------------------------------------ block, cluster, grid shapes

// One plan s of a Tri, x in global memory.
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
__device__ __forceinline__ void solve_global(const Solve<T>& S, int per)
{
    const Tri<T>& R = S.tri[0];
    const int n = S.n, nlev = R.nlev, K = R.K;
    const int s = blockIdx.x / per;
    const int64_t sn = static_cast<int64_t>(s) * n;
    const int32_t* lstart = R.lstart + static_cast<int64_t>(s) * (nlev + 1);
    const Plan<T> P{lstart, R.lrows + sn, R.lcols + sn * K, R.lvals + sn * K,
                    R.ldinv + sn, S.b + sn, S.x + sn, n, K};
    const int own = __ldg(R.nlevs + s);
    int levels = own;
    if (kShape == kGrid)
        for (int k = 0; k < S.nb; ++k)
            levels = max(levels, __ldg(R.nlevs + k));
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
                grid_barrier(S.bar, static_cast<unsigned>(l + 1));
            else if (kShape == kClusters)
                cluster_barrier();
            else
                __syncthreads();
        }
    }
}

// ------------------------------------- block-smem and cluster-smem shapes

// Plan s of triangle `second` of a launch: its segment starts (level l,
// rank q at seg[l·kRanks + q]; lstart itself for one rank), rows, slots
// and 1/diag. Field by field, so no dynamic index into the parameters.
template <typename T>
struct One {
    const int32_t* seg;
    const int32_t* rows;
    const int32_t* cols;
    const T* vals;
    const T* dinv;
    int K;
};

template <int kRanks, typename T>
__device__ __forceinline__ One<T> plan_of(const Solve<T>& S, bool second,
                                          int s)
{
    const Tri<T>& A = S.tri[0];
    const Tri<T>& B = S.tri[1];
    const int nlev = second ? B.nlev : A.nlev;
    const int K = second ? B.K : A.K;
    const int64_t sn = static_cast<int64_t>(s) * S.n;
    const int32_t* seg = kRanks == 1
        ? (second ? B.lstart : A.lstart) + static_cast<int64_t>(s) * (nlev + 1)
        : (second ? B.lseg : A.lseg)
              + static_cast<int64_t>(s) * (static_cast<int64_t>(nlev) * kRanks + 1);
    return One<T>{seg, (second ? B.lrows : A.lrows) + sn,
                  (second ? B.lcols : A.lcols) + sn * K,
                  (second ? B.lvals : A.lvals) + sn * K,
                  (second ? B.ldinv : A.ldinv) + sn, K};
}

// The shared shapes' ring: kStages stages, stage st holding level v of
// the walk for v ≡ st (mod kStages), filled by one thread of the
// producer warp with TMA bulk copies (cp.async.bulk, completion counted
// in bytes on the stage's mbarrier) and read by the consumer threads once
// the mbarrier's phase for v has completed. A stage holds the level's
// segment [a, e) of this rank (header) and, for its first `consumers`
// positions, the rows, 1/diag and (K ≤ kSlots) the slots: each array's
// run of positions copied from its 16-byte-aligned start to its 16-byte-
// rounded end, so element a sits at offset (address of a mod 16) / size
// in the stage's copy. The plan's arrays must be readable up to 15 bytes
// past their end (ops/sptrsv.py allocates them so).
struct Bar {
    unsigned addr;

    __device__ __forceinline__ void init(unsigned count) const
    {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                     :: "r"(addr), "r"(count) : "memory");
    }
    __device__ __forceinline__ void arrive_expect(unsigned bytes) const
    {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(addr), "r"(bytes) : "memory");
    }
    __device__ __forceinline__ void wait(unsigned parity) const
    {
        unsigned done = 0;
        while (!done)
            asm volatile("{\n\t.reg .pred p;\n\t"
                         "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                         "selp.u32 %0, 1, 0, p;\n\t}"
                         : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
};

// bytes of [p, p + n) rounded out to 16-byte boundaries, and its start
__device__ __forceinline__ unsigned span16(const void* p, size_t n,
                                           const void** start)
{
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uintptr_t lo = a & ~uintptr_t(15);
    *start = reinterpret_cast<const void*>(lo);
    return n ? static_cast<unsigned>(((a + n + 15) & ~uintptr_t(15)) - lo) : 0u;
}

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar)
{
    if (bytes)
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                     "complete_tx::bytes [%0], [%1], %2, [%3];"
                     :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// element offset of p in a copy starting at its 16-byte-aligned address
template <typename E>
__device__ __forceinline__ int skew(const E* p)
{
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

template <typename T>
struct Ring {
    unsigned char* base;   // stage 0
    unsigned bar0;         // stage 0's mbarrier (8 bytes a stage)
    int consumers;

    // the stage layout (ops/sptrsv.py::smem_bytes): a 16-byte header
    // (a, e, the copies' skews), then rows, 1/diag, cols, vals, each
    // consumers (·kSlots)
    // elements and 32 bytes of alignment slack
    __device__ __forceinline__ size_t stage_bytes() const
    {
        return 16 + static_cast<size_t>(consumers) * (1 + kSlots)
            * (sizeof(int32_t) + sizeof(T)) + 128;
    }
    __device__ __forceinline__ unsigned char* stage(int st) const
    {
        return base + st * stage_bytes();
    }
    __device__ __forceinline__ int32_t* head(int st) const
    {
        return reinterpret_cast<int32_t*>(stage(st));
    }
    __device__ __forceinline__ int32_t* rows(int st) const
    {
        return reinterpret_cast<int32_t*>(stage(st) + 16);
    }
    __device__ __forceinline__ T* dinv(int st) const
    {
        return reinterpret_cast<T*>(stage(st) + 16 + consumers * 4 + 32);
    }
    __device__ __forceinline__ int32_t* cols(int st) const
    {
        return reinterpret_cast<int32_t*>(
            stage(st) + 16 + consumers * (4 + sizeof(T)) + 64);
    }
    __device__ __forceinline__ T* vals(int st) const
    {
        return reinterpret_cast<T*>(stage(st) + 16 + consumers
                                    * (4 + sizeof(T) + 4 * kSlots) + 96);
    }
    __device__ __forceinline__ Bar bar(int st) const
    {
        return Bar{bar0 + 8u * st};
    }

    // Stage st := level [a, e) of plan P: one arrive with the bytes to
    // expect, then the copies (the producer's one thread).
    __device__ __forceinline__ void fill(int st, const One<T>& P, int a,
                                         int e) const
    {
        const int m = max(0, min(e - a, consumers));
        const bool slots = P.K <= kSlots;
        const void *r0, *d0, *c0 = nullptr, *v0 = nullptr;
        const unsigned rb = span16(P.rows + a, m * sizeof(int32_t), &r0);
        const unsigned db = span16(P.dinv + a, m * sizeof(T), &d0);
        const int64_t ak = static_cast<int64_t>(a) * P.K;
        const unsigned cb = slots ? span16(P.cols + ak, m * P.K * sizeof(int32_t), &c0) : 0u;
        const unsigned vb = slots ? span16(P.vals + ak, m * P.K * sizeof(T), &v0) : 0u;
        // the header: the segment, and where element a sits in each copy
        int32_t* h = head(st);
        h[0] = a;
        h[1] = e;
        h[2] = skew(P.rows + a) | skew(P.dinv + a) << 8
            | skew(P.cols + ak) << 16 | skew(P.vals + ak) << 24;
        const Bar b = bar(st);
        b.arrive_expect(rb + db + cb + vb);
        bulk_copy(smem_addr(rows(st)), r0, rb, b.addr);
        bulk_copy(smem_addr(dinv(st)), d0, db, b.addr);
        bulk_copy(smem_addr(cols(st)), c0, cb, b.addr);
        bulk_copy(smem_addr(vals(st)), v0, vb, b.addr);
    }
};

// This rank's view of x in the shared shapes: its own rows' x at xs
// (rows [rank·chunk, (rank+1)·chunk)), the others' through their shared
// memory, and a zero in shared memory for the sentinel x[n] (0·v adds
// +0 to a sum that is never −0: the plain version's bits). q = c / chunk
// by a multiply (exact for c < 2^31: m = ⌈2^(32+l) / chunk⌉, l =
// ⌈log2 chunk⌉); mapa only for another block's x. A gather picks its
// load (ld.shared or ld.shared::cluster) by a predicate, so a row's
// gathers go out back to back. The choices (measured on the H100,
// PERF.md, Findings): the division cost about 400 cycles a level,
// ld.shared::cluster on the block's own x about 400 more than
// ld.shared, and mapa on every slot 10 %.
template <int kRanks, typename T>
struct Xs {
    T* xs;
    int n, chunk, rank;
    unsigned zero;
    unsigned long long m;
    int l;

    __device__ __forceinline__ Xs(T* x, int n_, int chunk_, int rank_,
                                  unsigned zero_)
        : xs(x), n(n_), chunk(chunk_), rank(rank_), zero(zero_)
    {
        l = chunk > 1 ? 32 - __clz(chunk - 1) : 0;
        m = ((1ull << (32 + l)) + chunk - 1) / static_cast<unsigned>(chunk);
    }

    // the shared address of x[c], and whether it lies in another block
    __device__ __forceinline__ unsigned addr(int c, bool& far) const
    {
        far = false;
        if (c == n)
            return zero;
        if (kRanks == 1)
            return smem_addr(xs + c);
        const int q = static_cast<int>(
            (static_cast<unsigned long long>(c) * m) >> (32 + l));
        const unsigned a = smem_addr(xs + (c - q * chunk));
        far = q != rank;
        return far ? map_rank(a, static_cast<unsigned>(q)) : a;
    }

    __device__ __forceinline__ T load(unsigned a, bool far) const
    {
        return load_x<kRanks>(a, far, T(0));
    }

    __device__ __forceinline__ T at(int c) const
    {
        bool far;
        const unsigned a = addr(c, far);
        return load(a, far);
    }
};

// A consumer's first row of a level, read from the ring with the
// addresses of its x gathers (far: bit u for slot u in another block):
// position p (none when p >= e), row r, the plan's K; the segment [a, e).
// Only K of the plan is read here, so nothing waits on the kernel's
// parameters after a barrier.
template <typename T>
struct Next {
    int a, p, e, r, K;
    unsigned at[kSlots], far;
    T v[kSlots], d;

    template <int kRanks>
    __device__ __forceinline__ void take(const Ring<T>& R, int st, int t,
                                         int K_, const Xs<kRanks, T>& X)
    {
        const int4 h = *reinterpret_cast<const int4*>(R.head(st));
        a = h.x;
        e = h.y;
        K = K_;
        p = a + t;
        if (p >= e)
            return;
        r = R.rows(st)[(h.z & 0xff) + t];
        d = R.dinv(st)[((h.z >> 8) & 0xff) + t];
        if (K > kSlots)
            return;
        const int32_t* c = R.cols(st) + ((h.z >> 16) & 0xff) + t * K;
        const T* v0 = R.vals(st) + ((h.z >> 24) & 0xff) + t * K;
        far = 0;
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
            const bool on = u < K;
            bool f = false;
            at[u] = on ? X.addr(c[u], f) : kNone;
            far |= static_cast<unsigned>(f) << u;
            v[u] = on ? v0[u] : T(0);
        }
    }
};

// x[r] = (b[r] − Σ_k vals·x[cols])·dinv over xs, in place of b[r]: the
// ring's row ...
template <int kRanks, typename T>
__device__ __forceinline__ void finish_ring(const Next<T>& q,
                                            const Xs<kRanks, T>& X, int lo)
{
    T xv[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
        if (u < q.K)
            xv[u] = X.load(q.at[u], (q.far >> u) & 1);
    T acc = T(0);
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
        if (u < q.K)
            acc = add_rn(acc, mul_rn(q.v[u], xv[u]));
    T* xr = X.xs + (q.r - lo);
    *xr = mul_rn(sub_rn(*xr, acc), q.d);
}

// ... with its slots from global memory (K > kSlots) ...
template <int kRanks, typename T>
__device__ __forceinline__ void finish_global(const Next<T>& q,
                                              const One<T>& P,
                                              const Xs<kRanks, T>& X, int lo)
{
    const int64_t at = static_cast<int64_t>(q.p) * P.K;
    T acc = T(0);
    for (int k = 0; k < P.K; ++k)
        acc = add_rn(acc, mul_rn(__ldg(P.vals + at + k),
                                 X.at(__ldg(P.cols + at + k))));
    T* xr = X.xs + (q.r - lo);
    *xr = mul_rn(sub_rn(*xr, acc), q.d);
}

// ... or a row past the consumers in its segment, all from global.
template <int kRanks, typename T>
__device__ __forceinline__ void solve_smem_at(const One<T>& P, int p,
                                              const Xs<kRanks, T>& X, int lo)
{
    const int r = __ldg(P.rows + p);
    const int64_t at = static_cast<int64_t>(p) * P.K;
    T acc = T(0);
    for (int k = 0; k < P.K; ++k)
        acc = add_rn(acc, mul_rn(__ldg(P.vals + at + k),
                                 X.at(__ldg(P.cols + at + k))));
    T* xr = X.xs + (r - lo);
    *xr = mul_rn(sub_rn(*xr, acc), __ldg(P.dinv + p));
}

// One round's barrier, split. The consumers release their x stores,
// which are all to the block's own shared memory, so the release is
// restricted to shared::cta operations: a plain release at cluster scope
// compiles to MEMBAR.ALL.GPU, which waits for every memory access of the
// thread to reach L2 (about 0.4 µs a round on the H100, measured). The
// producer warp, whose stores another block never reads, arrives
// relaxed. One rank: __syncthreads, in round_wait.
//
// An assumption, not a documented pattern: the PTX ISA describes the
// fence.release.sync_restrict::shared::cta fence beside mbarrier
// arrives, and this pairs it with a relaxed barrier.cluster arrive and
// an acquire wait. Two orders rest on it. Read after write: a level's x
// store to the owner's shared memory is seen by the other blocks'
// ld.shared::cluster reads of later levels. Write after read, in the
// fused solve only: U's levels overwrite the y = L⁻¹ b that other
// blocks read during L's levels; the fence does not order those far
// reads, but each read's value is used by the reader's own x store,
// which the fence orders before its arrive. The full release on the one
// round from L to U, the formal order for the second, cost the fused
// solve 2 % as a branch, 14 % as a predicate and 20 % as two loops
// (registers spilled; measured on the H100, PERF.md §6), and is not
// taken. Held on the card by tests/test_torch_sptrsv_card.py (stacked
// cluster-smem plans whose every level reads across all ranks, solved
// single and fused again and again over many seeds, bit for bit) and
// chip_smoke.py's repeated fused solves.
template <int kRanks>
__device__ __forceinline__ void round_arrive(bool producer)
{
    if (kRanks == 1)
        return;
    if (producer)
        asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    else
        asm volatile("fence.release.sync_restrict::shared::cta.cluster;\n\t"
                     "barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

template <int kRanks>
__device__ __forceinline__ void round_wait()
{
    if (kRanks == 1)
        __syncthreads();
    else
        cluster_wait();
}

// Plan s = blockIdx.x / kRanks, rank = the block's rank in its cluster;
// the block's last warp the producer, the others consumers. Virtual
// levels w = 0 .. V−1: L's own levels, then (ntri 2) U's.
template <int kRanks, typename T>
__device__ __forceinline__ void solve_smem(const Solve<T>& S)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int n = S.n, t = threadIdx.x, threads = blockDim.x;
    const int consumers = threads - 32;
    const bool producer = t >= consumers;
    const bool lead = t == consumers;          // the producer's thread
    const int s = blockIdx.x / kRanks;
    const int rank = kRanks == 1 ? 0 : static_cast<int>(cluster_rank());
    const int chunk = (n + kRanks - 1) / kRanks;
    const int lo = rank * chunk;
    const int nloc = max(0, min(chunk, n - lo));
    T* xs = reinterpret_cast<T*>(smem);
    const size_t xbytes = (static_cast<size_t>(chunk) * sizeof(T) + 15) & ~size_t(15);
    // after x: the stages' mbarriers and a zero (16 bytes), then the ring
    const unsigned bar0 = smem_addr(smem + xbytes);
    const unsigned zero = bar0 + 8 * kStages;
    const Xs<kRanks, T> X(xs, n, chunk, rank, zero);
    const Ring<T> R{smem + xbytes + ((8 * kStages + 16 + 15) & ~15), bar0, consumers};
    const int n0 = __ldg(S.tri[0].nlevs + s);
    const int V = n0 + (S.ntri == 2 ? __ldg(S.tri[1].nlevs + s) : 0);
    const int K0 = S.tri[0].K, K1 = S.tri[1].K;

    // virtual level w's plan, and its segment [a, e) of this rank
    auto plan = [&](int w) { return plan_of<kRanks>(S, w >= n0, s); };
    auto bounds = [&](int w, int& a, int& e) {
        const int64_t at = static_cast<int64_t>(w >= n0 ? w - n0 : w) * kRanks
                           + rank;
        const One<T> P = plan(w);
        a = __ldg(P.seg + at);
        e = __ldg(P.seg + at + 1);
    };
    if (t == 0) {
        for (int st = 0; st < kStages; ++st)
            R.bar(st).init(1);
        *reinterpret_cast<double*>(smem + xbytes + 8 * kStages) = 0.0;
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    int na = 0, ne = 0;                  // the producer's next level's segment
    if (lead) {
        for (int w = 0; w < kStages && w < V; ++w) {
            int a, e;
            bounds(w, a, e);
            R.fill(w, plan(w), a, e);
        }
        if (kStages < V)
            bounds(kStages, na, ne);
    }
    const T* bs = S.b + static_cast<int64_t>(s) * n + lo;
#pragma unroll 4
    for (int i = t; i < nloc; i += threads)
        xs[i] = __ldg(bs + i);
    Next<T> q;
    q.a = q.p = q.e = 0;
    if (!producer && V > 0) {
        R.bar(0).wait(0);
        q.template take<kRanks>(R, 0, t, 0 >= n0 ? K1 : K0, X);
    }
    if (kRanks == 1)
        __syncthreads();
    else
        cluster_barrier();
    for (int w = 0; w < V; ++w) {
        if (!producer && q.p < q.e) {
            if (q.K <= kSlots)
                finish_ring<kRanks>(q, X, lo);
            else
                finish_global<kRanks>(q, plan(w), X, lo);
            if (q.p + consumers < q.e) {
                const One<T> P = plan(w);
                for (int p = q.p + consumers; p < q.e; p += consumers)
                    solve_smem_at<kRanks>(P, p, X, lo);
            }
        }
        if (w + 1 < V) {
            round_arrive<kRanks>(producer);
            if (!producer) {
                const int st = (w + 1) % kStages;
                R.bar(st).wait(((w + 1) / kStages) & 1);
                q.template take<kRanks>(R, st, t, w + 1 >= n0 ? K1 : K0, X);
            }
            round_wait<kRanks>();
            // every consumer took level w before this round's arrive:
            // stage w's slot is free for level w + kStages
            if (lead && w + kStages < V) {
                R.fill(w % kStages, plan(w + kStages), na, ne);
                if (w + kStages + 1 < V)
                    bounds(w + kStages + 1, na, ne);
            }
        }
    }
    // every block of the cluster is done reading the others' x
    if (kRanks == 1)
        __syncthreads();
    else
        cluster_barrier();
    T* xg = S.x + static_cast<int64_t>(s) * n + lo;
#pragma unroll 4
    for (int i = t; i < nloc; i += threads)
        xg[i] = xs[i];
}

template <int kShape, typename T>
__global__ void __launch_bounds__(kThreads)
sptrsv_kernel(const __grid_constant__ Solve<T> S)
{
    if constexpr (kShape == kBlockSmem)
        solve_smem<1>(S);
    else if constexpr (kShape == kClusterSmem)
        solve_smem<kCluster>(S);
    else if constexpr (kShape == kCluster16Smem)
        solve_smem<kCluster16>(S);
    else if constexpr (kShape == kClusters)
        solve_global<kShape>(S, kCluster);
    else if constexpr (kShape == kGrid)
        solve_global<kShape>(S, static_cast<int>(gridDim.x));
    else
        solve_global<kShape>(S, 1);
}

// A warp's multiple of threads for `rows` rows, at most kThreads.
int threads_for(int rows)
{
    return rows >= kThreads ? kThreads : ((rows + 31) / 32) * 32;
}

// The shared shapes' consumer threads for levels of `rows` rows: a
// warp's multiple, at most kThreads less the producer warp.
int consumers_for(int rows)
{
    return rows >= kThreads - 32 ? kThreads - 32 : ((rows + 31) / 32) * 32;
}

// The shared shapes' dynamic shared memory (ops/sptrsv.py::smem_bytes):
// x's chunk, the stages' mbarriers and the stages for `consumers`
// consumer threads (Ring::stage_bytes), each part 16-byte aligned.
template <typename T>
size_t smem_bytes(int n, int ranks, int consumers)
{
    const size_t chunk = (static_cast<size_t>(n) + ranks - 1) / ranks;
    const size_t stage = 16 + static_cast<size_t>(consumers) * (1 + kSlots)
        * (sizeof(int32_t) + sizeof(T)) + 128;
    return ((chunk * sizeof(T) + 15) & ~size_t(15))
        + ((8 * kStages + 16 + 15) & ~15) + kStages * stage;
}

// The most dynamic shared memory a block may ask for on device `dev`.
cudaError_t smem_optin(int dev, int* bytes)
{
    static card::PerDevice cache;
    return cache.get(dev, bytes, [dev](int* out) {
        return cudaDeviceGetAttribute(
            out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    });
}

// Lets instance kShape/T take up to `bytes` of dynamic shared memory on
// device `dev`, once a device and instance. Setting a function's
// attribute is refused while `stream` is being captured into a graph:
// that first call raises, and the wrapper says so.
template <int kShape, typename T>
cudaError_t allow_smem(int dev, int bytes, cudaStream_t stream)
{
    static card::PerDevice cache;
    int done = 0;
    return cache.get(dev, &done, [bytes, stream](int* out) {
        cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
        cudaError_t err = cudaStreamIsCapturing(stream, &cap);
        if (err != cudaSuccess)
            return err;
        if (cap != cudaStreamCaptureStatusNone)
            return cudaErrorStreamCaptureUnsupported;
        err = cudaFuncSetAttribute(sptrsv_kernel<kShape, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
        if (err == cudaSuccess && kShape == kCluster16Smem)
            err = cudaFuncSetAttribute(
                sptrsv_kernel<kShape, T>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        *out = 1;
        return err;
    });
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

template <int kShape, typename T>
cudaError_t launch_ex(const Solve<T>& S, int blocks, int threads, int ranks,
                      size_t bytes, cudaStream_t stream)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = ranks > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, sptrsv_kernel<kShape, T>, S);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kShape, typename T>
cudaError_t launch_smem(const Solve<T>& S, int rmax, cudaStream_t stream)
{
    constexpr int ranks = kShape == kClusterSmem ? kCluster
                          : kShape == kCluster16Smem ? kCluster16 : 1;
    const int consumers = consumers_for((rmax + ranks - 1) / ranks);
    const size_t bytes = smem_bytes<T>(S.n, ranks, consumers);
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = smem_optin(dev, &optin);
    if (err != cudaSuccess)
        return err;
    if (bytes > static_cast<size_t>(optin))
        return cudaErrorInvalidValue;
    err = allow_smem<kShape, T>(dev, optin, stream);
    if (err != cudaSuccess)
        return err;
    return launch_ex<kShape, T>(S, S.nb * ranks, consumers + 32, ranks, bytes,
                                stream);
}

template <typename T>
cudaError_t launch(int shape, const Solve<T>& S, int rmax, cudaStream_t stream)
{
    if (shape == kBlockSmem)
        return launch_smem<kBlockSmem, T>(S, rmax, stream);
    if (shape == kClusterSmem)
        return launch_smem<kClusterSmem, T>(S, rmax, stream);
    if (shape == kCluster16Smem)
        return launch_smem<kCluster16Smem, T>(S, rmax, stream);
    if (shape == kBlock) {
        sptrsv_kernel<kBlock, T><<<S.nb, threads_for(rmax), 0, stream>>>(S);
        return cudaGetLastError();
    }
    if (shape == kClusters)
        return launch_ex<kClusters, T>(
            S, S.nb * kCluster, threads_for((rmax + kCluster - 1) / kCluster),
            kCluster, 0, stream);
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
    err = cudaMemsetAsync(S.bar, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess)
        return err;
    void* args[] = {const_cast<Solve<T>*>(&S)};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sptrsv_kernel<kGrid, T>), dim3(sms),
        dim3(threads_for((rmax + sms - 1) / sms)), args, 0, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
Tri<T> tri_of(const void* lstart, const void* lseg, const void* nlevs,
              const void* lrows, const void* lcols, const void* lvals,
              const void* ldinv, int nlev, int K)
{
    return Tri<T>{static_cast<const int32_t*>(lstart),
                  static_cast<const int32_t*>(lseg),
                  static_cast<const int32_t*>(nlevs),
                  static_cast<const int32_t*>(lrows),
                  static_cast<const int32_t*>(lcols),
                  static_cast<const T*>(lvals), static_cast<const T*>(ldinv),
                  nlev, K};
}

bool is_smem(int shape)
{
    return shape == kBlockSmem || shape == kClusterSmem
        || shape == kCluster16Smem;
}

bool is_cluster_smem(int shape)
{
    return shape == kClusterSmem || shape == kCluster16Smem;
}

}  // namespace

extern "C" int sptrsv_launch(const void* lstart, const void* lseg,
                             const void* nlevs, const void* lrows,
                             const void* lcols, const void* lvals,
                             const void* ldinv, const void* b, void* x,
                             void* bar, int nb, int n, int nlev, int rmax,
                             int K, int fp64, int shape, void* stream)
{
    if (nb <= 0 || n <= 0 || nlev <= 0)
        return 0;
    if (shape < kBlock || shape > kCluster16Smem
        || (shape == kGrid && (nb != 1 || bar == nullptr))
        || (is_cluster_smem(shape) && lseg == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    auto* st = static_cast<cudaStream_t>(stream);
    auto* br = static_cast<unsigned*>(bar);
    cudaError_t err;
    if (fp64) {
        const Tri<double> tri = tri_of<double>(lstart, lseg, nlevs, lrows,
                                               lcols, lvals, ldinv, nlev, K);
        const Solve<double> S{{tri, tri}, static_cast<const double*>(b),
                              static_cast<double*>(x), br, nb, n, 1};
        err = launch<double>(shape, S, rmax, st);
    } else {
        const Tri<float> tri = tri_of<float>(lstart, lseg, nlevs, lrows,
                                             lcols, lvals, ldinv, nlev, K);
        const Solve<float> S{{tri, tri}, static_cast<const float*>(b),
                             static_cast<float*>(x), br, nb, n, 1};
        err = launch<float>(shape, S, rmax, st);
    }
    return static_cast<int>(err);
}

// x = U⁻¹ L⁻¹ b in one launch of a shared shape (block-smem or
// cluster-smem; rmax the wider of the two plans'), L's arrays then U's.
extern "C" int sptrsv_lu_launch(
    const void* l_lstart, const void* l_lseg, const void* l_nlevs,
    const void* l_lrows, const void* l_lcols, const void* l_lvals,
    const void* l_ldinv, const void* u_lstart, const void* u_lseg,
    const void* u_nlevs, const void* u_lrows, const void* u_lcols,
    const void* u_lvals, const void* u_ldinv, const void* b, void* x,
    int nb, int n, int l_nlev, int u_nlev, int rmax, int l_K, int u_K,
    int fp64, int shape, void* stream)
{
    if (nb <= 0 || n <= 0 || l_nlev <= 0 || u_nlev <= 0)
        return 0;
    if (!is_smem(shape)
        || (is_cluster_smem(shape)
            && (l_lseg == nullptr || u_lseg == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    auto* st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (fp64) {
        const Solve<double> S{
            {tri_of<double>(l_lstart, l_lseg, l_nlevs, l_lrows, l_lcols,
                            l_lvals, l_ldinv, l_nlev, l_K),
             tri_of<double>(u_lstart, u_lseg, u_nlevs, u_lrows, u_lcols,
                            u_lvals, u_ldinv, u_nlev, u_K)},
            static_cast<const double*>(b), static_cast<double*>(x), nullptr,
            nb, n, 2};
        err = launch<double>(shape, S, rmax, st);
    } else {
        const Solve<float> S{
            {tri_of<float>(l_lstart, l_lseg, l_nlevs, l_lrows, l_lcols,
                           l_lvals, l_ldinv, l_nlev, l_K),
             tri_of<float>(u_lstart, u_lseg, u_nlevs, u_lrows, u_lcols,
                           u_lvals, u_ldinv, u_nlev, u_K)},
            static_cast<const float*>(b), static_cast<float*>(x), nullptr,
            nb, n, 2};
        err = launch<float>(shape, S, rmax, st);
    }
    return static_cast<int>(err);
}

// The most dynamic shared memory a block may ask for on device `dev`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), what launch_shape weighs.
extern "C" int sptrsv_smem_optin(int dev, int* bytes)
{
    return static_cast<int>(smem_optin(dev, bytes));
}
