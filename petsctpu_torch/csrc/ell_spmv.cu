// The ELL sparse matrix-vector product y = A x of the port's AIJ, for
// Hopper (sm_90a), in fp32, fp64, complex64 and complex128.
//
// Replaces petsctpu/mat/ell.py:53 (AIJ.mult: XLA code in the reference, a
// gather, a multiply and a row sum). The pack is the reference's
// (mat/ell.py::aij_pack):
//
//   cols [m, K] int32   the column of each slot, row-major (padding: 0)
//   vals [m, K] T       the value of each slot (padding: 0)
//   x    [n]    T       n need not equal m
//
// and the product is, for every row i,
//
//   y[i] = Σ_k vals[i,k]·x[cols[i,k]]
//
// a left fold over k = 0…K−1 from +0.0, each product and each add rounded
// once (__dmul_rn/__dadd_rn, __fmul_rn/__fadd_rn: no FMA contraction):
// MatMult_SeqAIJ's order (aij.c:1173) and the arithmetic of the plain
// version (ops/ell_spmv.py::ell_spmv_plain), so the two agree bit for
// bit. A complex product is (ar·br − ai·bi) + (ar·bi + ai·br)i, each of
// its four products, its difference and its sum rounded once, as the
// plain version computes it on the real and imaginary parts. Padding
// slots are computed (0·x[0]), not skipped, for the same bits.
//
// Bound: bytes. A slot reads 4 bytes of column and 4 to 16 of value
// (fp64: 12 B, against 16 with int64 columns), x is gathered through L2
// and y written once; 2 flops a real slot. On ksp ex43's A (3,145,728
// rows, K 27, fp64) the arrays are 1,069,547,520 B: 0.3193 ms at 3.35
// TB/s; on snes ex14's 128³ Jacobian (K 7) 209,715,200 B, 0.0626 ms.
//
// Design (the ring kernel). The first version staged a tile of whole rows
// through the 48 KB a block has without opt-in and folded it at once, and
// ran at 54 % of its bound on ex43's A. Its three limits and what this
// design does about each:
//  1. Too little in flight (5 blocks of 96 rows an SM, each thread staging
//     8 + 8 bytes a step with an integer t / K per element): a grid of
//     persistent blocks, as many as the card holds and no more than there
//     are tiles, walks the tiles (R whole rows, R a multiple of 4: a
//     tile's cols and vals are each one contiguous, 16-byte-aligned run of
//     R·K elements). Each block keeps a ring of `stages` tiles in dynamic
//     shared memory (above 48 KB through cudaFuncSetAttribute); one thread
//     fills a free stage with two TMA bulk copies (cp.async.bulk, cols and
//     vals, completing on the stage's mbarrier, marked L2 evict-first so
//     that the streamed pack does not push x out of L2), so stages − 1
//     tiles stream from HBM while one is computed. A block has more
//     threads than a tile has rows (256 against 64 for ex43's A: three
//     blocks, 768 threads and about 120 KB in flight an SM;
//     ops/ell_spmv.py::launch_plan sizes the rows, stages, threads and
//     grid), so that its gathers, not its rows, set how much it keeps in
//     flight. A ragged last tile copies the 16-byte-aligned prefix of its
//     bytes in bulk and the tail with plain loads, reading nothing past
//     the arrays.
//  2. No overlap (stage, sync, fold; one thread walking its row's slots
//     in a loop, a gather issued only when the add chain reached it):
//     phase A has all threads walk the stage's flat slots, four
//     neighbouring slots a thread and neighbouring threads on neighbouring
//     quads (16-byte shared loads), two quads a step: eight independent
//     gathers of x in flight a thread, each product rounded once and
//     written back over its value (or, for an even K, into a product
//     buffer of odd row stride K + 1, its row found by a multiply-high).
//     Phase B has a thread a row fold its K products in slot order from
//     +0.0; an odd row stride keeps the threads' reads of one slot in
//     distinct banks. The other stages' copies run on through both phases.
//  3. Wide columns (int64: 8 of a fp64 slot's 16 bytes): the port's AIJ
//     stores int32 columns, the reference's own pack, and the kernel takes
//     int32 only.
// No atomics; each row is written once.
//
// Rows too wide for a stage of 32 rows (K past ~100 in fp64) take the
// chunked kernel: 32 rows a block; for each chunk of Kc slots all its
// threads gather and multiply into the 48 KB without opt-in, then a
// thread a row carries the fold over the chunks in slot order.

#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

constexpr int kBarBytes = 128;        // the stages' mbarriers, ahead of the ring
constexpr int kMaxStages = 8;
constexpr int kMaxThreads = 512;
constexpr int kOptinSmem = 232448;    // a block's shared memory with the opt-in

template <typename T>
struct alignas(2 * sizeof(T)) Cplx {
    T re, im;
};

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ Cplx<T> mul_rn(Cplx<T> a, Cplx<T> b)
{
    return {sub_rn(mul_rn(a.re, b.re), mul_rn(a.im, b.im)),
            add_rn(mul_rn(a.re, b.im), mul_rn(a.im, b.re))};
}

template <typename T>
__device__ __forceinline__ Cplx<T> add_rn(Cplx<T> a, Cplx<T> b)
{
    return {add_rn(a.re, b.re), add_rn(a.im, b.im)};
}

// x[i] through the read-only path (a complex entry as one 8- or 16-byte load)
__device__ __forceinline__ float ldx(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldx(const double* p) { return __ldg(p); }
__device__ __forceinline__ Cplx<float> ldx(const Cplx<float>* p)
{
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    return {v.x, v.y};
}
__device__ __forceinline__ Cplx<double> ldx(const Cplx<double>* p)
{
    const double2 v = __ldg(reinterpret_cast<const double2*>(p));
    return {v.x, v.y};
}

// four neighbouring slots' values, read and written as 16-byte words
template <typename T>
struct alignas(16) Quad {
    T v[4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// Wait for the phase of bar with this parity to complete; a copy that
// never lands traps (a fault the wrapper's caller sees) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    for (uint32_t tries = 0;; ++tries) {
        uint32_t done;
        asm volatile(
            "{\n"
            ".reg .pred P1;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
            "selp.u32 %0, 1, 0, P1;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
        if (done)
            return;
        if (tries == (1u << 24))
            __trap();
    }
}

// One thread: bytes (a multiple of 16, > 0) from src (global) to dst
// (shared), completing on bar, marked L2 evict-first.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
                   "l"(policy)
                 : "memory");
}

// One thread: start the copies of tile `tile` (rows r0 .. r0 + nr − 1)
// into a stage: the 16-byte-aligned prefix of its cols and of its vals in
// bulk; the block loads the rest with plain loads (load_tail).
template <typename T>
__device__ __forceinline__ void fill_stage(unsigned char* st, uint32_t cbytes,
                                           uint64_t* bar, const int32_t* cols,
                                           const T* vals, int64_t r0, int nr,
                                           int K, uint64_t policy)
{
    const uint32_t n = static_cast<uint32_t>(nr) * K;
    const uint32_t bc = n * 4u & ~15u;
    const uint32_t bv = n * static_cast<uint32_t>(sizeof(T)) & ~15u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bc + bv) : "memory");
    if (bc)
        bulk_copy(st, cols + r0 * K, bc, bar, policy);
    if (bv)
        bulk_copy(st + cbytes, vals + r0 * K, bv, bar, policy);
}

template <typename T, bool EVEN>
__global__ void __launch_bounds__(kMaxThreads)
ell_ring_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t m, int K,
                int R, int stages)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const int nt = blockDim.x;                 // threads: R or more
    const int tid = threadIdx.x;
    const uint32_t cbytes = static_cast<uint32_t>(R) * K * 4u;
    const uint32_t stage_bytes = cbytes + static_cast<uint32_t>(R) * K * sizeof(T);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    unsigned char* ring = smem + kBarBytes;
    // the products of an even K, row stride K + 1; of an odd K, in place
    T* prod = reinterpret_cast<T*>(ring + static_cast<size_t>(stages) * stage_bytes);
    const int Ks = EVEN ? K + 1 : K;
    const uint32_t magic = EVEN ? 0xffffffffu / static_cast<uint32_t>(K) + 1u : 0u;
    const int64_t tiles = (m + R - 1) / R;
    const int64_t step = gridDim.x;
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));

    if (tid == 0) {
        for (int s = 0; s < stages; ++s)
            mbar_init(&bar[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int s = 0; s < stages; ++s) {
            const int64_t t = blockIdx.x + s * step;
            if (t < tiles) {
                const int64_t r0 = t * R;
                fill_stage<T>(ring + static_cast<size_t>(s) * stage_bytes, cbytes,
                              &bar[s], cols, vals, r0,
                              static_cast<int>(m - r0 < R ? m - r0 : R), K, policy);
            }
        }

    int s = 0;
    uint32_t parity = 0;
    for (int64_t t = blockIdx.x; t < tiles; t += step) {
        unsigned char* st = ring + static_cast<size_t>(s) * stage_bytes;
        int32_t* sc = reinterpret_cast<int32_t*>(st);
        T* sv = reinterpret_cast<T*>(st + cbytes);
        const int64_t r0 = t * R;
        const int nr = static_cast<int>(m - r0 < R ? m - r0 : R);
        const int n = nr * K;                  // the tile's slots
        const int nq = (n + 3) >> 2;           // its quads
        if (nr < R) {
            // the ragged last tile: its tail past the bulk copies, by plain
            // loads; the columns of the last quad's padding slots are 0
            const int c0 = static_cast<int>(static_cast<uint32_t>(n) * 4u & ~15u) / 4;
            const int v0 = static_cast<int>(static_cast<uint32_t>(n) * sizeof(T) & ~15u)
                           / static_cast<int>(sizeof(T));
            for (int i = c0 + tid; i < 4 * nq; i += nt)
                sc[i] = i < n ? __ldg(cols + r0 * K + i) : 0;
            for (int i = v0 + tid; i < n; i += nt)
                sv[i] = vals[r0 * K + i];
        }
        mbar_wait(&bar[s], parity);
        if (nr < R)
            __syncthreads();

        // phase A: a thread's quads q and q + nt, their gathers all issued
        // before their products
        for (int q0 = tid; q0 < nq; q0 += 2 * nt) {
            int4 c[2];
            T xv[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int q = q0 + u * nt;
                c[u] = q < nq ? *reinterpret_cast<const int4*>(sc + 4 * q)
                              : make_int4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                xv[u][0] = ldx(x + c[u].x);
                xv[u][1] = ldx(x + c[u].y);
                xv[u][2] = ldx(x + c[u].z);
                xv[u][3] = ldx(x + c[u].w);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int q = q0 + u * nt;
                if (q < nq) {
                    Quad<T> v = *reinterpret_cast<const Quad<T>*>(sv + 4 * q);
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        v.v[j] = mul_rn(v.v[j], xv[u][j]);
                    if (EVEN) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const uint32_t i = 4u * q + j;
                            prod[i + __umulhi(i, magic)] = v.v[j];
                        }
                    } else {
                        *reinterpret_cast<Quad<T>*>(sv + 4 * q) = v;
                    }
                }
            }
        }
        __syncthreads();

        // phase B: a row a thread, its products folded in slot order
        for (int r = tid; r < nr; r += nt) {
            const T* p = (EVEN ? prod : sv) + r * Ks;
            T acc = {};
#pragma unroll 4
            for (int k = 0; k < K; ++k)
                acc = add_rn(acc, p[k]);
            y[r0 + r] = acc;
        }

        // release the stage: every generic access to it done, then refill
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (tid == 0 && t + stages * step < tiles) {
            const int64_t r1 = (t + stages * step) * R;
            fill_stage<T>(st, cbytes, &bar[s], cols, vals, r1,
                          static_cast<int>(m - r1 < R ? m - r1 : R), K, policy);
        }
        if (++s == stages) {
            s = 0;
            parity ^= 1u;
        }
    }
}

// Rows wider than a stage: R rows a block, their slots taken in chunks
// of Kc. For each chunk all threads gather x and form the products, four
// slots a thread a step, into shared memory at odd row stride Ks; then a
// thread a row carries its fold over the chunk in slot order.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ell_chunk_kernel(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ x, T* __restrict__ y, int64_t m, int K,
                 int R, int Kc, int Ks)
{
    extern __shared__ __align__(128) unsigned char smem[];
    T* prod = reinterpret_cast<T*>(smem);
    const int nt = blockDim.x;
    const int tid = threadIdx.x;
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
    const int nr = static_cast<int>(m - r0 < R ? m - r0 : R);
    T acc = {};
    for (int k0 = 0; k0 < K; k0 += Kc) {
        const int kc = K - k0 < Kc ? K - k0 : Kc;
        const int span = nr * kc;
        __syncthreads();                 // the previous chunk is folded
        for (int t0 = tid; t0 < span; t0 += 4 * nt) {
            int c[4], at[4];
            T v[4], xv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int t = t0 + u * nt;
                const int r = t / kc;
                const int s = t - r * kc;
                const int64_t g = (r0 + r) * K + k0 + s;
                at[u] = t < span ? r * Ks + s : -1;
                c[u] = t < span ? __ldg(cols + g) : 0;
                v[u] = t < span ? vals[g] : T{};
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                xv[u] = ldx(x + c[u]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (at[u] >= 0)
                    prod[at[u]] = mul_rn(v[u], xv[u]);
        }
        __syncthreads();
        if (tid < nr) {
            const T* p = prod + tid * Ks;
            for (int s = 0; s < kc; ++s)
                acc = add_rn(acc, p[s]);
        }
    }
    if (tid < nr)
        y[r0 + tid] = acc;
}

// the ring kernel's shared bytes (ops/ell_spmv.py::ring_smem computes the same)
template <typename T>
size_t ring_smem(int R, int K, int stages)
{
    const size_t stage = static_cast<size_t>(R) * K * (4 + sizeof(T));
    const size_t prod = K % 2 == 0 ? static_cast<size_t>(R) * (K + 1) * sizeof(T) : 0;
    return kBarBytes + stages * stage + prod;
}

// Allow the ring kernel the opt-in shared memory, once a device.
template <typename T, bool EVEN>
cudaError_t allow_smem(int dev)
{
    static card::PerDevice cache;
    int done = 0;
    return cache.get(dev, &done, [](int* out) {
        *out = 1;
        return cudaFuncSetAttribute(ell_ring_kernel<T, EVEN>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kOptinSmem);
    });
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           long long m, int K, int mode, int R, int threads, int stages_or_kc,
           int Ks, long long grid, cudaStream_t stream)
{
    const int32_t* c = static_cast<const int32_t*>(cols);
    const T* v = static_cast<const T*>(vals);
    const T* xx = static_cast<const T*>(x);
    T* yy = static_cast<T*>(y);
    if (grid <= 0 || grid > 0x7fffffffLL || R <= 0 || threads <= 0
        || threads > kMaxThreads || K <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (mode == 1) {
        const size_t smem = static_cast<size_t>(R) * Ks * sizeof(T);
        if (R > threads || smem > 48 * 1024)
            return static_cast<int>(cudaErrorInvalidValue);
        ell_chunk_kernel<T><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
            c, v, xx, yy, m, K, R, stages_or_kc, Ks);
        return static_cast<int>(cudaGetLastError());
    }
    const int stages = stages_or_kc;
    if (mode != 0 || R % 4 || stages < 1 || stages > kMaxStages)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = ring_smem<T>(R, K, stages);
    if (smem > static_cast<size_t>(kOptinSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = K % 2 == 0 ? allow_smem<T, true>(dev) : allow_smem<T, false>(dev);
    if (err != cudaSuccess)
        return static_cast<int>(err);
    if (K % 2 == 0)
        ell_ring_kernel<T, true><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
            c, v, xx, yy, m, K, R, stages);
    else
        ell_ring_kernel<T, false><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
            c, v, xx, yy, m, K, R, stages);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = A x for an ELL pack with int32 columns; dtype 0 is fp32, 1 fp64, 2
// complex64, 3 complex128. mode 0: the ring kernel, R rows a tile,
// `threads` a block, `stages_or_kc` stages, `grid` persistent blocks; mode
// 1: the chunked kernel, R rows and `threads` threads a block, chunks of
// `stages_or_kc` slots at row stride Ks, `grid` = ⌈m / R⌉ blocks
// (ops/ell_spmv.py::launch_plan).
// Returns the CUDA error of the launch.
extern "C" int ell_spmv_launch(const void* cols, const void* vals,
                               const void* x, void* y, long long m, int K,
                               int dtype, int mode, int R, int threads,
                               int stages_or_kc, int Ks, long long grid,
                               cudaStream_t stream)
{
    if (m <= 0)
        return 0;
    switch (dtype) {
    case 0: return launch<float>(cols, vals, x, y, m, K, mode, R, threads, stages_or_kc, Ks, grid, stream);
    case 1: return launch<double>(cols, vals, x, y, m, K, mode, R, threads, stages_or_kc, Ks, grid, stream);
    case 2: return launch<Cplx<float>>(cols, vals, x, y, m, K, mode, R, threads, stages_or_kc, Ks, grid, stream);
    case 3: return launch<Cplx<double>>(cols, vals, x, y, m, K, mode, R, threads, stages_or_kc, Ks, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
