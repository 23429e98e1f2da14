// The ELL sparse matrix-vector product y = A x of the port's AIJ, for
// Hopper (sm_90a), in fp32, fp64, complex64 and complex128.
//
// Replaces petsctpu/mat/ell.py::AIJ.mult (XLA code in the reference: a
// gather, a multiply and a row sum). The pack is the port's (mat/ell.py):
//
//   cols [m, K] int64   the column of each slot, row-major (padding: 0)
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
// Bound: bytes. A product reads cols (8 B a slot), vals (4 to 16 B a
// slot) and x, and writes y; 2 flops a real slot against 12–16 bytes. The
// row-major [m, K] layout makes a thread-per-row load strided (K·8 bytes
// between neighbouring threads), so a block stages a tile of whole rows
// of cols and vals through shared memory with coalesced loads (the tile
// of R rows is R·K contiguous elements of each array), and each thread
// then folds one row from shared memory, gathering x through L2 (x is
// const __restrict__, so its loads take the read-only path). The tile's
// row stride in shared memory is odd (Ks = K or K+1), so the threads'
// reads of one slot fall in distinct banks. Where a tile of
// whole rows would not fit the 48 KB a block has without opt-in (K wider
// than ~96), the slots are staged in chunks of Kc and the fold carries
// over the chunks in slot order. ops/ell_spmv.py::tile picks R, Kc and Ks.
// No atomics; each row is written once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void ell_spmv_kernel(const int64_t* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t m, int K, int Kc, int Ks)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int R = blockDim.x;
    int64_t* scol = reinterpret_cast<int64_t*>(smem);
    T* sval = reinterpret_cast<T*>(scol + static_cast<size_t>(R) * Ks);

    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
    const int nr = static_cast<int>(m - r0 < R ? m - r0 : R);
    const int t0 = threadIdx.x;
    T acc = {};
    for (int k0 = 0; k0 < K; k0 += Kc) {
        const int kc = K - k0 < Kc ? K - k0 : Kc;
        const int span = nr * kc;
        __syncthreads();                 // the previous chunk is folded
        if (kc == K) {
            // whole rows: the tile is one contiguous run of nr·K slots
            const int64_t* gc = cols + r0 * K;
            const T* gv = vals + r0 * K;
            for (int t = t0; t < span; t += R) {
                const int r = t / K;
                const int s = t - r * K;
                scol[r * Ks + s] = gc[t];
                sval[r * Ks + s] = gv[t];
            }
        } else {
            for (int t = t0; t < span; t += R) {
                const int r = t / kc;
                const int s = t - r * kc;
                const int64_t g = (r0 + r) * K + k0 + s;
                scol[r * Ks + s] = cols[g];
                sval[r * Ks + s] = vals[g];
            }
        }
        __syncthreads();
        if (t0 < nr) {
            const int64_t* rc = scol + t0 * Ks;
            const T* rv = sval + t0 * Ks;
            for (int s = 0; s < kc; ++s)
                acc = add_rn(acc, mul_rn(rv[s], x[rc[s]]));
        }
    }
    if (t0 < nr)
        y[r0 + t0] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           long long m, int K, int R, int Kc, int Ks, cudaStream_t stream)
{
    const long long blocks = (m + R - 1) / R;
    const size_t smem = static_cast<size_t>(R) * Ks * (sizeof(int64_t) + sizeof(T));
    ell_spmv_kernel<T><<<static_cast<unsigned>(blocks), R, smem, stream>>>(
        static_cast<const int64_t*>(cols), static_cast<const T*>(vals),
        static_cast<const T*>(x), static_cast<T*>(y), m, K, Kc, Ks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = A x for an ELL pack; dtype 0 is fp32, 1 fp64, 2 complex64, 3
// complex128. R threads a block (one row each), Kc slots a staged chunk,
// Ks the shared row stride (ops/ell_spmv.py::tile). Returns the CUDA
// error of the launch.
extern "C" int ell_spmv_launch(const void* cols, const void* vals,
                               const void* x, void* y, long long m, int K,
                               int dtype, int R, int Kc, int Ks,
                               cudaStream_t stream)
{
    if (m <= 0)
        return 0;
    switch (dtype) {
    case 0: return launch<float>(cols, vals, x, y, m, K, R, Kc, Ks, stream);
    case 1: return launch<double>(cols, vals, x, y, m, K, R, Kc, Ks, stream);
    case 2: return launch<Cplx<float>>(cols, vals, x, y, m, K, R, Kc, Ks, stream);
    case 3: return launch<Cplx<double>>(cols, vals, x, y, m, K, R, Kc, Ks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
