// K1: the stencil (DIA-style) SpMV of StencilMat.mult, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// petsctpu/ops/stencil_pallas.py::stencil5_mult_pallas, which covers the
// 2-D 5-point case with zero boundary, and computes the general
// StencilMat.mult of petsctpu/mat/stencil.py:91-104 instead:
//
//   coeffs [D, N] (N = n0*n1*n2, the grid in C order, 1-D and 2-D
//   grids padded with leading 1s), x [N], y [N], T = float or double;
//   y[i] = sum over d of coeffs[d, i] * x[i + off_d],
//   summed in offset order starting from 0.
//
// Per axis, a neighbour index j = i_k + off_{d,k} outside [0, n_k)
// reads 0 (boundary "none"), wraps (periodic) or reflects about the
// boundary node (mirror: -1 reads 1, n_k reads n_k - 2, with period
// 2(n_k - 1) beyond that, as numpy's reflect pad does). An out-of-grid
// neighbour contributes coeffs * 0, as the plain version's zero pad
// does.
//
// Design (first version: simple and right). One thread per output
// point, in a grid-stride loop. The offsets and boundary codes travel
// by value in a small parameter struct, so every thread reads them from
// the constant bank. Each thread splits its index into grid coordinates
// once (in 32-bit arithmetic whenever D*N allows), then walks the D
// offsets: the coefficient read coeffs[d, i] is coalesced across a
// warp, the x read is a neighbour gather served by L1/L2 (a warp's 32
// neighbours are mostly contiguous, and each x entry is read by D
// threads that are close in time). Nothing is staged in
// shared memory. Each step rounds the product and the sum separately
// (mul_rn then add_rn), which forbids FMA contraction, so the kernel
// equals the plain PyTorch version (petsctpu_torch/ops/stencil_mult.py)
// bit for bit. The TPU kernel's strip pipeline with a VMEM halo carry
// has no counterpart: blocks run in no order here, and L2 plays the
// role of the halo buffer.
//
// Bound: memory. The compulsory traffic is D*N coefficients, x once and
// y once, (D + 2) * N * sizeof(T) bytes, against 2*D flops a point: far
// below the card's ratio of operations to bytes in fp32 and in fp64.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 125;   // a 3-D box stencil of width 2
constexpr int kThreads = 256;

enum Boundary : int { kNone = 0, kPeriodic = 1, kMirror = 2 };

struct StencilParams {
    int64_t n[3];                  // grid extents, C order
    int bnd[3];                    // Boundary per axis
    int D;
    int off[kMaxOffsets][3];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The neighbour coordinate along one axis, or -1 when it lies outside a
// "none" axis.
template <typename I>
__device__ __forceinline__ I neighbour(I j, I n, int bnd)
{
    if (j >= 0 && j < n)
        return j;
    if (bnd == kPeriodic) {
        j %= n;
        return j < 0 ? j + n : j;
    }
    if (bnd == kMirror) {
        if (n == 1)
            return 0;
        const I period = 2 * (n - 1);
        j %= period;
        if (j < 0)
            j += period;
        return j < n ? j : period - j;
    }
    return -1;
}

// I is the index type: int32_t whenever D*N fits, since 64-bit
// division is a long software sequence and the index split is the
// kernel's main integer work.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
stencil_mult_kernel(const T* __restrict__ coeffs, const T* __restrict__ x,
                    T* __restrict__ y, const StencilParams p)
{
    const I n0 = static_cast<I>(p.n[0]);
    const I n1 = static_cast<I>(p.n[1]);
    const I n2 = static_cast<I>(p.n[2]);
    const I N = n0 * n1 * n2;
    const I stride = static_cast<I>(gridDim.x) * blockDim.x;
    for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < N; i += stride) {
        const I i2 = i % n2;
        const I i01 = i / n2;
        const I i1 = i01 % n1;
        const I i0 = i01 / n1;
        T acc = T(0);
        for (int d = 0; d < p.D; ++d) {
            const I j0 = neighbour<I>(i0 + p.off[d][0], n0, p.bnd[0]);
            const I j1 = neighbour<I>(i1 + p.off[d][1], n1, p.bnd[1]);
            const I j2 = neighbour<I>(i2 + p.off[d][2], n2, p.bnd[2]);
            const T xv = (j0 < 0 || j1 < 0 || j2 < 0)
                ? T(0) : __ldg(x + (j0 * n1 + j1) * n2 + j2);
            acc = add_rn(acc, mul_rn(coeffs[static_cast<I>(d) * N + i], xv));
        }
        y[i] = acc;
    }
}

template <typename T>
void launch(const void* coeffs, const void* x, void* y,
            const StencilParams& p, int64_t N, unsigned blocks,
            cudaStream_t s)
{
    const T* c = static_cast<const T*>(coeffs);
    const T* xv = static_cast<const T*>(x);
    T* yv = static_cast<T*>(y);
    // the last index touched is (D - 1)*N + N - 1, plus a grid-stride
    // step of at most blocks*kThreads past N
    const int64_t reach = static_cast<int64_t>(p.D) * N
        + static_cast<int64_t>(blocks) * kThreads;
    if (reach < INT32_MAX)
        stencil_mult_kernel<T, int32_t><<<blocks, kThreads, 0, s>>>(c, xv, yv, p);
    else
        stencil_mult_kernel<T, int64_t><<<blocks, kThreads, 0, s>>>(c, xv, yv, p);
}

}  // namespace

// offsets: D*3 host ints (axis order as n); n: 3 host extents; bnd: 3
// host boundary codes; dtype 0 = float, 1 = double. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or -1 when D
// exceeds kMaxOffsets or the dtype is unknown.
extern "C" int stencil_mult_launch(const void* coeffs, const void* x, void* y,
                                   const int* offsets, int D,
                                   const long long* n, const int* bnd,
                                   int dtype, int num_sms, void* stream)
{
    if (D < 0 || D > kMaxOffsets || (dtype != 0 && dtype != 1))
        return -1;
    StencilParams p;
    for (int k = 0; k < 3; ++k) {
        p.n[k] = n[k];
        p.bnd[k] = bnd[k];
    }
    p.D = D;
    for (int d = 0; d < D; ++d)
        for (int k = 0; k < 3; ++k)
            p.off[d][k] = offsets[3 * d + k];
    const int64_t N = p.n[0] * p.n[1] * p.n[2];
    if (N == 0)
        return 0;
    int64_t blocks = (N + kThreads - 1) / kThreads;
    const int64_t cap = static_cast<int64_t>(num_sms > 0 ? num_sms : 132) * 16;
    if (blocks > cap)
        blocks = cap;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        launch<float>(coeffs, x, y, p, N, static_cast<unsigned>(blocks), s);
    else
        launch<double>(coeffs, x, y, p, N, static_cast<unsigned>(blocks), s);
    return static_cast<int>(cudaGetLastError());
}
