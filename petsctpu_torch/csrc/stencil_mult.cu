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
// does, so NaN and inf coefficients give what the plain version gives.
//
// Bound: memory. The compulsory traffic is D*N coefficients, x once and
// y once, (D + 2) * N * sizeof(T) bytes, against 2*D flops a point: far
// below the card's ratio of operations to bytes in fp32 and in fp64.
// The coefficients are D/(D+2) of it, so what the kernel needs is many
// loads in flight, not reuse of x (x is read D times, from L1 and L2).
//
// Design. A warp owns 32 consecutive points, and the warps stride over
// the grid in groups of 32; the grid is as many blocks as the card holds
// at once (from the occupancy of the instantiation), spread evenly over
// the groups. Each neighbour is resolved per axis, reading a point inside
// the grid and using 0 where the neighbour is outside (the boundary
// path), kBatch offsets' coefficient and x loads issued together before
// they are folded, in a rolled loop that keeps the code small. D is a
// template constant for the 5-, 7- and 27-point stencils, and any other D
// up to 125 runs a generic instantiation. The fold stays in offset order
// from 0 with mul_rn and add_rn (no FMA contraction), so the kernel
// equals the plain PyTorch version (petsctpu_torch/ops/stencil_mult.py)
// bit for bit. Coefficients are read once, with the streaming hint, and y
// is stored with it, so L1 and L2 keep x.
//
// The fp32 5- and 7-point instantiations add an interior path. The host
// (petsctpu_torch/ops/stencil_mult.py::stencil_plan) gives each offset's
// flat delta, (o0*n1 + o1)*n2 + o2, and the interior box, the points
// whose every neighbour lies inside the grid: [max(0, -min_d o_dk),
// n_k - max(0, max_d o_dk)) on axis k. A warp whose 32 points all lie in
// the box (a warp-uniform test) loads all D offsets at once from
// x[i + delta_d], with no boundary code. On an H100 it earns its code
// only there (PERF.md, section 6; scripts/bench_k1.py): 4096^2 5-point
// 0.169 ms against 0.226 with the boundary path alone, 128^3 7-point
// 0.0361 against 0.0367; in fp64 the boundary path alone was as fast or
// faster (65^3 27-point 0.0279 against 0.0292, a 19-point 65^3 0.0250
// against 0.0315, 129^3 7-point the same).
//
// What sets the pace is loads in flight a SM, so registers decide
// between batch and occupancy: the fp64 27-point instantiation is capped
// at 48 registers (5 blocks an SM; 65^3 0.0279 ms against 0.0310
// uncapped). The TPU kernel's strip pipeline with a VMEM halo carry has
// no counterpart: blocks run in no order here, and L2 plays the role of
// the halo buffer. Staging x in shared memory was not tried: with x's
// loads all pointed at the point's own line, the kernel ran no faster.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

constexpr int kMaxOffsets = 125;   // a 3-D box stencil of width 2
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;          // offsets loaded together, any D
constexpr unsigned kFull = 0xffffffffu;

enum Boundary : int { kNone = 0, kPeriodic = 1, kMirror = 2 };

struct StencilParams {
    int64_t n[3];                  // grid extents, C order
    int64_t lo[3];                 // the interior box, [lo, hi) per axis
    int64_t hi[3];
    int64_t delta[kMaxOffsets];    // each offset's flat delta
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

// I is the index type: int32_t whenever (D + 1)*N fits, since 64-bit
// division is a long software sequence and the index split is the
// kernel's main integer work. DC > 0 compiles D = DC; DC == 0 takes D
// from the parameters. kMinBlocks caps the registers (0: no cap);
// kInterior says whether the interior path is compiled (see the design
// above).
template <typename T, int DC>
constexpr int kMinBlocks = (sizeof(T) == 8 && DC == 27) ? 5 : 0;
template <typename T, int DC>
constexpr bool kInterior = sizeof(T) == 4 && (DC == 5 || DC == 7);

template <typename T, typename I, int DC>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, DC>))
stencil_mult_kernel(const T* __restrict__ coeffs, const T* __restrict__ x,
                    T* __restrict__ y, const StencilParams p)
{
    const int D = DC > 0 ? DC : p.D;
    const I n0 = static_cast<I>(p.n[0]);
    const I n1 = static_cast<I>(p.n[1]);
    const I n2 = static_cast<I>(p.n[2]);
    const I N = n0 * n1 * n2;
    const I step = static_cast<I>(gridDim.x) * kThreads;
    for (I base = (static_cast<I>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
         base < N; base += step) {
        const I i = base + static_cast<I>(threadIdx.x % 32);
        const bool live = i < N;
        const I i2 = i % n2;
        const I i01 = i / n2;
        const I i1 = i01 % n1;
        const I i0 = i01 / n1;
        const bool inner = live
            && i0 >= static_cast<I>(p.lo[0]) && i0 < static_cast<I>(p.hi[0])
            && i1 >= static_cast<I>(p.lo[1]) && i1 < static_cast<I>(p.hi[1])
            && i2 >= static_cast<I>(p.lo[2]) && i2 < static_cast<I>(p.hi[2]);
        T acc = T(0);
        if (kInterior<T, DC> && __all_sync(kFull, inner)) {
            constexpr int B = DC > 0 ? DC : 1;    // DC where it is compiled
            T c[B], v[B];
#pragma unroll
            for (int d = 0; d < B; ++d) {
                c[d] = __ldcs(coeffs + static_cast<I>(d) * N + i);
                v[d] = __ldg(x + i + static_cast<I>(p.delta[d]));
            }
#pragma unroll
            for (int d = 0; d < B; ++d)
                acc = add_rn(acc, mul_rn(c[d], v[d]));
        } else if (live) {
#pragma unroll 1
            for (int d0 = 0; d0 < D; d0 += kBatch) {
                T c[kBatch], v[kBatch];
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const int d = d0 + b;
                    if (d < D) {
                        const I j0 = neighbour<I>(i0 + p.off[d][0], n0, p.bnd[0]);
                        const I j1 = neighbour<I>(i1 + p.off[d][1], n1, p.bnd[1]);
                        const I j2 = neighbour<I>(i2 + p.off[d][2], n2, p.bnd[2]);
                        const bool in = j0 >= 0 && j1 >= 0 && j2 >= 0;
                        // an outside neighbour reads the point itself
                        // (a valid address) and contributes 0
                        const T xv = __ldg(x + (in ? (j0 * n1 + j1) * n2 + j2 : i));
                        c[b] = __ldcs(coeffs + static_cast<I>(d) * N + i);
                        v[b] = in ? xv : T(0);
                    }
                }
#pragma unroll
                for (int b = 0; b < kBatch; ++b)
                    if (d0 + b < D)
                        acc = add_rn(acc, mul_rn(c[b], v[b]));
            }
        }
        if (live)
            __stcs(y + i, acc);
    }
}

// One instantiation's launch: as many blocks as the card holds at once
// (its occupancy, asked once a device), spread evenly over the groups of
// 32 points, so every warp walks the same number of groups.
template <typename T, typename I, int DC>
cudaError_t launch(const void* coeffs, const void* x, void* y,
                   const StencilParams& p, int64_t N, cudaStream_t s)
{
    static card::PerDevice per_sm;
    int dev = 0, sms = 0, blocks_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = card::sm_count(dev, &sms);
    if (err == cudaSuccess)
        err = per_sm.get(dev, &blocks_sm, [](int* out) {
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                out, stencil_mult_kernel<T, I, DC>, kThreads, 0);
        });
    if (err != cudaSuccess)
        return err;
    const int64_t blocks = card::even_blocks((N + 31) / 32, kWarps, sms, blocks_sm);
    stencil_mult_kernel<T, I, DC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const T*>(coeffs), static_cast<const T*>(x), static_cast<T*>(y), p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* coeffs, const void* x, void* y,
                         const StencilParams& p, int64_t N, cudaStream_t s)
{
    // the coefficient index reaches D*N, and a warp's first point steps
    // past N by at most the launched threads, under N + 2*kThreads
    if ((static_cast<int64_t>(p.D) + 1) * N + 2 * kThreads >= INT32_MAX)
        return launch<T, int64_t, 0>(coeffs, x, y, p, N, s);
    switch (p.D) {
    case 5:
        return launch<T, int32_t, 5>(coeffs, x, y, p, N, s);
    case 7:
        return launch<T, int32_t, 7>(coeffs, x, y, p, N, s);
    case 27:
        return launch<T, int32_t, 27>(coeffs, x, y, p, N, s);
    default:
        return launch<T, int32_t, 0>(coeffs, x, y, p, N, s);
    }
}

}  // namespace

// offsets: D*3 host ints (axis order as n); n: 3 host extents; bnd: 3
// host boundary codes; delta: D host flat deltas; box: 6 host ints, the
// interior box's lo then hi per axis (stencil_plan; the interior path
// reads both); dtype 0 = float,
// 1 = double. Launches on `stream` and returns the CUDA error code (0 on
// success), or -1 when D exceeds kMaxOffsets or the dtype is unknown.
extern "C" int stencil_mult_launch(const void* coeffs, const void* x, void* y,
                                   const int* offsets, int D,
                                   const long long* n, const int* bnd,
                                   const long long* delta,
                                   const long long* box, int dtype,
                                   void* stream)
{
    if (D < 1 || D > kMaxOffsets || (dtype != 0 && dtype != 1))
        return -1;
    StencilParams p;
    for (int k = 0; k < 3; ++k) {
        p.n[k] = n[k];
        p.lo[k] = box[k];
        p.hi[k] = box[3 + k];
        p.bnd[k] = bnd[k];
    }
    p.D = D;
    for (int d = 0; d < D; ++d) {
        p.delta[d] = delta[d];
        for (int k = 0; k < 3; ++k)
            p.off[d][k] = offsets[3 * d + k];
    }
    const int64_t N = p.n[0] * p.n[1] * p.n[2];
    if (N == 0)
        return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = dtype == 0 ? launch_dtype<float>(coeffs, x, y, p, N, s)
                                       : launch_dtype<double>(coeffs, x, y, p, N, s);
    return static_cast<int>(err);
}
