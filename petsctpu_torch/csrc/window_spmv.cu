// H2: the windowed scalar SELL SpMV of the round-4 probes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of scripts/probe_pallas_gather2.py:81
// and computes the same function on the same arrays:
//
//   starts [nb] int32, q [n,K] int32, r [n,K] int32, vals [n,K] f32,
//   x [Lx] f32, rows in blocks of Rb (n = nb*Rb);
//   y[i] = sum over k of vals[i,k] * x[starts[i/Rb] + 128*q[i,k] + r[i,k]],
//   summed in k order starting from 0.
//
// The TPU kernel copies each block's 256 KB window of x into VMEM and
// gathers from it. A block here has at most 227 KB of shared memory, so
// the window is not staged: x is read through L1/L2 (all of x is under
// 1 MB at the probe's size and stays in L2).
//
// Design (first version: simple and right): one thread per row, a loop
// over k. Each step rounds the product and the sum separately
// (__fmul_rn then __fadd_rn), so the kernel equals the plain PyTorch
// version (petsctpu_torch/ops/window_spmv.py) bit for bit.
//
// Bound: memory. The compulsory traffic is 12*n*K bytes of vals, q and r
// plus x and y once, against 2 flops per slot. A thread walks its row's
// K entries, so a warp's loads of one step touch 32 lines K*4 bytes
// apart; the lines are reused over the next steps from L1. Staging the
// row slabs through shared memory (coalesced) is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_spmv_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ q,
                   const int32_t* __restrict__ r,
                   const float* __restrict__ vals,
                   const float* __restrict__ x,
                   float* __restrict__ y,
                   int n, int K, int Rb)
{
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= n)
        return;
    const int64_t base = starts[i / Rb];
    const int64_t row = static_cast<int64_t>(i) * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
        const int64_t col = base + 128 * static_cast<int64_t>(q[row + k])
            + r[row + k];
        acc = __fadd_rn(acc, __fmul_rn(vals[row + k], x[col]));
    }
    y[i] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int window_spmv_launch(const void* starts, const void* q,
                                  const void* r, const void* vals,
                                  const void* x, void* y, int n, int K,
                                  int Rb, void* stream)
{
    if (n <= 0)
        return 0;
    const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    window_spmv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(q),
        static_cast<const int32_t*>(r), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), n, K, Rb);
    return static_cast<int>(cudaGetLastError());
}
