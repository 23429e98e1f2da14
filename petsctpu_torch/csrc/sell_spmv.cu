// K2: sliced-ELL SpMV with source-slice passes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel petsctpu/mat/sell.py::_sell_spmv and
// computes the same function on the same packed arrays:
//
//   vals [nt,P,G,128] f32, idx [nt,P,G,128] int8 (position 0..127 in a
//   128-wide chunk of x), qs [nt,P] int32, winstart [nt] int32,
//   xp [Lp,128] f32 (x at padded row G), y [nt,G,128] f32;
//   y[t,g,l] = sum over p of vals[t,p,g,l] * xp[winstart[t] + qs[t,p]
//              + (diag ? g : 0), idx[t,p,g,l]],
//   summed in pass order starting from 0.
//
// Design (first version: simple and right). The grid is (nt, G) with
// one 128-thread block per (tile, row group), one thread per lane.
// Each thread loops over the passes: qs[t,p] is one address for the
// whole block (a broadcast load), vals and idx are coalesced across
// the lanes, and the x entry is one gather from global memory, served
// by L2 when neighbouring tiles share the window. Nothing is staged in
// shared memory; a shared-memory or TMA window is later work. Each
// step rounds the product and the sum separately (__fmul_rn then
// __fadd_rn), which forbids FMA contraction, so the kernel equals the
// plain PyTorch version (petsctpu_torch/ops/sell_spmv.py) bit for bit.
// petsctpu splits the passes into chunks only to fit its fast memory;
// whenever it runs one chunk (P <= 307 at G = 16) its sum order is
// this one too.
//
// Bound: memory. The compulsory traffic is 5*nt*P*G*128 bytes of vals
// and idx, 4*nt*G*128 bytes of y and about 4*n bytes of x (plus the
// small qs and winstart), against 2 flops per slot: far below the
// card's ratio of operations to bytes. This design does nothing more
// about the bound than coalescing vals/idx/y; x goes through L2, and
// tiles whose windows overlap re-read it there.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
sell_spmv_kernel(const float* __restrict__ vals,
                 const int8_t* __restrict__ idx,
                 const int32_t* __restrict__ qs,
                 const int32_t* __restrict__ winstart,
                 const float* __restrict__ xp,
                 float* __restrict__ y,
                 int P, int G, int diag)
{
    const int t = blockIdx.x;
    const int g = blockIdx.y;
    const int l = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(winstart[t]) + (diag ? g : 0);
    const int32_t* q = qs + static_cast<int64_t>(t) * P;
    const int64_t pstride = static_cast<int64_t>(G) * kLanes;
    int64_t slot = (static_cast<int64_t>(t) * P * G + g) * kLanes + l;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p, slot += pstride) {
        const float v = vals[slot];
        const int c = idx[slot];
        const float x = xp[(row0 + q[p]) * kLanes + c];
        acc = __fadd_rn(acc, __fmul_rn(v, x));
    }
    y[(static_cast<int64_t>(t) * G + g) * kLanes + l] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sell_spmv_launch(const void* vals, const void* idx,
                                const void* qs, const void* winstart,
                                const void* xp, void* y,
                                int nt, int P, int G, int diag,
                                void* stream)
{
    const dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(G));
    sell_spmv_kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int8_t*>(idx),
        static_cast<const int32_t*>(qs), static_cast<const int32_t*>(winstart),
        static_cast<const float*>(xp), static_cast<float*>(y), P, G, diag);
    return static_cast<int>(cudaGetLastError());
}
