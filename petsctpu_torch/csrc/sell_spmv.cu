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
// Each step rounds the product and the sum separately (__fmul_rn then
// __fadd_rn), which forbids FMA contraction, so the kernel equals the
// plain PyTorch version (petsctpu_torch/ops/sell_spmv.py) bit for bit,
// padding slots (value 0) included. petsctpu splits the passes into
// chunks only to fit its fast memory; whenever it runs one chunk (P <=
// 307 at G = 16) its sum order is this one too.
//
// Design. A block of 128 threads takes kGroups = 4 row groups of one
// tile (grid (nt, ceil(G/4))); a thread owns four consecutive lanes of
// its row group and reads a pass's four values as one float4 and their
// four int8 positions as one 32-bit word. The passes go kBatch = 4 at a
// time: first the batch's value and position loads and its rows (qs
// read once a pass, one address for the warp), then its 16 gathers of
// x, then the fold in pass order, so that a thread keeps 8 loads and
// then 16 gathers in flight. The mode is a template parameter; offsets
// are 64-bit. vals and idx are streamed (__ldcs) so they do not push x
// out of L2; x is gathered through L1/L2 (a pass's four lanes read one
// 512-byte row of x). Timed on the H100 (PERF.md): the float4 shape
// closed most of the gap to the bound at ex45 128³ (7 passes), and the
// batch keeps a long pass loop (the 96 passes of the gather7 probe)
// from running one round trip a pass.
//
// Bound: memory. The compulsory traffic is 5*nt*P*G*128 bytes of vals
// and idx, 4*nt*G*128 bytes of y and about 4*n bytes of x (plus the
// small qs and winstart), against 2 flops per slot: far below the
// card's ratio of operations to bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroups = kThreads / 32;    // row groups a block
constexpr int kBatch = 4;                 // passes in flight

template <bool kDiag>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const float4* __restrict__ vals,
                 const uint32_t* __restrict__ idx,
                 const int32_t* __restrict__ qs,
                 const int32_t* __restrict__ winstart,
                 const float* __restrict__ xp,
                 float4* __restrict__ y, int P, int G)
{
    const int g = blockIdx.y * kGroups + threadIdx.x / 32;
    if (g >= G)
        return;
    const int64_t t = blockIdx.x;
    const int64_t row0 = static_cast<int64_t>(winstart[t]) + (kDiag ? g : 0);
    const int32_t* q = qs + t * P;
    const int64_t pstride = static_cast<int64_t>(G) * 32;   // float4s a pass
    int64_t slot = (t * P * G + g) * 32 + threadIdx.x % 32;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int p0 = 0; p0 < P; p0 += kBatch, slot += kBatch * pstride) {
        float4 v[kBatch];
        uint32_t c[kBatch];
        const float* xr[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            if (p0 + b < P) {
                v[b] = __ldcs(vals + slot + b * pstride);
                c[b] = __ldcs(idx + slot + b * pstride);
                xr[b] = xp + (row0 + q[p0 + b]) * 128;
            }
        }
        float x[kBatch][4];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            if (p0 + b < P) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    x[b][i] = __ldg(xr[b] + ((c[b] >> (8 * i)) & 0xffu));
            }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            if (p0 + b < P) {
                a0 = __fadd_rn(a0, __fmul_rn(v[b].x, x[b][0]));
                a1 = __fadd_rn(a1, __fmul_rn(v[b].y, x[b][1]));
                a2 = __fadd_rn(a2, __fmul_rn(v[b].z, x[b][2]));
                a3 = __fadd_rn(a3, __fmul_rn(v[b].w, x[b][3]));
            }
        }
    }
    y[(t * G + g) * 32 + threadIdx.x % 32] = make_float4(a0, a1, a2, a3);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// vals must be 16-byte and idx 4-byte aligned.
extern "C" int sell_spmv_launch(const void* vals, const void* idx,
                                const void* qs, const void* winstart,
                                const void* xp, void* y,
                                int nt, int P, int G, int diag,
                                void* stream)
{
    const dim3 grid(static_cast<unsigned>(nt),
                    static_cast<unsigned>((G + kGroups - 1) / kGroups));
    const auto st = static_cast<cudaStream_t>(stream);
    const auto v = static_cast<const float4*>(vals);
    const auto c = static_cast<const uint32_t*>(idx);
    const auto q = static_cast<const int32_t*>(qs);
    const auto w = static_cast<const int32_t*>(winstart);
    const auto x = static_cast<const float*>(xp);
    const auto out = static_cast<float4*>(y);
    if (diag)
        sell_spmv_kernel<true><<<grid, kThreads, 0, st>>>(v, c, q, w, x, out,
                                                          P, G);
    else
        sell_spmv_kernel<false><<<grid, kThreads, 0, st>>>(v, c, q, w, x, out,
                                                           P, G);
    return static_cast<int>(cudaGetLastError());
}
