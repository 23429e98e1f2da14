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
// the window is not staged: x is gathered through L1 and L2 (all of x
// is under 1 MB at the probe's size and stays in L2).
//
// Bound: memory. The compulsory traffic is 12*n*K bytes of vals, q and r
// plus the reached x and y once, against 2 flops a slot. A one-thread-a-
// row kernel reads a row's slabs K*4 bytes apart across a warp, 32 lines
// a load for each array, and loses them from L1 before its next step.
//
// Design: a warp owns 32 consecutive rows and walks them in chunks of 32
// slots. For each row j of the chunk, lane k reads slot k of row j (one
// 128-byte line of q, r and vals when K is 32), so a load is coalesced
// and 32 independent gathers of x issue at once; the rows' loads are
// unrolled so several rows are in flight. Lane k rounds its product
// (__fmul_rn) into a [32][33] shared-memory tile at [j][k] (the padding
// keeps both the stores and the reads free of bank conflicts); after
// __syncwarp lane j adds row j's chunk onto its running sum with
// __fadd_rn in k order, and the sum carries across chunks. So each row
// is folded from +0 in k order with one rounding a product and a sum,
// and the kernel equals the plain PyTorch version
// (petsctpu_torch/ops/window_spmv.py) bit for bit for any K, any Rb that
// divides n (each row reads its own starts[i/Rb]) and any n (rows past n
// are masked). The slabs are read with the streaming hint, so L1 keeps
// x; the grid is what the card holds at once, each warp striding over
// row groups, and the shared-memory carveout is the least the resident
// tiles need, the rest of the SM's 256 KB left to L1 for x (at the
// default carveout fewer blocks fit and the kernel ran 1.6 times as
// long).
//
// What sets the pace on an H100 is the random gathers of x: with every
// gather pointed into one 512-byte line the probe's product ran in half
// the time (PERF.md, section 6). Narrower chunks (16 or 8 slots, a
// smaller tile and more L1) and fewer resident warps were no faster, and
// the TPU's staged window in Hopper's form, split over a 2-block
// cluster's shared memory and gathered through distributed shared
// memory, was slower (0.064 ms against 0.045 on the probe).

#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

constexpr int kWarps = 4;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBytes = kWarps * 32 * 33 * 4;

__global__ void __launch_bounds__(kThreads)
window_spmv_kernel(const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ q,
                   const int32_t* __restrict__ r,
                   const float* __restrict__ vals,
                   const float* __restrict__ x,
                   float* __restrict__ y,
                   int n, int K, int Rb)
{
    __shared__ float tile[kWarps][32][33];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float (*t)[33] = tile[warp];
    const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * 32;
    for (int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
         row0 < n; row0 += step) {
        const int rows = static_cast<int>(n - row0 < 32 ? n - row0 : 32);
        const int64_t mine = lane < rows ? starts[(row0 + lane) / Rb] : 0;
        float acc = 0.0f;
        for (int k0 = 0; k0 < K; k0 += 32) {
            const int k = k0 + lane;
#pragma unroll 8   // eight rows' loads issue together
            for (int j = 0; j < 32; ++j) {
                const int64_t base = __shfl_sync(kFull, mine, j);
                float p = 0.0f;
                if (j < rows && k < K) {
                    const int64_t s = (row0 + j) * K + k;
                    const int64_t col = base + 128 * static_cast<int64_t>(__ldcs(q + s))
                        + __ldcs(r + s);
                    p = __fmul_rn(__ldcs(vals + s), __ldg(x + col));
                }
                t[j][lane] = p;
            }
            __syncwarp();
            const int m = K - k0 < 32 ? K - k0 : 32;
            for (int kk = 0; kk < m; ++kk)
                acc = __fadd_rn(acc, t[lane][kk]);
            __syncwarp();
        }
        if (lane < rows)
            y[row0 + lane] = acc;
    }
}

// The kernel's resident blocks an SM at full occupancy, asked once a
// device.
cudaError_t blocks_per_sm(int dev, int* per_sm)
{
    static card::PerDevice cache;
    return cache.get(dev, per_sm, [](int* out) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, window_spmv_kernel,
                                                             kThreads, 0);
    });
}

// Sets the kernel's shared-memory carveout to the least that `blocks`
// resident blocks an SM need (each tile plus the 1 KB the runtime
// reserves a block), once a device for each value.
cudaError_t set_carveout(int dev, int blocks)
{
    static int last[card::kDevices] = {};
    constexpr int kSmPerSm = 228 * 1024;
    const int need = blocks * (kTileBytes + 1024);
    int percent = (100 * need + kSmPerSm - 1) / kSmPerSm;
    percent = percent < 1 ? 1 : (percent > 100 ? 100 : percent);
    if (dev < card::kDevices && last[dev] == percent)
        return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        window_spmv_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, percent);
    if (err == cudaSuccess && dev < card::kDevices)
        last[dev] = percent;
    return err;
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int window_spmv_launch(const void* starts, const void* q,
                                  const void* r, const void* vals,
                                  const void* x, void* y, int n, int K,
                                  int Rb, void* stream)
{
    if (n <= 0)
        return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = card::sm_count(dev, &sms);
    if (err == cudaSuccess)
        err = blocks_per_sm(dev, &per_sm);
    if (err != cudaSuccess)
        return static_cast<int>(err);
    // as many blocks as the card holds at once, spread evenly over the
    // row groups
    const int64_t blocks = card::even_blocks((static_cast<int64_t>(n) + 31) / 32,
                                             kWarps, sms, per_sm);
    err = set_carveout(dev, static_cast<int>((blocks + sms - 1) / sms));
    if (err != cudaSuccess)
        return static_cast<int>(err);
    window_spmv_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(q),
        static_cast<const int32_t*>(r), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(y), n, K, Rb);
    return static_cast<int>(cudaGetLastError());
}
