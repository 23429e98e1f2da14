// H3: the gather forms of the round-4 TPU probes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/probe_pallas_gather.py
// (:19, :54, :69), probe_pallas_gather2.py:22, probe_pallas_gather3.py
// (:23, :45), probe_pallas_gather4.py (:26, :51), probe_pallas_gather5.py
// :22 and probe_gather6.py (:26, :75, :99). Each computes one gather of
// a float32 source x [S,L] (or 1-D) by int32 or int16 indices:
//
//   take       out[k]   = x[idx[k]]                          (x 1-D)
//   rows       out[i,j] = x[idx[i], j]
//   axis0      out[i,j] = x[idx[i,j], j]                     (take_along_axis 0)
//   axis1      out[i,j] = x[i, idx[i,j]]                     (take_along_axis 1)
//   chain      out[i,j] = x[idx[i,c], c] with c = idx2[i,j]  (axis 0, then 1)
//   window     out[i,j] = x[t + i + q/L, q%L], q = idx[i,j] or j
//                         (the concat of shifted row views, then a lane take)
//   transpose  out[i,j] = x[j, i]
//
// optionally summed over `blocks` column blocks of the gathered row
// (a[:, :n] + a[:, n:2n] + ...), and over a leading reps axis of the
// indices, folded from +0 in rep order. The TPU kernels did these in one
// VMEM-resident block; Mosaic could not lower some of them at all
// (PARITY.md: axis-0 take_along_axis, lane gathers wider than 128).
//
// Design. A gather runs one thread per output element, the index
// arithmetic done in the kernel from the indices as given; every read of
// x is one load from global memory (the probes' sources are at most 512
// rows, so they stay in L1/L2). A sum over reps with too few outputs to
// fill the card (the Sigma of 64 takes of P12 and P13, 2,048 outputs)
// runs rep_sum_kernel instead: a block owns 32 consecutive outputs (a
// lane each, so index loads coalesce), its warps (one for each kRepBatch
// reps, at most 8) share the reps, and a warp gathers kRepBatch reps at
// once, issuing all their index loads, then their dependent loads, before
// any store, so a thread waits one chain (idx2 -> idx -> x for chain) a
// batch and not one a rep. The gathered values go to shared memory, a
// batch of each warp's reps at a time, and warp 0 folds them from +0 in
// rep order. A thread an output runs P12's 64 reps as 64 dependent
// chains on 8 SMs: 0.0142 ms on an H100 against a 0.000291 ms bound. Sums
// round each add on its own (__fadd_rn), in the order of the plain
// PyTorch version (petsctpu_torch/ops/gather_forms.py), so the two agree
// bit for bit; pure gathers are exact.
//
// Bound: memory, and at the probes' sizes the launch. Each output is a
// dependent chain of one or two index loads and one x load; the
// compulsory bytes are the indices, x once and the output, a few
// hundred KB at most, so every case is microseconds.

#include <cstdint>

#include <cuda_runtime.h>

#include "card.cuh"

namespace {

enum Form { kTake = 0, kRows, kAxis0, kAxis1, kChain, kWindow, kTranspose };

constexpr int kThreads = 256;

struct Args {
    const float* x;
    const void* idx;
    const void* idx2;
    float* out;
    int64_t total;     // output elements
    int reps, M, N;    // index dims [reps, M, N]
    int L;             // row length of x
    int t;             // window row offset
    int blocks;        // column blocks summed; output width N / blocks
};

template <int F, typename I>
__device__ __forceinline__ float fetch(const Args& a, int r, int i, int j)
{
    const I* idx = static_cast<const I*>(a.idx);
    const int64_t k = (static_cast<int64_t>(r) * a.M + i) * a.N + j;
    if (F == kTake)
        return a.x[idx[k]];
    if (F == kRows)
        return a.x[static_cast<int64_t>(idx[i]) * a.L + j];
    if (F == kAxis0)
        return a.x[static_cast<int64_t>(idx[k]) * a.L + j];
    if (F == kAxis1)
        return a.x[static_cast<int64_t>(i) * a.L + idx[k]];
    if (F == kChain) {
        const int c = static_cast<const I*>(a.idx2)[k];
        const int row = idx[k - j + c];
        return a.x[static_cast<int64_t>(row) * a.L + c];
    }
    if (F == kWindow) {
        const int q = idx ? static_cast<int>(idx[k]) : j;
        return a.x[static_cast<int64_t>(a.t + i + q / a.L) * a.L + q % a.L];
    }
    return a.x[static_cast<int64_t>(j) * a.L + i];          // kTranspose
}

template <int F, typename I>
__device__ __forceinline__ float block_sum(const Args& a, int r, int i, int j,
                                           int width)
{
    float s = fetch<F, I>(a, r, i, j);
    for (int b = 1; b < a.blocks; ++b)
        s = __fadd_rn(s, fetch<F, I>(a, r, i, j + b * width));
    return s;
}

// One thread an output, its reps (if any) folded from +0 in order.
template <int F, typename I>
__global__ void __launch_bounds__(kThreads) gather_kernel(Args a)
{
    const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (o >= a.total)
        return;
    const int width = a.N / a.blocks;
    const int i = static_cast<int>(o / width);
    const int j = static_cast<int>(o % width);
    float acc;
    if (a.reps == 1) {
        acc = block_sum<F, I>(a, 0, i, j, width);
    } else {
        acc = 0.0f;
        for (int r = 0; r < a.reps; ++r)
            acc = __fadd_rn(acc, block_sum<F, I>(a, r, i, j, width));
    }
    a.out[o] = acc;
}

constexpr int kRepWarps = 8;     // most warps of a rep_sum block
constexpr int kRepBatch = 8;     // reps a warp gathers at once
constexpr int kRepChunk = kRepWarps * kRepBatch;   // most reps staged at a time

// A block of 32 outputs summed over reps (see the design note above).
template <int F, typename I>
__global__ void __launch_bounds__(32 * kRepWarps) rep_sum_kernel(Args a)
{
    __shared__ float part[kRepChunk][32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;          // warps: reps / kRepBatch, at most 8
    const int64_t o = static_cast<int64_t>(blockIdx.x) * 32 + lane;
    // a lane past the end gathers the last output's values and stores none
    const int64_t oc = o < a.total ? o : a.total - 1;
    const int width = a.N / a.blocks;
    const int i = static_cast<int>(oc / width);
    const int j = static_cast<int>(oc % width);
    float acc = 0.0f;
    for (int r0 = 0; r0 < a.reps; r0 += nw * kRepBatch) {
        const int n = min(nw * kRepBatch, a.reps - r0);
        int rr[kRepBatch];
        float v[kRepBatch];
#pragma unroll
        for (int u = 0; u < kRepBatch; ++u)
            rr[u] = r0 + min(w + u * nw, n - 1);
#pragma unroll
        for (int u = 0; u < kRepBatch; ++u)
            v[u] = fetch<F, I>(a, rr[u], i, j);
        for (int b = 1; b < a.blocks; ++b) {
#pragma unroll
            for (int u = 0; u < kRepBatch; ++u)
                v[u] = __fadd_rn(v[u], fetch<F, I>(a, rr[u], i, j + b * width));
        }
#pragma unroll
        for (int u = 0; u < kRepBatch; ++u)
            if (w + u * nw < n)
                part[w + u * nw][lane] = v[u];
        __syncthreads();
        if (w == 0)
            for (int r = 0; r < n; ++r)
                acc = __fadd_rn(acc, part[r][lane]);
        __syncthreads();
    }
    if (w == 0 && o < a.total)
        a.out[o] = acc;
}

// Outputs below which a sum over reps takes rep_sum_kernel: one
// kThreads-thread block for each SM of the current card (33,792 on an
// H100's 132). With more, a thread an output fills the card, and its
// serial reps hide behind the other warps (P7's 65,536 outputs of 16
// reps on an H100: 0.0032 ms a thread an output, 0.0047 in rep_sum
// blocks). The SM count is asked once a device.
cudaError_t rep_sum_outputs(int64_t* outputs)
{
    int dev = 0, n = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = card::sm_count(dev, &n);
    if (err != cudaSuccess)
        return err;
    *outputs = static_cast<int64_t>(n) * kThreads;
    return cudaSuccess;
}

template <int F, typename I>
cudaError_t launch_form(const Args& a, cudaStream_t stream)
{
    int64_t rep_sum_below = 0;
    if (a.reps > 1) {
        const cudaError_t err = rep_sum_outputs(&rep_sum_below);
        if (err != cudaSuccess)
            return err;
    }
    if (a.total < rep_sum_below) {
        const unsigned grid = static_cast<unsigned>((a.total + 31) / 32);
        const int warps = min(kRepWarps, (a.reps + kRepBatch - 1) / kRepBatch);
        rep_sum_kernel<F, I><<<grid, 32 * warps, 0, stream>>>(a);
    } else {
        const unsigned grid = static_cast<unsigned>((a.total + kThreads - 1) / kThreads);
        gather_kernel<F, I><<<grid, kThreads, 0, stream>>>(a);
    }
    return cudaGetLastError();
}

template <typename I>
cudaError_t launch(int form, const Args& a, cudaStream_t stream)
{
    switch (form) {
    case kTake: return launch_form<kTake, I>(a, stream);
    case kRows: return launch_form<kRows, I>(a, stream);
    case kAxis0: return launch_form<kAxis0, I>(a, stream);
    case kAxis1: return launch_form<kAxis1, I>(a, stream);
    case kChain: return launch_form<kChain, I>(a, stream);
    case kWindow: return launch_form<kWindow, I>(a, stream);
    case kTranspose: return launch_form<kTranspose, I>(a, stream);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// idx_bytes is 4 (int32) or 2 (int16); idx and idx2 may be null where
// the form takes none.
extern "C" int gather_forms_launch(int form, int idx_bytes, const void* x,
                                   const void* idx, const void* idx2,
                                   void* out, long long total, int reps,
                                   int M, int N, int L, int t, int blocks,
                                   void* stream)
{
    if (total <= 0)
        return 0;
    const Args a{static_cast<const float*>(x), idx, idx2,
                 static_cast<float*>(out), total, reps, M, N, L, t, blocks};
    const auto s = static_cast<cudaStream_t>(stream);
    if (idx_bytes == 4)
        return static_cast<int>(launch<int32_t>(form, a, s));
    if (idx_bytes == 2)
        return static_cast<int>(launch<int16_t>(form, a, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
