// K3: the transpose product y = Aᵀr of a chunk-mode SELL operator, for
// Hopper (sm_90a), as a gather over a transpose plan.
//
// Replaces the Pallas TPU kernel petsctpu/mat/sell.py::_sell_spmvT_chunk
// together with the per-tile window combine that SellMat.multT runs after
// it (petsctpu/mat/sell.py:118-124). Mosaic has no scatter, so the TPU
// kernel sums each pass's row into a window by one-hot compares and adds
// the windows into y. Here the pack is first turned into a plan
// (petsctpu_torch/ops/sell_spmvT.py::transpose_plan): for each output o
// (an entry of y [Lp*128]) the list of the live slots that add into it,
// in (tile, pass, row) order, each entry a value and a code
//
//   val [E] f32, src [E] u32 = fine row f | kPassFlag | kTileFlag,
//
// the flags saying that the entry starts a new pass or a new tile of its
// output. List s has cnt[s] entries, entry k at first[s] + stride*k.
//
// A list is walked with three sums in registers, each a left fold from
// +0 rounded once per product and once per add (__fmul_rn, __fadd_rn, no
// FMA contraction):
//   part += val * r[f]            the pass's row, over its slots;
//   w    += part at a new pass    the tile's window row, over its passes;
//   y    += w at a new tile       the output, over its tiles;
// and y = y + (w + part) at the end: the fold order of sell_spmvT_plain
// on the pack (which stays the definition), so the kernel equals it and
// the plan's plain version bit for bit. No windows, no scratch, no float
// atomics: every launch gives the same bits.
//
// Two launch shapes, chosen when the plan is built (the rule and why are
// in transpose_plan):
//   thread shape (stride 32): one thread an output, its whole list. The
//     lists of 32 consecutive outputs are interleaved by lane, so a
//     warp's loads at step k are 128 contiguous bytes (a list shorter
//     than the longest of its 32 is padded, and the padding never read);
//     the thread writes y[o] once.
//   warp shape (stride 1): one warp an output; the output's list is
//     split where a tile starts, each lane walks one tile's segment
//     (contiguous: its w), and the warp folds the lanes' results in tile
//     order through shuffles, 32 segments a group, carrying y across the
//     output's groups. Each w_t is independent of the others, so the
//     split computes the same bits.
//
// Bound: memory. The compulsory traffic is 8 bytes an entry (val, src),
// r once and y once, against 2 flops an entry. r is gathered through L2
// (8.4 MB on the 128³ GAMG level 0); in the thread shape val and src are
// streamed (__ldcs) so they do not push r out of it, in the warp shape a
// lane reads them through L1, 8 entries a sector. kAhead entries of a
// list are loaded before their gathers, so a thread keeps 2*kAhead loads
// and then kAhead gathers in flight. Offsets are 32-bit: a plan holds
// fewer than 2³¹ entries.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kTileFlag = 1u << 31;
constexpr uint32_t kPassFlag = 1u << 30;
constexpr uint32_t kRowMask = kPassFlag - 1u;
constexpr int kThreads = 256;
constexpr int kAhead = 8;                 // entries of a list in flight
constexpr unsigned kFull = 0xffffffffu;

// One list: n entries at e, e + kStride, ...; returns y + (w + part).
template <int kStride>
__device__ __forceinline__ float walk(const float* __restrict__ val,
                                      const uint32_t* __restrict__ src,
                                      const float* __restrict__ r,
                                      int e, int n)
{
    float y = 0.0f, w = 0.0f, part = 0.0f;
    for (int k = 0; k < n; k += kAhead, e += kStride * kAhead) {
        float v[kAhead], x[kAhead];
        uint32_t c[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const bool on = k + u < n;
            const int at = e + kStride * u;
            if (kStride == 1) {
                v[u] = on ? __ldg(val + at) : 0.0f;
                c[u] = on ? __ldg(src + at) : 0u;
            } else {
                v[u] = on ? __ldcs(val + at) : 0.0f;
                c[u] = on ? __ldcs(src + at) : 0u;
            }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
            x[u] = k + u < n ? __ldg(r + (c[u] & kRowMask)) : 0.0f;
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            // an entry past the list has code 0 and adds +0 to part,
            // which is never -0: no bit changes
            if (c[u] & kPassFlag) {
                w = __fadd_rn(w, part);
                part = 0.0f;
            }
            if (c[u] & kTileFlag) {
                y = __fadd_rn(y, w);
                w = 0.0f;
            }
            part = __fadd_rn(part, __fmul_rn(v[u], x[u]));
        }
    }
    return __fadd_rn(y, __fadd_rn(w, part));
}

__global__ void __launch_bounds__(kThreads)
spmvT_thread(const float* __restrict__ val, const uint32_t* __restrict__ src,
             const int32_t* __restrict__ first,
             const int32_t* __restrict__ cnt,
             const float* __restrict__ r, float* __restrict__ y, int nout)
{
    const int o = blockIdx.x * kThreads + threadIdx.x;
    if (o >= nout)
        return;
    y[o] = walk<32>(val, src, r, first[o], cnt[o]);
}

__global__ void __launch_bounds__(kThreads)
spmvT_warp(const float* __restrict__ val, const uint32_t* __restrict__ src,
           const int32_t* __restrict__ first, const int32_t* __restrict__ cnt,
           const int32_t* __restrict__ ogroup, const float* __restrict__ r,
           float* __restrict__ y, int nout)
{
    const int o = (blockIdx.x * kThreads + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (o >= nout)                        // uniform across the warp
        return;
    float acc = 0.0f;
    for (int j = ogroup[o]; j < ogroup[o + 1]; ++j) {
        const int s = 32 * j + lane;
        const float seg = walk<1>(val, src, r, first[s], cnt[s]);
#pragma unroll
        for (int i = 0; i < 32; ++i)      // the segments in tile order
            acc = __fadd_rn(acc, __shfl_sync(kFull, seg, i));
    }
    if (lane == 0)
        y[o] = acc;
}

}  // namespace

// Launches the plan's shape on `stream` and returns cudaGetLastError()
// (0 on success). y has nout floats; ogroup is read in the warp shape.
extern "C" int sell_spmvT_launch(const void* val, const void* src,
                                 const void* first, const void* cnt,
                                 const void* ogroup, const void* r, void* y,
                                 int nout, int warp_shape, void* stream)
{
    const auto st = static_cast<cudaStream_t>(stream);
    const auto v = static_cast<const float*>(val);
    const auto s = static_cast<const uint32_t*>(src);
    const auto f = static_cast<const int32_t*>(first);
    const auto n = static_cast<const int32_t*>(cnt);
    const auto x = static_cast<const float*>(r);
    const auto out = static_cast<float*>(y);
    if (nout <= 0)
        return 0;
    if (warp_shape) {
        const unsigned blocks = static_cast<unsigned>(
            (static_cast<int64_t>(nout) * 32 + kThreads - 1) / kThreads);
        spmvT_warp<<<blocks, kThreads, 0, st>>>(
            v, s, f, n, static_cast<const int32_t*>(ogroup), x, out, nout);
    } else {
        const unsigned blocks = static_cast<unsigned>(
            (nout + kThreads - 1) / kThreads);
        spmvT_thread<<<blocks, kThreads, 0, st>>>(v, s, f, n, x, out, nout);
    }
    return static_cast<int>(cudaGetLastError());
}
