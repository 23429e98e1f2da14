// H1: the SELL pass of the round-4 probes (per-tile, per-group and
// crossed row selection over a chunk stream), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/probe_sell_bisect.py (:71,
// :106, :160, :208), probe_gather7.py:48 (base, V1 and V2),
// probe_sell2_compact.py:90, probe_sell2_onehot.py:114 and
// probe_sellx_crossed.py:110 (= probe_gather8.py:110), and computes what
// they compute:
//
//   vals [NCH,P,G,128] f32, idx [NCH,P,G,128] int8 or int32 (a lane j of
//   x's 128), xp [Lx,128] f32; tile t owns the chunks cstart[t] ..
//   cstart[t]+nch[t]-1 and reads x from row ws[t];
//   y[t,g,l] = sum over its chunks ch, in order, of
//              part[ch] = sum over p of vals[ch,p,g,l]
//                                     * xp[ws[t] + row, idx[ch,p,g,l]],
//   each part folded from 0 in pass order, the first chunk's part taken
//   as it is and each later one added to it. The row of a slot is
//     tile:    qs[ch,p] + g
//     group:   qbase + qoff[ch,p,g], qbase per chunk, per pass or 0,
//              qoff int8 or int32 (gather7 V1/V2, sell2_onehot; V2's
//              one-hot product on the TPU is this exact row select)
//     crossed: 128*hh[ch] + i1[ch, j, G*p + g] with j = idx[ch,p,g,l]
//              (SELL-X, P*G = 128).
//
// On the TPU each of these is a VMEM window of x, one grid step per
// chunk and a sum carried in the output block across steps; the
// per-group and crossed forms needed one-hot products or transposes
// there (PARITY.md), here they are ordinary gathers.
//
// Design (first version, K2's): one 128-thread block per (tile, row
// group), one thread per lane; a loop over the tile's chunks and their
// passes. vals and idx are read coalesced, the per-pass row offsets are
// one broadcast address for the block (tile and group) or an L1 gather
// from i1's 16 KB chunk slab (crossed), and the x entry is one gather
// from global memory: the probes' x buffers are at most 320 rows
// (160 KB) and stay in L1/L2, so no shared-memory window is needed.
// Each step rounds product and sum separately (__fmul_rn, __fadd_rn),
// so the kernel equals the plain PyTorch version
// (petsctpu_torch/ops/sell_pass.py) bit for bit.
//
// Bound: memory. 5 (int8 idx) or 8 (int32) bytes per slot of vals and
// idx, plus the per-pass indices, x once and y, against 2 flops per
// slot. This design coalesces the slot stream and leaves x to the
// caches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

enum Mode { kTile = 0, kGroup = 1, kCrossed = 2 };

struct Args {
    const float* vals;
    const void* idx;
    const float* xp;
    const int32_t* ws;
    const int32_t* cstart;
    const int32_t* nch;
    const int32_t* qs;      // tile: qs [NCH,P]; group: qbase or null
    const void* qoff;       // group: [NCH,P,G]
    const int32_t* hh;      // crossed: [NCH]
    const int8_t* i1;       // crossed: [NCH,128,128]
    float* y;
    int P, G;
    int qbase_per_pass;     // group: qbase is [NCH,P] (1) or [NCH] (0)
};

template <int MODE, typename I, typename Q>
__global__ void __launch_bounds__(kLanes) sell_pass_kernel(Args a)
{
    const int t = blockIdx.x;
    const int g = blockIdx.y;
    const int l = threadIdx.x;
    const I* idx = static_cast<const I*>(a.idx);
    const Q* qoff = static_cast<const Q*>(a.qoff);
    const int64_t base = a.ws[t];
    const int64_t c0 = a.cstart[t];
    const int n = a.nch[t];
    const int64_t pstride = static_cast<int64_t>(a.G) * kLanes;
    float out = 0.0f;
    for (int c = 0; c < n; ++c) {
        const int64_t ch = c0 + c;
        int64_t slot = (ch * a.P * a.G + g) * kLanes + l;
        float acc = 0.0f;
        for (int p = 0; p < a.P; ++p, slot += pstride) {
            const float v = a.vals[slot];
            const int j = idx[slot];
            int64_t row;
            if (MODE == kTile) {
                row = a.qs[ch * a.P + p] + g;
            } else if (MODE == kGroup) {
                row = qoff[(ch * a.P + p) * a.G + g];
                if (a.qs)
                    row += a.qs[a.qbase_per_pass ? ch * a.P + p : ch];
            } else {
                row = 128 * static_cast<int64_t>(a.hh[ch])
                    + a.i1[(ch * 128 + j) * 128 + a.G * p + g];
            }
            acc = __fadd_rn(acc, __fmul_rn(v, a.xp[(base + row) * kLanes + j]));
        }
        out = c == 0 ? acc : __fadd_rn(out, acc);
    }
    a.y[(static_cast<int64_t>(t) * a.G + g) * kLanes + l] = out;
}

template <int MODE, typename I, typename Q>
cudaError_t launch(const Args& a, int nt, cudaStream_t stream)
{
    const dim3 grid(static_cast<unsigned>(nt), static_cast<unsigned>(a.G));
    sell_pass_kernel<MODE, I, Q><<<grid, kLanes, 0, stream>>>(a);
    return cudaGetLastError();
}

template <typename I>
cudaError_t launch_mode(int mode, int qoff_bytes, const Args& a, int nt,
                        cudaStream_t stream)
{
    if (mode == kTile)
        return launch<kTile, I, int8_t>(a, nt, stream);
    if (mode == kCrossed)
        return launch<kCrossed, I, int8_t>(a, nt, stream);
    if (mode == kGroup && qoff_bytes == 1)
        return launch<kGroup, I, int8_t>(a, nt, stream);
    if (mode == kGroup && qoff_bytes == 4)
        return launch<kGroup, I, int32_t>(a, nt, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// mode: 0 tile, 1 group, 2 crossed; idx_bytes and qoff_bytes are 1
// (int8) or 4 (int32). Pointers a mode does not use may be null.
extern "C" int sell_pass_launch(int mode, int idx_bytes, int qoff_bytes,
                                const void* vals, const void* idx,
                                const void* xp, const void* ws,
                                const void* cstart, const void* nch,
                                const void* qs, const void* qoff,
                                const void* hh, const void* i1, void* y,
                                int nt, int P, int G, int qbase_per_pass,
                                void* stream)
{
    if (nt <= 0)
        return 0;
    const Args a{static_cast<const float*>(vals), idx,
                 static_cast<const float*>(xp),
                 static_cast<const int32_t*>(ws),
                 static_cast<const int32_t*>(cstart),
                 static_cast<const int32_t*>(nch),
                 static_cast<const int32_t*>(qs), qoff,
                 static_cast<const int32_t*>(hh),
                 static_cast<const int8_t*>(i1), static_cast<float*>(y),
                 P, G, qbase_per_pass};
    const auto s = static_cast<cudaStream_t>(stream);
    if (idx_bytes == 1)
        return static_cast<int>(launch_mode<int8_t>(mode, qoff_bytes, a, nt, s));
    if (idx_bytes == 4)
        return static_cast<int>(launch_mode<int32_t>(mode, qoff_bytes, a, nt, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
