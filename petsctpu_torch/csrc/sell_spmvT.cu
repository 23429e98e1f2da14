// K3: the transpose product y = Aᵀr of a chunk-mode SELL operator, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel petsctpu/mat/sell.py::_sell_spmvT_chunk
// together with the per-tile window combine that SellMat.multT runs after
// it (petsctpu/mat/sell.py:118-124, a loop of nt slice updates). On the
// same packed arrays as K2:
//
//   vals [nt,P,G,128] f32, idx [nt,P,G,128] int8, qs [nt,P] int32,
//   winstart [nt] int32, rt [nt,G,128] f32 (r zero-padded to nt*G*128),
//   wins [nt,S,128] f32 (scratch), y [Lp,128] f32;
//
//   part[t,p,c] = sum over (g, l) ascending with idx[t,p,g,l] == c
//                 of vals[t,p,g,l] * rt[t,g,l]           (one pass's row)
//   wins[t,q,c] = sum over passes p ascending with qs[t,p] == q
//                 of part[t,p,c]
//   y[R,c]      = sum over t ascending with winstart[t] <= R < winstart[t]+S
//                 of wins[t, R - winstart[t], c].
//
// Every sum is a left fold from +0 in that order, with one rounding per
// product and one per sum (__fmul_rn, __fadd_rn: no FMA contraction), as
// petsctpu's kernel sums a pass's row before adding it to its window row.
// Slots whose value is 0 (the pack's padding) are skipped: a fold that
// starts at +0 is never -0, so adding ±0 to it never changes a bit, and
// skipping them gives the same result as adding them. The plain PyTorch
// version (petsctpu_torch/ops/sell_spmvT.py) folds in the same order, so
// the two agree bit for bit. No float atomics: every run gives the same
// bits, so GAMG's iteration counts repeat from run to run.
//
// Design.
//   windows kernel: one block of kWarps warps per tile t, taking the
//     tile's passes kWarps at a time, one pass a warp. A warp takes its
//     pass's G*128 slots 32 at a time in (g, l) order, with the loads of
//     the next kAhead chunks in flight. Lane j owns the columns j, j+32,
//     j+64, j+96 of the pass's row and keeps their sums in registers. In
//     a chunk of 32 slots, __match_any_sync groups the lanes by idx; the
//     lowest lane of each group publishes the group's lane mask under its
//     column in shared memory, and the column's owner adds the group's
//     products in lane order. The kWarps rows then go to shared memory,
//     and 128 threads add them into their window rows in pass order. The
//     window lives in shared memory when its S*512 bytes fit beside the
//     scratch (S = 120 on the 128³ GAMG level 0: 61 KB), else in the wins
//     scratch in global memory (up to the pack's cap of 8192 rows, 4 MB);
//     it ends in wins either way.
//   combine kernel: one block of 128 threads per kRows rows of y. The
//     block first finds the first and last tile whose window covers its
//     rows, then thread c walks the tiles between them in ascending t,
//     kTilesAhead at a time, and adds the rows of each window that cover
//     its rows.
//   The TPU kernel's one-hot compare (Mosaic has no scatter) is not
//   carried over: each product is read once and added by its column's
//   owner.
//
// Bound: memory. The compulsory traffic is 5 bytes per slot of vals and
// idx (nt*P*G*128*5), r (nt*G*128*4) and y (Lp*128*4), against 2 flops
// per slot. This design also materialises the windows in global memory:
// written once by the windows kernel and read once by the combine,
// 2*nt*S*512 bytes (about 250 MB on the 128³ GAMG level 0, as much again
// as the compulsory bytes), and every combine block reads all of
// winstart once. Keeping the windows out of global memory is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;                 // warps (passes at once) a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kAhead = 4;                 // 32-slot chunks in flight a warp
constexpr int kRows = 4;                  // y rows per combine block
constexpr int kTilesAhead = 4;            // tiles whose loads are in flight
constexpr unsigned kFull = 0xffffffffu;

struct WarpScratch {
    float a[32];                          // the chunk's products, by lane
    unsigned mask[kLanes];                // lanes of the chunk, by column
};

constexpr size_t kScratchBytes = kWarps * sizeof(WarpScratch);
constexpr size_t kRowsBytes = kWarps * kLanes * sizeof(float);
static_assert((kScratchBytes + kRowsBytes) % 16 == 0,
              "window must stay 16-byte aligned");

__host__ __device__ size_t window_bytes(int S)
{
    return static_cast<size_t>(S) * kLanes * sizeof(float);
}

// Shared memory of a windows block: the warps' scratch, their pass rows,
// and the window when it is kept there.
__host__ __device__ size_t smem_bytes(int S, bool win_in_smem)
{
    return kScratchBytes + kRowsBytes + (win_in_smem ? window_bytes(S) : 0);
}

// Adds the products a of one chunk of 32 slots (key = column, or -1 for a
// skipped slot) into the owning lanes' sums, in lane order.
__device__ __forceinline__ void fold_chunk(WarpScratch& sc, int lane,
                                           float a, int key, float (&acc)[4])
{
    const unsigned peers = __match_any_sync(kFull, key);
    sc.a[lane] = a;
    if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0)
        sc.mask[key] = peers;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        unsigned m = sc.mask[lane + 32 * j];
        if (m == 0u)
            continue;
        sc.mask[lane + 32 * j] = 0u;
        do {
            acc[j] = __fadd_rn(acc[j], sc.a[__ffs(m) - 1]);
            m &= m - 1u;
        } while (m != 0u);
    }
    __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
sell_spmvT_windows(const float* __restrict__ vals,
                   const int8_t* __restrict__ idx,
                   const int32_t* __restrict__ qs,
                   const float* __restrict__ rt,
                   float* __restrict__ wins,
                   int P, int G, int S, int win_in_smem)
{
    extern __shared__ __align__(16) unsigned char smem[];
    WarpScratch& sc = reinterpret_cast<WarpScratch*>(smem)[threadIdx.x / 32];
    float* rows = reinterpret_cast<float*>(smem + kScratchBytes);
    float* win_smem = reinterpret_cast<float*>(smem + kScratchBytes
                                               + kRowsBytes);

    const int t = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int64_t wsize = static_cast<int64_t>(S) * kLanes;
    float* out = wins + static_cast<int64_t>(t) * wsize;
    float* win = win_in_smem ? win_smem : out;
    const int32_t* qt = qs + static_cast<int64_t>(t) * P;

    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int64_t i = threadIdx.x; i < wsize / 4; i += kThreads)
        reinterpret_cast<float4*>(win)[i] = zero;
#pragma unroll
    for (int j = 0; j < 4; ++j)
        sc.mask[lane + 32 * j] = 0u;
    __syncthreads();

    const int nslot = G * kLanes;         // a multiple of 32 * kAhead
    const float* rtile = rt + static_cast<int64_t>(t) * nslot;
    for (int p0 = 0; p0 < P; p0 += kWarps) {
        const int p = p0 + warp;
        if (p < P) {                      // uniform across the warp
            const int64_t base = (static_cast<int64_t>(t) * P + p) * nslot;
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float v[kAhead], r[kAhead];
            int c[kAhead];
#pragma unroll
            for (int u = 0; u < kAhead; ++u) {
                v[u] = vals[base + 32 * u + lane];
                c[u] = idx[base + 32 * u + lane];
                r[u] = rtile[32 * u + lane];
            }
            for (int s0 = 0; s0 < nslot; s0 += 32 * kAhead) {
                float a[kAhead];
                int key[kAhead];
#pragma unroll
                for (int u = 0; u < kAhead; ++u) {
                    a[u] = __fmul_rn(v[u], r[u]);
                    key[u] = v[u] != 0.0f ? c[u] : -1;
                }
                if (s0 + 32 * kAhead < nslot) {   // next chunks in flight
#pragma unroll
                    for (int u = 0; u < kAhead; ++u) {
                        const int s = s0 + 32 * (kAhead + u) + lane;
                        v[u] = vals[base + s];
                        c[u] = idx[base + s];
                        r[u] = rtile[s];
                    }
                }
#pragma unroll
                for (int u = 0; u < kAhead; ++u)
                    fold_chunk(sc, lane, a[u], key[u], acc);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
                rows[warp * kLanes + lane + 32 * j] = acc[j];
        }
        __syncthreads();
        if (threadIdx.x < kLanes) {       // the rows into the window, in order
            const int col = threadIdx.x;
            for (int k = 0; k < kWarps && p0 + k < P; ++k) {
                float* cell = win + static_cast<int64_t>(qt[p0 + k]) * kLanes
                    + col;
                *cell = __fadd_rn(*cell, rows[k * kLanes + col]);
            }
        }
        __syncthreads();
    }
    if (win_in_smem)
        for (int64_t i = threadIdx.x; i < wsize / 4; i += kThreads)
            reinterpret_cast<float4*>(out)[i] =
                reinterpret_cast<const float4*>(win_smem)[i];
}

__global__ void __launch_bounds__(kLanes)
sell_spmvT_combine(const float* __restrict__ wins,
                   const int32_t* __restrict__ winstart,
                   float* __restrict__ y, int nt, int S, int Lp)
{
    __shared__ int span[2][kLanes / 32];
    const int c = threadIdx.x;
    const int r0 = blockIdx.x * kRows;
    int lo = nt, hi = -1;                 // tiles whose windows cover r0..
    for (int t = c; t < nt; t += kLanes) {
        const int ws = winstart[t];
        if (ws < r0 + kRows && ws + S > r0) {
            lo = min(lo, t);
            hi = max(hi, t);
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(kFull, lo, o));
        hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (c % 32 == 0) {
        span[0][c / 32] = lo;
        span[1][c / 32] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kLanes / 32; ++k) {
        lo = min(lo, span[0][k]);
        hi = max(hi, span[1][k]);
    }

    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        acc[i] = 0.0f;
    for (int t0 = lo; t0 <= hi; t0 += kTilesAhead) {
        int ws[kTilesAhead];
        float w[kTilesAhead][kRows];
#pragma unroll
        for (int u = 0; u < kTilesAhead; ++u) {
            ws[u] = t0 + u <= hi ? winstart[t0 + u] : r0 + kRows;
            const float* wt = wins + static_cast<int64_t>(t0 + u) * S * kLanes
                + c;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int R = r0 + i;
                w[u][i] = R >= ws[u] && R < ws[u] + S
                    ? wt[static_cast<int64_t>(R - ws[u]) * kLanes] : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kTilesAhead; ++u)
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int R = r0 + i;
                if (R >= ws[u] && R < ws[u] + S)
                    acc[i] = __fadd_rn(acc[i], w[u][i]);
            }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        if (r0 + i < Lp)
            y[static_cast<int64_t>(r0 + i) * kLanes + c] = acc[i];
}

}  // namespace

// 1 when a window of S rows is kept in shared memory on the current
// device, 0 when it is kept in global memory.
extern "C" int sell_spmvT_window_in_smem(int S)
{
    int dev = 0;
    int optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return smem_bytes(S, true) <= static_cast<size_t>(optin);
}

// Launches both kernels on `stream` and returns the first CUDA error (0 on
// success). wins is scratch of nt*S*128 floats; y has Lp*128 floats.
extern "C" int sell_spmvT_launch(const void* vals, const void* idx,
                                 const void* qs, const void* winstart,
                                 const void* rt, void* wins, void* y,
                                 int nt, int P, int G, int S, int Lp,
                                 void* stream)
{
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int in_smem = sell_spmvT_window_in_smem(S);
    const size_t smem = smem_bytes(S, in_smem);
    cudaError_t err = cudaFuncSetAttribute(
        sell_spmvT_windows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess)
        return static_cast<int>(err);
    if (nt > 0) {
        sell_spmvT_windows<<<nt, kThreads, smem, st>>>(
            static_cast<const float*>(vals), static_cast<const int8_t*>(idx),
            static_cast<const int32_t*>(qs), static_cast<const float*>(rt),
            static_cast<float*>(wins), P, G, S, in_smem);
        err = cudaGetLastError();
        if (err != cudaSuccess)
            return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((Lp + kRows - 1) / kRows);
    sell_spmvT_combine<<<blocks, kLanes, 0, st>>>(
        static_cast<const float*>(wins), static_cast<const int32_t*>(winstart),
        static_cast<float*>(y), nt, S, Lp);
    return static_cast<int>(cudaGetLastError());
}
