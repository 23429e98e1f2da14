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
//              (SELL-X, P*G = 128), j and the i1 entry taken mod 128
//              (& 127: for int8, the TPU's take_along_axis).
//
// On the TPU each of these is a VMEM window of x, one grid step per
// chunk and a sum carried in the output block across steps; the
// per-group and crossed forms needed one-hot products or transposes
// there (PARITY.md), here they are ordinary gathers.
//
// Design of the tile and group modes (K2's first version): one 128-thread
// block per (tile, row group), one thread per lane; a loop over the
// tile's chunks and their passes. vals and idx are read coalesced, the
// per-pass row offsets are one broadcast address for the block, and the
// x entry is one gather from global memory: the probes' x buffers are at
// most 320 rows (160 KB) and stay in L1/L2, so no shared-memory window is
// needed.
//
// The crossed mode (SELL-X) has a kernel of its own, crossed_kernel: the
// first design ran it as above, and each slot made two dependent,
// uncoalesced reads, i1[(ch*128 + j)*128 + G*p + g] (32 rows of a 16 KB
// slab for a warp's 32 useful bytes) and then a random row of x, at 20 %
// of its bound. Every row a chunk reads lies in one half window of x,
// rows ws[t] + 128*hh[ch] + [0, 128): 64 KB. So one 512-thread block
// owns a tile and walks its chunks in order, two stages deep. While
// chunk c is computed, a TMA bulk copy (cp.async.bulk with an mbarrier)
// brings chunk c+1's half window into the other buffer (skipped when
// that buffer holds the same window already), and the threads load
// chunk c+1's i1 slab into registers and store it after chunk c, each
// 32-bit word of row j at word (w ^ (j & 31)) of its row, so that 32
// lanes reading one column of random rows hit random banks instead of
// one. The i1 lookup and the x gather are then shared-memory reads. A
// thread owns four lanes of a row group: each pass is one float4 of vals
// and one 32-bit word of int8 idx (an int4 of int32), the loads of a
// batch of kXBatch passes issued before their lookups, and the next
// chunk's addresses prefetched into L2. (Issuing a batch's lookups before
// its adds too measured 4 % slower on an H100: 0.0350 against 0.0336 ms.) Each (g, l) folds its chunk
// part from +0 in pass order, the first chunk's part is taken as it is
// and each later one added to y in chunk order: the plain version's
// order, so the kernel stays bit-equal to it, with no atomics. Shared
// memory is 2 x (64 + 16) KB, one block an SM: the 128 tiles of SELL-X
// run in one wave on the H100's 132 SMs; more tiles run in waves of 132.
//
// Each step rounds product and sum separately (__fmul_rn, __fadd_rn),
// so every mode equals the plain PyTorch version
// (petsctpu_torch/ops/sell_pass.py) bit for bit.
//
// Bound: memory. 5 (int8 idx) or 8 (int32) bytes per slot of vals and
// idx, plus the per-pass indices (for SELL-X the i1 entries read), x
// once and y, against 2 flops per slot.

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
    int Lx;                 // rows of xp
};

// Tile and group modes: a block per (tile, row group), a thread a lane.
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
            } else {
                row = qoff[(ch * a.P + p) * a.G + g];
                if (a.qs)
                    row += a.qs[a.qbase_per_pass ? ch * a.P + p : ch];
            }
            acc = __fadd_rn(acc, __fmul_rn(v, a.xp[(base + row) * kLanes + j]));
        }
        out = c == 0 ? acc : __fadd_rn(out, acc);
    }
    a.y[(static_cast<int64_t>(t) * a.G + g) * kLanes + l] = out;
}

// ------------------------------------------------- crossed mode (SELL-X)

constexpr int kXThreads = 512;
constexpr int kXBatch = 8;                             // passes loaded together
constexpr int kXWindow = 128 * kLanes;                 // floats of a half window
constexpr int kI1Words = 128 * 128 / 4;                // 32-bit words of a slab
constexpr int kXSmem = 2 * (kXWindow * 4 + kI1Words * 4) + 2 * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// Wait for the phase of bar with this parity to complete; a copy that
// never lands traps (a fault the wrapper's caller sees) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    for (uint32_t tries = 0;; ++tries) {
        uint32_t done;
        asm volatile(
            "{\n"
            ".reg .pred P1;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
            "selp.u32 %0, 1, 0, P1;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
        if (done)
            return;
        if (tries == (1u << 24))
            __trap();
    }
}

// One thread: bytes from src (global) to dst (shared), completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p)
{
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The four lane indices of a thread's quad, from 4 bytes or 16.
__device__ __forceinline__ int4 load4(const int8_t* p)
{
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_int4(static_cast<int8_t>(w), static_cast<int8_t>(w >> 8),
                     static_cast<int8_t>(w >> 16), static_cast<int8_t>(w >> 24));
}

__device__ __forceinline__ int4 load4(const int32_t* p)
{
    return *reinterpret_cast<const int4*>(p);
}

// i1[j][col] of a slab stored with its words swizzled by row.
__device__ __forceinline__ int i1_at(const uint8_t* slab, int j, int col)
{
    return slab[(j * 32 + ((col >> 2) ^ (j & 31))) * 4 + (col & 3)];
}

// acc + v * x[128*hh + i1[j][col], j], from the staged slab and window.
__device__ __forceinline__ float fold_slot(float acc, float v, int j, int col,
                                           const uint8_t* slab, const float* xw)
{
    j &= 127;
    const int r1 = i1_at(slab, j, col) & 127;
    return __fadd_rn(acc, __fmul_rn(v, xw[r1 * kLanes + j]));
}

template <typename I>
__global__ void __launch_bounds__(kXThreads, 1) crossed_kernel(Args a)
{
    extern __shared__ __align__(128) unsigned char smem[];
    float* xw = reinterpret_cast<float*>(smem);                       // [2][128*128]
    uint32_t* i1w = reinterpret_cast<uint32_t*>(xw + 2 * kXWindow);   // [2][4096]
    uint64_t* bar = reinterpret_cast<uint64_t*>(i1w + 2 * kI1Words);  // [2]

    const int t = blockIdx.x;
    const int tid = threadIdx.x;
    const I* idx = static_cast<const I*>(a.idx);
    const int64_t base = a.ws[t];
    const int64_t c0 = a.cstart[t];
    const int n = a.nch[t];
    const int nquads = a.G * 32;
    const uint4* i1q = reinterpret_cast<const uint4*>(a.i1);

    if (tid == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    int64_t tag[2] = {-1, -1};  // the first row of x each buffer holds
    uint32_t parity = 0;        // bit b: the phase of bar[b] to wait for
    uint32_t pending = 0;       // bit b: a copy into buffer b is in flight
    uint4 pre[2];               // the next chunk's i1 words, in registers

    // Ask for the half window from row0 in buffer b (one thread issues
    // it), unless the buffer holds it; rows past either end of xp are not
    // copied (no slot reads them).
    auto stage_x = [&](int64_t row0, int b) {
        const int64_t lo = row0 > 0 ? row0 : 0;
        const int64_t hi = row0 + 128 < a.Lx ? row0 + 128 : a.Lx;
        if (row0 == tag[b] || hi <= lo)
            return;
        tag[b] = row0;
        pending |= 1u << b;
        if (tid == 0)
            bulk_load(xw + b * kXWindow + (lo - row0) * kLanes,
                      a.xp + lo * kLanes,
                      static_cast<uint32_t>((hi - lo) * kLanes * 4), &bar[b]);
    };
    auto load_i1 = [&](int c) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
            pre[k] = i1q[(c0 + c) * (kI1Words / 4) + tid + k * kXThreads];
    };
    auto store_i1 = [&](int b) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int q = tid + k * kXThreads;    // uint4 q of the slab
            const int j = q >> 3;
            const int w0 = (q & 7) * 4;
            uint32_t* row = i1w + b * kI1Words + j * 32;
            row[(w0 + 0) ^ (j & 31)] = pre[k].x;
            row[(w0 + 1) ^ (j & 31)] = pre[k].y;
            row[(w0 + 2) ^ (j & 31)] = pre[k].z;
            row[(w0 + 3) ^ (j & 31)] = pre[k].w;
        }
    };

    // chunk c+1's first row of x, its hh loaded a chunk ahead
    int64_t row_next = 0;
    if (n > 0) {
        stage_x(base + 128 * static_cast<int64_t>(a.hh[c0]), 0);
        if (n > 1)
            row_next = base + 128 * static_cast<int64_t>(a.hh[c0 + 1]);
        load_i1(0);
        store_i1(0);
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
        const int b = c & 1;
        const int64_t ch = c0 + c;
        if (c + 1 < n) {
            stage_x(row_next, b ^ 1);
            if (c + 2 < n)
                row_next = base + 128 * static_cast<int64_t>(a.hh[ch + 2]);
            load_i1(c + 1);
            // the next chunk's vals and idx into L2, one request a line
            for (int qd = tid; qd < nquads; qd += kXThreads) {
                const int l0 = (qd & 31) * 4;
                const int64_t next = ((ch + 1) * a.P * a.G + (qd >> 5)) * kLanes + l0;
                for (int p = 0; p < a.P; ++p) {
                    const int64_t at = next + static_cast<int64_t>(p) * a.G * kLanes;
                    if (l0 % 32 == 0)
                        prefetch_l2(a.vals + at);
                    if (l0 * sizeof(I) % 128 == 0)
                        prefetch_l2(idx + at);
                }
            }
        }
        if (pending >> b & 1) {
            mbar_wait(&bar[b], parity >> b & 1);
            parity ^= 1u << b;
            pending &= ~(1u << b);
        }
        const uint8_t* slab = reinterpret_cast<const uint8_t*>(i1w + b * kI1Words);
        const float* xb = xw + b * kXWindow;
        for (int qd = tid; qd < nquads; qd += kXThreads) {
            const int g = qd >> 5;
            const int l0 = (qd & 31) * 4;
            float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (int p0 = 0; p0 < a.P; p0 += kXBatch) {
                float4 v[kXBatch];
                int4 j[kXBatch];
#pragma unroll
                for (int u = 0; u < kXBatch; ++u) {
                    const int p = min(p0 + u, a.P - 1);
                    const int64_t slot = ((ch * a.P + p) * a.G + g) * kLanes + l0;
                    v[u] = *reinterpret_cast<const float4*>(a.vals + slot);
                    j[u] = load4(idx + slot);
                }
#pragma unroll
                for (int u = 0; u < kXBatch; ++u) {
                    if (p0 + u < a.P) {
                        const int col = a.G * (p0 + u) + g;
                        part.x = fold_slot(part.x, v[u].x, j[u].x, col, slab, xb);
                        part.y = fold_slot(part.y, v[u].y, j[u].y, col, slab, xb);
                        part.z = fold_slot(part.z, v[u].z, j[u].z, col, slab, xb);
                        part.w = fold_slot(part.w, v[u].w, j[u].w, col, slab, xb);
                    }
                }
            }
            float4* y = reinterpret_cast<float4*>(
                a.y + (static_cast<int64_t>(t) * a.G + g) * kLanes + l0);
            if (c > 0) {
                const float4 prev = *y;
                part = make_float4(__fadd_rn(prev.x, part.x), __fadd_rn(prev.y, part.y),
                                   __fadd_rn(prev.z, part.z), __fadd_rn(prev.w, part.w));
            }
            *y = part;
        }
        if (c + 1 < n)
            store_i1(b ^ 1);
        __syncthreads();
    }
    if (n == 0)
        for (int qd = tid; qd < nquads; qd += kXThreads)
            reinterpret_cast<float4*>(a.y + static_cast<int64_t>(t) * a.G * kLanes)[qd]
                = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <typename I>
cudaError_t launch_crossed(const Args& a, int nt, cudaStream_t stream)
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return err;
    static uint64_t configured[2] = {0, 0};     // per idx type, a bit a device
    uint64_t& done = configured[sizeof(I) == 1 ? 0 : 1];
    if (!(done >> dev & 1)) {
        err = cudaFuncSetAttribute(crossed_kernel<I>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
        if (err != cudaSuccess)
            return err;
        done |= uint64_t{1} << dev;
    }
    crossed_kernel<I><<<static_cast<unsigned>(nt), kXThreads, kXSmem, stream>>>(a);
    return cudaGetLastError();
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
        return launch_crossed<I>(a, nt, stream);
    if (mode == kGroup && qoff_bytes == 1)
        return launch<kGroup, I, int8_t>(a, nt, stream);
    if (mode == kGroup && qoff_bytes == 4)
        return launch<kGroup, I, int32_t>(a, nt, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).
// mode: 0 tile, 1 group, 2 crossed; idx_bytes and qoff_bytes are 1
// (int8) or 4 (int32). Pointers a mode does not use may be null. Lx is
// xp's row count. Crossed mode needs vals, idx, xp and i1 16-byte aligned.
extern "C" int sell_pass_launch(int mode, int idx_bytes, int qoff_bytes,
                                const void* vals, const void* idx,
                                const void* xp, const void* ws,
                                const void* cstart, const void* nch,
                                const void* qs, const void* qoff,
                                const void* hh, const void* i1, void* y,
                                int nt, int P, int G, int qbase_per_pass,
                                int Lx, void* stream)
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
                 P, G, qbase_per_pass, Lx};
    const auto s = static_cast<cudaStream_t>(stream);
    if (idx_bytes == 1)
        return static_cast<int>(launch_mode<int8_t>(mode, qoff_bytes, a, nt, s));
    if (idx_bytes == 4)
        return static_cast<int>(launch_mode<int32_t>(mode, qoff_bytes, a, nt, s));
    return static_cast<int>(cudaErrorInvalidValue);
}
