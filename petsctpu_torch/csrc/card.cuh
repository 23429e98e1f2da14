// The card's shape as the kernels' launches use it: the SM count and a
// kernel's resident blocks an SM, each asked once a device, and the grid
// that spreads warp-sized groups of work evenly over the resident warps.
// Included by the kernels' sources (ops/_build.py rebuilds them all when
// a header in csrc/ changes).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace card {

constexpr int kDevices = 64;   // devices whose answers are kept

// One value a device (> 0 once asked), kept after the first ask.
struct PerDevice {
    int v[kDevices] = {};

    template <typename Ask>
    cudaError_t get(int dev, int* out, Ask ask)
    {
        if (dev < kDevices && v[dev] > 0) {
            *out = v[dev];
            return cudaSuccess;
        }
        const cudaError_t err = ask(out);
        if (err == cudaSuccess && dev < kDevices)
            v[dev] = *out;
        return err;
    }
};

// The number of SMs of device `dev`.
inline cudaError_t sm_count(int dev, int* sms)
{
    static PerDevice cache;
    return cache.get(dev, sms, [dev](int* out) {
        return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
    });
}

// As many blocks of `warps` warps as the card holds at once, spread
// evenly over `groups` groups of 32 (one a warp at a time): the fewest
// rounds, and no round left to a few warps.
inline int64_t even_blocks(int64_t groups, int warps, int sms, int per_sm)
{
    const int64_t resident = static_cast<int64_t>(sms) * per_sm * warps;
    const int64_t rounds = (groups + resident - 1) / resident;
    return (groups + rounds * warps - 1) / (rounds * warps);
}

}  // namespace card
