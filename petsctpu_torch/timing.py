"""The card's peak rates and the CUDA-event timers that chip_smoke.py and
petsctpu_torch.probes measure kernels with."""

from __future__ import annotations

import statistics

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM data sheet, fp32 outside tensor cores
FP64_FLOPS_PER_S = 34e12   # H100 SXM data sheet, fp64 outside tensor cores


def time_ms(fn, runs=50, inner=10, warmup=3):
    """Median over `runs` of the CUDA-event time of `inner` back-to-back
    calls, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, inner=20):
    """The card's time per call without the host's: `inner` calls
    captured in one CUDA graph, the replay timed as time_ms does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, runs=20, inner=1) / inner
