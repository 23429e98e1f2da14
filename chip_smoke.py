"""Smoke test of the PyTorch/CUDA port (petsctpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It needs CUDA and nvcc (it builds the kernels from petsctpu_torch/csrc
into petsctpu_torch/_build on first use) and imports nothing of JAX or
petsctpu. Phases, each of which raises on failure:

1. device: the card's name and power limit;
2. build: every kernel, one nvcc per source, all started together;
3. K2 against plain, on the card: K2 (SELL SpMV) on the 128³ ex45
   operator (diag mode) and on a rectangular chunk-mode operator must
   equal its plain PyTorch version bit for bit and scipy's fp64 product
   within 1e-5 relative;
4. slice 1's path at full size: mat_from_options(-mat_type sell) and a
   KSP solve, CG+Jacobi to rtol 1e-5 (true residual ≤ 1e-4) and then
   GMRES(30)+Jacobi for 300 iterations, with the launch counts reset
   just before and read just after; plus the same CG solve at 16³ on
   the card against the port's CPU path;
5. K2's times (CUDA events, median of 50 runs after warm-up): the
   kernel, its plain version, a torch.sparse CSR product as the
   yardstick, the kernel's bound and a STREAM triad; and the ms per CG
   iteration of that path's solve and of a repeat of it;
6. slice 2's path at full size, KSP ex45 with -pc_type mg: the 129³
   7-point operator as a StencilMat (stencil_from_scipy, fp64) and a
   KSP solve, CG preconditioned by geometric MG on DA((129,129,129))
   with the device setup (Galerkin coarsening by probing, Chebyshev+
   Jacobi smoothing, a 27-row LU coarse solve) to rtol 1e-5: true
   residual ≤ 1e-4 and K1 launched at least once per iteration, with
   the counts reset just before and read just after; plus the same
   solve at 17³ on the card against the port's CPU path (equal its and
   reason, history within 1e-10 relative);
7. K1 against plain, on the card: K1 (stencil SpMV) must equal its
   plain version bit for bit, and the scipy fp64 product of the
   assembled operator within 1e-5 relative in fp32 and 1e-12 in fp64,
   on bench.py's 4096² 5-point layout with random coefficients (fp32),
   the 129³ ex45 operator, the 65³ 27-point Galerkin operator of the
   MG hierarchy (fp64), and small 2-D periodic and mirror stencils;
8. K1's times at those three large shapes: kernel, plain version,
   torch.sparse CSR `mv` and the byte bound; and the ms per CG+MG
   iteration of a repeat of the solve;
9. slice 3's path at full size, KSP ex45 with -pc_type gamg on SELL: the
   128³ operator through mat_from_options(-mat_type sell) and a KSP with
   set_operators(M, A_host), CG preconditioned by smoothed-aggregation
   GAMG to rtol 1e-5: true residual ≤ 1e-4, the setup seconds split into
   hierarchy, packing and transfer, the formats of every level, and K3
   launched at least (levels restricting through it) × its times in the
   solve, with the counts reset just before the path and read just after;
10. K3 against plain, on the card: K3 (SELL transpose product) must equal
   its plain version bit for bit, give the same bits over 10 launches,
   and match scipy's fp64 Pᵀr within 1e-5 relative, on the 128³ level-0
   prolongator of that hierarchy, on tests/test_sell.py:234's
   prolongator-like case at G 8 and 16, and on a case whose window does
   not fit in shared memory;
11. the same GAMG solve on the 2-D 128² Laplacian on the card against the
   port's CPU path (equal its and reason, history within 1e-4 relative);
12. K3's times on the 128³ level-0 prolongator: kernel (windows and
   combine), plain version, torch.sparse CSR `mv` of Pᵀ and the byte
   bound; and the ms per CG+GAMG iteration of a repeat of the solve.

It ends with the nvidia-smi line, a JSON line of kernels and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.convert import sell_from_arrays
from petsctpu_torch.core.logging import log_begin, log_events
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import (StencilMat, mat_from_options,
                                stencil_from_scipy, stencil_to_scipy)
from petsctpu_torch.mat.sell import sell_from_scipy, sell_pack, sell_to_scipy
from petsctpu_torch.models import ex45_system, laplacian_2d
from petsctpu_torch.ops import _build
from petsctpu_torch.ops.sell_spmv import sell_spmv, sell_spmv_plain
from petsctpu_torch.ops.sell_spmvT import (sell_spmvT, sell_spmvT_plain,
                                           window_in_shared_memory)
from petsctpu_torch.ops.stencil_mult import stencil_mult, stencil_mult_plain

GRID = 128                 # ex45 at 128³: n = 2,097,152
MG_GRID = 129              # ex45 -pc_type mg at 129³: n = 2,146,689
GAMG_GRID = 128            # ex45 -pc_type gamg at 128³: n = 2,097,152
K3_LEVELS = (0, 1)         # the levels that restrict through K3 at 128³
BENCH_M = 4096             # bench.py's stencil: 4096², n = 16,777,216
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM data sheet, fp32 outside tensor cores
FP64_FLOPS_PER_S = 34e12   # H100 SXM data sheet, fp64 outside tensor cores
MG_OPTS = {"ksp_type": "cg", "pc_type": "mg", "ksp_rtol": "1e-5"}
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
KSP_OPTS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": "1e-5",
            "ksp_max_it": "2000"}
GMRES_OPTS = {"ksp_type": "gmres", "pc_type": "jacobi",
              "ksp_gmres_restart": "30", "ksp_max_it": "300"}
GAMG_OPTS = {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": "1e-5"}


def device_info():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    return name, smi


def build_kernels():
    t = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {sorted(reports)} in {time.perf_counter() - t:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


def check_kernel(A, G, mode, dev, rng):
    """K2 against its plain version (bit for bit) and against scipy."""
    arrays, statics = sell_pack(A, G=G, mode=mode)
    M = sell_from_arrays(arrays, statics, device=dev)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    xp = M.pad_operand(torch.from_numpy(x).to(dev))
    args = (M.vals, M.idx, M.qs, M.winstart, xp)
    kw = dict(G=M.G, S=M.S, mode=M.mode)
    y = sell_spmv(*args, **kw)
    y_plain = sell_spmv_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    yv = y.reshape(-1)[:A.shape[0]].double().cpu().numpy()
    ref = A @ x.astype(np.float64)
    rel = float(np.abs(yv - ref).max() / np.abs(ref).max())
    print(f"kernel {mode}: n={A.shape[0]} m={A.shape[1]} nnz={A.nnz} "
          f"nt={M.nt} P={M.npass} G={M.G} S={M.S} Lp={M.Lp} "
          f"max|kernel-plain|={err} rel err vs scipy fp64={rel:.3e}")
    if not torch.equal(y, y_plain):
        raise AssertionError(f"K2 {mode}: kernel differs from its plain "
                             f"version (max abs {err})")
    if not rel <= 1e-5:
        raise AssertionError(f"K2 {mode}: relative error {rel} vs scipy")
    return M, xp, err


def solve(M, b, opts):
    ksp = KSP(Options(dict(opts)))
    ksp.set_operators(M)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = ksp.solve(b)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def check_gmres_history(hist, restart):
    """Finite, and non-increasing: strictly inside each restart cycle
    (Givens estimates), and across a restart within 1e-3 relative (the
    new cycle starts from a recomputed fp32 residual, not the estimate)."""
    if not np.isfinite(hist).all():
        raise AssertionError("GMRES history has non-finite entries")
    rises = [(k, hist[k - 1], hist[k]) for k in range(1, len(hist))
             if hist[k] > hist[k - 1]]
    for k, prev, cur in rises:
        if (k - 1) % restart != 0 or k == 1 or cur > prev * (1 + 1e-3):
            raise AssertionError(f"GMRES history rises at {k}: {prev} -> {cur}")
    return len(rises)


def reset_counts():
    sell_spmv.launches = 0
    stencil_mult.launches = 0
    sell_spmvT.launches = 0


def drive_main_path(A, b_np):
    """The options-driven solve at full size, counting kernel launches."""
    opts = Options({"mat_type": "sell", "mat_ordering_type": "natural"})
    reset_counts()
    t = time.perf_counter()
    M, perm = mat_from_options(A, opts, dtype=torch.float32)
    setup_s = time.perf_counter() - t
    b = torch.from_numpy(b_np[perm].astype(np.float32)).cuda()
    res, cg_s = solve(M, b, KSP_OPTS)
    its, reason = int(res.its), int(res.reason)
    cg_launches = sell_spmv.launches
    x = np.empty(A.shape[0])
    x[perm] = res.x.double().cpu().numpy()
    relres = float(np.linalg.norm(b_np - A @ x) / np.linalg.norm(b_np))
    print(f"main path: setup {setup_s:.2f} s; CG+jacobi its={its} "
          f"reason={reason} {cg_s:.3f} s = {1e3 * cg_s / its:.4f} ms/it; "
          f"true rel residual {relres:.3e}; K2 launches {cg_launches}")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG failed: reason {reason}, residual {relres}")
    if cg_launches < its:
        raise AssertionError(f"K2 launched {cg_launches} times in {its} its")
    gres, gm_s = solve(M, b, GMRES_OPTS)
    git = int(gres.its)
    rises = check_gmres_history(gres.history[:git + 1].numpy(), 30)
    launches = sell_spmv.launches
    print(f"main path: GMRES(30)+jacobi its={git} reason={int(gres.reason)} "
          f"{gm_s:.3f} s = {1e3 * gm_s / git:.4f} ms/it; history "
          f"{float(gres.history[0]):.6e} -> {float(gres.history[git]):.6e}, "
          f"{rises} rises at restarts; K2 launches in the main path {launches}")
    return M, b, launches, 1e3 * cg_s / its


def check_small_against_cpu():
    """CG+jacobi at 16³ on the card against the port's CPU path."""
    A, b, _ = ex45_system(16, 16, 16)
    opts = Options({"mat_type": "sell", "mat_ordering_type": "natural"})
    out = {}
    for dev in ("cuda", "cpu"):
        M, _ = mat_from_options(A, opts, device=dev)
        res = KSP(Options(dict(KSP_OPTS))).set_operators(M).solve(
            torch.from_numpy(b.astype(np.float32)).to(dev))
        out[dev] = (int(res.its), int(res.reason), res.history.numpy(),
                    res.x.cpu().numpy())
    (gi, gr, gh, gx), (ci, cr, ch, cx) = out["cuda"], out["cpu"]
    k = min(gi, ci) + 1
    hdiff = float(np.abs(gh[:k] / ch[:k] - 1).max())
    print(f"16^3 card vs cpu: its {gi}/{ci} reason {gr}/{cr} history rel "
          f"diff {hdiff:.2e} max|x diff| {np.abs(gx - cx).max():.2e}")
    if gr != cr or gr <= 0 or abs(gi - ci) > 1 or not hdiff <= 1e-4:
        raise AssertionError("16^3 solve on the card disagrees with the CPU")
    if gx.shape != (A.shape[0],) or not np.isfinite(gx).all():
        raise AssertionError("16^3 solution has the wrong shape or NaNs")


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


def stream_triad_gbs(n=1 << 27):
    b = torch.rand(n, device="cuda")
    c = torch.rand(n, device="cuda")
    a = torch.empty_like(b)
    ms = time_ms(lambda: torch.add(b, c, alpha=3.0, out=a), runs=20, inner=5)
    return 3 * n * 4 / (ms * 1e-3) / 1e9


def warm_cg_ms_per_it(M, b):
    """ms per CG iteration of a repeat of the main path's solve (the
    main path's own solve also pays the first-call set-up of cuBLAS)."""
    res, secs = solve(M, b, KSP_OPTS)
    return 1e3 * secs / int(res.its)


def measure(A, M, xp):
    """Times of K2, its plain version and the CSR yardstick at 128³."""
    args = (M.vals, M.idx, M.qs, M.winstart, xp)
    kw = dict(G=M.G, S=M.S, mode=M.mode)
    ms = time_ms(lambda: sell_spmv(*args, **kw))
    plain_ms = time_ms(lambda: sell_spmv_plain(*args, **kw), inner=1)
    Ac = sp.csr_matrix(A, dtype=np.float32)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(Ac.indptr.astype(np.int64)),
        torch.from_numpy(Ac.indices.astype(np.int64)),
        torch.from_numpy(Ac.data), size=Ac.shape,
        check_invariants=True).cuda()
    x = xp.reshape(-1)[M.G * 128:M.G * 128 + A.shape[1]].contiguous()
    y_lib = torch.mv(csr, x)
    y = sell_spmv(*args, **kw).reshape(-1)[:A.shape[0]]
    lib_rel = float((y_lib - y).abs().max() / y.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x))
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + M.nt * M.G * 128 * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2.0 * A.nnz / FP32_FLOPS_PER_S * 1e3
    triad = stream_triad_gbs()
    print(f"K2 at {GRID}^3: {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
          f"of {nbytes} compulsory bytes); plain {plain_ms:.4f} ms; "
          f"torch.sparse CSR mv {library_ms:.4f} ms (rel diff {lib_rel:.1e}); "
          f"bound {bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s "
          f"({bound_ops_ms:.5f} ms by fp32 ops); STREAM triad {triad:.1f} GB/s")
    if not lib_rel <= 1e-5:
        raise AssertionError(f"CSR yardstick disagrees with K2: {lib_rel}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def drive_mg_path():
    """KSP ex45 -pc_type mg at 129³ on a StencilMat, counting launches."""
    g = MG_GRID
    t = time.perf_counter()
    A, b, _ = ex45_system(g, g, g)
    print(f"ex45 {g}^3: n={A.shape[0]} nnz={A.nnz} "
          f"({time.perf_counter() - t:.1f} s)")
    reset_counts()
    t = time.perf_counter()
    S = stencil_from_scipy(A, (g, g, g))
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t
    bt = torch.from_numpy(b).cuda()
    ksp = KSP(Options({**MG_OPTS, "pc_mg_da": DA((g, g, g))}))
    ksp.set_operators(S)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    mg_s = time.perf_counter() - t
    setup_launches = stencil_mult.launches
    t = time.perf_counter()
    res = ksp.solve(bt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = {"stencil_mult": stencil_mult.launches,
                "sell_spmv": sell_spmv.launches}
    its, reason = int(res.its), int(res.reason)
    solve_launches = launches["stencil_mult"] - setup_launches
    x = res.x.cpu().numpy()
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError("MG solution has the wrong shape or NaNs")
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    pc = ksp.pc
    levels = " ".join(f"{lv.A.grid[0]}^3x{len(lv.A.offsets)}pt"
                      for lv in pc.levels)
    print(f"mg path: stencil_from_scipy {op_s:.2f} s; MG setup {mg_s:.2f} s "
          f"(levels {levels}, coarse {pc.coarse_A.shape[0]}-row LU with "
          f"{pc.coarse.Lplan.nlev}+{pc.coarse.Uplan.nlev} triangular "
          f"levels; {setup_launches} K1 launches)")
    print(f"mg path: CG+MG its={its} reason={reason} {secs:.3f} s = "
          f"{1e3 * secs / its:.4f} ms/it; true rel residual {relres:.3e}; "
          f"history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; K1 launches {solve_launches} in "
          f"the solve, {launches['stencil_mult']} in the path")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+MG failed: reason {reason}, residual "
                             f"{relres}")
    if solve_launches < its:
        raise AssertionError(f"K1 launched {solve_launches} times in {its} "
                             "its")
    return dict(S=S, ksp=ksp, b=bt, launches=launches["stencil_mult"],
                ms_per_it=1e3 * secs / its)


def check_mg_small_against_cpu():
    """CG+MG at 17³ on the card against the port's CPU path (fp64)."""
    g = 17
    A, b, _ = ex45_system(g, g, g)
    out = {}
    for dev in ("cuda", "cpu"):
        S = stencil_from_scipy(A, (g, g, g), device=dev)
        res = KSP(Options({**MG_OPTS, "pc_mg_da": DA((g, g, g))})) \
            .set_operators(S).solve(torch.from_numpy(b).to(dev))
        out[dev] = (int(res.its), int(res.reason), res.history.numpy(),
                    res.x.cpu().numpy())
    (gi, gr, gh, gx), (ci, cr, ch, cx) = out["cuda"], out["cpu"]
    k = min(gi, ci) + 1
    hdiff = float(np.abs(gh[:k] / ch[:k] - 1).max())
    print(f"17^3 CG+MG card vs cpu: its {gi}/{ci} reason {gr}/{cr} history "
          f"rel diff {hdiff:.2e} max|x diff| {np.abs(gx - cx).max():.2e}")
    if gr != cr or gr <= 0 or gi != ci or not hdiff <= 1e-10:
        raise AssertionError("17^3 MG solve on the card disagrees with the "
                             "CPU")
    if gx.shape != (A.shape[0],) or not np.isfinite(gx).all():
        raise AssertionError("17^3 MG solution has the wrong shape or NaNs")


def bench_stencil(rng, m):
    """bench.py's 4096² 5-point layout (bench.py:42-55) in fp32, each
    coefficient scaled by a random factor in [1, 1.1)."""
    C = np.zeros((5, m, m), np.float32)
    C[0] = 4.0
    C[1, 1:, :] = -1.0
    C[2, :-1, :] = -1.0
    C[3, :, 1:] = -1.0
    C[4, :, :-1] = -1.0
    C *= 1.0 + 0.1 * rng.random((5, m, m), dtype=np.float32)
    return StencilMat(torch.from_numpy(C).cuda(), STAR5, (m, m))


def numpy_stencil(S, x):
    """fp64 numpy product with every boundary type (np.roll for
    periodic, np.pad reflect for mirror, zero pad for none)."""
    C = S.coeffs.double().cpu().numpy()
    xg = x.reshape(S.grid)
    y = np.zeros(S.grid)
    for d, off in enumerate(S.offsets):
        s = xg
        for ax, (o, b) in enumerate(zip(off, S.boundary
                                        or ("none",) * len(S.grid))):
            if o == 0:
                continue
            if b == "periodic":
                s = np.roll(s, -o, axis=ax)
                continue
            pad = [(0, 0)] * s.ndim
            pad[ax] = (0, o) if o > 0 else (-o, 0)
            s = np.pad(s, pad, mode="reflect" if b == "mirror"
                       else "constant")
            idx = [slice(None)] * s.ndim
            m = s.shape[ax] - abs(o)
            idx[ax] = slice(o, o + m) if o > 0 else slice(0, m)
            s = s[tuple(idx)]
        y += C[d] * s
    return y.reshape(-1)


def check_k1(label, S, rng, A_host=None):
    """K1 against its plain version (bit for bit) and an fp64 product:
    scipy's on the assembled operator, or numpy's for mirror axes."""
    x64 = rng.standard_normal(S.shape[0])
    x = torch.from_numpy(x64).to("cuda", S.dtype)
    args = (S.coeffs, x, S.offsets, S.grid, S.boundary)
    y = stencil_mult(*args)
    y_plain = stencil_mult_plain(*args)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    xs = x.double().cpu().numpy()
    ref = A_host @ xs if A_host is not None else numpy_stencil(S, xs)
    rel = float(np.abs(y.double().cpu().numpy() - ref).max()
                / np.abs(ref).max())
    tol = 1e-5 if S.dtype == torch.float32 else 1e-12
    print(f"K1 {label}: grid {S.grid} D={len(S.offsets)} "
          f"boundary {S.boundary or 'none'} {S.dtype}: "
          f"max|kernel-plain|={err} rel err vs fp64 {rel:.3e}")
    if not torch.equal(y, y_plain):
        raise AssertionError(f"K1 {label}: kernel differs from its plain "
                             f"version (max abs {err})")
    if not rel <= tol:
        raise AssertionError(f"K1 {label}: relative error {rel} > {tol}")
    return err, x


def measure_k1(label, S, x, A_host):
    """Times of K1, its plain version and the CSR yardstick."""
    args = (S.coeffs, x, S.offsets, S.grid, S.boundary)
    ms = time_ms(lambda: stencil_mult(*args))
    plain_ms = time_ms(lambda: stencil_mult_plain(*args), runs=20, inner=1)
    Ac = A_host.astype(np.float32 if S.dtype == torch.float32
                       else np.float64)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(Ac.indptr.astype(np.int64)),
        torch.from_numpy(Ac.indices.astype(np.int64)),
        torch.from_numpy(Ac.data), size=Ac.shape,
        check_invariants=True).cuda()
    y_lib = torch.mv(csr, x)
    y = stencil_mult(*args)
    lib_rel = float((y_lib - y).abs().max() / y.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x))
    n, D = S.shape[0], len(S.offsets)
    nbytes = (D + 2) * S.coeffs.element_size() * n
    peak = FP32_FLOPS_PER_S if S.dtype == torch.float32 else FP64_FLOPS_PER_S
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2.0 * D * n / peak * 1e3
    print(f"K1 at {label}: {ms:.4f} ms ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
          f"of {nbytes} compulsory bytes); plain {plain_ms:.4f} ms; "
          f"torch.sparse CSR mv {library_ms:.4f} ms (rel diff {lib_rel:.1e}); "
          f"bound {bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s "
          f"({bound_ops_ms:.5f} ms by ops)")
    tol = 1e-5 if S.dtype == torch.float32 else 1e-12
    if not lib_rel <= tol:
        raise AssertionError(f"CSR yardstick disagrees with K1: {lib_rel}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def k1_phases(mg, rng):
    """K1 against plain on every case, and its times at the three large
    shapes; returns (max |kernel - plain|, times at 129³)."""
    errs, times = [], {}
    S = bench_stencil(rng, BENCH_M)
    A_host = stencil_to_scipy(S)
    err, x = check_k1(f"{BENCH_M}^2 5-point", S, rng, A_host)
    errs.append(err)
    measure_k1(f"{BENCH_M}^2 5-point fp32", S, x, A_host)
    del S, A_host, x
    for label, S in ((f"{MG_GRID}^3 7-point", mg["S"]),
                     ("65^3 27-point Galerkin", mg["ksp"].pc.levels[1].A)):
        A_host = stencil_to_scipy(S)
        err, x = check_k1(label, S, rng, A_host)
        errs.append(err)
        times[label] = measure_k1(label + " fp64", S, x, A_host)
    small = (((67, 130), STAR5 + ((2, -1), (-3, 2)), ("periodic", "none"),
              np.float64),
             ((61, 140), STAR5 + ((2, 0), (0, -2)), ("mirror", "mirror"),
              np.float32),
             ((9, 10, 33), ((0, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, 2),
                            (-2, 1, -1)), ("mirror", "periodic", "none"),
              np.float64))
    for grid, offs, bnd, dt in small:
        C = rng.standard_normal((len(offs),) + grid).astype(dt)
        S = StencilMat(torch.from_numpy(C).cuda(), offs, grid, bnd)
        errs.append(check_k1(f"small {'/'.join(bnd)}", S, rng)[0])
    return max(errs), times[f"{MG_GRID}^3 7-point"]


def warm_mg_ms_per_it(mg):
    t = time.perf_counter()
    res = mg["ksp"].solve(mg["b"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / int(res.its)


def drive_gamg_path():
    """KSP ex45 -pc_type gamg at 128³ on the fp32 SELL operator,
    counting launches."""
    g = GAMG_GRID
    A, b, _ = ex45_system(g, g, g)
    reset_counts()
    log_begin()
    t = time.perf_counter()
    M, perm = mat_from_options(A, Options({"mat_type": "sell",
                                           "mat_ordering_type": "natural"}),
                               dtype=torch.float32)
    op_s = time.perf_counter() - t
    if not np.array_equal(perm, np.arange(A.shape[0])):
        raise AssertionError("natural ordering gave a permutation")
    ksp = KSP(Options(dict(GAMG_OPTS))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    ev = log_events()
    split = {k: ev[k].time for k in ("PCGAMGHierarchy", "PCMGPack",
                                     "PCMGTransfer")}
    k3_setup, k2_setup = sell_spmvT.launches, sell_spmv.launches
    bt = torch.from_numpy(b.astype(np.float32)).cuda()
    t = time.perf_counter()
    res = ksp.solve(bt)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = sell_spmvT.launches
    its, reason = int(res.its), int(res.reason)
    k3_solve = launches - k3_setup
    k2_solve = sell_spmv.launches - k2_setup
    x = res.x.double().cpu().numpy()
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError("GAMG solution has the wrong shape or NaNs")
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    pc = ksp.pc
    print(f"gamg path: mat_from_options {op_s:.2f} s; GAMG setup {setup_s:.2f}"
          f" s = hierarchy {split['PCGAMGHierarchy']:.2f} + packing "
          f"{split['PCMGPack']:.2f} + transfer {split['PCMGTransfer']:.2f} s")
    for l, (lev, fmt) in enumerate(zip(pc.levels, pc.formats)):
        print(f"  level {l}: A {lev.A.shape} {fmt[0]}, P {lev.P.shape} "
              f"{fmt[1]}, R {fmt[2] or 'P.multT (K3)'}")
    print(f"  coarse: {pc.coarse_A.shape[0]} rows, dense LU")
    via_k3 = [l for l, f in enumerate(pc.formats) if f[2] is None]
    print(f"gamg path: CG+GAMG its={its} reason={reason} {secs:.3f} s = "
          f"{1e3 * secs / its:.4f} ms/it; true rel residual {relres:.3e}; "
          f"history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; K3 launches {k3_solve} in the "
          f"solve ({len(via_k3)} levels x {its} its needed), {launches} in "
          f"the path; K2 launches {k2_solve} in the solve")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+GAMG failed: reason {reason}, residual "
                             f"{relres}")
    if tuple(via_k3[:len(K3_LEVELS)]) != K3_LEVELS:
        raise AssertionError(f"levels restricting through K3: {via_k3}")
    if k3_solve < len(via_k3) * its:
        raise AssertionError(f"K3 launched {k3_solve} times in {its} its")
    return dict(ksp=ksp, b=bt, launches=launches, ms_per_it=1e3 * secs / its)


def padded_r(M, rng):
    """A random r for M's rows, as K3's zero-padded [nt,G,128] operand."""
    r = rng.standard_normal(M.shape[0]).astype(np.float32)
    rp = torch.zeros(M.nt * M.G * 128, device="cuda")
    rp[:M.shape[0]] = torch.from_numpy(r).cuda()
    return r, rp.view(M.nt, M.G, 128)


def check_k3(label, M, P_host, rng):
    """K3 against its plain version (bit for bit, and the same bits over
    10 launches) and against scipy's fp64 Pᵀr."""
    r, rt = padded_r(M, rng)
    args = (M.vals, M.idx, M.qs, M.winstart, rt)
    kw = dict(S=M.S, Lp=M.Lp)
    y = sell_spmvT(*args, **kw)
    y_plain = sell_spmvT_plain(*args, **kw)
    repeat = all(torch.equal(sell_spmvT(*args, **kw), y) for _ in range(10))
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    off = M.G * 128
    yv = y.reshape(-1)[off:off + M.shape[1]].double().cpu().numpy()
    ref = P_host.T @ r.astype(np.float64)
    rel = float(np.abs(yv - ref).max() / np.abs(ref).max())
    smem = window_in_shared_memory(M.S)
    print(f"K3 {label}: m={M.shape[0]} n={M.shape[1]} nt={M.nt} P={M.npass} "
          f"G={M.G} S={M.S} Lp={M.Lp} window in "
          f"{'shared' if smem else 'global'} memory; max|kernel-plain|={err}"
          f" same bits over 10 launches {repeat}; rel err vs scipy fp64 "
          f"{rel:.3e}")
    if not torch.equal(y, y_plain):
        raise AssertionError(f"K3 {label}: kernel differs from its plain "
                             f"version (max abs {err})")
    if not repeat:
        raise AssertionError(f"K3 {label}: launches disagree")
    if not rel <= 1e-5:
        raise AssertionError(f"K3 {label}: relative error {rel} vs scipy")
    return err, smem


def prolongator_like(G, rng, wide=False):
    """tests/test_sell.py:234's case: 3 nonzeros a row, columns clustered
    by row blocks of 1400 columns; wide=True spreads them over 80,000
    columns, so every window spans about 640 rows."""
    m = G * 128 * 3 + 77
    rows = np.repeat(np.arange(m), 3)
    if wide:
        n = 80000
        cols = rng.integers(0, n, rows.size)
    else:
        n = 1400
        cols = np.clip((rows // (m // n + 1))
                       + rng.integers(-40, 40, rows.size), 0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    return A


def k3_phases(gamg, rng):
    """K3 against plain on every case; returns (max |kernel - plain|,
    the finest prolongator that restricts through K3 and its scipy
    matrix)."""
    pc = gamg["ksp"].pc
    l = [f[2] for f in pc.formats].index(None)
    P0 = pc.levels[l].P
    P0_host = sell_to_scipy(P0)
    errs = [check_k3(f"{GAMG_GRID}^3 level-{l} prolongator", P0, P0_host,
                     rng)[0]]
    for G in (8, 16):
        A = prolongator_like(G, rng)
        M = sell_from_scipy(A, G=G, mode="chunk")
        errs.append(check_k3(f"prolongator-like G={G}", M, A, rng)[0])
    A = prolongator_like(8, rng, wide=True)
    M = sell_from_scipy(A, G=8, mode="chunk")
    err, smem = check_k3("wide windows G=8", M, A, rng)
    if smem:
        raise AssertionError(f"a window of S={M.S} rows was meant to exceed "
                             "shared memory")
    errs.append(err)
    return max(errs), P0, P0_host


def check_gamg_small_against_cpu():
    """CG+GAMG on the 2-D 128² Laplacian on the card against the CPU."""
    A = laplacian_2d(128, 128, dtype=np.float32).tocsr()
    b = np.random.default_rng(1).standard_normal(A.shape[0]) \
        .astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        M = sell_from_scipy(A, device=dev)
        res = KSP(Options(dict(GAMG_OPTS))).set_operators(M, A).solve(
            torch.from_numpy(b).to(dev))
        out[dev] = (int(res.its), int(res.reason), res.history.numpy(),
                    res.x.cpu().numpy())
    (gi, gr, gh, gx), (ci, cr, ch, cx) = out["cuda"], out["cpu"]
    k = min(gi, ci) + 1
    hdiff = float(np.abs(gh[:k] / ch[:k] - 1).max())
    print(f"128^2 CG+GAMG card vs cpu: its {gi}/{ci} reason {gr}/{cr} history"
          f" rel diff {hdiff:.2e} max|x diff| {np.abs(gx - cx).max():.2e}")
    if gr != cr or gr <= 0 or gi != ci or not hdiff <= 1e-4:
        raise AssertionError("128^2 GAMG solve on the card disagrees with the"
                             " CPU")
    if gx.shape != (A.shape[0],) or not np.isfinite(gx).all():
        raise AssertionError("128^2 GAMG solution has the wrong shape or NaNs")


def measure_k3(M, P_host, rng):
    """Times of K3, its plain version and the CSR yardstick on the
    finest prolongator that restricts through it (level 0 at 128³)."""
    _, rt = padded_r(M, rng)
    args = (M.vals, M.idx, M.qs, M.winstart, rt)
    kw = dict(S=M.S, Lp=M.Lp)
    ms = time_ms(lambda: sell_spmvT(*args, **kw))
    plain_ms = time_ms(lambda: sell_spmvT_plain(*args, **kw), runs=5,
                       inner=1, warmup=1)
    RT = sp.csr_matrix(P_host.T, dtype=np.float32)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(RT.indptr.astype(np.int64)),
        torch.from_numpy(RT.indices.astype(np.int64)),
        torch.from_numpy(RT.data), size=RT.shape,
        check_invariants=True).cuda()
    r = rt.reshape(-1)[:M.shape[0]].contiguous()
    y_lib = torch.mv(csr, r)
    off = M.G * 128
    y = sell_spmvT(*args, **kw).reshape(-1)[off:off + M.shape[1]]
    lib_rel = float((y_lib - y).abs().max() / y.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, r))
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + M.Lp * 128 * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2.0 * P_host.nnz / FP32_FLOPS_PER_S * 1e3
    print(f"K3 at {GAMG_GRID}^3 on P {M.shape}: {ms:.4f} ms "
          f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes} compulsory "
          f"bytes); plain {plain_ms:.4f} ms; torch.sparse CSR mv of P^T "
          f"{library_ms:.4f} ms (rel diff {lib_rel:.1e}); bound "
          f"{bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s ({bound_ops_ms:.5f}"
          f" ms by fp32 ops)")
    if not lib_rel <= 1e-5:
        raise AssertionError(f"CSR yardstick disagrees with K3: {lib_rel}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def warm_gamg_ms_per_it(gamg):
    t = time.perf_counter()
    res = gamg["ksp"].solve(gamg["b"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / int(res.its)


def main():
    name, smi = device_info()
    build_kernels()
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    A, b, _ = ex45_system(GRID, GRID, GRID)
    print(f"ex45 {GRID}^3: n={A.shape[0]} nnz={A.nnz} "
          f"({time.perf_counter() - t:.1f} s)")
    M, xp, err = check_kernel(A, 16, "diag", "cuda", rng)
    rows = 3 * 16 * 128 + 500
    R = sp.random(rows, 2500, density=4 / 2500, random_state=1,
                  format="csr", dtype=np.float32)
    R = (R + sp.eye(rows, 2500, dtype=np.float32)).tocsr()
    _, _, err_chunk = check_kernel(R, 16, "chunk", "cuda", rng)
    Mp, bp, launches, cg_ms_per_it = drive_main_path(A, b)
    check_small_against_cpu()
    times = measure(A, M, xp)
    print(f"CG+jacobi ms per iteration at {GRID}^3: {cg_ms_per_it:.4f} in "
          f"the main path, {warm_cg_ms_per_it(Mp, bp):.4f} repeated")
    del A, b, M, xp, Mp, bp, R
    mg = drive_mg_path()
    check_mg_small_against_cpu()
    k1_err, k1_times = k1_phases(mg, rng)
    mg_launches = mg["launches"]
    print(f"CG+MG ms per iteration at {MG_GRID}^3: {mg['ms_per_it']:.4f} in "
          f"the main path, {warm_mg_ms_per_it(mg):.4f} repeated")
    del mg
    gamg = drive_gamg_path()
    k3_err, P0, P0_host = k3_phases(gamg, rng)
    check_gamg_small_against_cpu()
    k3_times = measure_k3(P0, P0_host, rng)
    print(f"CG+GAMG ms per iteration at {GAMG_GRID}^3: "
          f"{gamg['ms_per_it']:.4f} in the main path, "
          f"{warm_gamg_ms_per_it(gamg):.4f} repeated")
    kernels = [dict(name="sell_spmv", route="cuda",
                    source="petsctpu_torch/csrc/sell_spmv.cu",
                    replaces="petsctpu/mat/sell.py:136", launches=launches,
                    max_abs_err=max(err, err_chunk), **times),
               dict(name="stencil_mult", route="cuda",
                    source="petsctpu_torch/csrc/stencil_mult.cu",
                    replaces="petsctpu/ops/stencil_pallas.py:50",
                    launches=mg_launches, max_abs_err=k1_err, **k1_times),
               dict(name="sell_spmvT", route="cuda",
                    source="petsctpu_torch/csrc/sell_spmvT.cu",
                    replaces="petsctpu/mat/sell.py:214",
                    launches=gamg["launches"], max_abs_err=k3_err,
                    **k3_times)]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
