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
5. K2's times: the kernel's device time (20 calls replayed from a CUDA
   graph, median of 20 replays) and a call's time back to back (CUDA
   events, median of 50 runs of 10 after warm-up; the wrapper's host
   cost included), its plain version, a torch.sparse CSR product as the
   yardstick (one call, timed back to back too), the kernel's bound and
   a STREAM triad; and the ms per CG iteration of that path's solve and
   of a repeat of it. In the kernels line a kernel's "ms" is its call
   back to back, as its "plain_ms" and "library_ms" are, and
   "device_ms" its time in a CUDA graph;
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
   every level operator of the MG hierarchy (fp64: the 129³ ex45
   operator and the 65³, 33³, 17³, 9³ and 5³ 27-point Galerkin
   operators), small 2-D periodic and mirror stencils, and the edge
   cases of K1_EDGES against numpy's fp64 product (grids with no
   interior point, D = 1, D = 125, a 19-point stencil on the generic
   path, a fast extent off a multiple of 32, every boundary type, an
   fp32 7-point stencil whose interior warps take the interior path,
   1-D);
   and with inf and NaN coefficients at boundary points it must give
   the same values and NaN at the same points;
8. K1's times at every level shape and at 4096²: kernel, plain version,
   torch.sparse CSR `mv` and the byte bound, and its launches an
   iteration at each level shape (StencilMat.mult's K1 calls counted by
   grid in phase 6's counted solve, their sum equal to the rise of K1's
   launch count over it); and the ms per CG+MG iteration of a repeat of
   the solve;
9. slice 3's path at full size, KSP ex45 with -pc_type gamg on SELL: the
   128³ operator through mat_from_options(-mat_type sell) and a KSP with
   set_operators(M, A_host), CG preconditioned by smoothed-aggregation
   GAMG to rtol 1e-5: true residual ≤ 1e-4, the setup seconds split into
   hierarchy, packing and transfer (K3's transpose plans part of it), the
   formats of every level, and K3 launched at least (levels restricting
   through it) × its times in the solve, with the counts reset just
   before the path and read just after;
10. K3 against plain, on the card: K3 (SELL transpose product over a
   transpose plan) must equal the plan's plain version and the
   definition on the pack (sell_spmvT_plain) bit for bit, give the same
   bits over 10 launches, and match scipy's fp64 Pᵀr within 1e-5
   relative, on the 128³ prolongators of levels 0 and 1 of that
   hierarchy (the thread and the warp shape), and in both launch shapes
   on tests/test_sell.py:234's prolongator-like case at G 8 and 16 and
   on a case whose windows span 640 rows;
11. the same GAMG solve on the 2-D 128² Laplacian on the card against the
   port's CPU path (equal its and reason, history within 1e-4 relative);
12. K3's times on the 128³ level-0 and level-1 prolongators: kernel, the
   plan's plain version, the definition on the pack, torch.sparse CSR
   `mv` of Pᵀ, the plan's byte bound and the pack's, and the plan's build
   time; K2 in chunk mode on the level-0 prolongator (P.mult) against its
   plain version, its pack bound and CSR `mv` of P; and the ms per
   CG+GAMG iteration of a repeat of the solve;
13. slice 4's path, the TPU probe kernels as H1-H3: every case of
   `python -m petsctpu_torch.probes` (petsctpu_torch.probes.check_cases)
   at its script's seed and size, its kernel launched once, with the
   launch counts reset just before and read just after. Each case's
   kernel (H1 sell_pass, H2 window_spmv or H3 gather_forms) must equal
   its plain version bit for bit and the script's numpy emulation
   (exactly for a gather, within 1e-5 relative for a sum). Then every
   case is timed: the kernel (back-to-back calls, and replayed from a
   CUDA graph, which leaves out the host's cost of a call), the plain
   version and the library call, beside the bound, and K2 on the padded
   layout beside the tile-mode SELL cases at bench scale. SELL-X (H1's
   crossed mode) is launched 10 more times and must give the same bits
   each time, and H1's crossed kernel must equal its plain version bit
   for bit on inputs SELL-X does not reach (outside the counted run):
   G 8 / P 16 with int32 idx and G 32 / P 4 on 140 tiles (more than the
   H100's 132 SMs), G 16 / P 8 on 5 tiles with int32 idx, each with a
   tile of no chunks, a tile whose staged half window runs past the last
   row of xp, and idx and i1 values across the whole int8 range (taken
   mod 128); and H2 must equal its plain version bit for bit on the
   (n, K, Rb) of H2_EDGES (K 5, 33 and 64, Rb off a multiple of 32, n
   under a block of rows). SELL-X's and P12's (H3's chained rep sum)
   device times are printed against their bounds, and the host's cost
   of a call by part (scripts/bench_calls.py) for P10 A (H3) and P17
   (H1).

Slice 5 runs right after phase 5, on phase 4's 128³ SELL operator:
14. its path, KSP ex45 with -ksp_type cg -pc_type bjacobi
   -pc_bjacobi_blocks 8 -sub_pc_type ilu (fp32, natural sub-ordering),
   rtol 1e-5: true residual ≤ 1e-4, the setup seconds split into factor
   numerics, levels and plan building, ms per iteration (first and
   repeated), and SpTRSV launched twice a PC apply (the wrapper's count
   against the applies counted), with the counts reset just before the
   path and read just after; the repeat is profiled (device busy and
   idle shares); then CG + -pc_type icc (one 2,097,152-row plan, the grid
   shape) and CG + -pc_type sor (SSOR, scalar: ex45 has no inodes) once
   each, to the same residual;
15. bjacobi(8) ILU, ASM(4, overlap 1), ICC(1) and SSOR at 16³ in fp64
   on the card against the port's CPU path: equal its and reason,
   histories within 1e-10 relative;
16. SpTRSV against its plain version, bit for bit, on the 128³ bjacobi
   L and U plans, the ICC plans, the SSOR plans and an SOR triangle with
   ω = 1.5, and on edge plans (a diagonal, a 4,096-row chain, rows
   without off-diagonals, stacked unequal subdomains in the block and
   cluster shapes, padded levels in the grid shape, K = 6 and 17 in the
   grid and cluster shapes); after phase 8, slice 2's coarse LU plans
   (fp64) likewise, and an MG apply's host time;
17. SpTRSV's times on each 128³ triangle: 20 solves replayed from a CUDA
   graph, a call back to back, the plain version, one
   torch.triangular_solve on the CSR triangle (cuSPARSE), the byte bound
   at 3.35 TB/s, and the dependency bound: the plan's bytes at the
   measured STREAM triad against its levels times one dependent round,
   measured on the chain.

It ends with the nvidia-smi line, a JSON line of kernels and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch import probes
from petsctpu_torch.convert import sell_from_arrays
from petsctpu_torch.core.logging import log_begin, log_events
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import (StencilMat, aij_from_scipy, mat_from_options,
                                stencil_from_scipy, stencil_to_scipy)
from petsctpu_torch.mat import stencil as stencil_module
from petsctpu_torch.mat.factor import (ilu0, make_sptrsv_plan,
                                       stacked_sptrsv_plan)
from petsctpu_torch.mat.sell import sell_from_scipy, sell_pack, sell_to_scipy
from petsctpu_torch.models import ex45_system, laplacian_2d
from petsctpu_torch.ops import _build
from petsctpu_torch.ops.gather_forms import gather_forms
from petsctpu_torch.ops.sell_pass import sell_pass, sell_pass_plain
from petsctpu_torch.ops.sell_spmv import sell_spmv, sell_spmv_plain
from petsctpu_torch.ops.sell_spmvT import (sell_spmvT, sell_spmvT_plain,
                                           sell_spmvT_plan_plain,
                                           transpose_plan)
from petsctpu_torch.ops.sptrsv import launch_shape, sptrsv, sptrsv_plain
from petsctpu_torch.ops.stencil_mult import stencil_mult, stencil_mult_plain
from petsctpu_torch.ops.window_spmv import window_spmv, window_spmv_plain
from petsctpu_torch.pc.sor import make_sor
from petsctpu_torch.timing import (FP32_FLOPS_PER_S, FP64_FLOPS_PER_S,
                                   HBM_BYTES_PER_S, graph_ms, time_ms)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))
from bench_calls import case_parts  # noqa: E402
from bench_k1 import (STAR5, STAR7, STAR19, bench_stencil,  # noqa: E402
                      csr_tensor, k1_bound)
from profile_torch_cg import _union_us, _wall_ms  # noqa: E402

GRID = 128                 # ex45 at 128³: n = 2,097,152
MG_GRID = 129              # ex45 -pc_type mg at 129³: n = 2,146,689
GAMG_GRID = 128            # ex45 -pc_type gamg at 128³: n = 2,097,152
K3_LEVELS = (0, 1)         # the levels that restrict through K3 at 128³
BENCH_M = 4096             # bench.py's stencil: 4096², n = 16,777,216
MG_OPTS = {"ksp_type": "cg", "pc_type": "mg", "ksp_rtol": "1e-5"}
BOX27 = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
              for k in (-1, 0, 1))
BOX125 = tuple((i, j, k) for i in range(-2, 3) for j in range(-2, 3)
               for k in range(-2, 3))
# K1's edge cases on the card: (label, grid, offsets, boundary, dtype)
K1_EDGES = (
    ("no interior point", (2, 3, 37), BOX27, ("none",) * 3, np.float64),
    ("no interior point, fp32 5-point", (2, 37), STAR5, ("none",) * 2,
     np.float32),
    ("D=1", (7, 9, 45), ((0, 0, 1),), ("none", "none", "periodic"),
     np.float64),
    ("D=125 (the 5x5x5 box)", (12, 11, 70), BOX125,
     ("mirror", "periodic", "none"), np.float32),
    ("19-point (generic path)", (20, 21, 45), STAR19, ("none",) * 3,
     np.float64),
    ("27-point, fast extent 47", (17, 13, 47), BOX27, ("periodic",) * 3,
     np.float32),
    ("7-point, three boundary types", (33, 34, 35), STAR7,
     ("periodic", "mirror", "none"), np.float64),
    ("7-point fp32 (the interior path), three boundary types", (20, 21, 45),
     STAR7, ("mirror", "none", "periodic"), np.float32),
    ("1-D 3-point", (1000,), ((-1,), (0,), (1,)), ("mirror",), np.float64),
)
# H2's edge cases on the card: (n, K, Rb)
H2_EDGES = ((96, 5, 48), (1000, 33, 100), (4100, 64, 41), (40, 33, 20),
            (2047, 32, 89))
KSP_OPTS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": "1e-5",
            "ksp_max_it": "2000"}
GMRES_OPTS = {"ksp_type": "gmres", "pc_type": "jacobi",
              "ksp_gmres_restart": "30", "ksp_max_it": "300"}
GAMG_OPTS = {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": "1e-5"}
# slice 5: bench.py's config 2 at slice 1's size, and two more PCs once
SLICE5_OPTS = {"ksp_type": "cg", "pc_type": "bjacobi",
               "pc_bjacobi_blocks": "8", "sub_pc_type": "ilu",
               "ksp_rtol": "1e-5", "ksp_max_it": "2000"}
ONCE_OPTS = {"icc": {"ksp_type": "cg", "pc_type": "icc", "ksp_rtol": "1e-5",
                     "ksp_max_it": "2000"},
             "sor": {"ksp_type": "cg", "pc_type": "sor", "ksp_rtol": "1e-5",
                     "ksp_max_it": "2000"}}
# the 16³ fp64 solves held card against CPU
SMALL_PCS = {"bjacobi(8) ILU": {"pc_type": "bjacobi",
                                "pc_bjacobi_blocks": "8"},
             "ASM(4, overlap 1)": {"pc_type": "asm", "pc_asm_blocks": "4",
                                   "pc_asm_overlap": "1"},
             "ICC(1)": {"pc_type": "icc", "pc_factor_levels": "1"},
             "SSOR": {"pc_type": "sor"}}


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
    sell_pass.launches = 0
    window_spmv.launches = 0
    gather_forms.launches = 0
    sptrsv.launches = 0


def drive_main_path(A, b_np):
    """The options-driven solve at full size, counting kernel launches."""
    opts = Options({"mat_type": "sell", "mat_ordering_type": "natural"})
    reset_counts()
    t = time.perf_counter()
    M, perm = mat_from_options(A, opts, dtype=torch.float32)
    setup_s = time.perf_counter() - t
    if not np.array_equal(perm, np.arange(A.shape[0])):
        raise AssertionError("natural ordering gave a permutation")
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
    call_ms = time_ms(lambda: sell_spmv(*args, **kw))
    ms = graph_ms(lambda: sell_spmv(*args, **kw))
    plain_ms = time_ms(lambda: sell_spmv_plain(*args, **kw), inner=1)
    csr = csr_tensor(A, np.float32)
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
    print(f"K2 at {GRID}^3: {ms:.4f} ms in a CUDA graph "
          f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes} compulsory "
          f"bytes, {100 * bound_bytes_ms / ms:.1f} % of the byte bound), "
          f"{call_ms:.4f} ms a call back to back; plain {plain_ms:.4f} ms; "
          f"torch.sparse CSR mv {library_ms:.4f} ms (rel diff {lib_rel:.1e}); "
          f"bound {bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s "
          f"({bound_ops_ms:.5f} ms by fp32 ops); STREAM triad {triad:.1f} GB/s")
    if not lib_rel <= 1e-5:
        raise AssertionError(f"CSR yardstick disagrees with K2: {lib_rel}")
    return dict(ms=call_ms, device_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
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
    by_grid = collections.Counter()
    real = stencil_module.stencil_mult

    def spy(coeffs, x, offsets, grid, boundary=()):
        by_grid[tuple(grid)] += 1
        return real(coeffs, x, offsets, grid, boundary)
    stencil_module.stencil_mult = spy      # StencilMat.mult's K1 call
    try:
        t = time.perf_counter()
        res = ksp.solve(bt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        stencil_module.stencil_mult = real
    launches = {"stencil_mult": stencil_mult.launches,
                "sell_spmv": sell_spmv.launches, "sptrsv": sptrsv.launches}
    its, reason = int(res.its), int(res.reason)
    solve_launches = launches["stencil_mult"] - setup_launches
    if sum(by_grid.values()) != solve_launches:
        raise AssertionError(f"K1's calls by grid ({sum(by_grid.values())}) "
                             f"differ from its launches in the solve "
                             f"({solve_launches})")
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
          f"the solve, {launches['stencil_mult']} in the path; SpTRSV "
          f"launches {launches['sptrsv']} (the coarse LU)")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+MG failed: reason {reason}, residual "
                             f"{relres}")
    if solve_launches < its:
        raise AssertionError(f"K1 launched {solve_launches} times in {its} "
                             "its")
    if launches["sptrsv"] < 2 * its:
        raise AssertionError(f"SpTRSV launched {launches['sptrsv']} times in "
                             f"{its} its")
    return dict(S=S, ksp=ksp, b=bt, launches=launches["stencil_mult"],
                ms_per_it=1e3 * secs / its, its=its,
                per_it={g: n / its for g, n in by_grid.items()})


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
    call_ms = time_ms(lambda: stencil_mult(*args))
    ms = graph_ms(lambda: stencil_mult(*args))
    plain_ms = time_ms(lambda: stencil_mult_plain(*args), runs=20, inner=1)
    csr = csr_tensor(A_host, np.float32 if S.dtype == torch.float32
                     else np.float64)
    y_lib = torch.mv(csr, x)
    y = stencil_mult(*args)
    lib_rel = float((y_lib - y).abs().max() / y.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x))
    nbytes, bound_bytes_ms, bound_ops_ms = k1_bound(S)
    print(f"K1 at {label}: {ms:.4f} ms in a CUDA graph "
          f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes} compulsory "
          f"bytes), {call_ms:.4f} ms a call back to back; plain "
          f"{plain_ms:.4f} ms; "
          f"torch.sparse CSR mv {library_ms:.4f} ms (rel diff {lib_rel:.1e}); "
          f"bound {bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s "
          f"({bound_ops_ms:.5f} ms by ops)")
    tol = 1e-5 if S.dtype == torch.float32 else 1e-12
    if not lib_rel <= tol:
        raise AssertionError(f"CSR yardstick disagrees with K1: {lib_rel}")
    return dict(ms=call_ms, device_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def check_k1_edges(rng):
    """K1 against its plain version, bit for bit, and numpy's fp64
    product on K1_EDGES: no interior point, D = 1 and 125, a 19-point
    stencil, a fast extent off a multiple of 32, every boundary type;
    then a 7-point stencil with inf and NaN coefficients at boundary
    points (an out-of-grid neighbour adds coeff·0): the same values and
    NaN at the same points."""
    errs = []
    for label, grid, offs, bnd, dt in K1_EDGES:
        C = rng.standard_normal((len(offs),) + grid).astype(dt)
        S = StencilMat(torch.from_numpy(C).cuda(), offs, grid, bnd)
        errs.append(check_k1(f"edge: {label}", S, rng)[0])
    grid = (9, 10, 33)
    C = rng.standard_normal((7,) + grid)
    C[1, 0] = np.inf                    # offset (-1, 0, 0) at i0 = 0
    C[6, :, :, -1] = np.nan             # offset (0, 0, 1) at i2 = 32
    C[3, 4, 0, 5] = -np.inf             # offset (0, -1, 0) at i1 = 0
    S = StencilMat(torch.from_numpy(C).cuda(), STAR7, grid)
    x = torch.from_numpy(rng.standard_normal(S.shape[0])).cuda()
    args = (S.coeffs, x, S.offsets, S.grid, S.boundary)
    y, y_plain = stencil_mult(*args), stencil_mult_plain(*args)
    nan = torch.isnan(y_plain)
    same = torch.equal(torch.isnan(y), nan) and torch.equal(y[~nan],
                                                            y_plain[~nan])
    print(f"K1 edge: inf and NaN coefficients at boundary points: "
          f"{int(nan.sum())} NaN of {y.numel()}, equal to the plain "
          f"version: {same}")
    if not same or int(nan.sum()) == 0:
        raise AssertionError("K1 with inf/NaN coefficients differs from its "
                             "plain version")
    return errs


def k1_phases(mg, rng):
    """K1 against plain on every case, and its times at every level shape
    of the slice-2 hierarchy and at 4096²; returns (max |kernel - plain|,
    times at 129³)."""
    errs, times = [], {}
    S = bench_stencil(rng, BENCH_M)
    A_host = stencil_to_scipy(S)
    err, x = check_k1(f"{BENCH_M}^2 5-point", S, rng, A_host)
    errs.append(err)
    measure_k1(f"{BENCH_M}^2 5-point fp32", S, x, A_host)
    del S, A_host, x
    per_it, its = mg["per_it"], mg["its"]
    for lv in mg["ksp"].pc.levels:
        S = lv.A
        label = f"{S.grid[0]}^3 {len(S.offsets)}-point"
        A_host = stencil_to_scipy(S)
        err, x = check_k1(label, S, rng, A_host)
        errs.append(err)
        times[label] = measure_k1(label + " fp64", S, x, A_host)
        print(f"K1 at {label}: {per_it.get(S.grid, 0):.2f} launches an "
              f"iteration of the CG+MG solve ({its} its)")
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
    errs += check_k1_edges(rng)
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
                                     "PCMGTransfer", "PCMGTransposePlan")}
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
          f"{split['PCMGPack']:.2f} + transfer {split['PCMGTransfer']:.2f} s "
          f"(K3's transpose plans {split['PCMGTransposePlan']:.3f} s of it)")
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
    """A random r for M's rows, and the same r zero-padded to the pack's
    [nt,G,128] (the operand of the definition, sell_spmvT_plain)."""
    r = torch.from_numpy(rng.standard_normal(M.shape[0])
                         .astype(np.float32)).cuda()
    rt = torch.zeros(M.nt * M.G * 128, device="cuda")
    rt[:M.shape[0]] = r
    return r, rt.view(M.nt, M.G, 128)


def plan_name(plan):
    return "warp" if plan.warp_shape else "thread"


def check_k3(label, M, P_host, rng, plans=None):
    """K3 against its plan's plain version and the definition on the pack
    (bit for bit, and the same bits over 10 launches) and against scipy's
    fp64 Pᵀr, on M's own plan or the given ones."""
    r, rt = padded_r(M, rng)
    y_def = sell_spmvT_plain(M.vals, M.idx, M.qs, M.winstart, rt, S=M.S,
                             Lp=M.Lp)
    errs = []
    for plan in plans or (M.transpose_plan(),):
        y = sell_spmvT(plan, r)
        y_plain = sell_spmvT_plan_plain(plan, r)
        repeat = all(torch.equal(sell_spmvT(plan, r), y) for _ in range(10))
        torch.cuda.synchronize()
        err = max(float((y - y_plain).abs().max()),
                  float((y - y_def).abs().max()))
        off = M.G * 128
        yv = y.reshape(-1)[off:off + M.shape[1]].double().cpu().numpy()
        ref = P_host.T @ r.double().cpu().numpy()
        rel = float(np.abs(yv - ref).max() / np.abs(ref).max())
        print(f"K3 {label}: m={M.shape[0]} n={M.shape[1]} nt={M.nt} "
              f"P={M.npass} G={M.G} S={M.S} Lp={M.Lp}; plan {plan_name(plan)}"
              f" shape, {int(plan.cnt.sum())} entries in {plan.val.numel()} "
              f"slots, longest list {plan.longest}; max|kernel-plain|="
              f"{err} (plan's plain version and definition) same bits over "
              f"10 launches {repeat}; rel err vs scipy fp64 {rel:.3e}")
        if not (torch.equal(y, y_plain) and torch.equal(y, y_def)):
            raise AssertionError(f"K3 {label}: kernel differs from its plain "
                                 f"versions (max abs {err})")
        if not repeat:
            raise AssertionError(f"K3 {label}: launches disagree")
        if not rel <= 1e-5:
            raise AssertionError(f"K3 {label}: relative error {rel} vs "
                                 "scipy")
        errs.append(err)
    return max(errs)


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
    [(level, P, scipy P)] of the levels that restrict through K3). The
    small cases run in both launch shapes."""
    pc = gamg["ksp"].pc
    levels = []
    for l, (lev, fmt) in enumerate(zip(pc.levels, pc.formats)):
        if fmt[2] is None:
            levels.append((l, lev.P, sell_to_scipy(lev.P)))
    errs = [check_k3(f"{GAMG_GRID}^3 level-{l} prolongator", P, P_host, rng)
            for l, P, P_host in levels]
    for label, G, wide in (("prolongator-like G=8", 8, False),
                           ("prolongator-like G=16", 16, False),
                           ("wide windows G=8", 8, True)):
        A = prolongator_like(G, rng, wide=wide)
        M = sell_from_scipy(A, G=G, mode="chunk")
        plans = [transpose_plan(M.vals, M.idx, M.qs, M.winstart, S=M.S,
                                Lp=M.Lp, warp_shape=w) for w in (False, True)]
        errs.append(check_k3(label, M, A, rng, plans))
    return max(errs), levels


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


def pack_bytes(M):
    return sum(t.numel() * t.element_size()
               for t in (M.vals, M.idx, M.qs, M.winstart))


def measure_k3(l, M, P_host, rng):
    """Times of K3, its plan's plain version, the definition on the pack
    and the CSR yardstick on the level-l prolongator, the plan's byte
    bound (its live entries, list offsets and counts, r and y, each
    once) beside the pack's, the plan's build time, and K3 on a plan of
    the launch shape the split rule did not pick."""
    r, rt = padded_r(M, rng)
    plan = M.transpose_plan()
    call_ms = time_ms(lambda: sell_spmvT(plan, r))
    ms = graph_ms(lambda: sell_spmvT(plan, r))
    plain_ms = time_ms(lambda: sell_spmvT_plan_plain(plan, r), runs=5,
                       inner=1, warmup=1)
    pk = (M.vals, M.idx, M.qs, M.winstart, rt)
    def_ms = time_ms(lambda: sell_spmvT_plain(*pk, S=M.S, Lp=M.Lp), runs=5,
                     inner=1, warmup=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    transpose_plan(M.vals, M.idx, M.qs, M.winstart, S=M.S, Lp=M.Lp)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    other = transpose_plan(M.vals, M.idx, M.qs, M.winstart, S=M.S, Lp=M.Lp,
                           warp_shape=not plan.warp_shape)
    other_ms = graph_ms(lambda: sell_spmvT(other, r))
    del other
    csr = csr_tensor(P_host.T, np.float32)
    y_lib = torch.mv(csr, r)
    off = M.G * 128
    y = sell_spmvT(plan, r).reshape(-1)[off:off + M.shape[1]]
    lib_rel = float((y_lib - y).abs().max() / y.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, r))
    entries = int(plan.cnt.sum())
    lists = plan.cnt.numel()
    nbytes = entries * 8 + lists * 8 + plan.ogroup.numel() * 4 \
        + plan.rows * 4 + plan.nout * 4
    pack_nbytes = pack_bytes(M) + rt.numel() * 4 + M.Lp * 128 * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pack_bound_ms = pack_nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 2.0 * entries / FP32_FLOPS_PER_S * 1e3
    print(f"K3 at {GAMG_GRID}^3 level {l}, P {M.shape}, {plan_name(plan)} "
          f"shape: {ms:.4f} ms in a CUDA graph ({nbytes / (ms * 1e-3) / 1e9:.1f}"
          f" GB/s of {nbytes} plan bytes, {100 * bound_bytes_ms / ms:.1f} % "
          f"of the plan bound), {call_ms:.4f} ms a call back to back; plan's "
          f"plain version {plain_ms:.4f} ms; definition on the pack "
          f"{def_ms:.4f} ms; torch.sparse CSR mv of P^T {library_ms:.4f} ms "
          f"(rel diff {lib_rel:.1e}); plan bound {bound_bytes_ms:.4f} ms by "
          f"bytes at 3.35 TB/s ({bound_ops_ms:.5f} ms by fp32 ops); pack "
          f"bound {pack_bound_ms:.4f} ms ({pack_nbytes} B); plan build "
          f"{build_s:.3f} s, {plan.val.numel() * 8 + lists * 8} B; the "
          f"other shape {other_ms:.4f} ms in a CUDA graph")
    if not lib_rel <= 1e-5:
        raise AssertionError(f"CSR yardstick disagrees with K3: {lib_rel}")
    return dict(ms=call_ms, device_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=max(bound_bytes_ms, bound_ops_ms),
                bound_by="bytes" if bound_bytes_ms >= bound_ops_ms
                else "operations")


def measure_k2_prolongation(M, P_host, rng):
    """K2 in chunk mode on a prolongator (P.mult, the prolongation):
    bit for bit against its plain version, and its time beside the pack's
    byte bound and torch.mv on CSR of P (the price of the pack's
    padding)."""
    x = torch.from_numpy(rng.standard_normal(M.shape[1])
                         .astype(np.float32)).cuda()
    xp = M.pad_operand(x)
    args = (M.vals, M.idx, M.qs, M.winstart, xp)
    kw = dict(G=M.G, S=M.S, mode=M.mode)
    y = sell_spmv(*args, **kw)
    if not torch.equal(y, sell_spmv_plain(*args, **kw)):
        raise AssertionError("K2 on the prolongator differs from its plain "
                             "version")
    call_ms = time_ms(lambda: sell_spmv(*args, **kw))
    ms = graph_ms(lambda: sell_spmv(*args, **kw))
    csr = csr_tensor(P_host, np.float32)
    library_ms = time_ms(lambda: torch.mv(csr, x))
    nbytes = pack_bytes(M) + xp.numel() * 4 + y.numel() * 4
    live = int((M.vals != 0).sum())
    print(f"K2 chunk mode on P {M.shape} (P.mult): {ms:.4f} ms in a CUDA "
          f"graph, {call_ms:.4f} ms a call back to back; pack bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B, "
          f"{100 * live / M.vals.numel():.1f} % of the slots live); "
          f"torch.sparse CSR mv of P {library_ms:.4f} ms; max|kernel-plain|"
          f"=0.0")


def warm_gamg_ms_per_it(gamg):
    t = time.perf_counter()
    res = gamg["ksp"].solve(gamg["b"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / int(res.its)


# ---------------------------------------------------------------- slice 5

def solve_counted(ksp, b):
    """ksp.solve(b) with the PC's applies and SpTRSV's launches counted:
    (result, seconds, PC applies, SpTRSV launches)."""
    pc = ksp.pc
    applies = [0]
    real = pc.apply

    def apply(x):
        applies[0] += 1
        return real(x)
    pc.apply = apply
    before = sptrsv.launches
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ksp.solve(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        del pc.apply
    return res, secs, applies[0], sptrsv.launches - before


def true_residual(A, b_np, res):
    x = res.x.double().cpu().numpy()
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or NaNs")
    return float(np.linalg.norm(b_np - A @ x) / np.linalg.norm(b_np))


def setup_split():
    """Seconds of the logged setup events: numerics, levels, plans."""
    ev = log_events()
    t = {k: ev[k].time if k in ev else 0.0
         for k in ("MatFactorNumeric", "MatSolveLevels", "MatSolvePlan")}
    return (t["MatFactorNumeric"], t["MatSolveLevels"],
            t["MatSolvePlan"] - t["MatSolveLevels"])


def profile_solve(ksp, b):
    """The device's busy and idle shares of a repeat of the solve under
    torch.profiler, and its top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ksp.solve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    n = int(res.its)
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in events])
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        per[e.name][0] += 1
        per[e.name][1] += e.time_range.end - e.time_range.start
    print(f"slice5 profiled: wall {1e3 * wall / n:.4f} ms/it; device busy "
          f"{busy / n / 1e3:.4f} ms/it, idle share "
          f"{1 - busy / (wall * 1e6):.3f}")
    for name, (count, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"  {us / n / 1e3:9.5f} ms  {count / n:5.1f}/it  {name[:80]}")


def drive_slice5_path(A, b_np, M):
    """Slice 5's path at full size: ex45 128³ on phase 4's fp32 SELL
    operator, KSP with -ksp_type cg -pc_type bjacobi -pc_bjacobi_blocks 8
    -sub_pc_type ilu (natural sub-ordering), rtol 1e-5, counting
    launches; then a repeat of the solve, timed and profiled."""
    reset_counts()
    log_begin()
    ksp = KSP(Options(dict(SLICE5_OPTS))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    numeric, levels, plans = setup_split()
    pc = ksp.pc
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    res, secs, applies, launches = solve_counted(ksp, b)
    its, reason = int(res.its), int(res.reason)
    path_launches = sptrsv.launches
    relres = true_residual(A, b_np, res)
    print(f"slice5 path: bjacobi(8) ILU(0) setup {setup_s:.2f} s = factor "
          f"numerics {numeric:.2f} + levels {levels:.2f} + plan building "
          f"{plans:.2f} + subdomains and the rest "
          f"{setup_s - numeric - levels - plans:.2f} s; plans "
          f"{tuple(pc.Lplans.level_rows.shape)} L, "
          f"{tuple(pc.Uplans.level_rows.shape)} U (nb, nlev, rmax)")
    print(f"slice5 path: CG+bjacobi(8) ILU its={its} reason={reason} "
          f"{secs:.3f} s = {1e3 * secs / its:.4f} ms/it; true rel residual "
          f"{relres:.3e}; history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; {applies} PC applies, SpTRSV "
          f"launches {launches} ({launches / its:.2f} an iteration), K2 "
          f"launches {sell_spmv.launches}")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+bjacobi failed: reason {reason}, "
                             f"residual {relres}")
    if launches != 2 * applies or applies < its:
        raise AssertionError(f"SpTRSV launched {launches} times for "
                             f"{applies} PC applies in {its} its")
    if sell_spmv.launches < its:
        raise AssertionError(f"K2 launched {sell_spmv.launches} times in "
                             f"{its} its")
    res2, secs2, _, _ = solve_counted(ksp, b)
    if int(res2.its) != its:
        raise AssertionError("the repeated solve took other its")
    print(f"slice5 CG+bjacobi(8) ILU ms per iteration at {GRID}^3: "
          f"{1e3 * secs / its:.4f} in the main path, "
          f"{1e3 * secs2 / its:.4f} repeated")
    profile_solve(ksp, b)
    return dict(ksp=ksp, b=b, launches=path_launches,
                per_it=launches / its)


def drive_once(A, b_np, M, name):
    """CG with -pc_type icc or sor at 128³ on the SELL operator, once."""
    log_begin()
    ksp = KSP(Options(dict(ONCE_OPTS[name]))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    numeric, levels, plans = setup_split()
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    res, secs, applies, launches = solve_counted(ksp, b)
    its, reason = int(res.its), int(res.reason)
    relres = true_residual(A, b_np, res)
    print(f"{name} at {GRID}^3 ({type(ksp.pc).__name__}): setup {setup_s:.2f}"
          f" s (numerics {numeric:.2f}, levels {levels:.2f}, plans "
          f"{plans:.2f}); CG its={its} reason={reason} {secs:.3f} s = "
          f"{1e3 * secs / its:.4f} ms/it; true rel residual {relres:.3e}; "
          f"SpTRSV launches {launches} for {applies} PC applies")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+{name} failed: reason {reason}, residual "
                             f"{relres}")
    if launches != 2 * applies:
        raise AssertionError(f"{name}: {launches} SpTRSV launches for "
                             f"{applies} applies")
    return ksp


def check_slice5_small_against_cpu():
    """bjacobi(8) ILU, ASM(4, overlap 1), ICC(1) and SSOR at 16³ in fp64
    on AIJ, on the card and on the CPU through the port: equal its and
    reason, histories within 1e-10 relative."""
    A, b, _ = ex45_system(16, 16, 16)
    for label, pc_opts in SMALL_PCS.items():
        out = {}
        for dev in ("cuda", "cpu"):
            opts = Options({"ksp_type": "cg", "ksp_rtol": "1e-8", **pc_opts})
            res = KSP(opts).set_operators(aij_from_scipy(A, device=dev),
                                          A).solve(
                torch.from_numpy(b).to(dev))
            out[dev] = (int(res.its), int(res.reason), res.history.numpy())
        (gi, gr, gh), (ci, cr, ch) = out["cuda"], out["cpu"]
        hdiff = float(np.abs(gh[:gi + 1] / ch[:gi + 1] - 1).max()) \
            if gi == ci else float("inf")
        print(f"16^3 CG+{label} card vs cpu: its {gi}/{ci} reason {gr}/{cr}"
              f" history rel diff {hdiff:.2e}")
        if (gi, gr) != (ci, cr) or gr <= 0 or not hdiff <= 1e-10:
            raise AssertionError(f"16^3 CG+{label} on the card disagrees "
                                 "with the CPU")


def check_sptrsv(label, plan, rng):
    """SpTRSV against its plain version, bit for bit, on the card."""
    shape = tuple(plan.dinv.shape)
    b = torch.from_numpy(rng.standard_normal(shape)).to("cuda", plan.dtype)
    x = plan.solve(b)
    ref = sptrsv_plain(*plan.order, b.reshape(plan.nb, -1)).reshape(x.shape)
    torch.cuda.synchronize()
    err = float((x - ref).abs().max())
    held = sum(t.numel() * t.element_size() for t in (*plan.order,
                                                        plan.nlevs))
    print(f"sptrsv {label}: {tuple(plan.level_rows.shape)} levels x rows, "
          f"K={plan.cols.shape[-1]} ({plan.order[2].shape[-1]} on the "
          f"device, {held} B), rmax {plan.rmax}, {plan.dtype}, "
          f"{launch_shape(plan.nb, plan.rmax)} shape: "
          f"max|kernel-plain|={err}")
    if not torch.equal(x, ref):
        raise AssertionError(f"sptrsv {label}: the kernel differs from its "
                             f"plain version by {err}")
    return err, b


def edge_plans(rng):
    """SpTRSV's edge plans: a diagonal (nlev 1), a chain (1-D tridiagonal
    lower, n 4096, rmax 1) in fp64 and fp32, rows with no off-diagonals
    among others, stacked plans of unequal subdomains (identity-padded,
    levels padded) in the block and the cluster shapes, a single plan in
    the grid shape with padded levels and slots, and two-level triangles
    of six off-diagonals a row (K > 4: the slots past the fourth loaded
    after the barrier) in the grid and the cluster shapes."""
    out = {"diagonal": make_sptrsv_plan(
        sp.diags(rng.uniform(1, 2, 1000)).tocsr(), True, False,
        np.float64, device="cuda")}
    e = np.ones(4096)
    chain = sp.diags([-e[:-1], 2 * e], [-1, 0]).tocsr()
    for dt in (np.float64, np.float32):
        out[f"chain {np.dtype(dt).name}"] = make_sptrsv_plan(
            chain, True, False, dt, device="cuda")
    n = 5000
    T = sp.tril(sp.random(n, n, density=3.0 / n, random_state=rng,
                          format="csr"), -1).tocsr()
    T = (sp.diags(np.where(rng.random(n) < 0.5, 0.0, 1.0)) @ T).tocsr()
    T.eliminate_zeros()
    out["half the rows without off-diagonals"] = make_sptrsv_plan(
        (T + sp.diags(rng.uniform(1, 2, n))).tocsr(), True, False,
        np.float32, device="cuda")

    def unequal(A, pieces):
        size = max(m for _, m in pieces)
        subs = []
        for lo, m in pieces:
            L = ilu0(A[lo:lo + m][:, lo:lo + m])[0]
            subs.append(sp.block_diag([L, sp.csr_matrix((size - m,) * 2)])
                        .tocsr() if m < size else L)
        return stacked_sptrsv_plan(subs, True, True, np.float32,
                                   device="cuda")

    A16 = sp.csr_matrix(ex45_system(16, 16, 16)[0])
    out["stacked, unequal subdomains"] = unequal(
        A16, ((0, 300), (300, 1000), (1300, 37)))
    A64 = sp.csr_matrix(ex45_system(64, 64, 64)[0])
    out["stacked, unequal subdomains, wide levels"] = unequal(
        A64, ((0, 20000), (20000, 60000), (80000, 3000)))
    out["grid shape, padded"] = make_sptrsv_plan(
        ilu0(A64)[1], False, False, np.float64, pad_to=(300, 3100, 5),
        device="cuda")
    # two wide levels: rows 3000-5999 each read 6 rows of 0-2999
    m = 3000
    r = np.repeat(np.arange(m, 2 * m), 6)
    c = rng.integers(0, m, r.size)
    W = (sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                       shape=(2 * m, 2 * m)).tocsr()
         + sp.diags(rng.uniform(1, 2, 2 * m))).tocsr()
    out["two wide levels, K > 4"] = make_sptrsv_plan(
        W, True, False, np.float32, device="cuda")
    out["stacked two wide levels, K > 4"] = stacked_sptrsv_plan(
        [W, sp.csr_matrix(W.T)[::-1][:, ::-1].tocsr()], True, False,
        np.float64, device="cuda")
    return out


def plan_to_scipy(plan):
    """The triangle of a (stacked) plan as one scipy CSR (stacked plans
    block-diagonal), the diagonal as 1/dinv."""
    cols = plan.cols.reshape(plan.nb, plan.n + 1, -1)
    vals = plan.vals.astype(np.float64).reshape(cols.shape)
    dinv = plan.dinv.astype(np.float64).reshape(plan.nb, plan.n)
    n = plan.n
    blocks = []
    for s in range(plan.nb):
        r = np.repeat(np.arange(n), cols.shape[-1])
        c, v = cols[s, :n].ravel(), vals[s, :n].ravel()
        live = c < n
        blocks.append((sp.coo_matrix((v[live], (r[live], c[live])),
                                     shape=(n, n))
                       + sp.diags(1.0 / dinv[s])).tocsr())
    return sp.block_diag(blocks).tocsr()


def library_trsv(plan, upper):
    """One PyTorch call computing the same solve, where this PyTorch has
    one: torch.triangular_solve on a CUDA sparse CSR triangle (cuSPARSE).
    Returns (the call, None) or (None, why not)."""
    T = csr_tensor(plan_to_scipy(plan),
                   np.float32 if plan.dtype == torch.float32 else np.float64)
    bcol = torch.ones((T.shape[0], 1), dtype=plan.dtype, device="cuda")
    try:
        torch.triangular_solve(bcol, T, upper=upper)
    except (RuntimeError, NotImplementedError) as err:
        return None, str(err).splitlines()[0][:120]
    return (lambda: torch.triangular_solve(bcol, T, upper=upper)), None


def sptrsv_bound(plan, triad_gbs, level_us):
    """(bound ms, bound_by, its term, bytes, every term): the larger of
    the plan's live bytes (a row's index, its live cols and vals, b,
    1/diag and x written; the level starts) over the measured STREAM
    triad, and nlev dependent rounds of `level_us` each (a level's
    loads, x gather, store and barrier, timed on a chain plan). The flops
    (2 a live slot and 2 a row) at their type's peak count too, far
    below both. bound_by is "bytes" for the first term, "operations" for
    the others."""
    n, es = plan.n, plan.vals.itemsize
    live = int((plan.cols.reshape(plan.nb, n + 1, -1)[:, :n] != n).sum())
    rows = plan.nb * n
    nbytes = rows * (4 + 3 * es) + live * (4 + es) + 4 * plan.order[0].numel()
    peak = FP32_FLOPS_PER_S if plan.dtype == torch.float32 \
        else FP64_FLOPS_PER_S
    nlev = int(plan.nlevs.max())
    terms = {"bytes at the STREAM triad": nbytes / (triad_gbs * 1e9) * 1e3,
             f"{nlev} dependent levels": nlev * level_us * 1e-3,
             "flops at peak": (2 * live + 2 * rows) / peak * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term.startswith("bytes")
            else "operations", term, nbytes, terms)


def measure_sptrsv(label, plan, upper, triad_gbs, level_us, rng):
    """A triangle's times: a call back to back, 20 solves replayed from a
    CUDA graph, the plain version, the library call; and its bound."""
    shape = tuple(plan.dinv.shape)
    b = torch.from_numpy(rng.standard_normal(shape)).to("cuda", plan.dtype)
    call_ms = time_ms(lambda: plan.solve(b), runs=20, inner=5)
    device_ms = graph_ms(lambda: plan.solve(b))
    lead = (*plan.order, b.reshape(plan.nb, -1))
    plain_ms = time_ms(lambda: sptrsv_plain(*lead), runs=3, inner=1,
                       warmup=1)
    lib, why = library_trsv(plan, upper)
    library_ms = (time_ms(lib, runs=5, inner=1, warmup=1) if lib is not None
                  else None)
    bound_ms, bound_by, term, nbytes, terms = sptrsv_bound(
        plan, triad_gbs, level_us)
    nlev = int(plan.nlevs.max())
    lib_text = (f"{library_ms:.4f} ms" if library_ms is not None
                else f"none ({why})")
    terms_text = "; ".join(f"{k} {v:.4f} ms" for k, v in terms.items())
    print(f"sptrsv at {label}: {device_ms:.4f} ms in a CUDA graph "
          f"({1e3 * device_ms / nlev:.3f} us a level, {nlev} levels), "
          f"{call_ms:.4f} ms a call back to back; plain {plain_ms:.4f} ms; "
          f"torch.triangular_solve on CSR {lib_text}; bound {bound_ms:.4f} "
          f"ms by {term}, {100 * bound_ms / device_ms:.1f} % of the device "
          f"time ({terms_text}; {nbytes} B live)")
    return dict(ms=call_ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_term=term)


def slice5_phases(A, b_np, M, triad_gbs, rng):
    """Slice 5 on phase 4's 128³ operator: the counted CG+bjacobi(8)
    path, CG+icc and CG+sor once, the 16³ card-vs-CPU solves, SpTRSV
    against its plain version on every plan of phase 16 (slice
    2's coarse LU plans are checked in mg_sptrsv_check), and the times of
    each 128³ triangle. Returns the kernels line's entry for sptrsv and
    the max |kernel - plain| of its checks."""
    path = drive_slice5_path(A, b_np, M)
    icc = drive_once(A, b_np, M, "icc")
    sor = drive_once(A, b_np, M, "sor")
    check_slice5_small_against_cpu()
    pc = path["ksp"].pc
    sor_w = make_sor(A, omega=1.5, dtype=np.float32, device="cuda")
    plans = {"bjacobi(8) ILU L": (pc.Lplans, False),
             "bjacobi(8) ILU U": (pc.Uplans, True),
             "ICC L (one subdomain)": (icc.pc.Lplan, False),
             "ICC U (one subdomain)": (icc.pc.Uplan, True),
             "SSOR forward": (sor.pc.fwd_plan, False),
             "SSOR backward": (sor.pc.bwd_plan, True),
             "SOR omega=1.5 forward": (sor_w.fwd_plan, False)}
    errs = [check_sptrsv(f"{GRID}^3 {k}", p, rng)[0]
            for k, (p, _) in plans.items()]
    edges = edge_plans(rng)
    errs += [check_sptrsv(f"edge: {k}", p, rng)[0] for k, p in edges.items()]
    chain = edges["chain float64"]
    b = torch.ones(chain.n, dtype=torch.float64, device="cuda")
    level_us = 1e3 * graph_ms(lambda: chain.solve(b)) / chain.nlev
    print(f"sptrsv chain (n {chain.n}, rmax 1, fp64): {level_us:.3f} us a "
          "dependent level (index, cols, x gather, store, barrier)")
    times = {k: measure_sptrsv(f"{GRID}^3 {k}", p, up, triad_gbs, level_us,
                               rng)
             for k, (p, up) in plans.items() if "omega" not in k}
    return dict(name="sptrsv", route="cuda",
                source="petsctpu_torch/csrc/sptrsv.cu",
                replaces="petsctpu/mat/factor.py:368",
                launches=path["launches"], max_abs_err=max(errs),
                **times["bjacobi(8) ILU L"])


def mg_sptrsv_check(mg, rng):
    """Slice 2's coarse LU plans (fp64) through SpTRSV, bit for bit, and
    an MG apply's host time."""
    pc = mg["ksp"].pc
    err = max(check_sptrsv(f"slice 2 coarse LU {k}", p, rng)[0]
              for k, p in (("L", pc.coarse.Lplan), ("U", pc.coarse.Uplan)))
    print(f"slice 2: an MG apply {_wall_ms(lambda: pc.apply(mg['b'])):.4f} "
          "ms (host clock, the coarse LU through SpTRSV)")
    return err


PROBE_KERNELS = (sell_pass, window_spmv, gather_forms)
# H1's crossed mode (SELL-X) and H3's chained rep sum (P12): device time
# against the bound; H3's and H1's slowest calls against their library
# calls (P10 A, P17): the host's cost of a call by part
DEVICE_VS_BOUND = ("probe_sellx_crossed", "probe_gather6_D")
HOST_PARTS = ("probe_pallas_gather5_A", "probe_sell_bisect_d")


def check_repeatable(case, res, times=10):
    """The case's kernel launched `times` more times gives the checked
    output's bits every time (no atomics, a fixed fold order)."""
    for k in range(times):
        out = case.run()
        if not torch.equal(out, res["out"]):
            raise AssertionError(f"{case.name}: launch {k + 2} differs from "
                                 "the first")
    torch.cuda.synchronize()
    print(f"{case.name}: the same bits over {times + 1} launches")


def crossed_case(rng, G, idx_dtype, nt):
    """H1 crossed-mode inputs on the card: nt tiles of 1-3 chunks, tile 0
    with none; idx and i1 across the whole int8 range, except that the
    last tile, whose half windows start past every other tile's, reads
    only rows 0-39 of them, the last 40 rows of xp (its staged window
    runs 88 rows past the end)."""
    P = 128 // G
    nch = rng.integers(1, 4, nt).astype(np.int32)
    nch[0] = 0
    cstart = np.concatenate([[0], np.cumsum(nch)[:-1]]).astype(np.int32)
    NCH = int(nch.sum())
    ws = (rng.integers(0, 8, nt) * 8).astype(np.int32)
    hh = rng.integers(0, 2, NCH).astype(np.int32)
    i1 = rng.integers(-128, 128, (NCH, 128, 128)).astype(np.int8)
    ws[-1] = int(ws[:-1].max()) + 256
    tail = slice(int(cstart[-1]), NCH)
    hh[tail] = 1
    i1[tail] = rng.integers(0, 40, i1[tail].shape)
    xp = rng.standard_normal((int(ws[-1]) + 128 + 40, 128))
    a = dict(vals=rng.standard_normal((NCH, P, G, 128)).astype(np.float32),
             idx=rng.integers(-128, 128, (NCH, P, G, 128)).astype(idx_dtype),
             xp=xp.astype(np.float32), ws=ws, cstart=cstart, nch=nch, hh=hh,
             i1=i1)
    return {k: torch.from_numpy(v).cuda() for k, v in a.items()}


def check_crossed_edges(rng):
    """H1's crossed kernel against its plain version, bit for bit, on the
    inputs of crossed_case that SELL-X does not reach: a G other than
    16 (P = 16, two batches of 8 passes; P = 4, a batch of 4 with
    clamped loads and 1,024 quads for 512 threads), int32 idx, a tile
    with no chunks, a half window past the end of xp, and more tiles than
    the H100 has SMs."""
    for G, idx_dtype, nt in ((8, np.int32, 140), (32, np.int8, 140),
                             (16, np.int32, 5)):
        a = crossed_case(rng, G, idx_dtype, nt)
        arrays = [a.pop(k) for k in ("vals", "idx", "xp", "ws", "cstart",
                                     "nch")]
        got = sell_pass(*arrays, mode="crossed", **a)
        ref = sell_pass_plain(*arrays, mode="crossed", **a)
        if not torch.equal(got, ref):
            raise AssertionError(
                f"sell_pass crossed, G={G} {idx_dtype.__name__} {nt} tiles: "
                "the kernel differs from its plain version by "
                f"{(got - ref).abs().max().item():.3e}")
        print(f"sell_pass crossed G={G} P={128 // G} "
              f"{idx_dtype.__name__} {nt} tiles ({arrays[0].shape[0]} "
              "chunks, a tile of none, a half window past xp's end): "
              "equals its plain version bit for bit")


def check_window_edges(rng):
    """H2 against its plain version, bit for bit, on H2_EDGES: K 5, 33
    and 64 (a part chunk of slots), Rb not a multiple of 32 (the rows of
    a warp in two blocks), n below a block of rows and off a multiple of
    32."""
    for n, K, Rb in H2_EDGES:
        starts = (rng.integers(0, 64, n // Rb) * 16).astype(np.int32)
        a = [torch.from_numpy(v).cuda() for v in (
            starts, rng.integers(0, 32, (n, K)).astype(np.int32),
            rng.integers(0, 128, (n, K)).astype(np.int32),
            rng.standard_normal((n, K)).astype(np.float32),
            rng.standard_normal(32 * 128 + 1024).astype(np.float32))]
        y, y_plain = window_spmv(*a, Rb=Rb), window_spmv_plain(*a, Rb=Rb)
        if not torch.equal(y, y_plain):
            raise AssertionError(
                f"window_spmv n={n} K={K} Rb={Rb}: the kernel differs from "
                f"its plain version by {(y - y_plain).abs().max().item()}")
        print(f"window_spmv n={n} K={K} Rb={Rb}: equals its plain version "
              "bit for bit")


def probes_phase():
    """Slice 4's path: every probe case launched once through its kernel
    and checked, with the counts reset just before and read just after;
    then every case timed. Returns the kernels' entries of the JSON line,
    each with the times of its largest case (by bound): "ms" a call back
    to back, "device_ms" in a CUDA graph."""
    reset_counts()
    t = time.perf_counter()
    checked = probes.check_cases(device="cuda")
    secs = time.perf_counter() - t
    launches = {k.__name__: k.launches for k in PROBE_KERNELS}
    print(f"probes path: {len(checked)} cases checked in {secs:.1f} s; "
          f"launches {launches}")
    by_name = {case.name: (case, res) for case, res in checked}
    check_repeatable(*by_name["probe_sellx_crossed"])
    check_crossed_edges(np.random.default_rng(13))
    check_window_edges(np.random.default_rng(17))
    t = time.perf_counter()
    results = []
    for case, res in checked:
        res.update(probes.measure(case, res["out"]))
        print(probes.line(res), flush=True)
        results.append(res)
    print(f"probes timed in {time.perf_counter() - t:.1f} s")
    for name in DEVICE_VS_BOUND:
        res = by_name[name][1]
        print(f"{name}: device {res['graph_ms']:.4f} ms in a CUDA graph "
              f"against a {res['bound_ms']:.6f} ms bound = "
              f"{100 * res['bound_ms'] / res['graph_ms']:.1f} % of it; a call "
              f"{res['ms']:.4f} ms, library {res['library_ms']:.4f} ms")
    for name in HOST_PARTS:
        case = by_name[name][0]
        print(f"host cost of a {case.kernel} call, {name}, by part "
              "(us a call):")
        for part, us in case_parts(case).items():
            print(f"  {part}: {us:.2f}")
    kernels = []
    for name, n in launches.items():
        rs = [r for r in results if r["kernel"] == name]
        if n == 0 or not rs:
            raise AssertionError(f"{name} was not launched on the probes "
                                 "path")
        top = max(rs, key=lambda r: r["bound_ms"])
        print(f"{name}: {len(rs)} cases; the kernels line shows "
              f"{top['name']}")
        kernels.append(dict(
            name=name, route="cuda", source=f"petsctpu_torch/csrc/{name}.cu",
            replaces=", ".join(dict.fromkeys(r["replaces"] for r in rs)),
            launches=n, max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=top["ms"], device_ms=top["graph_ms"],
            **{k: top[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}))
    return kernels


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
    trsv = slice5_phases(A, b, Mp, stream_triad_gbs(), rng)
    del A, b, M, xp, Mp, bp, R
    mg = drive_mg_path()
    check_mg_small_against_cpu()
    k1_err, k1_times = k1_phases(mg, rng)
    trsv["max_abs_err"] = max(trsv["max_abs_err"], mg_sptrsv_check(mg, rng))
    mg_launches = mg["launches"]
    print(f"CG+MG ms per iteration at {MG_GRID}^3: {mg['ms_per_it']:.4f} in "
          f"the main path, {warm_mg_ms_per_it(mg):.4f} repeated")
    del mg
    gamg = drive_gamg_path()
    k3_err, k3_levels = k3_phases(gamg, rng)
    check_gamg_small_against_cpu()
    k3_times = [measure_k3(l, P, P_host, rng) for l, P, P_host in k3_levels]
    measure_k2_prolongation(*k3_levels[0][1:], rng)
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
                    **k3_times[0]), trsv]
    del gamg, k3_levels
    kernels += probes_phase()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
