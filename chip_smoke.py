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

Slice 5 runs right after phase 5, on phase 4's 128³ SELL operator, its
launch counts reset just before phase 14 and read after its last solve:
14. its path, KSP ex45 with -ksp_type cg -pc_type bjacobi
   -pc_bjacobi_blocks 8 -sub_pc_type ilu (fp32, natural sub-ordering),
   rtol 1e-5: 82 iterations and true residual ≤ 1e-4, the setup seconds
   split into factor numerics, levels and plan building, ms per
   iteration (first and repeated), and one SpTRSV launch a PC apply
   (sptrsv_lu: L and U in one launch, the wrapper's count against the
   applies counted); the repeat is profiled (device busy and idle
   shares); then CG + -pc_type icc (one 2,097,152-row plan, the grid
   shape, two sptrsv launches an apply) and CG + -pc_type sor (SSOR,
   scalar: ex45 has no inodes) once each, to the same residual;
15. bjacobi(8) ILU, ASM(4, overlap 1), ICC(1) and SSOR at 16³ in fp64
   on the card against the port's CPU path: equal its and reason,
   histories within 1e-10 relative;
16. SpTRSV against its plain version, bit for bit, in the shape each
   plan takes (printed; the 128³ ones held to theirs: bjacobi
   cluster-smem, its fp64 copy cluster, ICC and SSOR grid): the 128³
   bjacobi L and U plans and an fp64 copy of L, the ICC plans, the SSOR
   plans and an SOR triangle with ω = 1.5, and edge plans (a diagonal,
   a 4,096-row chain, rows without off-diagonals, stacked unequal
   subdomains, padded levels in the grid shape, K = 6 and 20, and the
   capacity edges: layered plans at the most rows whose x fits one
   block's and a cluster's shared memory and one row over, and narrow
   levels whose x fits neither, the block shape); the fused solve
   sptrsv_lu likewise on the 128³ bjacobi pair and on pairs at both
   capacity edges; after phase 8, slice 2's coarse LU plans (fp64) and
   their fused solve, and an MG apply's host time;
17. SpTRSV's times on each 128³ triangle and on a fused bjacobi apply:
   20 solves replayed from a CUDA graph (the fused apply also beside
   its two triangles as two launches), a call back to back, the plain
   version, torch.triangular_solve on the CSR triangles (cuSPARSE), and
   the dependency bound: the plan's bytes at the measured STREAM triad
   against its levels times one dependent round, the fastest measured
   on the chain, in the shape it takes (block-smem) or in the block
   shape with x in global memory.

Slice 6 runs right after slice 5, on the same 128³ SELL operator:
18. its path, KSP ex45 with -ksp_type bcgs -pc_type bjacobi
   -pc_bjacobi_blocks 8 -sub_pc_type ilu (fp32), rtol 1e-5: converged,
   true residual ≤ 1e-4, and, counted from just before the solve to just
   after it, exactly 2 K2 launches an iteration, 2·its + 1 sptrsv_lu
   launches (one a PC apply, the first on b) and its + 1 copies to the
   host (the initial norm, then one an iteration); ms per iteration
   first and repeated, the repeat profiled (device busy, idle share,
   SpTRSV's and K2's shares), setup seconds. These K2 and sptrsv_lu
   launches join the kernels line's counts;
19. every slice-6 type at 16³ in fp64 on AIJ, on the card against the
   port's CPU path (SLICE6_SMALL: ex45, a nonsymmetric ex45 and a well
   conditioned one, with Jacobi or ILU(0), rtol 1e-6), then SpecEstPC
   with fgmres (the host-driven fgmres_host), CG with a null space on
   the Neumann Laplacian, a Fischer-guess sequence and complex128
   BiCGStab: equal its and reason, histories within 1e-10 relative
   (the Fischer sequence 1e-7: its guess solves nearly dependent normal
   equations);
20. at 128³ on the SELL operator: Chebyshev + Jacobi with the default
   power-iteration bounds (petsctpu's 12 steps underestimate λmax, so
   it may diverge: its and reason printed) and with the 10-step Arnoldi
   bounds for 300 iterations (the residual must fall), ms per
   iteration; DGMRES(30) + Jacobi for three cycles, ms per cycle, its
   basis on the card (the peak of device memory above the start holds
   V); solve_ir with fp64 AIJ residuals and CG + bjacobi(8) ILU fp32
   inner solves on SELL to rtol 1e-10: the fp64 true residual ≤ 1e-10,
   sweeps and inner its printed.

Slice 7 runs after phase 12, on ksp ex55 (2-D Q1 elasticity, 2 dofs a
node, a soft inclusion, fp32 SELL in natural order):
21. its path at ne = 1023 (1024² nodes, n = 2,097,152): -ksp_type cg
   -pc_type gamg -pc_gamg_dof 2 -pc_gamg_coordinates (rigid-body modes)
   -pc_gamg_coarse_eq_limit 80, rtol 1e-5, with the launch counts reset
   just before the operator is built and read after the solve: the
   setup seconds split into hierarchy, level operators and transfers
   (host packing and transfer, K3's plans), Chebyshev bounds and the
   coarse LU; each level's size and formats; its, reason, ms per
   iteration first and repeated, the idle share of a profiled repeat,
   K2, K3 and SpTRSV launches in the solve and the true relative
   residual (printed, not gated: CG stops on the preconditioned norm,
   which the soft inclusion makes a poor guide to the true residual).
   It fails unless reason > 0, x is finite and K3 is launched once for
   each P.multT call, at least once an iteration on every level that
   restricts through it. K2 on the fine operator and K3 on each of
   those prolongators are then held bit for bit against their plain
   versions and timed (as phases 5 and 12 do). The blocked route
   (-pc_gamg_dof 2 alone) runs once at ne = 511 (since slice 8; the
   script's time: it ran at ne = 1023 before);
22. both routes at ne = 63 on the card against the port's CPU path,
   equal its and reason: fp32 on SELL for b and four one-ulp changes of
   b with histories within 5e-4, and fp64 on AIJ within 1e-8. The CPU
   first measures the fp32 history's own rounding noise: a one-ulp
   change of b moves its NC history by up to 3.95e-4 over 40 such b
   (RBM 1.90e-4), so no fp32 run of another rounding meets 1e-4;
23. the device refresh: gamg_probe_plan from asa_tentatives' P0s on the
   ne = 511 system (ne = 1023 before slice 8; the script's time), refreshed on the card with D·A·D (d =
   exp(0.2·N(0,1))), its K2 launches (12 power steps + ncp + ncc a SELL
   level) and host reads (one) counted, one refresh timed, each level's
   P and PᵀAP held against scipy's, in fp64 from that level's refreshed
   operator and frozen P0 (relative 1e-4; PᵀAP on the pattern the
   refresh keeps, the mass outside it printed), and CG on D·A·D
   preconditioned by it (its true residual printed, not gated). Before
   it, the case that tests/test_torch_gamg_device.py holds against
   petsctpu, D·A·D at ne = 31: the card's CG takes the CPU's its and
   its true residual stays within 1.1e-3 (petsctpu 0.9386e-3); then the
   same case on the card at ne = 63, 127 and 255, printing how fp32
   CG's true residual grows with ne; then
   gamg_device_plan (the SpGEMM plans) on ex45 at 64³ the same way;
24. -pc_type asa on ex55 at ne = 255: to convergence on the card (fp32
   SELL), and 40 iterations in fp64 on AIJ on the card against the CPU
   (equal its and reason, histories within 1e-10).
`python3 chip_smoke.py slice7` runs the build and phases 21-24 alone
(its last line lists their launches, not the contract's result line).

Slice 8 runs after slice 7, on ksp ex43 (Q1-Q1 Stokes, 3 dofs a node,
SolCx with η₁/η₀ = 1e6, xc = 0.5, nz = 2), fp64 on AIJ:
25. its path at mx = my = 1023 (n = 3,145,728, 2,097,152 velocity):
   make_fieldsplit on the PC matrix B with the operator A's rows
   (Amat_host), fields {0,1} and {2} by dof % 3, -pc_fieldsplit_type
   symmetric_multiplicative -fieldsplit_0_pc_type gamg
   -fieldsplit_0_pc_gamg_dof 2 -fieldsplit_1_pc_type jacobi, and
   FGMRES(30) on A to rtol 1e-8: its, reason and the true relative
   residual (≤ 1e-8, or it fails), the error line (h, p L2, u L2, u H1)
   against SolCx, ms per iteration first and repeated, the profiled
   repeat's idle share and its top kernels with their launches an
   iteration, the setup split (assembly, submatrix extraction and device
   blocks, GAMG hierarchy, level operators, coarse solve), the GAMG
   levels' sizes and formats, every hand kernel's launches an iteration
   (K1-K3, SpTRSV, H1-H3, even at zero) and the host reads; then
   AIJ.mult on A timed (a call and 20 from a CUDA graph) beside its
   byte bound at the measured STREAM triad and torch.mv on CSR;
26. the ex43 golden at mx = 20 (LU on the velocity) on the card and on
   the CPU: the monitor stream and the error line digit for digit, 8
   its;
27. -pc_fieldsplit_type schur (fact full) with GAMG(dof 2) at mx = 255,
   card against CPU: equal its and reason, histories within 2e-6 (at
   least 30 times the CPU's own change under a 1e-15 change of b,
   measured there), the inner Schur GMRES's host reads counted;
28. every other slice-8 PC type once, at its reference test's size, card
   against CPU (composite both modes, ksp with and without specest,
   shell, mat, eisenstat and its transformed system, galerkin,
   redistribute, lsc, svd, cp, spai, supportgraph, exotic both spaces,
   tfs, additive on the MAC Stokes model with its null space, three
   fields): equal its and reason, histories within each case's bound
   (1e-10 to 1e-7, at least 30 times the CPU's own difference under a
   1e-15 change of b), or, for the exact solvers and galerkin, one apply
   within 1e-12; then SpTRSV against its plain version, bit for
   bit, on the golden's velocity LU pair (sptrsv_lu, 10 more solves the
   same bits, its fused apply timed) and on the Eisenstat triangles.
The kernels line's SpTRSV launches gain the card's solves of phases 26
and 28 (phase 25 launches none). `python3 chip_smoke.py slice8` runs the
build and phases 25-28 alone. Since slice 9, AIJ.mult is the ELL kernel
(ell_spmv): phase 25 holds it bit for bit against its plain version on
ex43's A and times it there (a call, 20 calls from a CUDA graph, the
plain version, torch.mv on CSR, the kernel and CSR again in turns, the
byte bound of the int32 pack at 3.35 TB/s and at the STREAM triad), the
slice's ms per iteration are with the kernel, and the AIJ products of
one more, untimed solve are broken down by operator (m, K, dtype:
launches an iteration, device ms of one on its own pack, their product,
the shape's bound).

Slice 9 runs after slice 8, SNES in fp64 through the SNES object
(-snes_type newtonls -snes_linesearch_type bt -snes_rtol 1e-8 -ksp_type
gmres -ksp_rtol 1e-5 -snes_monitor), with the launch counts reset just
before each path and read just after:
29. snes ex14's 3-D Bratu at 128³ (λ = 6, n = 2,097,152, the 7-point
   AIJ with 14.6 M stored entries): the 27-color FD Jacobian ('ds'
   differencing, one batched residual over the colors, Fb [27, n]) and
   ILU(0) rebuilt on each Jacobian (J copied to the host, factored
   there, its two SpTRSV plans built): the monitor stream, its and
   reason (reason > 0 and fnorm ≤ 1e-8·fnorm₀, or it fails), GMRES its
   a Newton step, ms a linear iteration, each step's setup split
   (coloring assembly, J to the host, host ILU(0), the plans), the peak
   device memory, a profiled linear solve of the last step (idle share,
   top kernels), and ell_spmv launched once and SpTRSV once an ILU apply
   (fused, or two launches for triangles past shared memory) at least
   each linear iteration; then ell_spmv on the last Jacobian against
   its plain version bit for bit, and timed as in phase 25;
30. snes ex5's 2-D Bratu at 1025² (λ = 6, n = 1,050,625): the StencilMat
   Jacobian colored over 9 colors, GMRES + the device geometric MG
   (make_geometric_mg_device) rebuilt on each Jacobian: the same lines,
   K1 launched at least once a linear iteration;
31. ten small cases on the card against the CPU (ex14 at m = 8 and 12,
   ex5 at 16, newtontr, qn, ngmres, ncg, FAS, VI RSLS, NASM): equal its
   and reasons, histories within each case's bound (entries floored at
   1e-7 of the first norm), at least 30 times the CPU's own change under
   a 1e-15 change of x0, measured in the run;
32. ell_spmv against its plain version, bit for bit, and scipy: K = 1,
   m = 12345 with an all-padding row, rows wider than a stage (K = 300,
   fp64 and fp32, one row of K = 6000, 37 rows of 4001: the chunked
   kernel), an fp32 7-point operator, rectangular both ways, complex128
   and complex64, m = 0; the ring kernel's edges: m not a multiple of 4,
   m under one tile, a last tile of 3 rows whose bytes are not a
   multiple of 16, rows of 52 and 20 + 80 bytes (copies end mid-row),
   even K in fp64, fp32, complex64 and complex128 (products at stride
   K + 1), odd K in each dtype, K = 96 at 32 rows a tile.
`python3 chip_smoke.py slice9` runs the build and phases 29-32 alone, and
then ex43's A at mx = 1023 as phase 25 does.
33. ts ex15's 2-D heat DAE at 2049² (n = 4,198,401, fp64; Dirichlet rows
   weighted 4/h²) by backward Euler, dt = 0.01, 10 steps through
   ts_solve: the port's Newton with GMRES(30) on the 9-color FD
   Jacobian (a 5-point StencilMat), preconditioned by the device MG
   rebuilt on each Jacobian, the launch counts reset just before and
   read just after; each step's max, min, Newton and GMRES its and
   seconds, a Newton step's setup split into coloring assembly and MG
   setup, ms a linear iteration, peak memory, a profiled linear solve
   and a profiled time step; checks that every Newton and GMRES solve
   converges, max(u) falls every step, min(u) ≥ −1e-6·max(u0) and K1
   is launched at least once a linear iteration; then K1 against its
   plain version and timed (beside its bound and CSR `mv`) at every
   level shape of the hierarchy;
34. the TS goldens on the card: ex15_1's max column at M = 20 through
   the golden test's route (AD products, no PC) within 2e-5, ts ex1's
   pseudo-Bratu fnorms within 2e-3, ts ex3's SSP errors within 2e-4;
35. seven small TS cases on the card against the CPU (ex15 at M = 33
   with the colored Jacobian and device MG, ex22_3 by RosW ra34pw2,
   ARKIMEX 4, GL p = 3, alpha, rk dp45 with the basic adaptor, a
   periodic characteristic rotation): equal step counts, final times,
   Newton and linear its and reasons, states within each case's bound,
   at least 30 times the CPU's own change under a 1e-15 change of u0.
`python3 chip_smoke.py slice11` runs the build and phases 33-35 alone.
36. ksp ex55 at ne = 1023 (n = 2,097,152, bs 2, 37.7 M nonzeros) in fp32
   through mat_from_options(-mat_type baij -mat_block_size 2): on the
   card SellBAIJ, whose forward product is K2 on the block expansion
   (explicit zeros kept); CG + pbjacobi for a fixed 300 its (rtol
   1e-30), the launch counts reset just before the operator is built and
   K2's read just after the solve; ms an iteration first and repeated, a
   profiled repeat's idle share, the reason, the true residual and CG's
   energy ½xᵀAx − bᵀx, checked to fall at its 50, 100, ..., 300 (the
   residual of CG on ex55 rises over these 300 its: CG's transient at
   this size, scripts/ex55_convergence.py); the same solve on the
   BAIJ's block ops, its history within 30 times the block ops' own
   change under four one-ulp changes of b (the correctness gate of the
   route); K2 on this pack bit for bit
   against its plain version; SellBAIJ.mult (K2), BAIJ.mult and
   BAIJ.multT (the block ops; multT through its fold plan, two calls
   bit-equal), the ELL kernel on the expansion and CSR `mv`, each against
   its bound;
37. the same system in fp64 on SBAIJ (-mat_type sbaij), CG + ICC(0) on
   the host matrix for 300 its: ms an iteration, idle share, SpTRSV
   launches (two a PC apply, the solve's own), the setup split, peak
   memory, CG's energy falling at its 100, 200 and 300; SpTRSV on both
   ICC triangles of this plan bit for bit against its plain version, and
   the ICC apply against the plain triangles composed; SBAIJ.mult
   against the fp64 AIJ product within 1e-13 on three x, two calls
   bit-equal, timed against its bound and CSR `mv`;
38. ex55 at ne = 63 card against CPU: fp64 BAIJ and SBAIJ with CG +
   pbjacobi and + jacobi, and SBAIJ with CG + ICC(0): equal its and
   reason, the history within 1e-8 on the entries where two CPU solves
   (ICC: one) on b changed by 1e-15 stay within 1e-9 of the CPU's (CG
   on ex55 amplifies rounding; at least half the history), x within 30
   times those solves' change of x; fp32 SellBAIJ with CG + pbjacobi for
   b and two one-ulp changes of b (the history within 1e-3 where 4
   one-ulp changes of b keep the CPU's within 1e-4, x within 30 times
   their change); the three blocked
   configs of tests/test_golden_ex10.py on the card with that test's
   bounds;
39. card against CPU: -mat_type band (RCM) and dia (natural) with CG +
   jacobi on ex45 at 32³, ILU(0) with -pc_factor_tri_solve band and
   band2, -pc_gamg_mat_type band, NN and BDDC on a 2-D Poisson MatIS of
   4 subdomains, the FFT PC (equal its and reasons, histories within
   1e-8 and x as in phase 38, against one CPU solve on b changed by
   1e-15); MAIJ and Nest products, ell_from_coo with duplicates and
   AIJ.multT (bit-equal to the CPU, two calls bit-equal); then BandMat
   and DiaMat on the natural-order 513² 5-point Laplacian timed beside
   the ELL kernel and CSR `mv`.
`python3 chip_smoke.py slice12` runs the build and phases 36-39 alone.

It ends with the nvidia-smi line, a JSON line of kernels and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch import probes
from petsctpu_torch.convert import sell_from_arrays
from petsctpu_torch.core.logging import log_begin, log_events
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import KSP, ksp_solve
from petsctpu_torch.ksp import api as ksp_api
from petsctpu_torch.ksp import bcgs as ksp_bcgs
from petsctpu_torch.ksp import common as ksp_common
from petsctpu_torch.ksp.cheby import (estimate_extreme_singular_arnoldi,
                                      estimate_lambda_max)
from petsctpu_torch.ksp.common import KSPConfig, to_host
from petsctpu_torch.ksp.mixed import solve_ir
from petsctpu_torch.ksp.specest import SpecEstPC
from petsctpu_torch.mat import (SellBAIJ, StencilMat, aij_from_scipy,
                                aij_to_scipy, baij_from_scipy_bsr,
                                band_from_scipy, dia_from_scipy,
                                mat_from_options, sbaij_from_scipy,
                                stencil_from_scipy, stencil_to_scipy)
from petsctpu_torch.mat.coo import ell_from_coo
from petsctpu_torch.mat.maij import MAIJ
from petsctpu_torch.mat.nest import make_nest
from petsctpu_torch.mat import stencil as stencil_module
from petsctpu_torch.mat.dense import Dense
from petsctpu_torch.mat.nullspace import make_nullspace
from petsctpu_torch.mat.factor import (SpTRSVPlan, ilu0, lu_solve,
                                       make_sptrsv_plan, stacked_sptrsv_plan)
from petsctpu_torch.mat.sell import (SellMat, sell_from_scipy, sell_pack,
                                     sell_to_scipy)
from petsctpu_torch.models import (ex2_system, ex45_system, laplacian_2d,
                                   poisson_3d)
from petsctpu_torch.models.bratu import (bratu3d_fd_jacobian,
                                         bratu3d_initial_guess,
                                         bratu3d_residual,
                                         bratu_initial_guess,
                                         bratu_jacobian_template,
                                         bratu_residual)
from petsctpu_torch.models.adr1d import (adr_initial, adr_rhs_advection,
                                         adr_rhs_reaction)
from petsctpu_torch.models.ddpoisson import matis_poisson_2d
from petsctpu_torch.models.elasticity import ex55_system
from petsctpu_torch.models.heat import (heat2d_ifunc, heat2d_initial,
                                        heat2d_jacobian_template)
from petsctpu_torch.models.q1stokes import (integrate_errors,
                                            q1q1_stokes_system,
                                            solcx_nodal_solution)
from petsctpu_torch.models.stokes import stokes_mac
from petsctpu_torch.ops import _build
from petsctpu_torch.mat import ell as ell_module
from petsctpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_plain
from petsctpu_torch.ops.ell_spmv import launch_plan as ell_plan
from petsctpu_torch.ops.gather_forms import gather_forms
from petsctpu_torch.ops.sell_pass import sell_pass, sell_pass_plain
from petsctpu_torch.ops.sell_spmv import sell_spmv, sell_spmv_plain
from petsctpu_torch.ops.sell_spmvT import (sell_spmvT, sell_spmvT_plain,
                                           sell_spmvT_plan_plain,
                                           transpose_plan)
from petsctpu_torch.ops import sptrsv as sptrsv_module
from petsctpu_torch.ops.sptrsv import (device_shape, sptrsv, sptrsv_lu,
                                       sptrsv_lu_plain, sptrsv_plain)
from petsctpu_torch.ops.stencil_mult import stencil_mult, stencil_mult_plain
from petsctpu_torch.ops.window_spmv import window_spmv, window_spmv_plain
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.asa import asa_tentatives
from petsctpu_torch.pc.extra import make_eisenstat_system
from petsctpu_torch.pc.factor import ILUPC, make_ilu
from petsctpu_torch.pc.fieldsplit import make_fieldsplit
from petsctpu_torch.pc.gamg import rigid_body_modes
from petsctpu_torch.pc.mg import make_geometric_mg_device
from petsctpu_torch.pc.gamg_device import (GAMGProbeLevelPlan, PPair,
                                           csr_data_of_matching,
                                           gamg_device_plan, gamg_probe_plan)
from petsctpu_torch.pc.simple import make_jacobi
from petsctpu_torch.pc.sor import make_sor
from petsctpu_torch.snes import (SNES, ColoredJacobian, fas_levels_from_da,
                                 snes_fas, snes_nasm, snes_ncg, snes_ngmres,
                                 snes_qn, snes_solve, snes_vinewtonrsls)
from petsctpu_torch.snes.api import SNESConfig
from petsctpu_torch.ts import (TSConfig, ts_alpha, ts_arkimex,
                               ts_characteristic, ts_gl, ts_pseudo, ts_rosw,
                               ts_solve)
from petsctpu_torch.ts import gl as ts_gl_module
from petsctpu_torch.ts import imex as ts_imex
from petsctpu_torch.ts import steppers as ts_steppers
from petsctpu_torch.timing import (FP32_FLOPS_PER_S, FP64_FLOPS_PER_S,
                                   HBM_BYTES_PER_S, graph_ms, time_ms)
from petsctpu_torch.vec.indexset import IS

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
SLICE5_ITS = 82            # CG + bjacobi(8) ILU(0)'s its at 128³
ONCE_OPTS = {"icc": {"ksp_type": "cg", "pc_type": "icc", "ksp_rtol": "1e-5",
                     "ksp_max_it": "2000"},
             "sor": {"ksp_type": "cg", "pc_type": "sor", "ksp_rtol": "1e-5",
                     "ksp_max_it": "2000"}}
# slice 6: BiCGStab with slice 5's PC at its size, and three runs beside it
SLICE6_OPTS = {"ksp_type": "bcgs", "pc_type": "bjacobi",
               "pc_bjacobi_blocks": "8", "sub_pc_type": "ilu",
               "ksp_rtol": "1e-5", "ksp_max_it": "2000"}
SLICE6_ITS = 61            # BiCGStab + bjacobi(8) ILU(0)'s its at 128³
CHEBY_ITS = 300
DGMRES_OPTS = {"ksp_type": "dgmres", "pc_type": "jacobi",
               "ksp_gmres_restart": "30", "ksp_max_it": "90"}
# the 16³ fp64 solves of every slice-6 type, card against CPU: each on
# a system and PC where its stream is not chaotic (on the CPU, the
# port's solve with its dots summed in another order, left to right,
# agrees with its own to better than 1e-10; TFQMR + Jacobi and
# DGMRES(10) + Jacobi on N differ so by 2e-8 and 1.3e-10, and differed
# on an NVIDIA H100 80GB HBM3, 700.00 W by 3.4e-9 and 2.1e-10): N is
# ex45 with +0.4 on its superdiagonal entries (nonsymmetric, ex45's
# pattern), W is N + 2·diag(A) (well conditioned) for LSQR
ILU = {"pc_type": "ilu"}
ILU_T = {"pc_type": "ilu", "pc_factor_transpose_solves": "true"}
JACOBI = {"pc_type": "jacobi"}
SLICE6_SMALL = {
    "bcgs": ("N", ILU), "cgs": ("N", ILU), "bicg": ("N", ILU_T),
    "gcr": ("N", ILU), "bcgsl": ("N", ILU), "lgmres": ("N", ILU),
    "ibcgs": ("N", ILU), "fbcgs": ("N", ILU), "fbcgsr": ("N", ILU),
    "lcd": ("N", ILU), "tcqmr": ("N", ILU), "fgmres_host": ("N", ILU),
    "cgne": ("N", ILU_T), "dgmres": ("N", {**ILU, "ksp_gmres_restart": "6"}),
    "agmres": ("N", {**ILU, "ksp_gmres_restart": "4"}),
    "tfqmr": ("N", ILU), "lsqr": ("W", JACOBI),
    "cr": ("A", JACOBI), "stcg": ("A", JACOBI), "gltr": ("A", JACOBI),
    "qcg": ("A", JACOBI), "chebyshev": ("A", JACOBI),
    "specest": ("A", JACOBI), "richardson": ("A", JACOBI),
    "pipecr": ("A", ILU), "minres": ("A", ILU), "symmlq": ("A", ILU),
    "nash": ("A", ILU), "preonly": ("A", ILU)}
# the 16³ fp64 solves held card against CPU
# slice 7: ksp ex55 (2-D Q1 elasticity) CG + GAMG at 1024² nodes
EX55_NE = 1023             # n = 2,097,152 dofs
EX55_SMALL_NE = 63         # card against CPU: n = 8,192
EX55_NC_NE = 511           # the blocked route, once: n = 524,288
REFRESH_NE = 511           # the probe refresh's ex55 system
DEVICE_PLAN_GRID = 64      # the SpGEMM refresh on ex45 at 64³
ASA_NE = 255               # -pc_type asa, card against CPU: n = 131,072
SLICE7_OPTS = {"ksp_type": "cg", "pc_type": "gamg", "pc_gamg_dof": "2",
               "pc_gamg_coarse_eq_limit": "80", "ksp_rtol": "1e-5",
               "ksp_max_it": "500"}
ASA_OPTS = {"ksp_type": "cg", "pc_type": "asa", "ksp_rtol": "1e-5",
            "ksp_max_it": "500"}
ASA_CHECK_ITS = 40         # its of the fp64 card-against-CPU ASA solve
EX55_SMALL_FP32_RTOL = 5e-4  # ne = 63 fp32 histories, card against CPU
ULP_SEEDS = 40             # one-ulp changes of b the CPU's noise is read over
REFRESH_SMALL_NE = 31      # D·A·D refresh held against petsctpu's in tests
REFRESH_SMALL_TRUE_MAX = 1.1e-3  # its fp32 true relative residual bound
REFRESH_TREND_NES = (63, 127, 255)  # the same case on the card, printed
EX43_MX = 1023            # n = 3,145,728 dofs, 2,097,152 of them velocity
EX43_SCHUR_MX = 255       # schur full card against CPU: n = 196,608
SOLCX = dict(c_str=0, eta0=1.0, eta1=1.0e6, xc=0.5, nz=2)
EX43_OPTS = {"pc_fieldsplit_type": "symmetric_multiplicative",
             "fieldsplit_0_pc_type": "gamg", "fieldsplit_0_pc_gamg_dof": "2",
             "fieldsplit_1_pc_type": "jacobi"}
EX43_GOLDEN_OPTS = {"pc_fieldsplit_type": "symmetric_multiplicative",
                    "fieldsplit_0_pc_type": "lu",
                    "fieldsplit_1_pc_type": "jacobi"}
EX43_SCHUR_OPTS = {"pc_fieldsplit_type": "schur",
                   "pc_fieldsplit_schur_fact_type": "full",
                   "fieldsplit_0_pc_type": "gamg",
                   "fieldsplit_0_pc_gamg_dof": "2",
                   "fieldsplit_1_pc_type": "jacobi"}
SCHUR_RTOL = 2e-6          # its history card against CPU; phase 27
                           # requires 30 times the CPU's own change under
                           # a 1e-15 change of b: 1.25e-8 on the chip
                           # machine's CPU with PR 12's AIJ row sums,
                           # 3.53e-8 with the slot-order fold (PR 13)
# the ex43 golden (output/ex43_1.out) and its DMDAIntegrateErrors line
EX43_GOLDEN = (
    "  0 KSP Residual norm 0.0239928 \n"
    "  1 KSP Residual norm 0.00018525 \n"
    "  2 KSP Residual norm 3.95184e-05 \n"
    "  3 KSP Residual norm 8.60318e-07 \n"
    "  4 KSP Residual norm 9.54453e-08 \n"
    "  5 KSP Residual norm 1.07793e-08 \n"
    "  6 KSP Residual norm 9.097e-10 \n"
    "  7 KSP Residual norm 2.479e-10 \n"
    "  8 KSP Residual norm 4.583e-11 \n")
EX43_GOLDEN_ERRORS = "4.7619e-02   1.2519e-03   7.1432e-05   2.3330e-03 "
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
    return (M,) + check_k2(A, M, dev, rng, mode)


def check_k2(A, M, dev, rng, label):
    """K2 on M (the pack of A) against its plain version (bit for bit)
    and against scipy: (the padded x, max |kernel - plain|)."""
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
    print(f"kernel {label}: n={A.shape[0]} m={A.shape[1]} nnz={A.nnz} "
          f"nt={M.nt} P={M.npass} G={M.G} S={M.S} Lp={M.Lp} "
          f"max|kernel-plain|={err} rel err vs scipy fp64={rel:.3e}")
    if not torch.equal(y, y_plain):
        raise AssertionError(f"K2 {label}: kernel differs from its plain "
                             f"version (max abs {err})")
    if not rel <= 1e-5:
        raise AssertionError(f"K2 {label}: relative error {rel} vs scipy")
    return xp, err


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


HAND_KERNELS = {"stencil_mult": stencil_mult, "sell_spmv": sell_spmv,
                "sell_spmvT": sell_spmvT, "sptrsv": sptrsv,
                "sptrsv_lu": sptrsv_lu, "sell_pass": sell_pass,
                "window_spmv": window_spmv, "gather_forms": gather_forms,
                "ell_spmv": ell_spmv}


def reset_counts():
    for k in HAND_KERNELS.values():
        k.launches = 0


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


def measure(A, M, xp, label=f"{GRID}^3", triad=True):
    """Times of K2, its plain version and the CSR yardstick on A (the
    128³ ex45 operator unless `label` says otherwise)."""
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
    triad = f"; STREAM triad {stream_triad_gbs():.1f} GB/s" if triad else ""
    print(f"K2 at {label}: {ms:.4f} ms in a CUDA graph "
          f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of {nbytes} compulsory "
          f"bytes, {100 * bound_bytes_ms / ms:.1f} % of the byte bound), "
          f"{call_ms:.4f} ms a call back to back; plain {plain_ms:.4f} ms; "
          f"torch.sparse CSR mv {library_ms:.4f} ms (rel diff {lib_rel:.1e}); "
          f"bound {bound_bytes_ms:.4f} ms by bytes at 3.35 TB/s "
          f"({bound_ops_ms:.5f} ms by fp32 ops){triad}")
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
                "sell_spmv": sell_spmv.launches, "sptrsv": sptrsv.launches,
                "sptrsv_lu": sptrsv_lu.launches}
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
          f"launches {launches['sptrsv']}, sptrsv_lu "
          f"{launches['sptrsv_lu']} (the coarse LU)")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+MG failed: reason {reason}, residual "
                             f"{relres}")
    if solve_launches < its:
        raise AssertionError(f"K1 launched {solve_launches} times in {its} "
                             "its")
    if launches["sptrsv_lu"] < its or launches["sptrsv"]:
        raise AssertionError(f"the coarse LU launched sptrsv_lu "
                             f"{launches['sptrsv_lu']} and sptrsv "
                             f"{launches['sptrsv']} times in {its} its")
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


def measure_k3(l, M, P_host, rng, label=f"{GAMG_GRID}^3"):
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
    print(f"K3 at {label} level {l}, P {M.shape}, {plan_name(plan)} "
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

def trsv_launches():
    """SpTRSV's launches so far: one triangle (sptrsv) and both (sptrsv_lu)."""
    return sptrsv.launches + sptrsv_lu.launches


def solve_counted(ksp, b):
    """ksp.solve(b) with the PC's applies and SpTRSV's launches counted:
    (result, seconds, PC applies, SpTRSV launches, sptrsv_lu's of them)."""
    pc = ksp.pc
    applies = [0]
    real = pc.apply

    def apply(x):
        applies[0] += 1
        return real(x)
    pc.apply = apply
    before, fused = trsv_launches(), sptrsv_lu.launches
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ksp.solve(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        del pc.apply
    return (res, secs, applies[0], trsv_launches() - before,
            sptrsv_lu.launches - fused)


def true_residual(A, b_np, res):
    x = res.x.double().cpu().numpy()
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or NaNs")
    return float(np.linalg.norm(b_np - A @ x) / np.linalg.norm(b_np))


def setup_split():
    """Seconds of the logged setup events: numerics, levels, plans (the
    segments included), the plans' (level, rank) segments."""
    ev = log_events()
    t = {k: ev[k].time if k in ev else 0.0
         for k in ("MatFactorNumeric", "MatSolveLevels", "MatSolvePlan",
                   "MatSolveSegments")}
    return (t["MatFactorNumeric"], t["MatSolveLevels"],
            t["MatSolvePlan"] - t["MatSolveLevels"], t["MatSolveSegments"])


def profile_solve(ksp, b, label="slice5", top=6):
    """The device's busy and idle shares of a repeat of the solve under
    torch.profiler, its `top` kernels by device time (with their
    launches an iteration), and SpTRSV's and K2's shares of the busy
    time."""
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
    share = {k: sum(us for name, (_, us) in per.items() if k in name)
             / max(busy, 1e-9) for k in ("sptrsv", "sell_spmv")}
    print(f"{label} profiled: wall {1e3 * wall / n:.4f} ms/it; device busy "
          f"{busy / n / 1e3:.4f} ms/it, idle share "
          f"{1 - busy / (wall * 1e6):.3f}; SpTRSV {share['sptrsv']:.3f} "
          f"and K2 {share['sell_spmv']:.3f} of the busy time")
    for name, (count, us) in sorted(per.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / n / 1e3:9.5f} ms  {count / n:5.1f}/it  {name[:80]}")


def drive_slice5_path(A, b_np, M):
    """Slice 5's path at full size: ex45 128³ on phase 4's fp32 SELL
    operator, KSP with -ksp_type cg -pc_type bjacobi -pc_bjacobi_blocks 8
    -sub_pc_type ilu (natural sub-ordering), rtol 1e-5, counting
    launches (one SpTRSV launch a PC apply, both triangles in one
    sptrsv_lu); then a repeat of the solve, timed and profiled."""
    log_begin()
    ksp = KSP(Options(dict(SLICE5_OPTS))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    numeric, levels, plans, segs = setup_split()
    pc = ksp.pc
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    res, secs, applies, launches, fused = solve_counted(ksp, b)
    its, reason = int(res.its), int(res.reason)
    relres = true_residual(A, b_np, res)
    print(f"slice5 path: bjacobi(8) ILU(0) setup {setup_s:.2f} s = factor "
          f"numerics {numeric:.2f} + levels {levels:.2f} + plan building "
          f"{plans:.2f} (the (level, rank) segments {segs:.2f}) + "
          f"subdomains and the rest "
          f"{setup_s - numeric - levels - plans:.2f} s; plans "
          f"{tuple(pc.Lplans.level_rows.shape)} L, "
          f"{tuple(pc.Uplans.level_rows.shape)} U (nb, nlev, rmax); "
          f"{shape_of(pc.Lplans, pc.Uplans)} shape for the apply")
    print(f"slice5 path: CG+bjacobi(8) ILU its={its} reason={reason} "
          f"{secs:.3f} s = {1e3 * secs / its:.4f} ms/it; true rel residual "
          f"{relres:.3e}; history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; {applies} PC applies, SpTRSV "
          f"launches {launches} ({launches / its:.2f} an iteration, "
          f"{fused} of them sptrsv_lu), K2 launches {sell_spmv.launches}")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"CG+bjacobi failed: reason {reason}, "
                             f"residual {relres}")
    if GRID == 128 and its != SLICE5_ITS:
        raise AssertionError(f"CG+bjacobi took {its} its, not {SLICE5_ITS}")
    if launches != applies or fused != applies or applies < its:
        raise AssertionError(f"SpTRSV launched {launches} times ({fused} "
                             f"sptrsv_lu) for {applies} PC applies in {its} "
                             "its")
    if sell_spmv.launches < its:
        raise AssertionError(f"K2 launched {sell_spmv.launches} times in "
                             f"{its} its")
    res2, secs2, _, _, _ = solve_counted(ksp, b)
    if int(res2.its) != its:
        raise AssertionError("the repeated solve took other its")
    print(f"slice5 CG+bjacobi(8) ILU ms per iteration at {GRID}^3: "
          f"{1e3 * secs / its:.4f} in the main path, "
          f"{1e3 * secs2 / its:.4f} repeated")
    profile_solve(ksp, b)
    return dict(ksp=ksp, b=b, per_it=launches / its)


def drive_once(A, b_np, M, name):
    """CG with -pc_type icc or sor at 128³ on the SELL operator, once."""
    log_begin()
    ksp = KSP(Options(dict(ONCE_OPTS[name]))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    numeric, levels, plans, segs = setup_split()
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    res, secs, applies, launches, _ = solve_counted(ksp, b)
    its, reason = int(res.its), int(res.reason)
    relres = true_residual(A, b_np, res)
    print(f"{name} at {GRID}^3 ({type(ksp.pc).__name__}): setup {setup_s:.2f}"
          f" s (numerics {numeric:.2f}, levels {levels:.2f}, plans "
          f"{plans:.2f}, segments {segs:.2f}); CG its={its} reason={reason} {secs:.3f} s = "
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


def shape_of(plan, upper=None):
    """The launch shape of a plan's solve on the card, or of the fused
    solve of plan (L) and upper (U)."""
    rmax = plan.rmax if upper is None else max(plan.rmax, upper.rmax)
    return device_shape(plan.nb, plan.n, rmax, plan.dtype, plan.device)


def check_sptrsv(label, plan, rng, expect=None):
    """SpTRSV against its plain version, bit for bit, on the card, in the
    shape it takes (held to `expect` where given)."""
    shape = tuple(plan.dinv.shape)
    b = torch.from_numpy(rng.standard_normal(shape)).to("cuda", plan.dtype)
    x = plan.solve(b)
    ref = sptrsv_plain(*plan.order, b.reshape(plan.nb, -1)).reshape(x.shape)
    torch.cuda.synchronize()
    err = float((x - ref).abs().max())
    held = sum(t.numel() * t.element_size() for t in (*plan.order,
                                                        plan.nlevs,
                                                        plan.lseg)
               if t is not None)
    taken = shape_of(plan)
    print(f"sptrsv {label}: {tuple(plan.level_rows.shape)} levels x rows, "
          f"K={plan.cols.shape[-1]} ({plan.order[2].shape[-1]} on the "
          f"device, {held} B), rmax {plan.rmax}, {plan.dtype}, "
          f"{taken} shape: max|kernel-plain|={err}")
    if not torch.equal(x, ref):
        raise AssertionError(f"sptrsv {label}: the kernel differs from its "
                             f"plain version by {err}")
    if expect is not None and taken != expect:
        raise AssertionError(f"sptrsv {label}: took the {taken} shape, not "
                             f"{expect}")
    return err, b


def check_sptrsv_lu(label, L, U, rng, expect=None, repeat=0):
    """The fused L+U solve (mat/factor.lu_solve, one sptrsv_lu launch)
    against its plain version, bit for bit, on the card; `repeat` more
    solves of the same b must give the same bits (the barriers between
    levels hold every time)."""
    if not L.fuses(U):
        raise AssertionError(f"sptrsv_lu {label}: the pair does not fuse "
                             f"({shape_of(L, U)} shape)")
    b = torch.from_numpy(rng.standard_normal(tuple(L.dinv.shape))).to(
        "cuda", L.dtype)
    before = sptrsv_lu.launches
    x = lu_solve(L, U, b)
    ref = sptrsv_lu_plain(L.order, U.order,
                          b.reshape(L.nb, -1)).reshape(x.shape)
    torch.cuda.synchronize()
    err = float((x - ref).abs().max())
    taken = shape_of(L, U)
    print(f"sptrsv_lu {label}: L {tuple(L.level_rows.shape)}, U "
          f"{tuple(U.level_rows.shape)} levels x rows, {L.dtype}, {taken} "
          f"shape: max|kernel-plain|={err}")
    if sptrsv_lu.launches != before + 1:
        raise AssertionError(f"sptrsv_lu {label}: not one launch")
    if not torch.equal(x, ref):
        raise AssertionError(f"sptrsv_lu {label}: the kernel differs from "
                             f"its plain version by {err}")
    differ = sum(not torch.equal(lu_solve(L, U, b), ref)
                 for _ in range(repeat))
    if repeat:
        print(f"sptrsv_lu {label}: {repeat} more solves, {differ} differ")
    if differ:
        raise AssertionError(f"sptrsv_lu {label}: {differ} of {repeat} "
                             "repeated solves differ from the plain version")
    if expect is not None and taken != expect:
        raise AssertionError(f"sptrsv_lu {label}: took the {taken} shape, "
                             f"not {expect}")
    return err


def layered(n, width, rng, deps=2):
    """A lower triangle whose level l is rows [l·width, (l+1)·width), each
    row reading `deps` random rows of the level before."""
    r = np.repeat(np.arange(width, n), deps)
    c = (r // width - 1) * width + rng.integers(0, width, r.size)
    T = sp.coo_matrix((rng.uniform(-0.5, 0.5, r.size), (r, c)),
                      shape=(n, n)).tocsr()
    return (T + sp.diags(rng.uniform(1, 2, n))).tocsr()


def mirrored(T):
    """The upper triangle P T P of a lower one (P reverses the rows)."""
    return sp.csr_matrix(T[::-1][:, ::-1])


def capacity_rows(shape, rmax, itemsize):
    """The most rows a plan of levels of rmax rows may have to take
    `shape` (block-smem or cluster-smem) on this card."""
    ranks = sptrsv_module.CLUSTER if shape == "cluster-smem" else 1
    ring = sptrsv_module.smem_bytes(shape, 0, rmax, itemsize)
    optin = sptrsv_module._smem_optin(torch.cuda.current_device())
    return ranks * ((optin - ring) // itemsize)


def edge_plans(rng):
    """SpTRSV's edge plans: {label: (plan, the shape it must take or
    None)}. A diagonal (nlev 1), a chain (1-D tridiagonal lower, n 4096,
    rmax 1) in fp64 and fp32, rows with no off-diagonals among others,
    stacked plans of unequal subdomains (identity-padded, levels padded),
    a single plan with padded levels and slots too large for shared
    memory (the grid), two-level triangles of six off-diagonals a row (K
    > 4: the slots past the fourth read after the barrier) single and
    stacked; and the capacity edges: layered plans of levels of 1,024 (2,048)
    rows at the most rows that fit one block's (a cluster's) shared
    memory and one row more, and a narrow plan too large for it (the
    block shape)."""
    cuda = "cuda"
    out = {"diagonal": (make_sptrsv_plan(
        sp.diags(rng.uniform(1, 2, 1000)).tocsr(), True, False,
        np.float64, device=cuda), None)}
    e = np.ones(4096)
    chain = sp.diags([-e[:-1], 2 * e], [-1, 0]).tocsr()
    for dt in (np.float64, np.float32):
        out[f"chain {np.dtype(dt).name}"] = (make_sptrsv_plan(
            chain, True, False, dt, device=cuda), "block-smem")
    n = 5000
    T = sp.tril(sp.random(n, n, density=3.0 / n, random_state=rng,
                          format="csr"), -1).tocsr()
    T = (sp.diags(np.where(rng.random(n) < 0.5, 0.0, 1.0)) @ T).tocsr()
    T.eliminate_zeros()
    out["half the rows without off-diagonals"] = (make_sptrsv_plan(
        (T + sp.diags(rng.uniform(1, 2, n))).tocsr(), True, False,
        np.float32, device=cuda), None)

    def unequal(A, pieces):
        size = max(m for _, m in pieces)
        subs = []
        for lo, m in pieces:
            L = ilu0(A[lo:lo + m][:, lo:lo + m])[0]
            subs.append(sp.block_diag([L, sp.csr_matrix((size - m,) * 2)])
                        .tocsr() if m < size else L)
        return stacked_sptrsv_plan(subs, True, True, np.float32,
                                   device=cuda)

    A16 = sp.csr_matrix(ex45_system(16, 16, 16)[0])
    out["stacked, unequal subdomains"] = (unequal(
        A16, ((0, 300), (300, 1000), (1300, 37))), "block-smem")
    A64 = sp.csr_matrix(ex45_system(64, 64, 64)[0])
    out["stacked, unequal subdomains, wide levels"] = (unequal(
        A64, ((0, 20000), (20000, 60000), (80000, 3000))), "cluster-smem")
    out["grid shape, padded"] = (make_sptrsv_plan(
        ilu0(A64)[1], False, False, np.float64, pad_to=(300, 3100, 5),
        device=cuda), "grid")
    # two wide levels: rows 3000-5999 each read 6 rows of 0-2999
    m = 3000
    r = np.repeat(np.arange(m, 2 * m), 6)
    c = rng.integers(0, m, r.size)
    W = (sp.coo_matrix((rng.standard_normal(r.size), (r, c)),
                       shape=(2 * m, 2 * m)).tocsr()
         + sp.diags(rng.uniform(1, 2, 2 * m))).tocsr()
    out["two wide levels, K > 4"] = (make_sptrsv_plan(
        W, True, False, np.float32, device=cuda), "cluster-smem")
    out["stacked two wide levels, K > 4"] = (stacked_sptrsv_plan(
        [W, sp.csr_matrix(W.T)[::-1][:, ::-1].tocsr()], True, False,
        np.float64, device=cuda), "cluster-smem")
    fit = capacity_rows("block-smem", 1024, 4)
    for extra, shape in ((0, "block-smem"), (1, "cluster-smem")):
        out[f"block-smem capacity {'+ 1 row' if extra else 'edge'}"] = (
            make_sptrsv_plan(layered(fit + extra, 1024, rng), True, False,
                             np.float32, device=cuda), shape)
    fit = capacity_rows("cluster-smem", 2048, 8)
    for extra, shape in ((0, "cluster-smem"), (1, "cluster")):
        out[f"cluster-smem capacity {'+ 1 row' if extra else 'edge'}, "
            "stacked"] = (stacked_sptrsv_plan(
                [layered(fit + extra, 2048, rng)] * 2, True, False,
                np.float64, device=cuda), shape)
    out["narrow levels, x past the shared memory"] = (make_sptrsv_plan(
        layered(1 << 19, 512, rng), True, False, np.float32, device=cuda),
        "block")
    return out


def edge_pairs(rng):
    """Fused L+U edge pairs: {label: (L, U, the shape)} at the block-smem
    and cluster-smem capacity edges (the U of mirrored levels)."""
    cuda = "cuda"
    out = {}
    fit = capacity_rows("block-smem", 1024, 4)
    out["block-smem capacity edge"] = (
        make_sptrsv_plan(layered(fit, 1024, rng), True, False, np.float32,
                         device=cuda),
        make_sptrsv_plan(mirrored(layered(fit, 512, rng)), False, False,
                         np.float32, device=cuda), "block-smem")
    fit = capacity_rows("cluster-smem", 2048, 8)
    out["cluster-smem capacity edge, stacked unequal"] = (
        stacked_sptrsv_plan([layered(fit, 2048, rng),
                             layered(fit, 1024, rng)], True, False,
                            np.float64, device=cuda),
        stacked_sptrsv_plan([mirrored(layered(fit, 512, rng))] * 2, False,
                            False, np.float64, device=cuda),
        "cluster-smem")
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


def sptrsv_bound(plans, triad_gbs, level_us):
    """(bound ms, bound_by, its term, bytes, every term) of solving the
    plans one after the other in one launch (one plan: sptrsv; L and U:
    sptrsv_lu): the larger of the plans' live bytes (each row's index,
    its live cols and vals and 1/diag, each plan's level starts; b read
    and x written once) over the measured STREAM triad, and their levels
    (nlev_L + nlev_U) as dependent rounds of `level_us` each (a level's
    x gather, store and barrier, timed on a chain plan). The flops (2 a
    live slot and 2 a row) at their type's peak count too, far below
    both. bound_by is "bytes" for the first term, "operations" for the
    others."""
    first = plans[0]
    es, rows = first.vals.itemsize, first.nb * first.n
    nbytes, flops, nlev = 2 * rows * es, 0, 0
    for plan in plans:
        n = plan.n
        live = int((plan.cols.reshape(plan.nb, n + 1, -1)[:, :n] != n).sum())
        nbytes += rows * (4 + es) + live * (4 + es) \
            + 4 * plan.order[0].numel()
        flops += 2 * live + 2 * rows
        nlev += int(plan.nlevs.max())
    peak = FP32_FLOPS_PER_S if first.dtype == torch.float32 \
        else FP64_FLOPS_PER_S
    terms = {"bytes at the STREAM triad": nbytes / (triad_gbs * 1e9) * 1e3,
             f"{nlev} dependent levels": nlev * level_us * 1e-3,
             "flops at peak": flops / peak * 1e3}
    term = max(terms, key=terms.get)
    return (terms[term], "bytes" if term.startswith("bytes")
            else "operations", term, nbytes, terms)


def bound_text(bound_ms, term, nbytes, terms, device_ms):
    return (f"bound {bound_ms:.4f} ms by {term}, "
            f"{100 * bound_ms / device_ms:.1f} % of the device time ("
            + "; ".join(f"{k} {v:.4f} ms" for k, v in terms.items())
            + f"; {nbytes} B live)")


def measure_sptrsv(label, plan, upper, triad_gbs, level_us, rng):
    """A triangle's times: a call back to back, 20 solves replayed from a
    CUDA graph, the plain version, the library call; its shape and its
    bound with a dependent round of `level_us` (chain_rounds)."""
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
        [plan], triad_gbs, level_us)
    nlev = int(plan.nlevs.max())
    lib_text = (f"{library_ms:.4f} ms" if library_ms is not None
                else f"none ({why})")
    print(f"sptrsv at {label} ({shape_of(plan)} shape): {device_ms:.4f} ms "
          f"in a CUDA graph ({1e3 * device_ms / nlev:.3f} us a level, "
          f"{nlev} levels), {call_ms:.4f} ms a call back to back; plain "
          f"{plain_ms:.4f} ms; torch.triangular_solve on CSR {lib_text}; "
          + bound_text(bound_ms, term, nbytes, terms, device_ms))
    return dict(ms=call_ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_term=term, shape=shape_of(plan))


def measure_sptrsv_lu(label, L, U, triad_gbs, level_us, rng):
    """A fused apply's times (lu_solve: one sptrsv_lu launch) beside the
    same two triangles as two sptrsv launches, in one call: a call back
    to back, 20 replayed from a CUDA graph, the plain version, cuSPARSE's
    two triangular solves (no one PyTorch call does both: library_ms is
    null); its shape and bounds."""
    b = torch.from_numpy(rng.standard_normal(tuple(L.dinv.shape))).to(
        "cuda", L.dtype)
    fused = (lambda: lu_solve(L, U, b))
    apart = (lambda: U.solve(L.solve(b)))
    call_ms = time_ms(fused, runs=20, inner=5)
    device_ms = graph_ms(fused)
    apart_ms = graph_ms(apart)
    device_ms2 = graph_ms(fused)
    lead = (L.order, U.order, b.reshape(L.nb, -1))
    plain_ms = time_ms(lambda: sptrsv_lu_plain(*lead), runs=3, inner=1,
                       warmup=1)
    libs = [library_trsv(p, up) for p, up in ((L, False), (U, True))]
    if all(f is not None for f, _ in libs):
        two = (lambda: [f() for f, _ in libs])
        lib_text = f"{time_ms(two, runs=5, inner=1, warmup=1):.4f} ms"
    else:
        lib_text = "none (" + "; ".join(w for _, w in libs if w) + ")"
    bound_ms, bound_by, term, nbytes, terms = sptrsv_bound(
        [L, U], triad_gbs, level_us)
    nlev = int(L.nlevs.max()) + int(U.nlevs.max())
    print(f"sptrsv_lu at {label} ({shape_of(L, U)} shape): {device_ms:.4f} "
          f"/ {device_ms2:.4f} ms in a CUDA graph "
          f"({1e3 * device_ms / nlev:.3f} us a level, {nlev} levels), as "
          f"two sptrsv launches "
          f"{apart_ms:.4f} ms; {call_ms:.4f} ms a call back to back; plain "
          f"{plain_ms:.4f} ms; cuSPARSE's two triangular solves {lib_text}; "
          + bound_text(bound_ms, term, nbytes, terms, device_ms))
    return dict(ms=call_ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bound_term=term, shape=shape_of(L, U),
                two_launches_ms=apart_ms)


def chain_rounds(chain):
    """One dependent round (µs) of the fp64 chain plan in the shape it
    takes (block-smem) and in the block shape with x in global memory
    (reached by reporting no shared memory; PR 8's round), and the
    fastest of them, the round the bound takes: the least a dependent
    level has been seen to cost on this card."""
    b = torch.ones(chain.n, dtype=torch.float64, device="cuda")
    rounds = {shape_of(chain):
              1e3 * graph_ms(lambda: chain.solve(b)) / chain.nlev}
    real = sptrsv_module._smem_optin
    sptrsv_module._smem_optin = lambda index: 0
    try:
        rounds[shape_of(chain)] = \
            1e3 * graph_ms(lambda: chain.solve(b)) / chain.nlev
    finally:
        sptrsv_module._smem_optin = real
    fastest = min(rounds, key=rounds.get)
    print(f"sptrsv chain (n {chain.n}, rmax 1, fp64), a dependent level: "
          + ", ".join(f"{us:.3f} us in the {k} shape"
                      for k, us in rounds.items())
          + f"; the bound takes the {fastest} shape's {rounds[fastest]:.3f}"
          " us")
    return rounds[fastest]


def as_fp64(plan):
    """A plan's fp64 copy (the same levels and slots)."""
    return SpTRSVPlan(plan.level_rows, plan.cols, plan.vals.astype(np.float64),
                      plan.dinv.astype(np.float64), plan.n, plan.nlev,
                      device="cuda")


def slice5_phases(A, b_np, M, triad_gbs, rng):
    """Slice 5 on phase 4's 128³ operator: the counted CG+bjacobi(8)
    path, CG+icc and CG+sor once (their SpTRSV launches counted from
    just before the first to just after the last), the 16³ card-vs-CPU
    solves, SpTRSV and the fused L+U solve against their plain versions
    on every plan of phase 16 (slice 2's coarse LU plans are checked in
    mg_sptrsv_check), and the times of each 128³ triangle and of a fused
    apply. Returns the kernels line's entries for sptrsv and sptrsv_lu."""
    reset_counts()
    path = drive_slice5_path(A, b_np, M)
    icc = drive_once(A, b_np, M, "icc")
    sor = drive_once(A, b_np, M, "sor")
    launches = {"sptrsv": sptrsv.launches, "sptrsv_lu": sptrsv_lu.launches}
    print(f"slice5 path (bjacobi, icc, sor): sptrsv launches "
          f"{launches['sptrsv']}, sptrsv_lu {launches['sptrsv_lu']}")
    if not all(launches.values()):
        raise AssertionError(f"a SpTRSV kernel was not launched: {launches}")
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
    # the shapes the 128³ plans take on an H100
    expect = {"bjacobi(8) ILU L": "cluster-smem",
              "bjacobi(8) ILU U": "cluster-smem",
              "bjacobi(8) ILU L in fp64": "cluster",
              "ICC L (one subdomain)": "grid",
              "SSOR forward": "grid"} if GRID == 128 else {}
    errs = [check_sptrsv(f"{GRID}^3 {k}", p, rng, expect.get(k))[0]
            for k, (p, _) in plans.items()]
    errs.append(check_sptrsv(f"{GRID}^3 bjacobi(8) ILU L in fp64",
                             as_fp64(pc.Lplans), rng,
                             expect.get("bjacobi(8) ILU L in fp64"))[0])
    edges = edge_plans(rng)
    errs += [check_sptrsv(f"edge: {k}", p, rng, shape)[0]
             for k, (p, shape) in edges.items()]
    lu_errs = [check_sptrsv_lu(f"{GRID}^3 bjacobi(8) ILU", pc.Lplans,
                               pc.Uplans, rng, expect.get("bjacobi(8) ILU L"),
                               repeat=50)]
    lu_errs += [check_sptrsv_lu(f"edge: {k}", L, U, rng, shape, repeat=20)
                for k, (L, U, shape) in edge_pairs(rng).items()]
    del edges
    level_us = chain_rounds(make_sptrsv_plan(
        sp.diags([-np.ones(4095), 2 * np.ones(4096)], [-1, 0]).tocsr(), True,
        False, np.float64, device="cuda"))
    times = {k: measure_sptrsv(f"{GRID}^3 {k}", p, up, triad_gbs,
                               level_us, rng)
             for k, (p, up) in plans.items() if "omega" not in k}
    lu_times = measure_sptrsv_lu(f"{GRID}^3 bjacobi(8) ILU", pc.Lplans,
                                 pc.Uplans, triad_gbs, level_us, rng)
    source = dict(route="cuda", source="petsctpu_torch/csrc/sptrsv.cu")
    return (dict(name="sptrsv", **source,
                 replaces="petsctpu/mat/factor.py:368",
                 launches=launches["sptrsv"], max_abs_err=max(errs),
                 **times["bjacobi(8) ILU L"]),
            dict(name="sptrsv_lu", **source,
                 replaces="petsctpu/pc/asm.py:70",
                 launches=launches["sptrsv_lu"], max_abs_err=max(lu_errs),
                 **lu_times))


def mg_sptrsv_check(mg, rng):
    """Slice 2's coarse LU plans (fp64) through SpTRSV and the fused
    solve, bit for bit, and an MG apply's host time."""
    pc = mg["ksp"].pc
    err = max(check_sptrsv(f"slice 2 coarse LU {k}", p, rng)[0]
              for k, p in (("L", pc.coarse.Lplan), ("U", pc.coarse.Uplan)))
    lu_err = check_sptrsv_lu("slice 2 coarse LU", pc.coarse.Lplan,
                             pc.coarse.Uplan, rng, "block-smem")
    print(f"slice 2: an MG apply {_wall_ms(lambda: pc.apply(mg['b'])):.4f} "
          "ms (host clock, the coarse LU through one sptrsv_lu launch)")
    return err, lu_err


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


@contextlib.contextmanager
def counted_host_copies():
    """Counts the KSP loop's copies to the host (ksp.common.to_host, as
    the BiCGStab loop and its start call it) while inside."""
    calls = [0]
    real = ksp_common.to_host

    def counted(*vals):
        calls[0] += 1
        return real(*vals)

    for mod in (ksp_common, ksp_bcgs):
        mod.to_host = counted
    try:
        yield calls
    finally:
        for mod in (ksp_common, ksp_bcgs):
            mod.to_host = real


def drive_slice6_path(A, b_np, M):
    """Slice 6's path at full size: ex45 128³ on phase 4's fp32 SELL
    operator, KSP with -ksp_type bcgs -pc_type bjacobi -pc_bjacobi_blocks
    8 -sub_pc_type ilu, rtol 1e-5, K2's and SpTRSV's launches and the
    loop's host copies counted from just before the solve to just after
    it; then a repeat of the solve, timed and profiled."""
    log_begin()
    ksp = KSP(Options(dict(SLICE6_OPTS))).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    reset_counts()
    with counted_host_copies() as copies:
        res, secs, applies, _, _ = solve_counted(ksp, b)
    k2, lu, single = sell_spmv.launches, sptrsv_lu.launches, sptrsv.launches
    its, reason = int(res.its), int(res.reason)
    relres = true_residual(A, b_np, res)
    print(f"slice6 path: BiCGStab+bjacobi(8) ILU setup {setup_s:.2f} s; "
          f"its={its} reason={reason} {secs:.3f} s = "
          f"{1e3 * secs / its:.4f} ms/it; true rel residual {relres:.3e}; "
          f"history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; {applies} PC applies; K2 "
          f"launches {k2} ({k2 / its:.2f} an iteration), sptrsv_lu {lu}, "
          f"sptrsv {single}; host copies {copies[0]} (one for the initial "
          "norm, then one an iteration)")
    if reason <= 0 or not relres <= 1e-4:
        raise AssertionError(f"BiCGStab+bjacobi failed: reason {reason}, "
                             f"residual {relres}")
    if GRID == 128 and SLICE6_ITS is not None and its != SLICE6_ITS:
        raise AssertionError(f"BiCGStab+bjacobi took {its} its, not "
                             f"{SLICE6_ITS}")
    if k2 != 2 * its:
        raise AssertionError(f"K2 launched {k2} times in {its} its, not 2 "
                             "an iteration")
    if lu != 2 * its + 1 or applies != lu or single:
        raise AssertionError(f"sptrsv_lu launched {lu} times (sptrsv "
                             f"{single}) for {applies} PC applies in {its} "
                             "its, not 2·its + 1")
    if copies[0] != its + 1:
        raise AssertionError(f"{copies[0]} host copies in {its} its")
    res2, secs2, _, _, _ = solve_counted(ksp, b)
    if int(res2.its) != its:
        raise AssertionError("the repeated solve took other its")
    print(f"slice6 BiCGStab+bjacobi(8) ILU ms per iteration at {GRID}^3: "
          f"{1e3 * secs / its:.4f} in the path, {1e3 * secs2 / its:.4f} "
          "repeated")
    profile_solve(ksp, b, "slice6")
    return dict(pc=ksp.pc, k2=k2, sptrsv_lu=lu)


def slice6_small_systems(g=16):
    """The 16³ systems of phase 19: ex45 (SPD), N = ex45 with +0.4 on
    its superdiagonal entries (nonsymmetric, ex45's pattern), W = N +
    2·diag(ex45) (well conditioned)."""
    A, _, _ = ex45_system(g, g, g)
    N = (A + sp.diags(0.4 * (A.diagonal(1) != 0), 1)).tocsr()
    W = (N + sp.diags(2 * A.diagonal())).tocsr()
    return {"A": A, "N": N, "W": W}


def history_diff(card, cpu, rtol):
    """Max relative difference of two solves' histories (atol
    rtol·1e-3·‖r0‖ for entries at rounding noise); inf unless their
    its, reasons and recorded entries are the same."""
    hc, hh = card.history.numpy(), cpu.history.numpy()
    live = ~np.isnan(hh)
    if ((int(card.its), int(card.reason)) != (int(cpu.its), int(cpu.reason))
            or not np.array_equal(live, ~np.isnan(hc))):
        return float("inf")
    if not live.any():                   # preonly records no history
        return 0.0
    a, c = hc[live], hh[live]
    return float(np.max(np.abs(a - c) / (np.abs(c) + 1e-3 * rtol
                                          * abs(c[0]))))


def same_solve(label, card, cpu, rtol=1e-10, size="16^3"):
    """Card against CPU: equal its and reason, the history within rtol
    (history_diff)."""
    ci, cr = int(card.its), int(card.reason)
    hi, hr = int(cpu.its), int(cpu.reason)
    diff = history_diff(card, cpu, rtol)
    xd = float(np.abs(card.x.cpu().numpy() - cpu.x.numpy()).max())
    print(f"{size} {label} card vs cpu: its {ci}/{hi} reason {cr}/{hr} "
          f"history rel diff {diff:.2e} max|x diff| {xd:.2e}")
    if not diff <= rtol or not np.isfinite(card.x.cpu().numpy()).all():
        raise AssertionError(f"{size} {label} on the card disagrees with "
                             "the CPU")
    return diff


def check_slice6_small_against_cpu(devices=("cuda", "cpu")):
    """Every type of slice 6 at 16³ in fp64 on AIJ, on the card and on
    the CPU through the port, rtol 1e-6 (SLICE6_SMALL), then SpecEstPC
    with fgmres (routed to fgmres_host), CG with a null space on the
    Neumann Laplacian, a Fischer-guess sequence and complex128
    BiCGStab: equal its and reason, histories within 1e-10 relative."""
    systems = slice6_small_systems()
    worst = 0.0
    for name, (key, pc_opts) in SLICE6_SMALL.items():
        M = systems[key]
        b = M @ np.ones(M.shape[0])
        out = [KSP(Options({"ksp_type": name, "ksp_rtol": "1e-6",
                            "ksp_max_it": "600", **pc_opts}))
               .set_operators(aij_from_scipy(M, device=dev), M)
               .solve(torch.from_numpy(b).to(dev)) for dev in devices]
        worst = max(worst, same_solve(f"{name} on {key}", *out))
    A = systems["A"]
    b = A @ np.ones(A.shape[0])
    out = []
    for dev in devices:
        T = aij_from_scipy(A, device=dev)
        # 10 estimation steps: with the default 5, 1.1·σmax falls below
        # λmax(M⁻¹A) and the cheap Chebyshev amplifies the top modes
        out.append(ksp_solve(T, torch.from_numpy(b).to(dev),
                             pc=SpecEstPC(T, make_jacobi(T), est_maxits=10),
                             ksp_type="fgmres", rtol=1e-6, maxits=200))
    worst = max(worst, same_solve("SpecEstPC + fgmres_host", *out))
    n1 = 16
    d = 2.0 * np.ones(n1)
    d[0] = d[-1] = 1.0
    L1 = sp.diags([-np.ones(n1 - 1), d, -np.ones(n1 - 1)], [-1, 0, 1])
    I1 = sp.eye(n1)
    L = (sp.kron(sp.kron(L1, I1), I1) + sp.kron(sp.kron(I1, L1), I1)
         + sp.kron(sp.kron(I1, I1), L1)).tocsr()
    bn = np.random.default_rng(6).standard_normal(L.shape[0])
    bn -= bn.mean()
    out = [ksp_solve(aij_from_scipy(L, device=dev),
                     torch.from_numpy(bn).to(dev), ksp_type="cg",
                     rtol=1e-6, maxits=500,
                     nullspace=make_nullspace(L.shape[0], device=dev))
           for dev in devices]
    worst = max(worst, same_solve("CG + null space (Neumann)", *out))
    xs = np.linspace(0, 1, A.shape[0])
    ksps = []
    for dev in devices:
        ksp = KSP(Options({"ksp_type": "cg", "ksp_rtol": "1e-14",
                           "ksp_atol": "1e-6", "pc_type": "jacobi"}))
        ksp.set_operators(aij_from_scipy(A, device=dev), A)
        ksps.append(ksp.set_use_fischer_guess(model=1, size=4))
    for k in range(3):
        bk = np.sin(2 * np.pi * (xs + 0.05 * k)) + 0.5
        out = [ksp.solve(torch.from_numpy(bk).to(dev))
               for ksp, dev in zip(ksps, devices)]
        # the guess solves the normal equations of nearly dependent
        # stored solutions (regularized at 1e-12)
        worst = max(worst, same_solve(f"Fischer guess, solve {k}", *out,
                                      rtol=1e-7))
    # complex: W phase-rotated + 0.2i·I (on the rotated ex45 itself the
    # unpreconditioned stream is chaotic: another dot order moves it by
    # 0.6)
    rng = np.random.default_rng(7)
    ph = sp.diags(np.exp(1j * rng.uniform(0, 2 * np.pi, A.shape[0])))
    C = (ph.getH() @ systems["W"].astype(np.complex128) @ ph
         + 0.2j * sp.eye(A.shape[0])).tocsr()
    bc = C @ (rng.standard_normal(C.shape[0])
              + 1j * rng.standard_normal(C.shape[0]))
    out = [ksp_solve(aij_from_scipy(C, dtype=np.complex128, device=dev),
                     torch.from_numpy(bc).to(dev), ksp_type="bcgs",
                     rtol=1e-6, maxits=500) for dev in devices]
    worst = max(worst, same_solve("complex128 BiCGStab", *out))
    print(f"slice6 16^3 card vs cpu: {len(SLICE6_SMALL) + 6} solves, "
          f"worst history rel diff {worst:.2e}")


def slice6_full_width_runs(A, b_np, M, pc):
    """Three runs beside BiCGStab at 128³: Chebyshev + Jacobi on the
    SELL operator (the default power-iteration bounds, and bounds from
    the 10-step Arnoldi estimator for 300 iterations), DGMRES(30) +
    Jacobi for three cycles with its basis on the card, and
    mixed-precision refinement (fp64 AIJ residuals, CG + bjacobi(8) ILU
    fp32 inner solves on the SELL operator) to 1e-10."""
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    jac = make_jacobi(M)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    lam = float(estimate_lambda_max(M, jac, M.shape[0], torch.float32,
                                    device=b.device))
    res, secs = timed(lambda: ksp_solve(M, b, pc=jac, ksp_type="chebyshev",
                                        maxits=CHEBY_ITS))
    its = int(res.its)
    print(f"slice6 chebyshev+jacobi at {GRID}^3, power-iteration bounds "
          f"(0.1, 1.1)·{lam:.6f}: its={its} reason={int(res.reason)} "
          f"{1e3 * secs / its:.4f} ms/it; history "
          f"{float(res.history[0]):.6e} -> {float(res.history[its - 1]):.6e}")
    if its < 1 or not np.isfinite(res.history[:its].numpy()).all():
        raise AssertionError("Chebyshev with the power-iteration bounds "
                             "gave no finite history")
    (smin, smax), est_s = timed(lambda: estimate_extreme_singular_arnoldi(
        M, jac, b, 10))
    res, secs = timed(lambda: ksp_solve(M, b, pc=jac, ksp_type="chebyshev",
                                        maxits=CHEBY_ITS,
                                        cheby_emin=0.9 * smin,
                                        cheby_emax=1.1 * smax))
    its, hist = int(res.its), res.history.numpy()
    relres = true_residual(A, b_np, res)
    print(f"slice6 chebyshev+jacobi at {GRID}^3, Arnoldi bounds "
          f"0.9·{smin:.6f}, 1.1·{smax:.6f} ({est_s:.3f} s): its={its} "
          f"reason={int(res.reason)} {1e3 * secs / its:.4f} ms/it; history "
          f"{hist[0]:.6e} -> {hist[its - 1]:.6e}; true rel residual "
          f"{relres:.3e}")
    if not (np.isfinite(hist[:its]).all() and hist[its - 1] < hist[0]):
        raise AssertionError("Chebyshev with the Arnoldi bounds did not "
                             "reduce the residual")
    ksp = KSP(Options(dict(DGMRES_OPTS))).set_operators(M)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, secs = timed(lambda: ksp.solve(b))
    peak = torch.cuda.max_memory_allocated() - base
    its, hist = int(res.its), res.history.numpy()
    cycles = -(-its // 30)
    ends = hist[~np.isnan(hist)]
    print(f"slice6 dgmres(30)+jacobi at {GRID}^3: its={its} reason="
          f"{int(res.reason)} {cycles} cycles, {secs / cycles:.4f} s a cycle;"
          f" true residual at the cycle ends {np.array2string(ends, precision=6)}"
          f"; {peak / 2**20:.1f} MiB on the card above the start (V is "
          f"{31 * M.shape[0] * 4 / 2**20:.1f} MiB)")
    if GRID == 128 and cycles != 3:
        raise AssertionError(f"DGMRES ran {cycles} cycles, not 3")
    if not (np.isfinite(ends).all() and ends[-1] < ends[0]):
        raise AssertionError("DGMRES did not reduce the residual")
    if peak < 31 * M.shape[0] * 4:
        raise AssertionError("DGMRES's basis was not on the card")
    A64 = aij_from_scipy(A, device=b.device)
    b64 = torch.from_numpy(b_np).to(b.device)
    res, secs = timed(lambda: solve_ir(
        A64, M, b64, pc32=pc, cfg=KSPConfig(rtol=1e-10),
        inner_cfg=KSPConfig(ksp_type="cg", rtol=1e-5, maxits=2000)))
    hist = res.history.numpy()
    sweeps = int(np.count_nonzero(~np.isnan(hist))) - 1
    relres = true_residual(A, b_np, res)
    print(f"slice6 solve_ir at {GRID}^3 (fp64 AIJ residuals, CG+bjacobi(8) "
          f"ILU fp32 inner solves on SELL): reason={int(res.reason)} "
          f"{sweeps} sweeps, {int(res.its)} inner its, {secs:.3f} s; "
          f"residual by sweep {np.array2string(hist[:sweeps + 1], precision=6)}"
          f"; fp64 true rel residual {relres:.3e}")
    if int(res.reason) <= 0 or not relres <= 1e-10:
        raise AssertionError(f"solve_ir failed: reason {int(res.reason)}, "
                             f"residual {relres}")


def slice6_phases(A, b_np, M):
    """Slice 6 on phase 4's 128³ operator: the counted BiCGStab path
    (phase 18), every type at 16³ card against CPU (phase 19), and the
    Chebyshev, DGMRES and refinement runs at full width (phase 20).
    Returns the path's K2 and sptrsv_lu launches."""
    path = drive_slice6_path(A, b_np, M)
    check_slice6_small_against_cpu()
    slice6_full_width_runs(A, b_np, M, path["pc"])
    return path["k2"], path["sptrsv_lu"]

# ---------------------------------------------------------------- slice 7

@contextlib.contextmanager
def reads_from_device():
    """Count the tensor methods that read a device value on the host
    (each a synchronising copy on the card) inside the context."""
    names = ("cpu", "item", "tolist", "__bool__", "__float__", "__int__")
    count = [0]
    real = {n: getattr(torch.Tensor, n) for n in names}

    def spy(n):
        def f(self, *a, **k):
            count[0] += 1
            return real[n](self, *a, **k)
        return f

    for n in names:
        setattr(torch.Tensor, n, spy(n))
    try:
        yield count
    finally:
        for n in names:
            setattr(torch.Tensor, n, real[n])


def slice7_options(route, coords):
    o = dict(SLICE7_OPTS)
    if route == "rbm":
        o["pc_gamg_coordinates"] = coords
    return Options(o)


def slice7_split():
    ev = log_events()
    return {k: ev[k].time if k in ev else 0.0
            for k in ("PCGAMGHierarchy", "PCMGPack", "PCMGTransfer",
                      "PCMGLevelOps", "PCMGTransposePlan", "PCMGSmoother",
                      "PCMGCoarseLU")}


def spy_restrictions(pc):
    """Count each level's P.multT calls (one K3 launch each) by wrapping
    the level's prolongator; returns the counter and an undo."""
    calls = collections.Counter()
    wrapped = []
    for l, (lev, fmt) in enumerate(zip(pc.levels, pc.formats)):
        if fmt[2] is None:
            real = lev.P.multT

            def spy(r, l=l, real=real):
                calls[l] += 1
                return real(r)
            lev.P.multT = spy
            wrapped.append(lev.P)

    def undo():
        for P in wrapped:
            del P.multT
    return calls, undo


def drive_slice7_path(A, b_np, coords, route, ne=EX55_NE):
    """KSP ex55 -pc_type gamg at ne (EX55_NE) on the fp32 SELL operator
    (natural order), route "rbm" (pc_gamg_coordinates) or "nc"
    (pc_gamg_dof 2 alone), counting launches from just before the
    operator is built to just after the solve."""
    reset_counts()
    log_begin()
    t = time.perf_counter()
    M, perm = mat_from_options(A, Options({"mat_type": "sell",
                                           "mat_ordering_type": "natural"}),
                               dtype=torch.float32)
    op_s = time.perf_counter() - t
    if not np.array_equal(perm, np.arange(A.shape[0])):
        raise AssertionError("natural ordering gave a permutation")
    ksp = KSP(slice7_options(route, coords)).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    sp_ = slice7_split()
    pc = ksp.pc
    print(f"slice 7 {route}: ex55 ne={ne} n={A.shape[0]} nnz={A.nnz}; "
          f"mat_from_options {op_s:.2f} s ({type(M).__name__}"
          f"{' G=%d S=%d P=%d' % (M.G, M.S, M.npass) if hasattr(M, 'G') else ''}"
          f"); GAMG setup {setup_s:.2f} s = hierarchy "
          f"{sp_['PCGAMGHierarchy']:.2f} + level operators and transfers "
          f"(host packing and transfer) {sp_['PCMGLevelOps']:.2f} (K3's "
          f"transpose plans {sp_['PCMGTransposePlan']:.3f} of it) + "
          f"Chebyshev bounds {sp_['PCMGSmoother']:.2f} + coarse LU "
          f"{sp_['PCMGCoarseLU']:.2f} + packed branch {sp_['PCMGPack']:.2f}"
          f" / {sp_['PCMGTransfer']:.2f} s")
    for l, (lev, fmt) in enumerate(zip(pc.levels, pc.formats)):
        print(f"  level {l}: A {lev.A.shape} {fmt[0]}, P {lev.P.shape} "
              f"{fmt[1]}, R {fmt[2] or 'P.multT (K3)'}")
    print(f"  coarse: {pc.coarse_A.shape[0]} rows, "
          f"{type(pc.coarse).__name__}")
    via_k3 = [l for l, f in enumerate(pc.formats) if f[2] is None]
    bt = torch.from_numpy(b_np.astype(np.float32)).cuda()
    k2_0, k3_0, lu_0 = sell_spmv.launches, sell_spmvT.launches, \
        trsv_launches()
    calls, undo = spy_restrictions(pc)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = ksp.solve(bt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        undo()
    its, reason = int(res.its), int(res.reason)
    k2, k3 = sell_spmv.launches - k2_0, sell_spmvT.launches - k3_0
    lu = trsv_launches() - lu_0
    relres = true_residual(A, b_np, res)
    print(f"slice 7 {route}: CG+GAMG its={its} reason={reason} {secs:.3f} s"
          f" = {1e3 * secs / its:.4f} ms/it; true rel residual "
          f"{relres:.3e}; history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; in the solve K2 {k2}, K3 {k3} "
          f"(P.multT calls by level {dict(sorted(calls.items()))}), SpTRSV "
          f"{lu} launches; in the path K2 {sell_spmv.launches}, K3 "
          f"{sell_spmvT.launches}")
    if reason <= 0:
        raise AssertionError(f"slice 7 {route}: CG+GAMG reason {reason}")
    if k3 != sum(calls.values()) or any(calls[l] < its for l in via_k3):
        raise AssertionError(f"slice 7 {route}: K3 launched {k3} times, "
                             f"P.multT by level {dict(calls)}, {its} its")
    return dict(ksp=ksp, b=bt, M=M, ms_per_it=1e3 * secs / its, its=its,
                k2=sell_spmv.launches, k3=sell_spmvT.launches,
                lu=sptrsv_lu.launches, via_k3=via_k3)


def ulp_changed(b, seed):
    """b with each entry moved one ulp up or down, by a seeded coin."""
    down = np.random.default_rng(seed).random(b.size) < 0.5
    return np.nextafter(b, np.where(down, -np.inf, np.inf).astype(b.dtype))


def check_slice7_small_against_cpu(devices=("cuda", "cpu")):
    """Both GAMG elasticity routes at ne = EX55_SMALL_NE on the card
    against the port's CPU path, equal its and reason: fp32 on SELL (the
    path's formats) for b and four one-ulp changes of b, histories
    within EX55_SMALL_FP32_RTOL; fp64 on AIJ within 1e-8. First the CPU
    alone reads the fp32 histories' rounding noise: how far one-ulp
    changes of b (ULP_SEEDS of them) move its history."""
    A, b, coords = ex55_system(EX55_SMALL_NE, 1e-3)
    size = f"ne={EX55_SMALL_NE}"
    worst = {}
    for prec, rtol in (("fp32", EX55_SMALL_FP32_RTOL), ("fp64", 1e-8)):
        bb = b.astype(np.float32 if prec == "fp32" else np.float64)
        for route in ("rbm", "nc"):
            ksps = {dev: KSP(slice7_options(route, coords)).set_operators(
                sell_from_scipy(A.astype(np.float32), device=dev)
                if prec == "fp32" else aij_from_scipy(A, device=dev), A)
                for dev in devices}
            cases = [("b", bb)]
            if prec == "fp32":
                cpu = ksps[devices[-1]]
                base = cpu.solve(torch.from_numpy(bb))
                noise = max(history_diff(cpu.solve(torch.from_numpy(
                    ulp_changed(bb, s))), base, rtol)
                    for s in range(ULP_SEEDS))
                print(f"{size} ex55 {route} CG+GAMG fp32 on the CPU: one-ulp "
                      f"changes of b move the history by up to {noise:.2e} "
                      f"({ULP_SEEDS} such b)")
                cases += [(f"b one ulp off (seed {s})", ulp_changed(bb, s))
                          for s in range(4)]
            for name, rhs in cases:
                out = [ksps[dev].solve(torch.from_numpy(rhs).to(dev))
                       for dev in devices]
                worst[prec, route] = max(worst.get((prec, route), 0.0),
                                         same_solve(
                    f"ex55 {route} CG+GAMG {prec}, {name}", *out, rtol,
                    size=size))
    return worst


def scaled_refresh_cg(ne, dev):
    """CG to rtol 1e-5 on D·A·D (d from seed 0) of ksp ex55 at ne,
    preconditioned by its probe refresh (asa_tentatives P0s) on dev, on
    SELL on the card and AIJ on the CPU: (its, reason, true relative
    residual)."""
    A, b, coords = ex55_system(ne, 1e-3)
    p0s = asa_tentatives(A, rigid_body_modes(coords, dof=2), coarse_n=80,
                         bs=2)
    A2 = scaled(A, np.random.default_rng(0))
    pc = gamg_probe_plan(A.astype(np.float32), p0s=p0s, coarse_n=80,
                         dtype=np.float32, device=dev).refresh(
        torch.from_numpy(csr_data_of_matching(A2)).to(dev))
    M = (sell_from_scipy(A2, device=dev) if dev == "cuda"
         else aij_from_scipy(A2, dtype=np.float32, device=dev))
    res = ksp_solve(M, torch.from_numpy(b.astype(np.float32)).to(dev),
                    pc=pc, ksp_type="cg", rtol=1e-5, maxits=2000)
    return int(res.its), int(res.reason), true_residual(A2, b, res)


def check_scaled_refresh_small(devices=("cuda", "cpu")):
    """scaled_refresh_cg at ne = REFRESH_SMALL_NE, the case that
    tests/test_torch_gamg_device.py::
    test_probe_refresh_of_scaled_ex55_solves_as_reference holds against
    petsctpu's (18 its; fp32 true relative residual 0.9386e-3 there, the
    port's CPU 0.8937e-3, 0.8692e-3-0.9852e-3 over twelve one-ulp changes
    of b on ELL and on SELL): the card takes the CPU's its and its true
    relative residual stays within REFRESH_SMALL_TRUE_MAX. Then the
    card alone at REFRESH_TREND_NES, printing how the fp32 true
    residual grows with ne (CG's drift in fp32; the full-width one is
    printed, not gated)."""
    (ci, cr, ct), (hi, hr, ht) = (scaled_refresh_cg(REFRESH_SMALL_NE, dev)
                                  for dev in devices)
    print(f"probe refresh ne={REFRESH_SMALL_NE}: CG on D·A·D card vs cpu: "
          f"its {ci}/{hi} reason {cr}/{hr} true rel residual {ct:.4e}/"
          f"{ht:.4e} (bound {REFRESH_SMALL_TRUE_MAX:.1e})")
    if ci != hi or min(cr, hr) <= 0 or not ct <= REFRESH_SMALL_TRUE_MAX:
        raise AssertionError(f"probe refresh ne={REFRESH_SMALL_NE}: the "
                             "card's CG on D·A·D disagrees with the CPU's")
    for ne in REFRESH_TREND_NES:
        its, reason, rel = scaled_refresh_cg(ne, devices[0])
        print(f"probe refresh ne={ne}: CG on D·A·D on the card its={its} "
              f"reason={reason} true rel residual {rel:.4e}")


def host_level(A, lp, power_its):
    """One refreshed level recomputed in fp64 on the host from the
    level's refreshed operator A: ω from the plan's power iteration (its
    start vector, its steps), P = P0 − ω D⁻¹A P0 with the frozen P0,
    and scipy's PᵀAP."""
    P0 = aij_to_scipy(lp.p0()).astype(np.float64)
    dinv = 1.0 / A.diagonal()
    v = lp.v0.double().cpu().numpy()
    for _ in range(power_its):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    P = (P0 - (4.0 / (3.0 * lam)) * sp.diags(dinv) @ A @ P0).tocsr()
    return P, (P.T @ A @ P).tocsr()


def frozen_pattern(plan, l):
    """The pattern (ones) that the refresh keeps for level l's operator:
    the next level's template, or the coarse dense LU's entries."""
    if l < len(plan.levels):
        lp = plan.levels[l]
        return aij_to_scipy(lp.a.ell_tmpl if isinstance(
            lp, GAMGProbeLevelPlan) else lp.a_tmpl)
    r = plan.coarse_rows.long().cpu().numpy()
    c = plan.coarse_cols.long().cpu().numpy()
    return sp.csr_matrix((np.ones(r.size), (r, c)), shape=(plan.nc,) * 2)


def check_refreshed(label, plan, pc, tol=1e-4):
    """Each refreshed level against host_level on its own refreshed
    operator: P, and PᵀAP on the pattern the refresh keeps (the coarse
    one as the LU's product), max |difference| over max |entry| ≤ tol
    (fp32 rounding). The mass of PᵀAP outside that pattern (dropped
    where the initial values cancelled exactly, as in petsctpu) is
    printed."""
    ops = [sell_to_scipy(lv.A) if isinstance(lv.A, SellMat)
           else aij_to_scipy(lv.A) for lv in pc.levels]
    P, L, U = torch.lu_unpack(pc.coarse.lu, pc.coarse.pivots)
    ops.append(sp.csr_matrix((P @ L @ U).double().cpu().numpy()))
    errs, outside = [], []
    for l, (lp, lv) in enumerate(zip(plan.levels, pc.levels)):
        Ph, C = host_level(ops[l].astype(np.float64), lp, plan.power_its)
        Pg = aij_to_scipy(lv.P.P if isinstance(lv.P, PPair) else lv.P)
        keep = C.multiply(frozen_pattern(plan, l + 1)).tocsr()
        scale = abs(C).max()
        errs.append(max(float(abs(Pg - Ph).max() / abs(Ph).max()),
                        float(abs(ops[l + 1].multiply(frozen_pattern(
                            plan, l + 1)) - keep).max() / scale)))
        outside.append(float(abs(C - keep).max() / scale))
    print(f"{label}: each refreshed level (P and PᵀAP) against scipy's on "
          f"its refreshed operator, max rel err by level "
          f"{' '.join(f'{e:.2e}' for e in errs)}; PᵀAP outside the frozen "
          f"pattern {' '.join(f'{e:.2e}' for e in outside)}")
    if not max(errs) <= tol:
        raise AssertionError(f"{label}: refreshed levels disagree with the "
                             "host's")
    return max(errs)


def scaled(A, rng):
    """D·A·D, d = exp(0.2·N(0,1)): new coefficients on A's own pattern
    (its explicit zeros kept), fp32."""
    A2 = sp.csr_matrix(A, dtype=np.float64, copy=True)
    A2.sort_indices()
    d = np.exp(0.2 * rng.standard_normal(A.shape[0]))
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A2.indptr))
    A2.data = A2.data * d[rows] * d[A2.indices]
    return A2.astype(np.float32)


def time_refresh(label, plan, a2):
    """Two refreshes on the card, the K2 launches and host reads of the
    second, its ms."""
    pc = plan.refresh(a2)
    torch.cuda.synchronize()
    k2 = sell_spmv.launches
    with reads_from_device() as reads:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pc = plan.refresh(a2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
    k2 = sell_spmv.launches - k2
    print(f"{label}: one refresh {ms:.2f} ms on the card, {k2} K2 launches, "
          f"{reads[0]} host reads")
    return pc, k2, reads[0]


def refresh_phases(rng):
    """The device refresh: gamg_probe_plan from asa_tentatives P0s on
    ksp ex55 at ne = REFRESH_NE (bs = 2, rigid-body modes), refreshed
    with D·A·D, and gamg_device_plan (SpGEMM plans) on ex45 at
    DEVICE_PLAN_GRID³; each held against the host's Galerkin products
    and preconditioning CG. Returns the max relative error."""
    check_scaled_refresh_small()
    A, b, coords = ex55_system(REFRESH_NE, 1e-3, dtype=np.float32)
    t = time.perf_counter()
    p0s = asa_tentatives(A, rigid_body_modes(coords, dof=2), coarse_n=80,
                         bs=2)
    tent_s = time.perf_counter() - t
    t = time.perf_counter()
    plan = gamg_probe_plan(A, p0s=p0s, coarse_n=80, dtype=np.float32)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t
    print(f"probe refresh plan, ex55 ne={REFRESH_NE} n={A.shape[0]}: "
          f"asa_tentatives {tent_s:.2f} s, gamg_probe_plan {plan_s:.2f} s, "
          f"{len(plan.levels)} levels, coarse {plan.nc} rows")
    expect = 0
    for l, lp in enumerate(plan.levels):
        ncp, n = lp.p0v.shape
        ncc = lp.vc.shape[0]
        print(f"  level {l}: n={n} ncp={ncp} ncc={ncc} p0v "
              f"{lp.p0v.numel() * 4 / 2**20:.1f} MiB, max prod pick "
              f"{int(lp.prod_pick.max())}, max coarse pick "
              f"{int(lp.c_pick.max())} (< 2^31), A on "
              f"{'SELL' if lp.a.use_sell else 'ELL'}")
        if lp.a.use_sell:
            expect += plan.power_its + ncp + ncc
    A2 = scaled(A, rng)
    a2 = torch.from_numpy(csr_data_of_matching(A2)).cuda()
    pc, k2, reads = time_refresh(f"probe refresh ne={REFRESH_NE}", plan, a2)
    if k2 != expect or reads != 1:
        raise AssertionError(f"probe refresh: {k2} K2 launches (expected "
                             f"{expect}), {reads} host reads (expected 1)")
    err = check_refreshed(f"probe refresh ne={REFRESH_NE}", plan, pc)
    solve_refreshed(f"probe refresh ne={REFRESH_NE}", A2, b, pc)
    del plan, pc, A, A2, a2, p0s

    g = DEVICE_PLAN_GRID
    A, b, _ = ex45_system(g, g, g)
    t = time.perf_counter()
    plan = gamg_device_plan(A, coarse_n=64, dtype=np.float32)
    torch.cuda.synchronize()
    print(f"SpGEMM refresh plan, ex45 {g}^3: gamg_device_plan "
          f"{time.perf_counter() - t:.2f} s, {len(plan.levels)} levels, "
          f"coarse {plan.nc} rows")
    A2 = scaled(A, rng)
    a2 = torch.from_numpy(csr_data_of_matching(A2)).cuda()
    pc, _, reads = time_refresh(f"SpGEMM refresh {g}^3", plan, a2)
    if reads != 1:
        raise AssertionError(f"SpGEMM refresh: {reads} host reads")
    err = max(err, check_refreshed(f"SpGEMM refresh {g}^3", plan, pc))
    solve_refreshed(f"SpGEMM refresh {g}^3", A2, b, pc)
    return err


def solve_refreshed(label, A2, b, pc):
    """CG on the new operator (fp32 SELL) preconditioned by its refresh;
    reason > 0, its true residual printed (check_scaled_refresh_small
    gates it where petsctpu's is known)."""
    M = sell_from_scipy(A2)
    t = time.perf_counter()
    res = ksp_solve(M, torch.from_numpy(b.astype(np.float32)).cuda(), pc=pc,
                    ksp_type="cg", rtol=1e-5, maxits=2000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    its, reason = int(res.its), int(res.reason)
    print(f"{label}: CG on D·A·D its={its} reason={reason} "
          f"{1e3 * secs / max(its, 1):.4f} ms/it; true rel residual "
          f"{true_residual(A2, b, res):.3e}")
    if reason <= 0:
        raise AssertionError(f"{label}: CG reason {reason}")


def asa_phase():
    """-pc_type asa on ksp ex55 at ne = ASA_NE: on the card on the fp32
    SELL operator to convergence (its, reason, levels and formats
    printed; it fails unless it converges), then in fp64 on AIJ for
    ASA_CHECK_ITS iterations on the card against the port's CPU path
    (equal its and reason, histories within 1e-10; the CPU's fp64 solve
    takes half a second an iteration, too long to converge here)."""
    A, b, _ = ex55_system(ASA_NE, 1e-3)
    t = time.perf_counter()
    ksp = KSP(Options(dict(ASA_OPTS))).set_operators(
        sell_from_scipy(A.astype(np.float32)), A)
    res = ksp.solve(torch.from_numpy(b.astype(np.float32)).cuda())
    torch.cuda.synchronize()
    its, reason = int(res.its), int(res.reason)
    print(f"asa ne={ASA_NE} fp32 SELL on the card: its={its} reason={reason} "
          f"{time.perf_counter() - t:.1f} s with the setup; levels "
          f"{[lv.A.shape[0] for lv in ksp.pc.levels]}, formats "
          f"{ksp.pc.formats}; true rel residual "
          f"{true_residual(A, b, res):.3e}")
    if reason <= 0:
        raise AssertionError(f"asa ne={ASA_NE}: CG reason {reason}")
    opts = {**ASA_OPTS, "ksp_max_it": str(ASA_CHECK_ITS)}
    out = {dev: KSP(Options(opts)).set_operators(
        aij_from_scipy(A, device=dev), A).solve(
            torch.from_numpy(b).to(dev)) for dev in ("cuda", "cpu")}
    same_solve(f"ex55 CG+ASA fp64, {ASA_CHECK_ITS} its", out["cuda"],
               out["cpu"], 1e-10, size=f"ne={ASA_NE}")


def slice7_phases(rng, kernels):
    """Slice 7: the RBM path at full width (phase 21) with its profile
    and K2/K3 checks and times on its operators, the NC route once,
    both routes card against CPU at ne = 63 (phase 22), the device
    refresh (phase 23) and PCASA (phase 24). Adds the path's launches
    and errors to the kernels line's entries."""
    t = time.perf_counter()
    A, b, coords = ex55_system(EX55_NE, 1e-3)
    print(f"ex55 ne={EX55_NE}: n={A.shape[0]} nnz={A.nnz} "
          f"({time.perf_counter() - t:.1f} s)")
    path = drive_slice7_path(A, b, coords, "rbm")
    k2, k3, trsv_lu = kernels["sell_spmv"], kernels["sell_spmvT"], \
        kernels["sptrsv_lu"]
    k2["launches"] += path["k2"]
    k3["launches"] += path["k3"]
    trsv_lu["launches"] += path["lu"]
    ksp, M = path["ksp"], path["M"]
    print(f"slice 7 rbm: ms per iteration {path['ms_per_it']:.4f} in the "
          f"path, {warm_gamg_ms_per_it(path):.4f} repeated")
    profile_solve(ksp, path["b"], label="slice 7 rbm")
    if isinstance(M, SellMat):
        label = f"ex55 ne={EX55_NE}"
        xp, err = check_k2(A, M, "cuda", rng, label)
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        measure(A, M, xp, label=label, triad=False)
        del xp
    pc = ksp.pc
    for l in path["via_k3"]:
        P = pc.levels[l].P
        P_host = sell_to_scipy(P)
        k3["max_abs_err"] = max(k3["max_abs_err"], check_k3(
            f"ex55 level-{l} prolongator", P, P_host, rng))
        measure_k3(l, P, P_host, rng, label=f"ex55 ne={EX55_NE}")
    del path, ksp, M, pc
    del A, b, coords
    A, b, coords = ex55_system(EX55_NC_NE, 1e-3)
    nc = drive_slice7_path(A, b, coords, "nc", ne=EX55_NC_NE)
    del nc, A, b, coords
    check_slice7_small_against_cpu()
    refresh_phases(rng)
    asa_phase()


# ---------------------------------------------------------------------------
# Slice 8: the remaining PCs, as ksp ex43 SolCx Stokes (phases 25-28)
# ---------------------------------------------------------------------------

def ex43_system(mx):
    """ksp ex43's SolCx system at mx = my (A, B, f), its fields {0,1} and
    {2} by dof % 3, and the assembly's seconds."""
    t = time.perf_counter()
    A, B, f = q1q1_stokes_system(mx, mx, **SOLCX)
    c = np.arange(A.shape[0]) % 3
    return (A, B, f, [np.flatnonzero(c != 2), np.flatnonzero(c == 2)],
            time.perf_counter() - t)


def fieldsplit_solve(A, B, f, fields, opts, dev, monitor=False):
    """ex43's solve: make_fieldsplit(B, fields, Amat_host=A) (the PC
    matrix B, the operator A) and FGMRES(30) to rtol 1e-8 on A, on dev;
    (result, PC, seconds of the solve)."""
    pc = make_fieldsplit(B, fields, options=Options(dict(opts)), Amat_host=A,
                         device=dev)
    Ad = aij_from_scipy(A, device=dev)
    fd = torch.from_numpy(f).to(dev)
    sync(dev)
    t = time.perf_counter()
    res = ksp_solve(Ad, fd, pc=pc, ksp_type="fgmres", rtol=1e-8,
                    maxits=10000, monitor=monitor)
    sync(dev)
    return res, pc, time.perf_counter() - t


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def launch_counts():
    return {name: k.launches for name, k in HAND_KERNELS.items()}


def error_line(mx, x):
    """DMDAIntegrateErrors' line (h, p L2, u L2, u H1) against SolCx."""
    Xa = solcx_nodal_solution(mx, mx, eta0=SOLCX["eta0"],
                              eta1=SOLCX["eta1"], xc=SOLCX["xc"],
                              nz=SOLCX["nz"])
    h, pL2, uL2, uH1 = integrate_errors(mx, mx, x, Xa)
    return f"{h:1.4e}   {pL2:1.4e}   {uL2:1.4e}   {uH1:1.4e} ", uL2


def ex43_split():
    ev = log_events()
    return {k: ev[k].time if k in ev else 0.0
            for k in ("PCFieldSplitBlocks", "PCFieldSplitSubPC",
                      "PCGAMGHierarchy", "PCMGPack", "PCMGTransfer",
                      "PCMGLevelOps", "PCMGSmoother", "PCMGCoarseLU")}


def measure_aij(A, Ad, x, triad_gbs, label):
    """AIJ.mult on A, the ELL kernel since slice 9 (XLA-coded in
    petsctpu): held bit for bit against its plain version on x, then
    timed beside torch.mv on CSR and its bound (measure_ell)."""
    err = ell_check(label, A, Ad, None, x)
    return dict(max_abs_err=err, **measure_ell(label, A, Ad, x, triad_gbs))


def ex43_ell_phase(triad_gbs, rng):
    """ell_spmv on ex43's A at mx = EX43_MX (K 27; slice 8's phase 25
    does this on its own A in the full run)."""
    A, _, _, _, secs = ex43_system(EX43_MX)
    print(f"ex43 mx={EX43_MX} assembled in {secs:.1f} s")
    x = torch.from_numpy(rng.standard_normal(A.shape[1])).cuda()
    return measure_aij(A, aij_from_scipy(A), x, triad_gbs,
                       f"ex43 mx={EX43_MX}")


def drive_slice8_path(triad_gbs):
    """Phase 25: ksp ex43 SolCx at mx = my = EX43_MX in fp64 on AIJ,
    FGMRES + symmetric_multiplicative fieldsplit with GAMG(dof 2) on the
    velocity and Jacobi on the pressure, counting every hand kernel's
    launches and the host reads in the solve. Returns the launches."""
    A, B, f, fields, asm_s = ex43_system(EX43_MX)
    n = A.shape[0]
    print(f"slice 8: ex43 SolCx mx=my={EX43_MX}: n={n} ({fields[0].size} "
          f"velocity) nnz(A)={A.nnz} nnz(B)={B.nnz}; assembly {asm_s:.2f} s")
    reset_counts()
    log_begin()
    t = time.perf_counter()
    Ad = aij_from_scipy(A)
    op_s = time.perf_counter() - t
    t = time.perf_counter()
    pc = make_fieldsplit(B, fields, options=Options(dict(EX43_OPTS)),
                         Amat_host=A)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    s = ex43_split()
    mg = pc.pc0
    print(f"slice 8 setup: operator A to the device {op_s:.2f} s; "
          f"fieldsplit {setup_s:.2f} s = submatrix extraction and device "
          f"blocks {s['PCFieldSplitBlocks']:.2f} + sub-PCs "
          f"{s['PCFieldSplitSubPC']:.2f} (GAMG hierarchy "
          f"{s['PCGAMGHierarchy']:.2f}, level operators: packed "
          f"{s['PCMGPack']:.2f} + transfer {s['PCMGTransfer']:.2f}, or "
          f"per level {s['PCMGLevelOps']:.2f} + Chebyshev bounds "
          f"{s['PCMGSmoother']:.2f}; coarse solve: sparse LU "
          f"{s['PCMGCoarseLU']:.2f} or the packed dense LU)")
    for l, (lev, fmt) in enumerate(zip(mg.levels, mg.formats)):
        print(f"  level {l}: A {lev.A.shape} {fmt[0]}, P {lev.P.shape} "
              f"{fmt[1]}, R {fmt[2] or 'P.multT'}")
    print(f"  coarse: {mg.coarse_A.shape[0]} rows, "
          f"{type(mg.coarse).__name__}")
    b = torch.from_numpy(f).cuda()

    def solve_once():
        return ksp_solve(Ad, b, pc=pc, ksp_type="fgmres", rtol=1e-8,
                         maxits=10000)

    before = launch_counts()
    with reads_from_device() as reads:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_once()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    its, reason = int(res.its), int(res.reason)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    relres = true_residual(A, f, res)
    line, uL2 = error_line(EX43_MX, res.x.cpu().numpy())
    print(f"slice 8: FGMRES + fieldsplit its={its} reason={reason} "
          f"{secs:.3f} s = {1e3 * secs / max(its, 1):.4f} ms/it; true rel "
          f"residual {relres:.3e}; history {float(res.history[0]):.6e} -> "
          f"{float(res.history[its]):.6e}; host reads {reads[0]} "
          f"({reads[0] / max(its, 1):.2f} an iteration)")
    print(f"slice 8: error line (h, p L2, u L2, u H1) {line}")
    print("slice 8: hand-kernel launches an iteration: " + ", ".join(
        f"{k} {v / max(its, 1):.2f}" for k, v in launched.items()))
    if reason <= 0 or not relres <= 1e-8:
        raise AssertionError(f"slice 8: reason {reason}, true residual "
                             f"{relres}")
    t = time.perf_counter()
    warm = solve_once()
    torch.cuda.synchronize()
    print(f"slice 8: ms per iteration {1e3 * secs / its:.4f} first, "
          f"{1e3 * (time.perf_counter() - t) / int(warm.its):.4f} repeated")
    profile_solve(types.SimpleNamespace(solve=lambda b_: solve_once()), b,
                  label="slice 8", top=12)
    with ell_shapes() as shapes:         # an untimed solve
        ell_its = int(solve_once().its)
    ell_breakdown("slice 8", shapes, ell_its)
    measure_aij(A, Ad, b, triad_gbs, f"ex43 mx={EX43_MX}")
    return launched


def check_ex43_golden(devices=("cuda", "cpu")):
    """Phase 26: the ex43 golden at mx = 20 (LU on the velocity, Jacobi
    on the pressure) on each device: the monitor stream and the error
    line digit for digit, 8 its. Returns the card's PC and its launches
    by kernel."""
    A, B, f, fields, _ = ex43_system(20)
    pcs, launched = {}, None
    for dev in devices:
        buf = io.StringIO()
        before = launch_counts()
        with contextlib.redirect_stdout(buf):
            res, pc, _ = fieldsplit_solve(A, B, f, fields, EX43_GOLDEN_OPTS,
                                          dev, monitor=True)
        now = {k: v - before[k] for k, v in launch_counts().items()}
        launched = launched or now
        line, _ = error_line(20, res.x.cpu().numpy())
        ok = (buf.getvalue() == EX43_GOLDEN and int(res.its) == 8
              and line == EX43_GOLDEN_ERRORS)
        print(f"ex43 golden mx=20 on {dev}: its {int(res.its)}, stream "
              f"{'digit for digit' if buf.getvalue() == EX43_GOLDEN else 'DIFFERS'}"
              f", errors {line!r}; sptrsv_lu launches {now['sptrsv_lu']}, "
              f"sptrsv {now['sptrsv']}")
        if not ok:
            raise AssertionError(f"ex43 golden on {dev}:\n{buf.getvalue()}"
                                 f"{line}")
        pcs[dev] = pc
    return pcs[devices[0]], launched


def b_changed(b, seed=1):
    """b·(1 + 1e-15·N(0,1)): the change whose effect on the CPU's own
    history a card-against-CPU bound must exceed 30 times."""
    return b * (1 + 1e-15 * np.random.default_rng(seed).standard_normal(
        b.size))


def check_bound_over_noise(label, bound, noise):
    print(f"  {label}: the CPU's own history change under a 1e-15 change "
          f"of b {noise:.2e}, the bound {bound:.0e}")
    if not bound >= 30 * noise:
        raise AssertionError(f"{label}: bound {bound} is not 30 times the "
                             f"CPU's own change {noise}")


def check_ex43_schur(devices=("cuda", "cpu")):
    """Phase 27: -pc_fieldsplit_type schur (fact full) with GAMG(dof 2)
    on the velocity and the inner Schur GMRES at mx = EX43_SCHUR_MX, on
    the card against the CPU: equal its and reason, the history within
    SCHUR_RTOL, itself at least 30 times the CPU's own change under a
    1e-15 change of b. Its inner solves read the host once an inner
    iteration: counted."""
    A, B, f, fields, _ = ex43_system(EX43_SCHUR_MX)
    out = []
    for dev in devices:
        with reads_from_device() as reads:
            res, _, secs = fieldsplit_solve(A, B, f, fields, EX43_SCHUR_OPTS,
                                            dev)
        its = int(res.its)
        print(f"ex43 mx={EX43_SCHUR_MX} schur full + GAMG(dof 2) on {dev}: "
              f"its {its} reason {int(res.reason)} {secs:.2f} s = "
              f"{1e3 * secs / max(its, 1):.2f} ms/it; host reads "
              f"{reads[0]} ({reads[0] / max(its, 1):.1f} an outer "
              f"iteration); true rel residual {true_residual(A, f, res):.3e}")
        out.append(res)
    same_solve("schur full + GAMG(dof 2)", *out, rtol=SCHUR_RTOL,
               size=f"mx={EX43_SCHUR_MX}")
    changed, _, _ = fieldsplit_solve(A, B, b_changed(f), fields,
                                     EX43_SCHUR_OPTS, devices[-1])
    check_bound_over_noise(f"mx={EX43_SCHUR_MX} schur full", SCHUR_RTOL,
                           history_diff(out[-1], changed, SCHUR_RTOL))


def _lap3d(m):
    return poisson_3d(m, m, m).tocsr()


def _dirichlet_laplacian(n=7):
    A = laplacian_2d(n, n).tolil()
    idx = np.arange(n * n).reshape(n, n)
    for k in np.concatenate([idx[0], idx[-1], idx[:, 0], idx[:, -1]]):
        A.rows[k], A.data[k] = [k], [1.0]
    return A.tocsr()


def _nonsym(m=6):
    A = laplacian_2d(m, m).tolil()
    for i in range(m * m - 1):
        A[i, i + 1] += 0.3
    return A.tocsr()


def slice8_pc_cases():
    """Each slice-8 PC type once, at its reference test's size: (label,
    host matrix, b, ksp type, make(dev) -> make_pc's options, or
    "eisenstat_system", bound). A solve's bound is at least 30 times the
    history difference that a 1e-15 relative change of b makes in the
    CPU's own solve (check_slice8_pcs_against_cpu measures it). ksp type
    None compares one apply instead: the exact solvers (svd, tfs,
    redistribute's LU) end at rounding noise in one iteration, and
    galerkin alone is a singular PC. Since AIJ products fold in slot order
    (PR 13) the CPU's own changes moved (composite additive 1.96e-11 →
    3.35e-11, ksp 2.01e-10 → 4.16e-10, cp 3.97e-10 → 1.62e-9, MAC
    fieldsplit additive 2.34e-10 → 4.83e-10 on the sandbox's CPU), so
    those four bounds were raised fivefold to stay about 100 times it."""
    E, _, _ = ex2_system(8, 7)
    E = sp.csr_matrix(E)
    N = _nonsym()
    D = _dirichlet_laplacian()
    S = sp.csr_matrix(ex2_system(6, 6)[0])
    m = 12
    ex1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    W = (sp.kron(sp.eye(m), ex1) + 1e-2 * sp.kron(ex1, sp.eye(m))).tocsr()
    L8, L5 = _lap3d(8), _lap3d(5)
    K, bk, (vi, pi), _ = stokes_mac(8)
    Q, _, fq, _, _ = ex43_system(8)
    q = np.arange(Q.shape[0]) % 3
    G = sp.csr_matrix(ex2_system(9, 9)[0])
    da = DA((9, 9))
    dac = da.coarsen()
    rng = np.random.default_rng(8)
    A00 = (laplacian_2d(6, 4) + 0.5 * sp.eye(24)).tocsr()
    Bl = sp.csr_matrix(rng.standard_normal((8, 24)) * 0.5)
    Sl = Bl @ np.linalg.inv(A00.toarray()) @ Bl.T
    dN = 1.0 / N.diagonal()

    def one(M):
        return M @ np.ones(M.shape[0])

    def opts(name, **o):
        return lambda dev: dict(pc_type=name, **o)

    return [
        ("composite additive", E, one(E), "gmres",
         opts("composite", pc_composite_pcs="jacobi,sor"), 5e-9),
        ("composite multiplicative", E, one(E), "gmres",
         opts("composite", pc_composite_pcs="jacobi,sor",
              pc_composite_type="multiplicative"), 1e-9),
        ("ksp (gmres + ilu)", E, one(E), "fgmres", opts("ksp"), 5e-8),
        ("ksp (specest)", E, one(E), "fgmres",
         opts("ksp", ksp_ksp_type="specest"), 1e-8),
        ("shell (1/diag)", N, np.ones(N.shape[0]), "gmres", lambda dev: dict(
            pc_type="shell", pc_shell_apply=lambda ctx, x: ctx * x,
            pc_shell_ctx=torch.from_numpy(dN).to(dev)), 1e-8),
        ("mat (diag(1/d))", N, np.ones(N.shape[0]), "gmres",
         lambda dev: dict(pc_type="mat", pc_mat_operator=aij_from_scipy(
             sp.diags(dN).tocsr(), device=dev)), 1e-8),
        ("eisenstat", E, one(E), "cg", opts("eisenstat"), 1e-10),
        ("eisenstat system (omega 1.4)", E, one(E), "gmres",
         "eisenstat_system", 1e-10),
        ("galerkin (Q1 9x9 -> 5x5)", G, rng.standard_normal(81), None,
         lambda dev: dict(
             pc_type="galerkin", pc_galerkin_interpolation=da.interpolation(
                 dac), pc_galerkin_interpolation_host=da.interpolation_scipy(
                 dac)), 1e-12),
        ("redistribute", D, rng.standard_normal(D.shape[0]), None,
         opts("redistribute"), 1e-12),
        ("lsc (dense Schur)", Sl, rng.standard_normal(8), "fgmres",
         lambda dev: dict(pc_type="lsc", pc_lsc_a00=A00, pc_lsc_b=Bl),
         1e-8),
        ("svd", S, rng.standard_normal(S.shape[0]), None, opts("svd"),
         1e-12),
        ("cp", N, np.ones(N.shape[0]), "fgmres", opts("cp"), 1e-7),
        ("spai", N, np.ones(N.shape[0]), "gmres", opts("spai"), 1e-8),
        ("supportgraph", W, np.ones(W.shape[0]), "cg",
         opts("supportgraph"), 1e-10),
        ("exotic wirebasket (direct)", L8, one(L8), "cg", opts(
            "exotic", pc_exotic_grid=(8, 8, 8), pc_exotic_type="wirebasket",
            pc_exotic_direct_solver="true"), 1e-10),
        ("wb face (inexact interior solves)", L8, one(L8), "cg",
         opts("wb", pc_exotic_grid=(8, 8, 8)), 1e-10),
        ("tfs", L5, rng.standard_normal(L5.shape[0]), None, opts("tfs"),
         1e-12),
        ("fieldsplit additive (MAC, null space)", K, bk, "fgmres",
         opts("fieldsplit", pc_fieldsplit_type="additive",
              fieldsplit_1_pc_type="jacobi",
              pc_fieldsplit_fields=[IS.general(vi), IS.general(pi)]), 5e-8),
        ("fieldsplit 3 fields multiplicative (ex43 mx=8)", Q, fq, "fgmres",
         opts("fieldsplit", pc_fieldsplit_type="multiplicative",
              fieldsplit_2_pc_type="jacobi",
              pc_fieldsplit_fields=[np.flatnonzero(q == k)
                                    for k in range(3)]), 1e-7),
    ]


def build_case(M, make, dev):
    """(operator, PC, b transform) of a slice8_pc_cases entry on dev."""
    if make == "eisenstat_system":
        op, pc, pre, _ = make_eisenstat_system(M, omega=1.4, device=dev)
        return op, pc, pre
    o = make(dev)
    op = (Dense(torch.from_numpy(M).to(dev)) if isinstance(M, np.ndarray)
          else aij_from_scipy(M, device=dev))
    return (op, make_pc(o.pop("pc_type"), A=op, A_host=M,
                        options=Options(o)), lambda b: b)


def check_slice8_pcs_against_cpu(devices=("cuda", "cpu")):
    """Phase 28: each slice-8 PC type once on the card against the CPU,
    fp64 on AIJ (lsc on the dense Schur complement): equal its and
    reason and histories within each case's bound, or one apply within
    it (slice8_pc_cases); a solve's bound must be at least 30 times the
    CPU's own history change under a 1e-15 change of b (one more CPU
    solve). Returns the launches of the card's solves by kernel."""
    worst, launched = 0.0, collections.Counter()
    for label, M, b, ksp_type, make, bound in slice8_pc_cases():
        out = []
        for dev, bb in [(d, b) for d in devices] + (
                [] if ksp_type is None else [(devices[-1], b_changed(b))]):
            before = launch_counts()
            op, pc, pre = build_case(M, make, dev)
            bd = pre(torch.from_numpy(bb).to(dev))
            nsp = None
            if "null space" in label:
                v = np.zeros(M.shape[0])
                v[M.shape[0] - 64:] = 1.0          # the MAC pressures
                nsp = make_nullspace(M.shape[0], has_constant=False,
                                     vecs=[v], device=dev)
            out.append(pc.apply(bd).cpu().numpy() if ksp_type is None else
                       ksp_solve(op, bd, pc=pc, ksp_type=ksp_type,
                                 rtol=1e-8, maxits=600, nullspace=nsp))
            if dev == devices[0]:
                launched.update({k: v - before[k]
                                 for k, v in launch_counts().items()})
        if ksp_type is None:
            diff = float(np.abs(out[0] - out[1]).max()
                         / np.abs(out[1]).max())
            print(f"small {label} card vs cpu: one apply, rel diff "
                  f"{diff:.2e}")
            if not diff <= bound:
                raise AssertionError(f"small {label}: apply on the card "
                                     "disagrees with the CPU")
        else:
            diff = same_solve(label, *out[:2], rtol=bound, size="small")
            check_bound_over_noise(label, bound,
                                   history_diff(out[1], out[2], bound))
        worst = max(worst, diff / bound)
    print(f"slice 8 PCs card vs cpu: {len(slice8_pc_cases())} cases, worst "
          f"difference {worst:.2e} of its bound; launches on the card "
          f"{dict(launched)}")
    return launched


def slice8_phases(rng, kernels, triad_gbs):
    """Slice 8: the full-width path (phase 25), the golden (26), Schur
    at mx = 255 (27) and every other new PC type (28), each against the
    CPU; then SpTRSV against its plain version on the golden's LU pair
    and the Eisenstat triangles, and the golden LU's fused apply timed.
    Adds the path's launches to the kernels line's entries."""
    launched = drive_slice8_path(triad_gbs)
    for name in ("sptrsv", "sptrsv_lu", "sell_spmv", "sell_spmvT",
                 "stencil_mult"):
        kernels[name]["launches"] += launched[name]
    golden_pc, golden = check_ex43_golden()
    check_ex43_schur()
    small = check_slice8_pcs_against_cpu()
    for name in ("sptrsv", "sptrsv_lu"):
        kernels[name]["launches"] += golden[name] + small[name]
    L, U = golden_pc.pc0.Lplan, golden_pc.pc0.Uplan
    kernels["sptrsv_lu"]["max_abs_err"] = max(
        kernels["sptrsv_lu"]["max_abs_err"],
        check_sptrsv_lu("ex43 mx=20 velocity LU", L, U, rng, repeat=10))
    b = torch.from_numpy(rng.standard_normal(L.n)).cuda()
    lead = (L.order, U.order, b[None])
    print(f"sptrsv_lu ex43 mx=20 velocity LU ({shape_of(L, U)} shape, "
          f"K {L.order[2].shape[-1]}/{U.order[2].shape[-1]}, levels "
          f"{int(L.nlevs.max())}+{int(U.nlevs.max())}): "
          f"{graph_ms(lambda: lu_solve(L, U, b)):.4f} ms in a CUDA graph, "
          f"{time_ms(lambda: lu_solve(L, U, b), runs=20, inner=5):.4f} ms a "
          f"call; plain {time_ms(lambda: sptrsv_lu_plain(*lead), runs=3, inner=1, warmup=1):.4f} ms")
    shell, _, _, _ = make_eisenstat_system(
        sp.csr_matrix(ex2_system(20, 20)[0]), device="cuda")
    for tri, label in ((shell.ctx[0], "E+L"), (shell.ctx[1], "E+U")):
        err, _ = check_sptrsv(f"eisenstat ex2 20x20 {label}", tri, rng)
        kernels["sptrsv"]["max_abs_err"] = max(
            kernels["sptrsv"]["max_abs_err"], err)


# ---------------------------------------------------------------- slice 9

EX14_M = 128              # snes ex14 3-D Bratu at 128³: n = 2,097,152
EX14_LAM = 6.0
EX5_M = 1025              # snes ex5 2-D Bratu at 1025²: n = 1,050,625
EX5_LAM = 6.0
SNES_OPTS = {"snes_type": "newtonls", "snes_linesearch_type": "bt",
             "snes_rtol": "1e-8", "ksp_type": "gmres", "ksp_rtol": "1e-5",
             "ksp_max_it": "10000", "snes_monitor": "1"}
ELL_PLAIN_RUNS = 3
SNES_FLOOR = 1e-7         # phase 31's history floor, of the first norm


def ell_check(label, A, Ad, rng, x=None):
    """ell_spmv on the ELL pack Ad (of the scipy matrix A) against its
    plain version, bit for bit, and against scipy's product (fp64: 1e-12
    relative, fp32: 1e-5); returns max |kernel − plain| (0)."""
    if x is None:
        x = rng.standard_normal(Ad.shape[1])
        if Ad.vals.is_complex():
            x = x + 1j * rng.standard_normal(Ad.shape[1])
        x = torch.from_numpy(x).to(Ad.vals.dtype).cuda()
    y = ell_spmv(Ad.cols, Ad.vals, x)
    y_plain = ell_spmv_plain(Ad.cols, Ad.vals, x)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max()) if y.numel() else 0.0
    ref = A @ x.cpu().numpy().astype(np.complex128 if Ad.vals.is_complex()
                                      else np.float64)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-300)
    rel = (float(np.abs(y.cpu().numpy() - ref).max()) / scale
           if ref.size else 0.0)
    tol = 1e-5 if Ad.vals.dtype in (torch.float32, torch.complex64) \
        else 1e-12
    m, K = Ad.cols.shape
    plan = ell_plan(m, K, Ad.vals.element_size(),
                    torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"ell_spmv {label}: m={m} n={Ad.shape[1]} K={K} "
          f"{str(Ad.vals.dtype)[6:]} {plan}: max|kernel-plain|={err} rel "
          f"err vs scipy {rel:.2e}")
    if not torch.equal(y, y_plain) or y.shape != (Ad.shape[0],):
        raise AssertionError(f"ell_spmv {label}: kernel differs from its "
                             f"plain version (max abs {err})")
    if not rel <= tol:
        raise AssertionError(f"ell_spmv {label}: rel err {rel} vs scipy")
    return err


def ell_rows(m, n, K, dtype=np.float64, seed=0, short=0):
    """An m × n matrix of K distinct columns a row (`short` rows with
    fewer, so that some slots are padding), values from the seed."""
    rng = np.random.default_rng(seed)
    step = max(1, n // K)
    cols = (rng.integers(0, n, m)[:, None] + step * np.arange(K)) % n
    keep = np.ones((m, K), bool)
    keep[rng.integers(0, m, short), -1] = False
    rows = np.repeat(np.arange(m), K).reshape(m, K)
    vals = rng.standard_normal((m, K))
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal((m, K))
    return sp.csr_matrix((vals[keep].astype(dtype),
                          (rows[keep], cols[keep])), shape=(m, n))


def ell_edge_cases(rng):
    """ell_spmv's edge cases and operator kinds (phase 32), each against
    its plain version bit for bit: K = 1, m off a multiple of the tile,
    an all-padding row, rows wider than one stage (the chunked kernel,
    fp64 and fp32), m = 0, fp32, complex64 and complex128 (phase 19's
    complex BiCGStab reaches AIJ.mult), rectangular both ways; and the
    ring kernel's edges: m not a multiple of 4, m under one tile, a last
    tile whose bytes are not a multiple of 16 (its tail by plain loads),
    rows whose bytes are no multiple of 16 (a bulk copy's 16-byte units
    and a stage's end fall mid-row), an even K (the products at row
    stride K + 1) in each dtype, an odd K in each dtype, and a single row
    wider than a stage."""
    def rand(m, n, density, dtype=np.float64, seed=0):
        return sp.random(m, n, density=density, random_state=seed,
                         format="csr", dtype=dtype)

    def padded_row(A, r):
        A = sp.lil_matrix(A)
        A[r, :] = 0
        return sp.csr_matrix(A)

    R27 = ell_plan(10 ** 6, 27, 8).rows      # fp64 K 27's rows a tile
    C = rand(5000, 5000, 5e-4) + 1j * rand(5000, 5000, 5e-4, seed=1)
    cases = [
        ("K=1 diagonal", sp.diags(rng.standard_normal(1000)).tocsr(), None),
        ("m=12345 (off the tile) with an all-padding row",
         padded_row(rand(12345, 9000, 8e-4), 77), None),
        ("K=300 (chunked, fp64)", rand(3000, 4000, 0.07, seed=2), None),
        ("K=300 (chunked, fp32)", rand(2000, 2500, 0.11, np.float32, 3),
         None),
        ("fp32 7-point 64^3", poisson_3d(64, 64, 64).astype(np.float32),
         None),
        ("rectangular 70000 x 3000", rand(70000, 3000, 2e-3, seed=4), None),
        ("rectangular 3000 x 70000", rand(3000, 70000, 1e-4, seed=5), None),
        ("complex128", C.tocsr(), np.complex128),
        ("complex64", C.tocsr(), np.complex64),
        ("m=0", sp.csr_matrix((0, 10)), None),
        ("m=1001 (not a multiple of 4), K=27",
         ell_rows(1001, 4000, 27, seed=6, short=50), None),
        ("m=3 (under one tile), K=7", ell_rows(3, 50, 7, seed=7), None),
        ("last tile of 3 rows, K=27 (cols 324 B, vals 648 B: off 16)",
         ell_rows(5 * R27 + 3, 9000, 27, seed=8, short=40), None),
        ("K=13 fp32 (52-byte rows: copies end mid-row)",
         ell_rows(20001, 30000, 13, np.float32, 9, short=100), None),
        ("K=5 complex128 (20-byte cols, 80-byte vals a row)",
         ell_rows(7777, 7000, 5, np.complex128, 10, short=30), None),
        ("K=6 fp64, even (products at stride 7), m off the tile",
         ell_rows(40003, 50000, 6, seed=11, short=200), None),
        ("K=8 fp32, even", ell_rows(30001, 30000, 8, np.float32, 12, 99),
         None),
        ("K=10 complex64, even",
         ell_rows(9999, 12000, 10, np.complex64, 13, 17), None),
        ("K=10 complex128, even",
         ell_rows(9999, 12000, 10, np.complex128, 14, 17), None),
        ("K=9 complex64, odd", ell_rows(5003, 6000, 9, np.complex64, 15),
         None),
        ("K=96 fp64, even, 32 rows a tile",
         ell_rows(1000, 20000, 96, seed=16, short=10), None),
        ("one row wider than a stage (K=6000, the chunked kernel)",
         ell_rows(1, 100000, 6000, seed=17), None),
        ("37 rows wider than a stage (K=4001 fp32)",
         ell_rows(37, 50000, 4001, np.float32, 18, short=5), None),
        ("K=120 complex128 (the chunked kernel), m off 32",
         ell_rows(500, 3000, 120, np.complex128, 19, short=9), None),
        ("K=469 fp64 (the chunked kernel: slice 8's coarse level's K)",
         ell_rows(2888, 2888, 469, seed=20, short=40), None),
    ]
    worst = 0.0
    for label, A, dtype in cases:
        Ad = aij_from_scipy(A, dtype=dtype)
        worst = max(worst, ell_check(label, A.astype(dtype or A.dtype), Ad,
                                     rng))
    return worst


def measure_ell(label, A, Ad, x, triad_gbs):
    """ell_spmv (AIJ.mult) on the pack Ad of A: a call back to back, 20
    calls from a CUDA graph, its plain version, torch.mv on CSR, the
    kernel and CSR again in turns (kernel, CSR, CSR, kernel, each 20
    calls from a CUDA graph), and the bound: the ELL arrays (int32
    columns), x and y moved once at 3.35 TB/s (and at the measured STREAM
    triad; beside it the bound of the int64 columns the port stored
    before) against 2 flops a slot at the fp64 or fp32 peak."""
    call_ms = time_ms(lambda: Ad.mult(x), runs=20, inner=5)
    device_ms = graph_ms(lambda: Ad.mult(x))
    plain_ms = time_ms(lambda: ell_spmv_plain(Ad.cols, Ad.vals, x),
                       runs=ELL_PLAIN_RUNS, inner=1, warmup=1)
    csr = csr_tensor(A, np.float64 if Ad.dtype == torch.float64
                     else np.float32)
    y, y_lib = Ad.mult(x), torch.mv(csr, x)
    rel = float((y - y_lib).abs().max() / y_lib.abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x), runs=20, inner=5)
    turns = [graph_ms(fn) for fn in (lambda: Ad.mult(x),
                                     lambda: torch.mv(csr, x),
                                     lambda: torch.mv(csr, x),
                                     lambda: Ad.mult(x))]
    m, K = Ad.cols.shape
    es = Ad.vals.element_size()
    ell = m * K * (es + Ad.cols.element_size()) + (A.shape[1] + m) * es
    ell64 = m * K * (es + 8) + (A.shape[1] + m) * es
    csr_b = A.nnz * (es + 4) + (m + 1) * 4 + (A.shape[1] + m) * es
    bytes_ms = ell / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * K / (FP64_FLOPS_PER_S if es == 8
                            else FP32_FLOPS_PER_S) * 1e3
    triad_ms = ell / (triad_gbs * 1e9) * 1e3
    print(f"ell_spmv (AIJ.mult) at {label}: m={m} K={K} nnz={A.nnz} "
          f"({A.nnz / m:.1f} a row, {100 * (1 - A.nnz / (m * K)):.1f} % ELL "
          f"padding), {Ad.cols.dtype} cols; {device_ms:.4f} ms in a CUDA "
          f"graph, {call_ms:.4f} ms a call back to back; plain {plain_ms:.4f}"
          f" ms; torch.mv CSR {library_ms:.4f} ms (rel diff {rel:.1e}); "
          f"bound {bytes_ms:.4f} ms by the ELL arrays' {ell} B at 3.35 TB/s "
          f"({triad_ms:.4f} ms at the STREAM triad {triad_gbs:.1f} GB/s; "
          f"{ops_ms:.5f} ms by ops; CSR's {csr_b} B {csr_b / (triad_gbs * 1e6):.4f} "
          f"ms at the triad; with int64 columns {ell64} B, "
          f"{ell64 / HBM_BYTES_PER_S * 1e3:.4f} ms); "
          f"{100 * bytes_ms / device_ms:.1f} % of the byte bound, "
          f"{100 * triad_ms / device_ms:.1f} % at the triad")
    kernel_ms, csr_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"ell_spmv at {label} in turns (kernel, CSR, CSR, kernel; ms in a "
          f"CUDA graph): {', '.join(f'{t:.4f}' for t in turns)}; kernel "
          f"{kernel_ms:.4f} against CSR {csr_ms:.4f} "
          f"({kernel_ms / csr_ms:.3f}×): {100 * bytes_ms / kernel_ms:.1f} % "
          f"of the byte bound, {100 * triad_ms / kernel_ms:.1f} % at the triad")
    if not rel <= 1e-12 * (1e7 if es == 4 else 1):
        raise AssertionError(f"ell_spmv disagrees with CSR mv: {rel}")
    return dict(ms=call_ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


@contextlib.contextmanager
def ell_shapes():
    """AIJ.mult's products by operator while the context is open:
    {(m, K, dtype, len(x), cols' address): [calls, (cols, vals, x) of the
    first]}."""
    real = ell_module.ell_spmv
    seen = {}

    def spy(cols, vals, x):
        key = (cols.shape[0], cols.shape[1], vals.dtype, x.shape[0],
               cols.data_ptr())
        if key in seen:
            seen[key][0] += 1
        else:
            seen[key] = [1, (cols, vals, x.clone())]
        return real(cols, vals, x)

    ell_module.ell_spmv = spy
    try:
        yield seen
    finally:
        ell_module.ell_spmv = real


def ell_breakdown(label, seen, its):
    """ell_spmv's time an iteration by operator: launches an iteration ×
    the device ms of one on its own pack (20 calls from a CUDA graph),
    beside its shape's byte bound."""
    rows, total = [], 0.0
    for (m, K, dtype, n, _), (calls, (cols, vals, x)) in seen.items():
        ms = graph_ms(lambda: ell_spmv(cols, vals, x))
        es = vals.element_size()
        bound = (m * K * (4 + es) + (n + m) * es) / HBM_BYTES_PER_S * 1e3
        rows.append((calls / its * ms, m, K, dtype, calls / its, ms, bound))
        total += calls / its * ms
    print(f"{label}: ell_spmv by operator ({len(rows)} operators, "
          f"{total:.4f} ms an iteration):")
    for per_it, m, K, dtype, launches, ms, bound in sorted(rows,
                                                           reverse=True):
        print(f"  m={m:>8} K={K:>3} {str(dtype)[6:]:>10}: {launches:6.2f} "
              f"an iteration × {ms:.4f} ms = {per_it:.4f} ms an iteration "
              f"({100 * bound / ms:.1f} % of its {bound:.5f} ms bound)")
    return total


class TimedJacobian:
    """A ColoredJacobian plan whose assemblies are timed (synchronised)."""

    def __init__(self, plan):
        self.plan, self.secs = plan, []

    def assemble(self, F, x, Fx):
        torch.cuda.synchronize()
        t = time.perf_counter()
        J = self.plan.assemble(F, x, Fx)
        torch.cuda.synchronize()
        self.secs.append(time.perf_counter() - t)
        return J


class ILU0Builder:
    """The slice's PC builder: ILU(0) of each Jacobian, factored on the
    host (as tests/test_sweep.py's ex14 rig does) and applied by SpTRSV
    on the card (mat/factor.lu_solve: sptrsv_lu), its setup timed by
    part: the copy of J to the host, the host ILU(0), the two plans."""

    def __init__(self):
        self.parts = []

    def __call__(self, J):
        t0 = time.perf_counter()
        Jh = aij_to_scipy(J)
        t1 = time.perf_counter()
        L, U = ilu0(Jh)
        t2 = time.perf_counter()
        pc = ILUPC(make_sptrsv_plan(L, lower=True, unit_diag=True,
                                    device=J.device),
                   make_sptrsv_plan(U, lower=False, unit_diag=False,
                                    device=J.device))
        torch.cuda.synchronize()
        self.parts.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        self.pc = pc
        return pc


@contextlib.contextmanager
def timed_ksp(ksp_type="gmres"):
    """Time and record each linear solve of the SNES (its, seconds, and
    the last operator, PC and right-hand side, for a profiled repeat)."""
    real = ksp_api.KSP_REGISTRY[ksp_type]
    log = types.SimpleNamespace(its=[], secs=[], last=None)

    def spy(A, b, x0, pc, cfg, axis):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(A, b, x0, pc, cfg, axis)
        torch.cuda.synchronize()
        log.secs.append(time.perf_counter() - t)
        log.its.append(int(res.its))
        log.last = (A, b, pc, cfg)
        return res

    ksp_api.KSP_REGISTRY[ksp_type] = spy
    try:
        yield log
    finally:
        ksp_api.KSP_REGISTRY[ksp_type] = real


def snes_path(label, F, x0, jac, builder):
    """One SNES solve through SNES(Options(SNES_OPTS)) with the launch
    counts reset just before and read just after; prints the monitor
    stream, the linear its of each Newton step, ms a linear iteration,
    the peak memory, and profiles one more linear solve of the last
    step. Returns (result, launches by kernel, ksp log)."""
    snes = SNES(Options(dict(SNES_OPTS)))
    snes.set_function(F).set_jacobian(jac).set_pc_builder(builder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with timed_ksp() as log:
        t = time.perf_counter()
        res = snes.solve(x0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    its, reason = int(res.its), int(res.reason)
    h = res.history[:its + 1].numpy()
    lin = sum(log.its)
    print(f"{label}: SNES its={its} reason={reason} {secs:.2f} s; fnorm "
          f"{h[0]:.6e} -> {h[-1]:.6e} ({h[-1] / h[0]:.2e} of the first); "
          f"linear its by step {log.its} ({lin} in all), "
          f"{1e3 * sum(log.secs) / max(lin, 1):.4f} ms a linear iteration "
          f"(the Krylov solves' {sum(log.secs):.2f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
          f"start)")
    print(f"{label}: launches " + ", ".join(f"{k} {v}" for k, v in
                                            launched.items() if v))
    if reason <= 0 or not h[-1] <= 1e-8 * h[0] or \
            not torch.isfinite(res.x).all():
        raise AssertionError(f"{label}: SNES reason {reason}, fnorm "
                             f"{h[-1]} of {h[0]}")
    A, b, pc, cfg = log.last
    ksolve = ksp_api.KSP_REGISTRY[cfg.ksp_type]
    profile_solve(types.SimpleNamespace(solve=lambda b_: ksolve(
        A, b_, torch.zeros_like(b_), pc, cfg, None)), b,
        label=f"{label} (a linear solve of the last step)", top=8)
    return res, launched, log


def drive_ex14_path(rng, triad_gbs):
    """Phase 29: snes ex14 3-D Bratu at 128³ (λ = 6, fp64) through the
    SNES object: newtonls + bt, the 27-color 'ds' FD Jacobian on the
    7-point AIJ, GMRES(30) + ILU(0) rebuilt on each Jacobian. Checks
    ell_spmv on the last Jacobian against its plain version and times
    it. Returns (launches, ell_spmv's max error and times)."""
    m = EX14_M
    t = time.perf_counter()
    F = bratu3d_residual(m, EX14_LAM)
    x0 = bratu3d_initial_guess(m, EX14_LAM)
    jac = TimedJacobian(bratu3d_fd_jacobian(m))
    J0 = jac.plan.template
    print(f"slice 9: snes ex14 {m}^3 lambda={EX14_LAM}: n={J0.shape[0]} "
          f"nnz={J0.nnz} K={J0.cols.shape[1]}, {jac.plan.ncolors} colors; "
          f"setup {time.perf_counter() - t:.2f} s; Fb [{jac.plan.ncolors}, "
          f"n] fp64 {jac.plan.ncolors * J0.shape[0] * 8 / 1e6:.0f} MB")
    builder = ILU0Builder()
    res, launched, log = snes_path(f"ex14 {m}^3", F, x0, jac, builder)
    for k, (a, (cp, fac, plan)) in enumerate(zip(jac.secs, builder.parts)):
        print(f"  Newton step {k + 1}: setup {a + cp + fac + plan:.2f} s = "
              f"coloring assembly {a:.3f} + J to the host {cp:.2f} + host "
              f"ILU(0) {fac:.2f} + SpTRSV plans {plan:.2f}; GMRES its "
              f"{log.its[k]} in {log.secs[k]:.3f} s")
    # an ILU(0) apply is one sptrsv_lu launch where the pair fuses, else
    # (x past shared memory: the 2,097,152-row triangles) two sptrsv
    applies = launched["sptrsv_lu"] + launched["sptrsv"] / 2
    print(f"ex14 {m}^3: ILU(0) applies through SpTRSV {applies:.0f} "
          f"({launched['sptrsv_lu']} fused, {launched['sptrsv']} single "
          f"launches), ell_spmv {launched['ell_spmv']}, in {sum(log.its)} "
          f"linear its")
    if launched["ell_spmv"] < sum(log.its) or applies < sum(log.its):
        raise AssertionError(f"ex14: ell_spmv or SpTRSV launched fewer "
                             f"times than the {sum(log.its)} linear its")
    J, b, _, _ = log.last
    Jh = aij_to_scipy(J)
    err = ell_check(f"ex14 {m}^3 Jacobian", Jh, J, rng, b)
    return launched, err, measure_ell(f"ex14 {m}^3 Jacobian", Jh, J, b,
                                      triad_gbs)


def drive_ex5_path():
    """Phase 30: snes ex5 2-D Bratu at 1025² (λ = 6, fp64): the StencilMat
    Jacobian colored over 9 colors, GMRES preconditioned by the device
    geometric MG (make_geometric_mg_device) rebuilt on each Jacobian;
    K1 launched through SNES. Returns the launches."""
    da = DA((EX5_M, EX5_M))
    jac = TimedJacobian(ColoredJacobian.from_stencil(
        bratu_jacobian_template(da)))
    print(f"slice 9: snes ex5 {EX5_M}^2 lambda={EX5_LAM}: n={da.n}, "
          f"{jac.plan.ncolors} colors")
    mg_secs = []

    def mg_builder(J):
        t = time.perf_counter()
        pc = make_geometric_mg_device(J, da)
        torch.cuda.synchronize()
        mg_secs.append(time.perf_counter() - t)
        return pc

    res, launched, log = snes_path(
        f"ex5 {EX5_M}^2", bratu_residual(da, EX5_LAM),
        bratu_initial_guess(da, EX5_LAM), jac, mg_builder)
    for k, (a, s) in enumerate(zip(jac.secs, mg_secs)):
        print(f"  Newton step {k + 1}: coloring assembly {a:.3f} s + device "
              f"MG setup {s:.2f} s; GMRES its {log.its[k]} in "
              f"{log.secs[k]:.3f} s")
    if launched["stencil_mult"] < sum(log.its):
        raise AssertionError("ex5: K1 launched fewer times than the linear "
                             "iterations")
    return launched


def x0_changed(x, seed=1):
    """x·(1 + 1e-15·N(0,1)) (x + 1e-15·N(0,1) where x is 0): the change
    whose effect on the CPU's own history a card-against-CPU bound must
    exceed 30 times."""
    noise = 1e-15 * np.random.default_rng(seed).standard_normal(x.size)
    return np.where(x == 0, noise, x * (1 + noise))


def slice9_small_cases():
    """The card-against-CPU cases of phase 31: (label, run(dev, x0) ->
    SNESResult, x0, bound). Each bound is at least 30 times the CPU's own
    history change under a 1e-15 change of x0 (measured in the run; on
    the sandbox's CPU: ex14 m=8 1.15e-6, m=12 2.07e-5 (the 'ds' FD
    parameters follow x's last bits), ex5 5.2e-7, newtontr 4.0e-10,
    qn / ngmres / ncg 1.2e-14 / 3.4e-14 / 3.4e-14, FAS 1.6e-10, VI
    8.8e-7, NASM 1.2e-10: each bound is about 100 times that)."""
    def ex14(m, lam):
        def run(dev, x0):
            snes = SNES(Options({"ksp_type": "gmres", "ksp_rtol": "1e-5",
                                 "ksp_max_it": "10000"}))
            snes.set_function(bratu3d_residual(m, lam))
            snes.set_jacobian(bratu3d_fd_jacobian(m, device=dev))
            snes.set_pc_builder(lambda J: make_ilu(
                aij_to_scipy(J), levels=0, device=dev))
            return snes.solve(torch.from_numpy(x0).to(dev))
        return run, bratu3d_initial_guess(m, lam, device="cpu").numpy()

    def ex5(m, lam):
        da = DA((m, m))

        def run(dev, x0):
            return snes_solve(
                bratu_residual(da, lam), torch.from_numpy(x0).to(dev),
                jac=ColoredJacobian.from_stencil(bratu_jacobian_template(
                    da, device=dev)),
                cfg=SNESConfig(rtol=1e-8, atol=1e-50),
                ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-10, maxits=1000,
                                  restart=200))
        return run, bratu_initial_guess(da, lam, device="cpu").numpy()

    def bratu_fn(m, lam, solve):
        da = DA((m, m))

        def run(dev, x0):
            return solve(da, bratu_residual(da, lam),
                         torch.from_numpy(x0).to(dev))
        return run, bratu_initial_guess(da, lam, device="cpu").numpy()

    def newtontr(da, F, x):
        return SNES(Options({"snes_type": "newtontr", "snes_rtol": "1e-10",
                             "ksp_rtol": "1e-10"})).set_function(F).solve(x)

    def fas(da, F, x):
        levels = fas_levels_from_da(da, lambda d: bratu_residual(d, 6.0), 3,
                                    mask_boundary=True)
        return snes_fas(levels, x, maxits=6, rtol=1e-10)

    def nasm(da, F, x):
        idx = np.arange(da.n)
        return snes_nasm(F, x, [idx[:45], idx[36:]], rtol=1e-6, maxits=20)

    n = 40
    h = 1.0 / (n + 1)
    Ao = (sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                   [-1, 0, 1]) / h ** 2).toarray()
    xs = np.linspace(h, 1 - h, n)
    psi = -0.2 + 0.4 * (xs - 0.5) ** 2

    def vi(dev, x0):
        Ad = torch.from_numpy(Ao).to(dev)
        f = torch.full((n,), -8.0, dtype=torch.float64, device=dev)
        return snes_vinewtonrsls(lambda u: Ad @ u - f,
                                 torch.from_numpy(x0).to(dev),
                                 lb=torch.from_numpy(psi).to(dev), ub=1e20,
                                 rtol=1e-10, maxits=50)

    return [
        ("ex14 m=8 lambda=5 (fdcoloring ds + GMRES/ILU(0))",
         *ex14(8, 5.0), 1e-4),
        ("ex14 m=12 lambda=2", *ex14(12, 2.0), 2e-3),
        ("ex5 m=16 lambda=5 (stencil FD + FGMRES)", *ex5(16, 5.0), 5e-5),
        ("newtontr ex5 m=12", *bratu_fn(12, 6.0, newtontr), 5e-8),
        ("qn ex5 m=33", *bratu_fn(33, 6.0, lambda da, F, x: snes_qn(
            F, x, history_len=10, maxits=20, rtol=1e-12)), 1e-10),
        ("ngmres ex5 m=33", *bratu_fn(33, 6.0, lambda da, F, x: snes_ngmres(
            F, x, msize=10, maxits=20, rtol=1e-12)), 1e-10),
        ("ncg prp ex5 m=33", *bratu_fn(33, 6.0, lambda da, F, x: snes_ncg(
            F, x, maxits=20, rtol=1e-12)), 1e-10),
        ("FAS 3 levels NGS ex5 m=17", *bratu_fn(17, 6.0, fas), 2e-8),
        ("VI rsls 1-D obstacle n=40", vi, np.zeros(n), 1e-4),
        ("NASM ex5 m=9 two subdomains", *bratu_fn(9, 5.0, nasm), 2e-8),
    ]


def snes_history_diff(card, cpu):
    """Max relative difference of two SNES histories, an entry's scale
    floored at SNES_FLOOR of the first norm (below it the FD Jacobian's
    √eps error and rounding set the last digits); inf unless the its,
    reasons and recorded entries are the same."""
    hc, hh = card.history.numpy(), cpu.history.numpy()
    live = ~np.isnan(hh)
    if ((int(card.its), int(card.reason)) != (int(cpu.its), int(cpu.reason))
            or not np.array_equal(live, ~np.isnan(hc))):
        return float("inf")
    a, c = hc[live], hh[live]
    return float(np.max(np.abs(a - c) / (np.abs(c) + SNES_FLOOR * c[0])))


def check_slice9_small_against_cpu(devices=("cuda", "cpu")):
    """Phase 31: each slice9_small_cases entry on the card and on the CPU:
    equal its and reason, histories within its bound (snes_history_diff),
    itself at least 30 times the CPU's own change under a 1e-15 change of
    x0. Returns the card runs' launches by kernel."""
    launched = collections.Counter()
    worst = 0.0
    for label, run, x0, bound in slice9_small_cases():
        before = launch_counts()
        card = run(devices[0], x0)
        launched.update({k: v - before[k]
                         for k, v in launch_counts().items()})
        cpu = run(devices[1], x0)
        diff = snes_history_diff(card, cpu)
        xd = float(np.abs(card.x.cpu().numpy() - cpu.x.numpy()).max())
        print(f"small {label} card vs cpu: its {int(card.its)}/"
              f"{int(cpu.its)} reason {int(card.reason)}/{int(cpu.reason)} "
              f"history rel diff {diff:.2e} max|x diff| {xd:.2e}")
        if not diff <= bound or not torch.isfinite(card.x).all():
            raise AssertionError(f"small {label} on the card disagrees "
                                 "with the CPU")
        check_bound_over_noise(label, bound, snes_history_diff(
            cpu, run(devices[1], x0_changed(x0))))
        worst = max(worst, diff / bound)
    print(f"slice 9 card vs cpu: {len(slice9_small_cases())} cases, worst "
          f"difference {worst:.2e} of its bound; launches on the card "
          f"{dict(launched)}")
    return launched


def slice9_phases(rng, kernels, triad_gbs):
    """Slice 9: the ex14 path at 128³ (phase 29), the ex5 path at 1025²
    (30), the small cases card against CPU (31), ell_spmv on its edge
    cases (32). Adds the paths' launches to the kernels line; returns
    ell_spmv's entry (launches from the ex14 path, times on its
    Jacobian)."""
    launched, err, times = drive_ex14_path(rng, triad_gbs)
    for name in ("sptrsv", "sptrsv_lu", "sell_spmv", "sell_spmvT",
                 "stencil_mult"):
        kernels[name]["launches"] += launched[name]
    ex5 = drive_ex5_path()
    for name in ("sptrsv", "sptrsv_lu", "stencil_mult"):
        kernels[name]["launches"] += ex5[name]
    small = check_slice9_small_against_cpu()
    for name in ("sptrsv", "sptrsv_lu", "stencil_mult"):
        kernels[name]["launches"] += small[name]
    err = max(err, ell_edge_cases(rng))
    return dict(name="ell_spmv", route="cuda",
                source="petsctpu_torch/csrc/ell_spmv.cu",
                replaces="petsctpu/mat/ell.py:53",
                launches=launched["ell_spmv"], max_abs_err=err, **times)


# ---------------------------------------------------------------------------
# Slice 11: TS (phases 33-35)
# ---------------------------------------------------------------------------

EX15_M = 2049             # ts ex15 2-D heat DAE at 2049²: n = 4,198,401
EX15_DT = 0.01
EX15_STEPS = 10
TS_SMALL_M = 33           # ex15 card against CPU: n = 1,089
EX15_GOLDEN_MAX = (0.455605, 0.238234, 0.148476, 0.104384, 0.0788279,
                   0.0620459, 0.0500304, 0.0409203, 0.0337537, 0.0279837)
TS_EX1_FNORMS = (0.207564, 0.184718, 0.160569, 0.135283, 0.109165,
                 0.0827478, 0.0569517, 0.03335, 0.0144859, 0.00341003,
                 0.000212272)
TS_EX3_ERRORS = (0.00103714, 0.00173865, 0.00218619, 0.00244382,
                 0.00256155, 0.0025782, 0.00252361, 0.00242114,
                 0.00228786, 0.00213706)


@contextlib.contextmanager
def ts_its():
    """The Newton solves' and the linear solves' (its, reason) of a TS
    run, in order, from spies on the steppers' snes_solve and on
    KSP_REGISTRY's gmres (every stage solve of the slice's runs)."""
    log = types.SimpleNamespace(newton=[], linear=[])
    mods = (ts_steppers, ts_imex, ts_gl_module)
    reals = [m.snes_solve for m in mods]
    real_ksp = ksp_api.KSP_REGISTRY["gmres"]

    def newton(real):
        def spy(*a, **kw):
            res = real(*a, **kw)
            log.newton.append((int(res.its), int(res.reason)))
            return res
        return spy

    def linear(A, b, x0, pc, cfg, axis):
        res = real_ksp(A, b, x0, pc, cfg, axis)
        log.linear.append((int(res.its), int(res.reason)))
        return res

    for m, real in zip(mods, reals):
        m.snes_solve = newton(real)
    ksp_api.KSP_REGISTRY["gmres"] = linear
    try:
        yield log
    finally:
        for m, real in zip(mods, reals):
            m.snes_solve = real
        ksp_api.KSP_REGISTRY["gmres"] = real_ksp


def ex15_bscale(M):
    """The Dirichlet rows' weight of the MG route: 4/h² (heat2d_ifunc)."""
    return 4.0 * (M - 1) ** 2


def drive_ex15_path(rng):
    """Phase 33: ts ex15's 2-D heat DAE (Dirichlet, the ifunc form, IC
    exp(-30 r³) inside r < 1/8; the boundary rows weighted 4/h²) at
    EX15_M², fp64, backward Euler dt = 0.01 for 10 steps through
    ts_solve: each step the port's Newton with GMRES(30) on the
    stencil-colored FD Jacobian (heat2d_jacobian_template, 9 colors),
    preconditioned by the device geometric MG rebuilt on each Jacobian
    (K1 at every level, the coarse LU through sptrsv_lu). Then K1
    against its plain version and timed at every level shape of the
    last hierarchy. Returns (launches by kernel, K1's max error)."""
    M = EX15_M
    da = DA((M, M))
    t = time.perf_counter()
    u0 = heat2d_initial(M)
    jac = TimedJacobian(ColoredJacobian.from_stencil(
        heat2d_jacobian_template(M, 0)))
    torch.cuda.synchronize()
    print(f"slice 11: ts ex15 {M}^2 (Dirichlet) BE dt={EX15_DT}: n={da.n}, "
          f"{jac.plan.ncolors} colors; setup {time.perf_counter() - t:.2f} s; "
          f"Fb [{jac.plan.ncolors}, n] fp64 "
          f"{jac.plan.ncolors * da.n * 8 / 1e6:.0f} MB")
    mg = types.SimpleNamespace(secs=[], pc=None)

    def mg_builder(J):
        t = time.perf_counter()
        mg.pc = make_geometric_mg_device(J, da)
        torch.cuda.synchronize()
        mg.secs.append(time.perf_counter() - t)
        return mg.pc

    steps = []

    def post_step(k, tt, u):
        mx, mn = to_host(u.max(), u.min())
        steps.append((k, float(tt), float(mx), float(mn),
                      time.perf_counter()))

    by_grid = collections.Counter()
    real = stencil_module.stencil_mult

    def spy(coeffs, x, offsets, grid, boundary=()):
        by_grid[tuple(grid)] += 1
        return real(coeffs, x, offsets, grid, boundary)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    stencil_module.stencil_mult = spy      # StencilMat.mult's K1 call
    try:
        with timed_ksp() as klog, ts_its() as tlog:
            t0 = time.perf_counter()
            res = ts_solve(None, u0, ifunc=heat2d_ifunc(
                               M, 0, bscale=ex15_bscale(M)),
                           ts_type="beuler", dt=EX15_DT,
                           max_steps=EX15_STEPS, max_time=1.0, jac=jac,
                           pc_builder=mg_builder, post_step=post_step)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        stencil_module.stencil_mult = real
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    lin = sum(klog.its)
    print(f"ex15 {M}^2: {int(res.steps)} steps to t={float(res.t):g} in "
          f"{secs:.2f} s; {len(tlog.newton)} Newton solves, {lin} GMRES its, "
          f"{1e3 * sum(klog.secs) / max(lin, 1):.4f} ms a linear iteration "
          f"(the Krylov solves' {sum(klog.secs):.2f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
          f"start)")
    mx0 = float(u0.max())
    prev, k_lin, t_prev = mx0, 0, t0
    for (k, tt, mx, mn, tk), (nits, reason) in zip(steps, tlog.newton):
        its = klog.its[k_lin:k_lin + nits]
        asm = jac.secs[k_lin:k_lin + nits]
        mgs = mg.secs[k_lin:k_lin + nits]
        k_lin += nits
        print(f"  step {k} t={tt:g}: max {mx:.6g} min {mn:.3e}; Newton its "
              f"{nits} (reason {reason}), GMRES its {its}; {tk - t_prev:.2f} "
              f"s; a Newton step's setup: coloring assembly "
              f"{', '.join(f'{a:.3f}' for a in asm)} s + MG setup "
              f"{', '.join(f'{s:.2f}' for s in mgs)} s")
        t_prev = tk
        if reason <= 0:
            raise AssertionError(f"ex15 step {k}: Newton reason {reason}")
        if min(r for _, r in tlog.linear[k_lin - nits:k_lin]) <= 0:
            raise AssertionError(f"ex15 step {k}: a GMRES solve diverged "
                                 f"{tlog.linear[k_lin - nits:k_lin]}")
        if not mx < prev:
            raise AssertionError(f"ex15 step {k}: max(u) {mx} did not fall "
                                 f"from {prev}")
        if not mn >= -1e-6 * mx0:
            raise AssertionError(f"ex15 step {k}: min(u) {mn} below "
                                 f"-1e-6 max(u0)")
        prev = mx
    if len(steps) != EX15_STEPS or not torch.isfinite(res.u).all():
        raise AssertionError(f"ex15: {len(steps)} steps, or a non-finite "
                             "state")
    print(f"ex15 {M}^2: launches " + ", ".join(
        f"{k} {v}" for k, v in launched.items() if v) + "; K1 by grid "
        + ", ".join(f"{g[0]}^2 {n}" for g, n in sorted(by_grid.items(),
                                                       reverse=True)))
    if launched["stencil_mult"] < lin:
        raise AssertionError(f"ex15: K1 launched {launched['stencil_mult']} "
                             f"times in {lin} linear its")
    A, b, pc, cfg = klog.last
    ksolve = ksp_api.KSP_REGISTRY[cfg.ksp_type]
    profile_solve(types.SimpleNamespace(solve=lambda b_: ksolve(
        A, b_, torch.zeros_like(b_), pc, cfg, None)), b,
        label=f"ex15 {M}^2 (a linear solve of the last step)", top=8)

    def one_step(u):
        ts_solve(None, u, ifunc=heat2d_ifunc(M, 0, bscale=ex15_bscale(M)),
                 ts_type="beuler", t0=float(res.t), dt=EX15_DT,
                 max_steps=1, max_time=1.0, jac=jac, pc_builder=mg_builder)
        return types.SimpleNamespace(its=1)

    profile_solve(types.SimpleNamespace(solve=one_step), res.u,
                  label=f"ex15 {M}^2 (one more time step, per step)", top=8)
    errs = []
    for lv in mg.pc.levels:
        S = lv.A
        label = f"{S.grid[0]}^2 {len(S.offsets)}-point"
        A_host = stencil_to_scipy(S)
        err, x = check_k1(label, S, rng, A_host)
        errs.append(err)
        measure_k1(label + " fp64", S, x, A_host)
        print(f"K1 at {label}: {by_grid.get(tuple(S.grid), 0) / lin:.2f} "
              f"launches a linear iteration of the TS path ({lin} its; MG "
              f"setups' products included)")
    del res, jac, mg, A, b, pc
    return launched, max(errs)


def heat2d_max_column(dev, M=20, steps=10, **kw):
    """ex15's max and min after each of `steps` BE steps at dt 0.01."""
    seen = []
    ts_solve(None, heat2d_initial(M, device=dev), ifunc=heat2d_ifunc(M, 0),
             ts_type="beuler", dt=0.01, max_steps=steps, max_time=1.0,
             post_step=lambda k, tt, v: seen.append(
                 tuple(float(a) for a in to_host(v.max(), v.min()))), **kw)
    return seen


def pseudo_bratu_fnorms(dev):
    """ts ex1: Bratu 4×4 (λ = 6) by pseudo-timestepping (dt0 0.125, SER
    increment 1.1): the fnorm stream."""
    mx = my = 4
    lam = 6.0
    h = 1.0 / (mx - 1)
    inner = torch.zeros((my, mx), dtype=torch.bool, device=dev)
    inner[1:-1, 1:-1] = True

    def F(t_, xv):
        X = xv.reshape(my, mx)
        u = X[1:-1, 1:-1]
        uxx = (-X[1:-1, 2:] + 2 * u - X[1:-1, :-2])
        uyy = (-X[2:, 1:-1] + 2 * u - X[:-2, 1:-1])
        f = -uxx - uyy + h * h * lam * torch.exp(u)
        full = torch.nn.functional.pad(f, (1, 1, 1, 1))
        return torch.where(inner, full, X).reshape(-1)

    u0 = np.zeros((my, mx))
    for j in range(1, my - 1):
        tj = min(j, my - 1 - j) * h
        for i in range(1, mx - 1):
            u0[j, i] = lam / (lam + 1.0) * np.sqrt(min(min(i, mx - 1 - i)
                                                       * h, tj))
    res = ts_pseudo(F, torch.from_numpy(u0.reshape(-1)).to(dev),
                    TSConfig(ts_type="pseudo", dt=0.125, max_steps=12,
                             pseudo_fnorm_rtol=1e-10))
    return res.fnorm_history.numpy()


def ssp_heat_errors(dev):
    """ts ex3: 1-D heat m = 60 by SSP rks2 (5 stages), dt 5e-4: the
    h-scaled 2-norm errors of steps 1..10."""
    m = 60
    h = 1.0 / (m - 1)
    A = (sp.diags([np.ones(m - 1), -2.0 * np.ones(m), np.ones(m - 1)],
                  [-1, 0, 1]) / h ** 2).tolil()
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[m - 1, :] = 0.0
    A[m - 1, m - 1] = 1.0
    Ad = torch.from_numpy(A.toarray()).to(dev)
    xs = h * np.arange(m)

    def exact(tt):
        return (np.sin(6 * np.pi * xs) * np.exp(-36 * np.pi ** 2 * tt)
                + 3 * np.sin(2 * np.pi * xs) * np.exp(-4 * np.pi ** 2 * tt))

    errs = []
    ts_solve(lambda t_, u: Ad @ u, torch.from_numpy(exact(0.0)).to(dev),
             TSConfig(ts_type="ssp", ssp_type="rks2", ssp_nstages=5,
                      dt=0.0005, max_steps=10, max_time=1.0),
             post_step=lambda k, tt, u: errs.append(
                 np.sqrt(h) * np.linalg.norm(u.cpu().numpy()
                                             - exact(0.0005 * k))))
    return np.array(errs)


def check_ts_goldens(dev="cuda"):
    """Phase 34: the TS goldens on the card: ex15_1's max column at M =
    20 through the golden test's own route (AD products, no PC) within
    2e-5; ts ex1's pseudo-Bratu fnorm stream within 2e-3; ts ex3's SSP
    errors within 2e-4 (tests/test_golden.py's bounds)."""
    maxes = np.array([mx for mx, _ in heat2d_max_column(dev)])
    d15 = float(np.max(np.abs(maxes / np.array(EX15_GOLDEN_MAX) - 1)))
    fh = pseudo_bratu_fnorms(dev)[:len(TS_EX1_FNORMS)]
    d1 = float(np.max(np.abs(fh / np.array(TS_EX1_FNORMS) - 1)))
    e3 = ssp_heat_errors(dev)
    d3 = float(np.max(np.abs(e3 / np.array(TS_EX3_ERRORS) - 1)))
    print(f"TS goldens on the card: ex15_1 max column {maxes[0]:.6g} ... "
          f"{maxes[-1]:.6g}, rel diff {d15:.2e} (2e-5); ts ex1 fnorms rel "
          f"diff {d1:.2e} (2e-3); ts ex3 SSP errors rel diff {d3:.2e} (2e-4)")
    if not (d15 <= 2e-5 and d1 <= 2e-3 and d3 <= 2e-4):
        raise AssertionError("a TS golden disagrees on the card")


def allen_cahn(n=64, eps=0.05):
    """u' = ε² u_xx + u − u³ on n interior points, zero Dirichlet ends."""
    h = 1.0 / (n + 1)

    def rhs(t_, u):
        P = torch.nn.functional.pad(u, (1, 1))
        return (eps / h) ** 2 * (P[2:] - 2 * u + P[:-2]) + u - u ** 3

    x = np.linspace(h, 1 - h, n)
    return rhs, 0.8 * np.sin(3 * np.pi * x) + 0.1 * np.cos(7 * x)


def ts_small_cases():
    """The card-against-CPU cases of phase 35: (label, run(dev, u0) ->
    TSResult, u0, bound). Each bound is at least 30 times the CPU's own
    state change under a 1e-15 change of u0 (measured in the run; on the
    CPU the bounds were set on: ex15 M=33 2.9e-15, ex22_3 RosW 1.9e-14,
    ARKIMEX 4 1.8e-14, GL p=3 6.2e-16, alpha 3.7e-16, rk dp45 7.1e-16,
    characteristic 2.9e-16: each bound is about 1000 times that)."""
    M = TS_SMALL_M

    def ex15(dev, u0):
        da = DA((M, M))
        return ts_solve(None, torch.from_numpy(u0).to(dev),
                        ifunc=heat2d_ifunc(M, 0, bscale=ex15_bscale(M)),
                        ts_type="beuler", dt=0.01,
                        max_steps=10, max_time=1.0,
                        jac=ColoredJacobian.from_stencil(
                            heat2d_jacobian_template(M, 0, device=dev)),
                        pc_builder=lambda J: make_geometric_mg_device(J, da))

    def ex22(dev, u0, ark=False):
        fexp, fimp = adr_rhs_advection(200), adr_rhs_reaction(200)
        x0 = torch.from_numpy(u0).to(dev)
        if ark:
            return ts_arkimex(fexp, fimp, x0, TSConfig(
                dt=0.1 / 400.0, max_steps=10, max_time=1.0,
                clamp_final=False), tableau="4")
        return ts_rosw(lambda t_, x: fexp(t_, x) + fimp(t_, x), x0,
                       TSConfig(dt=5e-3, max_steps=10000, max_time=1.0,
                                clamp_final=False), tableau="ra34pw2",
                       jac_fn=fimp)

    ac, ac0 = allen_cahn()

    def forced(t_, u):
        return ac(t_, u) + 0.3 * float(np.sin(5.0 * t_))

    def gl3(dev, u0):
        return ts_gl(ac, torch.from_numpy(u0).to(dev), order=3, dt=0.02,
                     max_time=0.2)

    def alpha(dev, u0):
        return ts_alpha(ac, torch.from_numpy(u0).to(dev), dt=0.02,
                        max_time=0.2)

    def dp45(dev, u0):
        return ts_solve(forced, torch.from_numpy(u0).to(dev), ts_type="rk",
                        rk_type="dp45", dt=0.05, max_time=1.0, adapt=True,
                        adapt_rtol=1e-8, adapt_atol=1e-10, max_steps=5000)

    m = 65
    xs = np.linspace(0, 1, m)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    c0 = np.exp(-100 * ((X - 0.7) ** 2 + (Y - 0.5) ** 2)).reshape(-1)

    def characteristic(dev, u0):
        vx = torch.from_numpy(-2 * np.pi * (Y - 0.5) + 0.3).to(dev)
        vy = torch.from_numpy(2 * np.pi * (X - 0.5) - 0.2).to(dev)
        return ts_characteristic(lambda t_, u: (vx, vy),
                                 torch.from_numpy(u0).to(dev), (m, m),
                                 dt=0.01, max_time=0.3, bc="periodic")

    u22 = adr_initial(200, device="cpu").numpy()
    return [
        (f"ex15 M={M} BE, colored Jacobian + device MG", ex15,
         heat2d_initial(M, device="cpu").numpy(), 1e-12),
        ("ex22_3 RosW ra34pw2 dt 5e-3 (200 steps)", ex22, u22, 2e-11),
        ("ex22 ARKIMEX 4, 10 steps",
         lambda dev, u0: ex22(dev, u0, ark=True), u22, 2e-11),
        ("GL p=3 Allen-Cahn, 10 steps", gl3, ac0, 1e-12),
        ("alpha Allen-Cahn, 10 steps", alpha, ac0, 1e-12),
        ("rk dp45 + basic adaptor, forced Allen-Cahn", dp45, ac0, 1e-12),
        ("characteristic, periodic rotation 65^2", characteristic, c0,
         1e-12),
    ]


def ts_state_diff(a, b):
    """Max relative difference of two TS states, inf unless their step
    counts and final times agree."""
    if int(a.steps) != int(b.steps) or float(a.t) != float(b.t):
        return float("inf")
    x, y = a.u.cpu().numpy(), b.u.cpu().numpy()
    return float(np.abs(x - y).max() / np.abs(y).max())


def check_ts_small_against_cpu(devices=("cuda", "cpu")):
    """Phase 35: each ts_small_cases entry on the card and on the CPU:
    equal step counts, final times, Newton its and reasons, and linear
    its, states within the case's bound, itself at least 30 times the
    CPU's own change under a 1e-15 change of u0. Returns the card runs'
    launches by kernel."""
    launched = collections.Counter()
    worst = 0.0
    for label, run, u0, bound in ts_small_cases():
        before = launch_counts()
        with ts_its() as card_its:
            card = run(devices[0], u0)
        launched.update({k: v - before[k]
                         for k, v in launch_counts().items()})
        with ts_its() as cpu_its:
            cpu = run(devices[1], u0)
        diff = ts_state_diff(card, cpu)
        print(f"small {label} card vs cpu: steps {int(card.steps)}/"
              f"{int(cpu.steps)} t {float(card.t):g}; Newton solves "
              f"{len(card_its.newton)}/{len(cpu_its.newton)}, linear its "
              f"{sum(i for i, _ in card_its.linear)}/"
              f"{sum(i for i, _ in cpu_its.linear)}; state rel diff "
              f"{diff:.2e}")
        if (card_its.newton != cpu_its.newton
                or card_its.linear != cpu_its.linear
                or not diff <= bound or not torch.isfinite(card.u).all()):
            raise AssertionError(f"small {label} on the card disagrees "
                                 "with the CPU")
        check_bound_over_noise(label, bound, ts_state_diff(
            cpu, run(devices[1], x0_changed(u0))))
        worst = max(worst, diff / bound)
    print(f"slice 11 card vs cpu: {len(ts_small_cases())} cases, worst "
          f"difference {worst:.2e} of its bound; launches on the card "
          f"{dict(launched)}")
    return launched


def slice11_phases(rng, kernels):
    """Slice 11: the ex15 path at EX15_M² (phase 33), the TS goldens on
    the card (34), the small TS cases card against CPU (35). Adds the
    paths' K1 and SpTRSV launches to the kernels line and K1's error."""
    launched, k1_err = drive_ex15_path(rng)
    check_ts_goldens()
    small = check_ts_small_against_cpu()
    for name in ("sptrsv", "sptrsv_lu", "stencil_mult", "ell_spmv"):
        if name in kernels:
            kernels[name]["launches"] += launched[name] + small[name]
    kernels["stencil_mult"]["max_abs_err"] = max(
        kernels["stencil_mult"]["max_abs_err"], k1_err)


# ---------------------------------------------------------------------------
# Slice 12: the Mat formats, as ksp ex55 on BAIJ and SBAIJ (phases 36-39)
# ---------------------------------------------------------------------------

FMT_NE = 1023              # ksp ex55 at ne = 1023: n = 2,097,152, bs 2
FMT_ITS = 300              # the fixed CG iteration count of phases 36-37
FIXED_CG = {"ksp_type": "cg", "ksp_rtol": "1e-30",
            "ksp_max_it": str(FMT_ITS)}
BLOCKED = {"mat_block_size": "2"}
FMT_NOISE_SEEDS = 4        # one-ulp changes of b read for phase 36's bound
FMT_SMALL_NE = 63          # phase 38: n = 8,192
FMT_ULP_SEEDS = 4          # one-ulp changes of b phase 38 reads fp32 noise over
BAND_GRID = 32             # phase 39's band and dia solves: ex45 at 32³
BAND_TIME_M = 513          # BandMat/DiaMat timed on the 513² 5-point
# the blocked configs of tests/test_golden_ex10.py: tag -> (file,
# mat_type, bs, ksp, pc); their bounds are that test's
EX10_BLOCKED = {
    "poisson_sbaij_cg_jacobi": ("ex10_poisson.bin", "sbaij", 1, "cg",
                                "jacobi"),
    "baij3_baij_gmres_pbjacobi": ("ex10_baij3.bin", "baij", 3, "gmres",
                                  "pbjacobi"),
    "baij3_baij_cg_jacobi": ("ex10_baij3.bin", "baij", 3, "cg", "jacobi"),
}
TESTS_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "data")


def read_ex10_system(path):
    """A PETSc binary Mat and the Vec after it in one file (ex10.c's
    same-file layout): (scipy CSR, rhs), fp64."""
    with open(path, "rb") as f:
        classid, m, n, nnz = np.frombuffer(f.read(16), dtype=">i4")
        if classid != 1211216:
            raise ValueError(f"{path}: not a PETSc Mat file ({classid})")
        rownnz = np.frombuffer(f.read(4 * m), dtype=">i4")
        cols = np.frombuffer(f.read(4 * nnz), dtype=">i4").astype(np.int64)
        data = np.frombuffer(f.read(8 * nnz), dtype=">f8").astype(np.float64)
        indptr = np.concatenate([[0], np.cumsum(rownnz)]).astype(np.int64)
        vclass, vn = np.frombuffer(f.read(8), dtype=">i4")
        if vclass != 1211214:
            raise ValueError(f"{path}: no rhs vector after the matrix")
        b = np.frombuffer(f.read(8 * vn), dtype=">f8").astype(np.float64)
    return sp.csr_matrix((data, cols, indptr), shape=(m, n)), b


def ex10_oracle(tag):
    """(monitor stream, its, true residual) of an oracle_ex10 capture."""
    import re
    txt = open(os.path.join(TESTS_DATA, "oracle_ex10", tag + ".txt")).read()
    monit = [float(m.group(2)) for m in re.finditer(
        r"^\s*(\d+) KSP Residual norm (\S+)", txt, re.M)]
    its = int(re.search(r"Number of iterations\s*=\s*(\d+)", txt).group(1))
    rn = re.search(r"^\s*Residual norm (\S+)\s*$", txt, re.M)
    return monit, its, float(rn.group(1)) if rn else None


def energy(A, b_np, x):
    """CG's functional ½xᵀAx − bᵀx in fp64 on the host: it falls from 0
    at x0 = 0 with every CG step, where the residual need not."""
    x = x.double().cpu().numpy()
    return float(0.5 * x @ (A @ x) - b_np @ x)


def energy_falls(label, M, A, pc, b, b_np, stops, last):
    """CG's energy at the iterations `stops` (the solve cut there, its PC
    reused) and `last` (the full solve's): it must fall at every sample,
    as CG's does whatever its residual does, or, once CG has converged,
    stay within 1e-9 of its size (the rounding of x). Returns the
    energies."""
    es = []
    for k in stops:
        r = ksp_solve(M, b, pc=pc, ksp_type="cg", rtol=1e-30, maxits=k)
        if int(r.its) != k:
            raise AssertionError(f"{label}: the cut solve stopped at "
                                 f"{int(r.its)} its, not {k}")
        es.append(energy(A, b_np, r.x))
    es.append(last)
    print(f"{label}: energy ½xᵀAx−bᵀx at its {list(stops)} and the end: "
          + ", ".join(f"{e:.9e}" for e in es))
    if not (es[0] < 0 and all(e2 < e1 + 1e-9 * abs(e1)
                              for e1, e2 in zip(es, es[1:]))):
        raise AssertionError(f"{label}: CG's energy does not fall: {es}")
    return es


def noise_prefix(cpu, perturbed, rtol):
    """How many leading history entries of the CPU's solve every solve of
    `perturbed` (the same solve on a b changed by about an ulp) matches
    within rtol, entry by entry by history_diff's measure: the part of
    the history that rounding has not yet moved."""
    hc = cpu.history.numpy()
    lead = int(np.count_nonzero(~np.isnan(hc)))
    for p in perturbed:
        hp = p.history.numpy()
        m = min(lead, int(np.count_nonzero(~np.isnan(hp))))
        d = np.abs(hp[:m] - hc[:m]) / (np.abs(hc[:m])
                                       + 1e-3 * rtol * abs(hc[0]))
        bad = np.flatnonzero(~(d <= rtol))
        lead = int(bad[0]) if bad.size else m
    return lead


def same_solve_to_noise(label, card, cpu, perturbed, rtol, size=""):
    """Card against CPU for a solve that amplifies rounding (`perturbed`:
    the CPU's solves on b changed by about an ulp): equal its and reason;
    the history within rtol on its leading entries where every perturbed
    solve stays within rtol/10 of the CPU's (noise_prefix), at least half
    the history; max|x diff| within 30 times the perturbed solves' largest
    change of x, or 1e-12·max|x| (fp32: 1e-5) where that is larger."""
    ci, cr, hi, hr = (int(card.its), int(card.reason), int(cpu.its),
                      int(cpu.reason))
    hh = cpu.history.numpy()
    n = int(np.count_nonzero(~np.isnan(hh)))
    lead = noise_prefix(cpu, perturbed, rtol / 10)
    hc, hh = card.history.numpy()[:lead], hh[:lead]
    diff = float(np.max(np.abs(hc - hh) / (np.abs(hh) + 1e-3 * rtol
                                           * abs(hh[0])))) if lead else 0.0
    xc, xh = card.x.cpu().numpy(), cpu.x.numpy()
    xnoise = max(float(np.abs(p.x.numpy() - xh).max()) for p in perturbed)
    floor = (1e-12 if xh.dtype == np.float64 else 1e-5) * np.abs(xh).max()
    xbound = max(30 * xnoise, floor)
    xd = float(np.abs(xc - xh).max())
    print(f"{size} {label} card vs cpu: its {ci}/{hi} reason {cr}/{hr}; "
          f"history rel diff {diff:.2e} (bound {rtol:.0e}) on its first "
          f"{lead} of {n} entries, where {len(perturbed)} perturbed CPU "
          f"solves stay within {rtol / 10:.0e}; max|x diff| {xd:.2e} "
          f"(bound {xbound:.2e}: the perturbed solves move x by up to "
          f"{xnoise:.2e})")
    if ((ci, cr) != (hi, hr) or 2 * lead < n or not diff <= rtol
            or not xd <= xbound or not np.isfinite(xc).all()):
        raise AssertionError(f"{size} {label} on the card disagrees with "
                             "the CPU")
    return diff


def fixed_cg(M, A, pc_type, b):
    """KSP with FIXED_CG and pc_type on M (A the host matrix): (ksp,
    result, setup s, solve s)."""
    ksp = KSP(Options({**FIXED_CG, "pc_type": pc_type})).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    sync(b.device)
    setup_s = time.perf_counter() - t
    t = time.perf_counter()
    res = ksp.solve(b)
    sync(b.device)
    return ksp, res, setup_s, time.perf_counter() - t


def repeat_ms(ksp, b):
    """ms an iteration of a repeat of the solve."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = ksp.solve(b)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / int(res.its)


def baij_route_noise(M, A, b32, seeds=FMT_NOISE_SEEDS):
    """Phase 36's bound, on M's device: the history difference between
    the SellBAIJ route (K2) and its BAIJ's block ops, CG + pbjacobi for
    FMT_ITS its, and the block ops' own change under one-ulp changes of
    b (`seeds` of them). Runs on the CPU too (fmt="sell" there: K2's
    plain version): (route diff, noise)."""
    dev = M.device
    b = torch.from_numpy(b32).to(dev)
    blocks = M.block_ops()
    base = fixed_cg(blocks, A, "pbjacobi", b)[1]
    route = history_diff(fixed_cg(M, A, "pbjacobi", b)[1], base, 1e-2)
    noise = max(history_diff(fixed_cg(blocks, A, "pbjacobi", torch.from_numpy(
        ulp_changed(b32, s)).to(dev))[1], base, 1e-2) for s in range(seeds))
    return route, noise


def product_bound(nbytes, flops, fp64):
    """(bound ms, what bounds it) of a product moving nbytes and doing
    flops."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / (FP64_FLOPS_PER_S if fp64 else FP32_FLOPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def time_product(label, fn, nbytes, flops, fp64, csr_ms=None):
    """A PyTorch-op product (no hand kernel: petsctpu leaves it to XLA):
    a call back to back, 20 from a CUDA graph, against its bound."""
    fn()
    call_ms = time_ms(fn, runs=20, inner=5)
    device_ms = graph_ms(fn)
    bound_ms, by = product_bound(nbytes, flops, fp64)
    print(f"{label}: {device_ms:.4f} ms in a CUDA graph, {call_ms:.4f} ms a "
          f"call back to back; bound {bound_ms:.4f} ms by {by} ({nbytes} B, "
          f"{flops:.0f} flops; {100 * bound_ms / device_ms:.1f} %)"
          + ("" if csr_ms is None else f"; torch.mv CSR {csr_ms:.4f} ms"))
    return dict(ms=call_ms, device_ms=device_ms, bound_ms=bound_ms,
                bound_by=by)


def csr_ms(A, x):
    csr = csr_tensor(A, np.float64 if x.dtype == torch.float64
                     else np.float32)
    torch.mv(csr, x)
    return time_ms(lambda: torch.mv(csr, x), runs=20, inner=5)


def repeatable(label, fn, x):
    """Two calls on the same x are bit-equal (a fold plan, no atomics)."""
    y1, y2 = fn(x), fn(x)
    if not torch.equal(y1, y2):
        raise AssertionError(f"{label}: two calls on the same x differ")
    print(f"{label}: two calls on the same x bit-equal")
    return y1


def drive_baij_path(A, b_np, rng, triad_gbs):
    """Phase 36: ksp ex55 at FMT_NE in fp32 through mat_from_options
    (-mat_type baij -mat_block_size 2): SellBAIJ on the card, its forward
    product K2 on the block expansion; CG + pbjacobi for FMT_ITS its,
    counted, repeated and profiled; the same solve on the BAIJ's block
    ops, held within 30 times the card's own one-ulp noise; K2 on this
    pack bit for bit against its plain version; the products timed."""
    reset_counts()
    log_begin()
    t = time.perf_counter()
    M, perm = mat_from_options(A, Options({"mat_type": "baij", **BLOCKED}),
                               dtype=torch.float32)
    op_s = time.perf_counter() - t
    if perm is not None or not isinstance(M, SellBAIJ):
        raise AssertionError(f"slice 12: baij gave {type(M).__name__}")
    b = torch.from_numpy(b_np.astype(np.float32)).cuda()
    ksp, res, setup_s, secs = fixed_cg(M, A, "pbjacobi", b)
    its, reason = int(res.its), int(res.reason)
    k2 = sell_spmv.launches
    hist = res.history[:its + 1].numpy()
    e = energy(A, b_np, res.x)
    print(f"slice 12 baij: ex55 ne={FMT_NE} n={A.shape[0]} nnz={A.nnz}; "
          f"mat_from_options {op_s:.2f} s (SellBAIJ: K2 G={M.sell.G} "
          f"S={M.sell.S} P={M.sell.npass}; BAIJ K={M.cols.shape[1]}); "
          f"pbjacobi setup {setup_s:.3f} s; CG+pbjacobi its={its} "
          f"reason={reason} {secs:.3f} s = {1e3 * secs / its:.4f} ms/it; K2 "
          f"launches {k2}; history {hist[0]:.6e} -> {hist[-1]:.6e} (min "
          f"{hist.min():.6e}); energy ½xᵀAx−bᵀx {e:.6e}; true rel residual "
          f"{true_residual(A, b_np, res):.3e}")
    if not (its == FMT_ITS or reason > 0) or not np.isfinite(hist).all():
        raise AssertionError(f"slice 12 baij: its {its} reason {reason}, "
                             f"history finite {np.isfinite(hist).all()}")
    if k2 < its:
        raise AssertionError(f"slice 12 baij: K2 launched {k2} times in "
                             f"{its} its")
    print(f"slice 12 baij: ms per iteration {1e3 * secs / its:.4f} first, "
          f"{repeat_ms(ksp, b):.4f} repeated")
    profile_solve(ksp, b, label="slice 12 baij")
    energy_falls("slice 12 baij CG+pbjacobi", M, A, ksp.pc, b, b_np,
                 range(50, its, 50), e)
    t = time.perf_counter()
    route, noise = baij_route_noise(M, A, b_np.astype(np.float32))
    print(f"slice 12 baij: CG+pbjacobi on the BAIJ's block ops against K2: "
          f"history rel diff {route:.2e}; the block ops' own under one-ulp "
          f"changes of b {noise:.2e} ({FMT_NOISE_SEEDS} b, "
          f"{time.perf_counter() - t:.1f} s)")
    if not route <= 30 * noise:
        raise AssertionError(f"slice 12 baij: the routes differ by {route}, "
                             f"over 30 times the noise {noise}")
    Bm = M.block_ops()
    kb = KSP(Options({**FIXED_CG, "pc_type": "pbjacobi"})).set_operators(
        Bm, A)
    kb.set_from_options().setup()
    kb.solve(b)
    print(f"slice 12 baij: ms per iteration on the block ops "
          f"{repeat_ms(kb, b):.4f}")
    # the products
    C = sp.csr_matrix(sp.bsr_matrix(A, blocksize=(2, 2))).astype(np.float32)
    label = f"ex55 ne={FMT_NE} BAIJ expansion"
    xp, err = check_k2(C, M.sell, "cuda", rng, label)
    k2_times = measure(C, M.sell, xp, label=label, triad=False)
    x = xp.reshape(-1)[M.sell.G * 128:M.sell.G * 128 + C.shape[1]] \
        .contiguous()
    nb = (Bm.cols.numel() * 4 + Bm.vals.numel() * 4 + 2 * A.shape[0] * 4)
    cm = csr_ms(C, x)
    times = {"SellBAIJ.mult (K2)": dict(k2_times),
             "BAIJ.mult": time_product(
                 f"BAIJ.mult (block ops) at {label}", lambda: Bm.mult(x),
                 nb, 2.0 * Bm.vals.numel(), False, cm)}
    repeatable("BAIJ.multT", Bm.multT, x)
    times["BAIJ.multT"] = time_product(
        f"BAIJ.multT (fold plan, {Bm.transpose_fold().ranks} ranks) at "
        f"{label}", lambda: Bm.multT(x), nb, 2.0 * Bm.vals.numel(), False, cm)
    Ad = aij_from_scipy(C)
    times["ELL (the expansion)"] = measure_ell(label, C, Ad, x, triad_gbs)
    del Ad
    return dict(launches=k2, err=err, times=times)


def drive_sbaij_path(A, b_np, rng):
    """Phase 37: ksp ex55 at FMT_NE in fp64 on SBAIJ (-mat_type sbaij
    -mat_block_size 2), CG + ICC(0) (on the host matrix) for FMT_ITS its,
    SpTRSV counted in the solve, CG's energy falling; SpTRSV on both
    triangles bit for bit against its plain version and the ICC apply
    against the plain triangles composed; SBAIJ.mult against the fp64
    AIJ product, repeatable, and timed."""
    reset_counts()
    log_begin()
    t = time.perf_counter()
    M, _ = mat_from_options(A, Options({"mat_type": "sbaij", **BLOCKED}),
                            dtype=torch.float64)
    op_s = time.perf_counter() - t
    ksp = KSP(Options({**FIXED_CG, "pc_type": "icc"})).set_operators(M, A)
    t = time.perf_counter()
    ksp.set_from_options().setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    numeric, levels, plans, _ = setup_split()
    b = torch.from_numpy(b_np).cuda()
    torch.cuda.reset_peak_memory_stats()
    before = dict(sptrsv=sptrsv.launches, sptrsv_lu=sptrsv_lu.launches,
                  ell_spmv=ell_spmv.launches)
    res, secs, applies, trsv, _ = solve_counted(ksp, b)
    launched = dict(sptrsv=sptrsv.launches, sptrsv_lu=sptrsv_lu.launches,
                    ell_spmv=ell_spmv.launches)
    launched = {k: v - before[k] for k, v in launched.items()}
    its, reason = int(res.its), int(res.reason)
    hist = res.history[:its + 1].numpy()
    e = energy(A, b_np, res.x)
    pl = ksp.pc.Lplan
    print(f"slice 12 sbaij: ex55 ne={FMT_NE} fp64 SBAIJ K={M.bcols.shape[1]} "
          f"nnzb={M.nnzb}; mat_from_options {op_s:.2f} s; ICC(0) setup "
          f"{setup_s:.2f} s = factor numerics {numeric:.2f} + levels "
          f"{levels:.2f} + plans {plans:.2f}; {pl.nlev} levels a triangle; "
          f"CG+icc its={its} reason={reason} {secs:.3f} s = "
          f"{1e3 * secs / its:.4f} ms/it; {applies} PC applies, {trsv} "
          f"SpTRSV launches ({before['sptrsv'] + before['sptrsv_lu']} "
          f"before the solve, since the counts were reset); history "
          f"{hist[0]:.6e} -> {hist[-1]:.6e}; energy "
          f"{e:.6e}; true rel residual {true_residual(A, b_np, res):.3e}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (its == FMT_ITS or reason > 0) or not np.isfinite(hist).all():
        raise AssertionError(f"slice 12 sbaij: its {its} reason {reason}")
    if trsv != 2 * applies or launched["sptrsv"] + launched["sptrsv_lu"] \
            != trsv:
        raise AssertionError(f"slice 12 sbaij: {trsv} SpTRSV launches for "
                             f"{applies} ICC applies ({launched})")
    print(f"slice 12 sbaij: ms per iteration {1e3 * secs / its:.4f} first, "
          f"{repeat_ms(ksp, b):.4f} repeated")
    profile_solve(ksp, b, label="slice 12 sbaij")
    energy_falls("slice 12 sbaij CG+icc", M, A, ksp.pc, b, b_np,
                 [k for k in (FMT_ITS // 3, 2 * FMT_ITS // 3) if k < its], e)
    pc = ksp.pc
    err = max(check_sptrsv(f"ex55 ne={FMT_NE} ICC(0) {name}", plan, rng)[0]
              for name, plan in (("Uᵀ (L)", pc.Lplan), ("U", pc.Uplan)))
    r = torch.from_numpy(rng.standard_normal(A.shape[0])).cuda()
    z = pc.apply(r)
    zp = sptrsv_plain(*pc.Uplan.order, (pc.dinv * sptrsv_plain(
        *pc.Lplan.order, r[None])[0])[None])[0]
    err = max(err, float((z - zp).abs().max()))
    print(f"slice 12 sbaij: the ICC apply against the plain triangles "
          f"composed: max abs diff {float((z - zp).abs().max())}")
    if not torch.equal(z, zp):
        raise AssertionError("slice 12 sbaij: the ICC apply differs from "
                             "its plain triangles")
    Ad = aij_from_scipy(A)
    worst = 0.0
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal(A.shape[0])).cuda()
        y, ya = repeatable("SBAIJ.mult", M.mult, x), Ad.mult(x)
        worst = max(worst, float((y - ya).abs().max() / ya.abs().max()))
    print(f"slice 12 sbaij: SBAIJ.mult against the fp64 AIJ product on 3 x: "
          f"max rel diff {worst:.2e}")
    if not worst <= 1e-13:
        raise AssertionError(f"slice 12 sbaij: SBAIJ.mult off by {worst}")
    nb = M.bcols.numel() * 4 + M.bvals.numel() * 8 + 2 * A.shape[0] * 8
    times = time_product(
        f"SBAIJ.mult (fold plan, {M.transpose_fold().ranks} ranks) at ex55 "
        f"ne={FMT_NE} fp64", lambda: M.mult(x), nb, M.flops_per_mult(),
        True, csr_ms(A, x))
    return dict(launched=launched, err=err, times=times)


def fmt_small_solves(devices=("cuda", "cpu")):
    """Phase 38: ex55 at FMT_SMALL_NE on the card against the CPU: fp64
    BAIJ and SBAIJ with CG + pbjacobi and + jacobi, SBAIJ with CG + ICC(0),
    to rtol 1e-5 (same_solve_to_noise at 1e-8 against two CPU solves on b
    changed by 1e-15, one for ICC), fp32 SellBAIJ (fmt "sell", K2's plain version on
    the CPU) with CG + pbjacobi for b and two one-ulp changes of b (at
    1e-3 against FMT_ULP_SEEDS CPU solves on one-ulp changes of b); then
    the blocked ex10 goldens on the card."""
    A, b, _ = ex55_system(FMT_SMALL_NE, 1e-3)
    size = f"ne={FMT_SMALL_NE}"
    worst = 0.0
    cpu = devices[-1]
    for mat_type, pc_type in (("baij", "pbjacobi"), ("baij", "jacobi"),
                              ("sbaij", "pbjacobi"), ("sbaij", "jacobi"),
                              ("sbaij", "icc")):
        o = {"ksp_type": "cg", "ksp_rtol": "1e-5", "pc_type": pc_type}

        def run(dev, rhs):
            M, _ = mat_from_options(A, Options({"mat_type": mat_type,
                                                **BLOCKED}), device=dev)
            return KSP(Options(o)).set_operators(M, A).solve(
                torch.from_numpy(rhs).to(dev))
        out = [run(dev, b) for dev in devices]
        # ICC's solve barely amplifies rounding (x moves by ~1e-13 under
        # a 1e-15 change of b) and is the CPU's slowest: one such solve
        seeds = (1,) if pc_type == "icc" else (1, 2)
        perturbed = [run(cpu, b_changed(b, s)) for s in seeds]
        worst = max(worst, same_solve_to_noise(
            f"ex55 {mat_type} CG+{pc_type} fp64", *out, perturbed, 1e-8,
            size=size))
    b32 = b.astype(np.float32)
    Ms = {dev: baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="sell",
                                   device=dev) for dev in devices}
    o = {"ksp_type": "cg", "ksp_rtol": "1e-5", "pc_type": "pbjacobi"}

    def run(dev, rhs):
        return KSP(Options(o)).set_operators(Ms[dev], A).solve(
            torch.from_numpy(rhs).to(dev))
    for name, rhs in (("b", b32), ("b one ulp off (seed 0)",
                                   ulp_changed(b32, 0)),
                      ("b one ulp off (seed 1)", ulp_changed(b32, 1))):
        perturbed = [run(cpu, ulp_changed(rhs, 100 + s))
                     for s in range(FMT_ULP_SEEDS)]
        worst = max(worst, same_solve_to_noise(
            f"ex55 SellBAIJ CG+pbjacobi fp32, {name}",
            *[run(dev, rhs) for dev in devices], perturbed, 1e-3, size=size))
    check_ex10_blocked(devices[0])
    return worst


def check_ex10_blocked(dev="cuda"):
    """The blocked configs of tests/test_golden_ex10.py on `dev`, with
    that test's bounds: exact its, the stream within 2e-5, the true
    residual within 2e-4."""
    for tag, (fname, mat_type, bs, ksp_t, pc_t) in EX10_BLOCKED.items():
        A, b = read_ex10_system(os.path.join(TESTS_DATA, fname))
        monit, its_ref, rnorm = ex10_oracle(tag)
        make = baij_from_scipy_bsr if mat_type == "baij" \
            else sbaij_from_scipy
        M = make(A, bs=bs, dtype=np.float64, device=dev)
        r = ksp_solve(M, torch.from_numpy(b).to(dev), pc=make_pc(
            pc_t, A=M, A_host=A), ksp_type=ksp_t, rtol=1e-5, maxits=400)
        h = r.history[:len(monit)].numpy()
        rel = float(np.max(np.abs(h - monit) / np.abs(monit)))
        tr = float(np.linalg.norm(b - A @ r.x.cpu().numpy()))
        print(f"ex10 golden {tag} on {dev}: its {int(r.its)}/{its_ref}, "
              f"stream rel diff {rel:.2e}, true residual {tr:.6e} against "
              f"{rnorm:.6e}")
        if int(r.its) != its_ref or not rel <= 2e-5 or \
                not abs(tr - rnorm) <= 2e-4 * max(rnorm, 1e-12) + 1e-9:
            raise AssertionError(f"ex10 golden {tag} fails on {dev}")


def fmt_rest_cases():
    """Phase 39's solves: (label, builder(dev) -> (operator, pc, b), ksp
    kwargs, history bound)."""
    A45, b45, _ = ex45_system(BAND_GRID, BAND_GRID, BAND_GRID)
    A16 = sp.csr_matrix(ex45_system(16, 16, 16)[0])
    L2 = laplacian_2d(48, 48)
    cases = []
    # band in RCM order (the default); dia in the natural order, where
    # ex45 has 7 diagonals (RCM's fill passes DiaMat's max_fill)
    for mt, order in (("band", "rcm"), ("dia", "natural")):
        def build(dev, mt=mt, order=order):
            M, perm = mat_from_options(A45, Options(
                {"mat_type": mt, "mat_ordering_type": order}), device=dev)
            return M, make_pc("jacobi", A=M), b45[perm]
        cases.append((f"ex45 {BAND_GRID}^3 -mat_type {mt} ({order}) "
                      "CG+jacobi", build, dict(ksp_type="cg", rtol=1e-5),
                      1e-8))
    for tri in ("band", "band2"):
        def build(dev, tri=tri):
            M = aij_from_scipy(A16, device=dev)
            return M, make_pc("ilu", A=M, A_host=A16, options=Options(
                {"pc_factor_tri_solve": tri})), A16 @ np.ones(A16.shape[0])
        cases.append((f"ex45 16^3 GMRES+ILU(0) tri {tri}", build,
                      dict(ksp_type="gmres", rtol=1e-8), 1e-8))

    def gamg_band(dev):
        M = aij_from_scipy(L2, device=dev)
        return M, make_pc("gamg", A=M, A_host=L2, options=Options(
            {"pc_gamg_mat_type": "band", "pc_gamg_coarse_eq_limit": "50"})), \
            L2 @ np.ones(L2.shape[0])
    cases.append(("2-D 48^2 CG+gamg -pc_gamg_mat_type band", gamg_band,
                  dict(ksp_type="cg", rtol=1e-8), 1e-8))
    for name in ("nn", "bddc"):
        def dd(dev, name=name):
            M = matis_poisson_2d(16, 2, device=dev)
            xex = np.random.default_rng(12).standard_normal(M.shape[0])
            return M, make_pc(name, A=M), M.assemble_host() @ xex
        cases.append((f"MatIS 4 subdomains FGMRES+{name}", dd,
                      dict(ksp_type="fgmres", rtol=1e-8, maxits=200), 1e-8))

    def fft(dev):
        M = aij_from_scipy(L2, device=dev)
        return M, make_pc("fft", A=M, options=Options(
            {"pc_fft_dims": (48, 48)})), np.ones(L2.shape[0])
    cases.append(("2-D 48^2 GMRES+fft", fft,
                  dict(ksp_type="gmres", rtol=1e-10, maxits=5), 1e-8))
    return cases


def fmt_rest(rng, devices=("cuda", "cpu")):
    """Phase 39: the rest of the Mat formats on the card against the CPU:
    band, dia, the banded ILU routes, GAMG on BandMat levels, NN and
    BDDC, the FFT PC (same_solve_to_noise at each case's bound against a
    CPU solve on b changed by 1e-15); MAIJ, Nest and ell_from_coo with
    duplicates; AIJ.multT
    repeatable and equal to the CPU's bits. Then BandMat.mult and
    DiaMat.mult timed on the natural-order BAND_TIME_M² 5-point Laplacian
    beside the ELL kernel and CSR mv."""
    worst = 0.0
    for label, build, kw, bound in fmt_rest_cases():
        out = []
        for dev in devices:
            M, pc, b = build(dev)
            out.append(ksp_solve(M, torch.from_numpy(b).to(dev), pc=pc, **kw))
        # an entry at rounding level (the FFT PC's exact solve leaves
        # ~1e-13 of r0) lies past the history's prefix that a 1e-15
        # change of b leaves within bound/10; x is held there
        perturbed = [ksp_solve(M, torch.from_numpy(b_changed(b)), pc=pc,
                               **kw)]
        worst = max(worst, same_solve_to_noise(label, *out, perturbed,
                                               bound))
    A = laplacian_2d(20, 20)
    B = sp.random(400, 90, density=0.05, random_state=3, format="csr")
    x = rng.standard_normal(1200)
    xs = rng.standard_normal(490)
    rows = rng.integers(-1, 401, 5000)
    cols = rng.integers(0, 400, 5000)
    rows[:40], cols[:40] = 7, 9                 # a run of 40 duplicates
    vals = rng.standard_normal(5000)
    res = {}
    for dev in devices:
        def T(a):
            return torch.from_numpy(a).to(dev)
        Ad = aij_from_scipy(A, device=dev)
        Mm = MAIJ(Ad, dof=3)
        N = make_nest([[Ad, aij_from_scipy(B, device=dev)],
                       [aij_from_scipy(B.T.tocsr(), device=dev), None]])
        E = ell_from_coo(T(rows), T(cols), T(vals), (400, 400), 24)
        Ar = aij_from_scipy(sp.random(400, 300, density=0.04, random_state=4,
                                      format="csr"), device=dev)
        xr = T(x[:400])
        yT = Ar.multT(xr)
        if not torch.equal(yT, Ar.multT(xr)):
            raise AssertionError(f"AIJ.multT on {dev}: two calls differ")
        res[dev] = [Mm.mult(T(x)), Mm.multT(T(x)), N.mult(T(xs)),
                    N.multT(T(xs)), E.cols.to(torch.int64), E.vals, yT]
    names = ("MAIJ.mult", "MAIJ.multT", "Nest.mult", "Nest.multT",
             "ell_from_coo cols", "ell_from_coo vals", "AIJ.multT")
    for name, a, c in zip(names, *(res[d] for d in devices)):
        a = a.cpu()
        d = float((a - c).abs().max() / c.abs().max())
        exact = name.startswith("ell_from_coo") or name == "AIJ.multT"
        print(f"{name} card vs cpu: rel diff {d:.2e}"
              + (" (bit-equal required)" if exact else ""))
        if (exact and not torch.equal(a, c)) or not d <= 1e-13:
            raise AssertionError(f"{name}: the card disagrees with the CPU")
    return worst


def time_band_dia(triad_gbs):
    """BandMat.mult and DiaMat.mult on the natural-order BAND_TIME_M²
    5-point Laplacian (fp64), beside AIJ.mult (the ELL kernel) and CSR
    mv: input for the GPU format policy."""
    A = laplacian_2d(BAND_TIME_M, BAND_TIME_M)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.shape[0])).cuda()
    label = f"{BAND_TIME_M}^2 5-point fp64"
    cm = csr_ms(A, x)
    Bm = band_from_scipy(A)
    Dm = dia_from_scipy(A)
    ya = aij_from_scipy(A).mult(x)
    for M in (Bm, Dm):
        d = float((M.mult(x) - ya).abs().max() / ya.abs().max())
        if not d <= 1e-14:
            raise AssertionError(f"{type(M).__name__}.mult off by {d}")
    n, es = A.shape[0], 8
    times = {
        "BandMat.mult": time_product(
            f"BandMat.mult at {label} (B={Bm.bandwidth}, T={Bm.tile}, "
            f"tiles {tuple(Bm.tiles.shape)})", lambda: Bm.mult(x),
            Bm.traffic_per_mult(), 2.0 * Bm.tiles.numel(), True, cm),
        "DiaMat.mult": time_product(
            f"DiaMat.mult at {label} ({len(Dm.offsets)} diagonals)",
            lambda: Dm.mult(x), Dm.traffic_per_mult(),
            2.0 * Dm.coeffs.numel(), True, cm)}
    print(f"the same product's least bytes (the nonzeros, their int32 "
          f"columns, x and y): {A.nnz * (es + 4) + 2 * n * es} B")
    times[f"ELL {BAND_TIME_M}^2"] = measure_ell(label, A, aij_from_scipy(A),
                                                x, triad_gbs)
    del Bm
    return times


def slice12_phases(rng, kernels, triad_gbs):
    """Slice 12: ex55 on SellBAIJ (phase 36) and SBAIJ (37), both formats
    small card against CPU with the blocked ex10 goldens (38), the rest
    of item 9 card against CPU and BandMat/DiaMat timed (39). Adds the
    paths' K2 and SpTRSV launches and K2's error to the kernels line."""
    t = time.perf_counter()
    A, b, _ = ex55_system(FMT_NE, 1e-3)
    print(f"ex55 ne={FMT_NE}: n={A.shape[0]} nnz={A.nnz} "
          f"({time.perf_counter() - t:.1f} s)")
    baij = drive_baij_path(A, b, rng, triad_gbs)
    kernels["sell_spmv"]["launches"] += baij["launches"]
    kernels["sell_spmv"]["max_abs_err"] = max(
        kernels["sell_spmv"]["max_abs_err"], baij["err"])
    print(f"slice 12: phase 36 in {time.perf_counter() - t:.1f} s")
    sbaij = drive_sbaij_path(A, b, rng)
    print(f"slice 12: phases 36-37 in {time.perf_counter() - t:.1f} s")
    del A, b
    for name in ("sptrsv", "sptrsv_lu", "ell_spmv"):
        if name in kernels:
            kernels[name]["launches"] += sbaij["launched"][name]
    kernels["sptrsv"]["max_abs_err"] = max(kernels["sptrsv"]["max_abs_err"],
                                           sbaij["err"])
    fmt_small_solves()
    print(f"slice 12: phases 36-38 in {time.perf_counter() - t:.1f} s")
    fmt_rest(rng)
    times = dict(baij["times"], **{"SBAIJ.mult": sbaij["times"]},
                 **time_band_dia(triad_gbs))
    print("slice 12 products: " + json.dumps(times))
    print(f"slice 12 in {time.perf_counter() - t:.1f} s")


T0 = time.perf_counter()


def main(argv=()):
    name, smi = device_info()
    build_kernels()
    rng = np.random.default_rng(0)
    if list(argv) in (["slice7"], ["slice8"], ["slice9"], ["slice11"],
                      ["slice12"]):
        kernels = {k: dict(name=k, launches=0, max_abs_err=0.0)
                   for k in ("sell_spmv", "sell_spmvT", "stencil_mult",
                             "sptrsv", "sptrsv_lu")}
        if argv[0] == "slice7":
            slice7_phases(rng, kernels)
        elif argv[0] == "slice8":
            slice8_phases(rng, kernels, stream_triad_gbs(1 << 28))
        elif argv[0] == "slice11":
            slice11_phases(rng, kernels)
        elif argv[0] == "slice12":
            kernels["ell_spmv"] = dict(name="ell_spmv", launches=0,
                                       max_abs_err=0.0)
            slice12_phases(rng, kernels, stream_triad_gbs(1 << 28))
        else:
            triad = stream_triad_gbs(1 << 28)
            ell = slice9_phases(rng, kernels, triad)
            ex43 = ex43_ell_phase(triad, rng)
            kernels["ell_spmv"] = dict(ell, max_abs_err=max(
                ell["max_abs_err"], ex43["max_abs_err"]))
        print(smi)
        print(f"{argv[0]} in {time.perf_counter() - T0:.1f} s")
        print(json.dumps({argv[0]: list(kernels.values())}))
        return
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
    trsv, trsv_lu = slice5_phases(A, b, Mp, stream_triad_gbs(), rng)
    k2_s6, lu_s6 = slice6_phases(A, b, Mp)
    launches += k2_s6
    trsv_lu["launches"] += lu_s6
    del A, b, M, xp, Mp, bp, R
    mg = drive_mg_path()
    check_mg_small_against_cpu()
    k1_err, k1_times = k1_phases(mg, rng)
    mg_err, mg_lu_err = mg_sptrsv_check(mg, rng)
    trsv["max_abs_err"] = max(trsv["max_abs_err"], mg_err)
    trsv_lu["max_abs_err"] = max(trsv_lu["max_abs_err"], mg_lu_err)
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
                    **k3_times[0]), trsv, trsv_lu]
    del gamg, k3_levels
    slice7_phases(rng, {k["name"]: k for k in kernels})
    triad = stream_triad_gbs(1 << 28)
    slice8_phases(rng, {k["name"]: k for k in kernels}, triad)
    kernels.append(slice9_phases(rng, {k["name"]: k for k in kernels},
                                 triad))
    slice11_phases(rng, {k["name"]: k for k in kernels})
    slice12_phases(rng, {k["name"]: k for k in kernels}, triad)
    kernels += probes_phase()
    print(smi)
    print(f"chip_smoke.py in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
