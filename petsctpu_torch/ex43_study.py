"""Two studies of ksp ex43 (Q1-Q1 SolCx Stokes) through the port.

    python -m petsctpu_torch.ex43_study errors [--device D] MX [MX ...]
    python -m petsctpu_torch.ex43_study noise [--device D]

`errors` solves ex43 (SolCx, η₁/η₀ = 1e6, xc = 0.5, nz = 2) at each mx =
my with FGMRES + symmetric_multiplicative fieldsplit, GAMG(dof 2) on
the velocity and Jacobi on the pressure, to rtol 1e-8, and prints its,
the true relative residual and the DMDAIntegrateErrors line (h, p L2,
u L2, u H1). An odd mx puts the viscosity jump at x = 0.5 inside an
element column.

`noise` measures how far a 1e-15 relative change of b moves the port's
own FGMRES history, for each fieldsplit type (LU on the velocity,
Jacobi on the pressure) on ex43 and on the MAC Stokes model with its
pressure null space: the largest change of an entry, relative to the
entry and to ‖r0‖. A stream that such a change moves past a bound
cannot be held to that bound against another package or device.

Both run on the CUDA device unless given `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat.nullspace import make_nullspace
from petsctpu_torch.models.q1stokes import (integrate_errors,
                                            q1q1_stokes_system,
                                            solcx_nodal_solution)
from petsctpu_torch.models.stokes import stokes_mac
from petsctpu_torch.pc.fieldsplit import make_fieldsplit

SOLCX = dict(eta0=1.0, eta1=1.0e6, xc=0.5, nz=2)
GAMG = {"pc_fieldsplit_type": "symmetric_multiplicative",
        "fieldsplit_0_pc_type": "gamg", "fieldsplit_0_pc_gamg_dof": "2",
        "fieldsplit_1_pc_type": "jacobi"}
TYPES = (("additive", None), ("multiplicative", None),
         ("symmetric_multiplicative", None), ("schur", "diag"),
         ("schur", "lower"), ("schur", "upper"), ("schur", "full"))
# (mx, η₁, types) of each ex43 system the noise study reads: the Schur
# types only at mx = 8 (their inner GMRES of up to 100 LU solves an
# outer iteration takes minutes at mx = 12 on a CPU)
EX43_NOISE = ((8, 1e6, TYPES), (12, 1e2, TYPES[:3]), (20, 1e6, TYPES[:3]))


def ex43(mx, eta1=1e6):
    A, B, f = q1q1_stokes_system(mx, mx, c_str=0, **{**SOLCX, "eta1": eta1})
    c = np.arange(A.shape[0]) % 3
    return A, B, f, [np.flatnonzero(c != 2), np.flatnonzero(c == 2)]


def errors(mxs, dev):
    for mx in mxs:
        A, B, f, fields = ex43(mx)
        pc = make_fieldsplit(B, fields, options=Options(dict(GAMG)),
                             Amat_host=A, device=dev)
        r = ksp_solve(aij_from_scipy(A, device=dev),
                      torch.from_numpy(f).to(dev), pc=pc, ksp_type="fgmres",
                      rtol=1e-8, maxits=10000)
        x = r.x.cpu().numpy()
        h, p, u, uh = integrate_errors(
            mx, mx, x, solcx_nodal_solution(mx, mx, **SOLCX))
        rel = np.linalg.norm(f - A @ x) / np.linalg.norm(f)
        print(f"ex43 mx={mx}: its {int(r.its)} reason {int(r.reason)} true "
              f"rel residual {rel:.3e}; h {h:1.4e} p L2 {p:1.4e} u L2 "
              f"{u:1.4e} u H1 {uh:1.4e}")


def history_change(solve, b, seed=1):
    """(its, its', max relative change, max change / ‖r0‖) of the history
    under b·(1 + 1e-15·N(0,1))."""
    noise = np.random.default_rng(seed).standard_normal(b.size)
    hs = [solve(bb) for bb in (b, b * (1 + 1e-15 * noise))]
    k = min(map(len, hs))
    d = np.abs(hs[0][:k] - hs[1][:k])
    return (len(hs[0]) - 1, len(hs[1]) - 1,
            float(np.max(d / np.abs(hs[0][:k]))), float(d.max() / hs[0][0]))


def noise(dev):
    systems = [(f"ex43 mx={mx} eta1={eta1:g}", *ex43(mx, eta1), None, types)
               for mx, eta1, types in EX43_NOISE]
    K, bk, (vi, pi), _ = stokes_mac(8)
    v = np.zeros(K.shape[0])
    v[pi] = 1.0
    systems.append(("stokes_mac(8)", K, K, bk, [vi, pi],
                    make_nullspace(K.shape[0], has_constant=False, vecs=[v],
                                   device=dev), TYPES))
    for label, A, B, f, fields, nsp, types in systems:
        Ad = aij_from_scipy(A, device=dev)
        for fs_type, fact in types:
            o = {"pc_fieldsplit_type": fs_type, "fieldsplit_0_pc_type": "lu",
                 "fieldsplit_1_pc_type": "jacobi"}
            if fact:
                o["pc_fieldsplit_schur_fact_type"] = fact
            pc = make_fieldsplit(B, fields, options=Options(o),
                                 Amat_host=A if B is not A else None,
                                 device=dev)

            def solve(b):
                r = ksp_solve(Ad, torch.from_numpy(b).to(dev), pc=pc,
                              ksp_type="fgmres", rtol=1e-8, maxits=200,
                              nullspace=nsp)
                return r.history.numpy()[:int(r.its) + 1]

            its, its2, rel, abs_r0 = history_change(solve, f)
            print(f"{label} {fs_type} {fact or ''}: its {its}/{its2}, "
                  f"history change {rel:.2e} relative, {abs_r0:.2e}·‖r0‖")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("study", choices=("errors", "noise"))
    ap.add_argument("mx", nargs="*", type=int)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.study == "errors":
        errors(args.mx, dev)
    else:
        noise(dev)


if __name__ == "__main__":
    main()
