"""Time the PyTorch-op forms of the blocked products on the card.

BAIJ.mult, SBAIJ.mult, the fold plan's rank step and PBJacobi's apply
are PyTorch ops (petsctpu leaves them to XLA). This script times each
op form they could take, at ksp ex55's ne = 1023 shapes (1,048,576
block rows of 2×2 blocks, 9 blocks a row; the upper triangle's 5),
with the pack's real pattern and random values, 20 calls from a CUDA
graph each, and checks that the forms agree:

  python3 scripts/bench_formats.py [--ne 1023]

Prints one line a form and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from petsctpu_torch.mat.bsr import baij_from_scipy_bsr  # noqa: E402
from petsctpu_torch.mat.sbaij import sbaij_from_scipy  # noqa: E402
from petsctpu_torch.models.elasticity import ex55_system  # noqa: E402
from petsctpu_torch.timing import graph_ms  # noqa: E402


def line(label, fn, ref=None):
    y = fn()
    ms = graph_ms(fn)
    d = "" if ref is None else "; max rel diff to the first form " \
        f"{float((y - ref).abs().max() / ref.abs().max()):.1e}"
    print(f"  {label}: {ms:.4f} ms{d}")
    return y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ne", type=int, default=1023)
    ne = ap.parse_args().ne
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    A, _, _ = ex55_system(ne, 1e-3)
    rng = np.random.default_rng(0)
    B = baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="ell")
    x = torch.from_numpy(rng.standard_normal(A.shape[0]).astype(
        np.float32)).cuda()
    V, C = B.vals, B.cols
    print(f"BAIJ.mult, fp32, brows {B.brows}, K {C.shape[1]}:")
    g = x.reshape(-1, 2)[C]
    ref = line("einsum rkij,rkj->ri (the gather included)",
               lambda: torch.einsum("rkij,rkj->ri", V, x.reshape(-1, 2)[C]))
    line("gather, product, sum over (k, j)",
         lambda: (V * x.reshape(-1, 2)[C][:, :, None, :]).sum((1, 3)), ref)
    Vt = V.permute(0, 2, 1, 3).reshape(B.brows, 2, -1).contiguous()
    line("bmm of [r, i, k·j] by the gathered [r, k·j, 1]",
         lambda: torch.bmm(Vt, x.reshape(-1, 2)[C].reshape(
             B.brows, -1, 1))[..., 0], ref)
    line("matmul of [r, i, k·j] by [r, k·j, 1] (the same, matmul)",
         lambda: (Vt @ x.reshape(-1, 2)[C].reshape(B.brows, -1, 1))[..., 0],
         ref)
    line("gather alone", lambda: x.reshape(-1, 2)[C])
    print("PBJacobi apply, fp32 [nb, 2, 2] by [nb, 2]:")
    binv = torch.linalg.inv(B.diag_blocks())
    xb = x.reshape(-1, 2)
    ref = line("einsum bij,bj->bi",
               lambda: torch.einsum("bij,bj->bi", binv, xb))
    line("product and sum over j", lambda: (binv * xb[:, None, :]).sum(-1),
         ref)
    line("two columns by hand", lambda: binv[:, :, 0] * xb[:, :1]
         + binv[:, :, 1] * xb[:, 1:], ref)
    S = sbaij_from_scipy(A, bs=2, dtype=np.float64)
    S.bcols, S.bvals = S.bcols.cuda(), S.bvals.cuda()
    x64 = x.double()
    plan = S.transpose_fold()
    plan.src, plan.tgt = plan.src.cuda(), plan.tgt.cuda()
    contrib = torch.einsum("rkij,ri->rkj", S.bvals,
                           x64.reshape(-1, 2)).reshape(-1, 2).contiguous()
    y0 = torch.zeros(S.brows, 2, dtype=torch.float64, device="cuda")
    s, e = plan.offsets[0], plan.offsets[1]
    t, src = plan.tgt[s:e], plan.src[s:e]
    print(f"a fold rank step, fp64 rows of 2, {e - s} slots "
          f"(SBAIJ's rank 0 of {plan.ranks}):")
    ref = line("index_select, add, index_put_", lambda: y0.clone().index_put_(
        (t,), y0.index_select(0, t) + contrib.index_select(0, src)))
    line("advanced indexing, add, index_put_", lambda: y0.clone().index_put_(
        (t,), y0[t] + contrib[src]), ref)
    flat = (src[:, None] * 2 + torch.arange(2, device="cuda")).reshape(-1)
    line("index_select of a flat view (2 scalars an index)",
         lambda: contrib.view(-1).index_select(0, flat))
    line("index_select alone", lambda: contrib.index_select(0, src))
    line("advanced indexing alone", lambda: contrib[src])
    line("index_put_ alone", lambda: y0.clone().index_put_(
        (t,), contrib[:e - s]))
    print("SBAIJ contributions, fp64:")
    ref = line("einsum rkij,ri->rkj", lambda: torch.einsum(
        "rkij,ri->rkj", S.bvals, x64.reshape(-1, 2)))
    line("product and sum over i", lambda: (
        S.bvals * x64.reshape(-1, 2)[:, None, :, None]).sum(2), ref)


if __name__ == "__main__":
    main()
