"""The parts every probe case shares: the Case record, the bound, the
CSR yardstick, and the check and measurement of one case."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.timing import (FP32_FLOPS_PER_S, HBM_BYTES_PER_S,
                                   graph_ms, time_ms)

REL_TOL = 1e-5             # sums: fp32 adds in another order than numpy's


@dataclass
class Case:
    """One TPU probe kernel, rebuilt from its script's seed.

    `run` calls the port's kernel wrapper on the case's inputs, `plain`
    its plain PyTorch version, `emulate` the script's numpy emulation.
    `nbytes` counts the bytes the function must move on this run's data:
    every element of an input it reads, once, and the output once; an
    element no index of the case reaches is not counted. `library` and
    `k2`, where given, build (at first use) and return a
    call of one PyTorch operation computing the same function, and of K2
    on the same data in K2's uniform layout."""

    name: str
    kernel: str
    replaces: str
    run: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    emulate: Callable[[], np.ndarray]
    exact: bool
    nbytes: Callable[[], int]
    flops: int
    library: Optional[Callable[[], Callable[[], torch.Tensor]]] = None
    k2: Optional[Callable[[], Callable[[], torch.Tensor]]] = None


def nbytes(*tensors) -> int:
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def distinct(flat: torch.Tensor, n: int) -> int:
    """How many of the n elements of an array the flat indices reach."""
    seen = torch.zeros(n, dtype=torch.bool, device=flat.device)
    seen[flat.reshape(-1)] = True
    return int(seen.sum())


def tensors(dev, *arrays):
    """The numpy arrays as contiguous tensors on dev."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def csr(rows, cols, vals, shape) -> torch.Tensor:
    """The CSR matrix of the (row, col, val) triples, duplicates summed."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def bound(case: Case) -> dict:
    """The least time the card could take (bound_ms), by the case's
    compulsory bytes at 3.35 TB/s or its fp32 operations at 67 TFLOP/s,
    whichever is longer (bound_by), with the bytes counted."""
    nb = case.nbytes()
    by_bytes = nb / HBM_BYTES_PER_S * 1e3
    by_ops = case.flops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), nbytes=nb,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _rel(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def check(case: Case, out: torch.Tensor) -> dict:
    """The kernel's output against its plain version (bit for bit) and
    the script's emulation (exact for a gather, else within REL_TOL of
    max|emulation|); raises AssertionError on a mismatch."""
    plain = case.plain()
    if out.shape != plain.shape or not torch.equal(out, plain):
        raise AssertionError(f"{case.name}: {case.kernel} differs from its "
                             f"plain version")
    got = out.cpu().numpy()
    emul = case.emulate()
    if got.shape != emul.shape or not np.isfinite(got).all():
        raise AssertionError(f"{case.name}: output {got.shape} against the "
                             f"emulation's {emul.shape}, or not finite")
    err = float(np.abs(got - emul).max()) if case.exact else _rel(got, emul)
    if not (err == 0 if case.exact else err <= REL_TOL):
        raise AssertionError(f"{case.name}: {'max abs' if case.exact else 'rel'}"
                             f" error {err} against the script's emulation")
    return dict(name=case.name, kernel=case.kernel, replaces=case.replaces,
                max_abs_err=float((out - plain).abs().max()),
                emulation_err=err, out=out)


def measure(case: Case, out: torch.Tensor) -> dict:
    """Times on the card: the kernel (back-to-back calls, and replayed
    from a CUDA graph), its plain version, the library call and K2 where
    the case has them."""
    ms = time_ms(case.run)
    plain_ms = time_ms(case.plain, runs=5, inner=1, warmup=1)
    res = dict(ms=ms, graph_ms=graph_ms(case.run), plain_ms=plain_ms,
               library_ms=None)
    if case.library is not None:
        lib = case.library()
        rel = _rel(lib().reshape(-1).cpu().numpy(),
                   out.reshape(-1).cpu().numpy())
        if not (rel == 0 if case.exact else rel <= REL_TOL):
            raise AssertionError(f"{case.name}: the library call disagrees "
                                 f"with the kernel ({rel})")
        res["library_ms"] = time_ms(lib)
    if case.k2 is not None:
        k2 = case.k2()
        rel = _rel(k2().reshape(-1).cpu().numpy(),
                   out.reshape(-1).cpu().numpy())
        if not rel <= REL_TOL:
            raise AssertionError(f"{case.name}: K2 disagrees with "
                                 f"{case.kernel} ({rel})")
        res["k2_ms"], res["k2_graph_ms"] = time_ms(k2), graph_ms(k2)
    return res


def line(res: dict) -> str:
    """One printed result line of a case."""
    text = (f"probe {res['name']}: {res['kernel']} (replaces "
            f"{res['replaces']}) max|kernel-plain|={res['max_abs_err']} "
            f"err vs emulation {res['emulation_err']:.3e}; bound "
            f"{res['bound_ms']:.6f} ms by {res['bound_by']} "
            f"({res['nbytes']} B)")
    if "ms" not in res:
        return text + "; times not measured (cpu)"
    lib = res["library_ms"]
    text += (f"; {res['ms']:.4f} ms ({res['graph_ms']:.4f} in a CUDA graph),"
             f" plain {res['plain_ms']:.4f} ms, library "
             f"{'none' if lib is None else f'{lib:.4f} ms'}")
    if "k2_ms" in res:
        text += (f", K2 on the padded layout {res['k2_ms']:.4f} ms "
                 f"({res['k2_graph_ms']:.4f} in a CUDA graph)")
    return text
