"""petsctpu_torch and chip_smoke.py stand alone: they import neither jax
nor petsctpu, and the port's entry points build on CUDA unless the
caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import petsctpu_torch
from petsctpu_torch.models import ex2_system

PKG = pathlib.Path(petsctpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_pulls_in_no_jax_or_petsctpu():
    mods = list(_modules())
    assert "petsctpu_torch.ops.sell_spmv" in mods
    assert "petsctpu_torch.ops.stencil_mult" in mods
    assert "petsctpu_torch.ops.sell_spmvT" in mods
    mods.append("chip_smoke")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.') "
        "or m == 'petsctpu' or m.startswith('petsctpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_petsctpu():
    offenders = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "petsctpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    assert not offenders, offenders


def _entry_points():
    from petsctpu_torch.dm import DA
    from petsctpu_torch.mat import (aij_from_scipy, mat_from_options,
                                    stencil_from_scipy)
    from petsctpu_torch.mat.sell import sell_from_scipy

    A, _, _ = ex2_system(40, 40)             # 1600 rows: one SELL tile
    return {
        "aij_from_scipy": lambda **kw: aij_from_scipy(A, **kw),
        "mat_from_options": lambda **kw: mat_from_options(
            A, mat_type="sell", **kw),
        "sell_from_scipy": lambda **kw: sell_from_scipy(A, G=8, **kw),
        "DA.create_matrix": lambda **kw: DA((40, 40)).create_matrix(**kw),
        "stencil_from_scipy": lambda **kw: stencil_from_scipy(
            A, (40, 40), **kw),
    }


@pytest.mark.parametrize("name", ["aij_from_scipy", "mat_from_options",
                                  "sell_from_scipy", "DA.create_matrix",
                                  "stencil_from_scipy"])
def test_entry_point_without_device_needs_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    build = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    M = build(device="cpu")
    M = M[0] if isinstance(M, tuple) else M
    assert M.device.type == "cpu"


def test_sell_spmv_rejects_what_the_kernel_does_not_take():
    from petsctpu_torch.ops.sell_spmv import sell_spmv

    nt, P, G, Lp = 2, 3, 4, 16

    def args(device="cpu", **over):
        a = dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float32),
                 idx=torch.zeros((nt, P, G, 128), dtype=torch.int8),
                 qs=torch.zeros((nt, P), dtype=torch.int32),
                 winstart=torch.zeros((nt,), dtype=torch.int32),
                 xp=torch.zeros((Lp, 128), dtype=torch.float32))
        a = {k: v.to(device) for k, v in a.items()}
        a.update(over)
        return a

    assert sell_spmv(**args(), G=G, S=8).shape == (nt, G, 128)
    with pytest.raises(ValueError, match="not supported"):
        sell_spmv(**args("meta"), G=G, S=8)
    bad = [dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float64)),
           dict(idx=torch.zeros((nt, P, G, 128), dtype=torch.int32)),
           dict(qs=torch.zeros((nt, P + 1), dtype=torch.int32)),
           dict(xp=torch.zeros((Lp, 64), dtype=torch.float32)),
           dict(vals=torch.zeros((nt, P, G, 256), dtype=torch.float32)
                [..., ::2])]
    for over in bad:
        with pytest.raises(ValueError):
            sell_spmv(**args(**over), G=G, S=8)
    with pytest.raises(ValueError, match="mode"):
        sell_spmv(**args(), G=G, S=8, mode="rows")


def test_sell_spmv_plain_matches_numpy_loop():
    """The plain version against a direct loop over slots, both modes."""
    from petsctpu_torch.ops.sell_spmv import sell_spmv

    rng = np.random.default_rng(0)
    nt, P, G, Lp = 3, 4, 2, 12
    vals = rng.standard_normal((nt, P, G, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (nt, P, G, 128)).astype(np.int8)
    qs = rng.integers(0, 4, (nt, P)).astype(np.int32)
    ws = rng.integers(0, 4, nt).astype(np.int32)
    xp = rng.standard_normal((Lp, 128)).astype(np.float32)
    for mode in ("diag", "chunk"):
        y = sell_spmv(*map(torch.from_numpy, (vals, idx, qs, ws, xp)),
                      G=G, S=8, mode=mode).numpy()
        ref = np.zeros((nt, G, 128), np.float32)
        for t in range(nt):
            for g in range(G):
                for p in range(P):
                    row = ws[t] + qs[t, p] + (g if mode == "diag" else 0)
                    ref[t, g] = ref[t, g] + vals[t, p, g] * xp[row, idx[t, p, g]]
        np.testing.assert_array_equal(y, ref)
