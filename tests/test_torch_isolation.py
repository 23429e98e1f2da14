"""petsctpu_torch and chip_smoke.py stand alone: they import neither jax
nor petsctpu, and the port's entry points (the example CLIs' main and
entry.py's entry among them) build on CUDA unless the caller asks for
the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import petsctpu_torch
from petsctpu_torch.models import ex2_system

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

PKG = pathlib.Path(petsctpu_torch.__file__).resolve().parent
ROOT = PKG.parent
# the example CLIs (petsctpu's examples/*.py) and a small argv of each
EXAMPLES = {
    "ex10": ["-f", str(ROOT / "tests" / "data" / "ex10_poisson.bin"),
             "-ksp_type", "cg", "-pc_type", "jacobi"],
    "ex2": ["-m", "4", "-n", "4"],
    "ex45": ["-da_grid", "5"],
    "ex9": ["-t", "1"],
    "ex11_complex": ["-n", "4", "-norandom"],
    "ex39_lattice": ["-size", "3"],
    "ex5": ["-da_grid_x", "5", "-da_grid_y", "5"],
    "ex5_fas": ["-da_grid_x", "9", "-da_grid_y", "9", "-fas_levels", "2"],
    "ex19": ["-da_grid", "5"],
    "ex12_plex": ["-cells", "4"],
    "ex22_imex": ["-da_grid_x", "8"],
    "ex_elasticity": ["-mx", "4", "-my", "2"],
    "ex_stokes": ["-m", "4"],
}


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
    for m in ("ops.sell_pass", "ops.window_spmv", "ops.gather_forms",
              "probes", "probes.common", "probes.gather", "probes.sell",
              "probes.__main__", "timing", "ops.sptrsv", "mat.host_factor",
              "mat.factor", "mat.order", "mat.coloring", "mat.base",
              "pc.factor", "pc.asm", "pc.sor", "ksp.bcgs", "ksp.cheby",
              "ksp.minres", "ksp.extra", "ksp.more", "ksp.lcd_tcqmr",
              "ksp.ibcgs", "ksp.dgmres", "ksp.specest", "ksp.guess",
              "ksp.mixed", "mat.nullspace", "mat.host_graph", "mat.spgemm",
              "models.elasticity", "pc.asa", "pc.gamg_device",
              "vec.indexset", "pc.composite", "pc.fieldsplit", "pc.extra",
              "pc.spai", "pc.supportgraph", "pc.exotic", "models.q1stokes",
              "models.solcx", "models.stokes", "ex43_study",
              "ops.ell_spmv", "snes", "snes.api", "snes.fdjac",
              "snes.variants", "snes.fas", "snes.vi", "snes.nasm",
              "models.bratu", "models.cavity", "models.pbratu",
              "models.radiative", "models.adr1d", "models.laplin",
              "core.random", "ts", "ts.steppers", "ts.imex", "ts.gl",
              "ts.characteristic", "models.heat", "mat.fold", "mat.bsr",
              "mat.sbaij", "mat.coo", "mat.band", "mat.dia", "mat.maij",
              "mat.nest", "mat.matis", "mat.fft", "pc.nn", "pc.bddc",
              "models.ddpoisson", "dm", "dm.section", "dm.dt", "dm.plex",
              "dm.label", "dm.interp", "dm.gmsh", "dm.exodus", "dm.ao",
              "dm.composite", "dm.shell", "core.layout", "core.rankctx",
              "core.commaudit", "parallel", "parallel.comm", "parallel.plan",
              "parallel.pmat", "parallel.pbaij", "parallel.pstencil",
              "parallel.api", "parallel.subcomm", "parallel.psnes",
              "pc.parallel", "mat.partition", "dm.decomp", "io",
              "io.viewer", "mat.griddetect", "core.draw", "models.lattice",
              "entry", "examples", "models.wave1d", "models.q1elasticity",
              "models.poisson", "pc.mg", "convert", "mat.sbaijfact",
              "core.debug", "core.ams", "core.hostmem", "io.vtk",
              "vec.nest", "vec.pf",
              *(f"examples.{n}" for n in EXAMPLES)):
        assert f"petsctpu_torch.{m}" in mods
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
    from petsctpu_torch.ksp.guess import make_fischer_guess
    from petsctpu_torch.mat.nullspace import make_nullspace
    from petsctpu_torch.probes.__main__ import main as probes_main
    from petsctpu_torch.mat.sell import sell_template
    from petsctpu_torch.mat.spgemm import SpGEMMPlan
    from petsctpu_torch.pc.gamg_device import gamg_device_plan, \
        gamg_probe_plan

    from petsctpu_torch.pc.exotic import make_tfs
    from petsctpu_torch.pc.extra import make_eisenstat_system, make_svd
    from petsctpu_torch.pc.fieldsplit import make_fieldsplit
    from petsctpu_torch.models import (adr1d, bratu, cavity, heat, pbratu,
                                       radiative)
    from petsctpu_torch.dm import DMComposite
    from petsctpu_torch.dm.plex import (Plex, fem_assemble_poisson,
                                        p2_assemble_poisson)
    from petsctpu_torch.dm.shell import DMRedundant
    from petsctpu_torch.entry import entry
    from petsctpu_torch.convert import sbaij_cholesky_from_arrays
    from petsctpu_torch.core.random import Random
    from petsctpu_torch.mat.base import ScatterMat
    from petsctpu_torch.mat.ell import aij_from_dense
    from petsctpu_torch.mat.sbaijfact import (make_sbaij_cholesky,
                                              sbaij_cholesky_factor)

    A, _, _ = ex2_system(40, 40)             # 1600 rows: one SELL tile
    halves = [np.arange(800), np.arange(800, 1600)]
    return {
        "make_fieldsplit": lambda **kw: make_fieldsplit(
            A, halves, **kw).isa,
        "make_eisenstat_system": lambda **kw: make_eisenstat_system(
            A, **kw)[1].d,
        "make_svd": lambda **kw: make_svd(A[:50, :50], **kw).U,
        "make_tfs": lambda **kw: make_tfs(A[:50, :50], **kw).X,
        "aij_from_scipy": lambda **kw: aij_from_scipy(A, **kw),
        "mat_from_options": lambda **kw: mat_from_options(
            A, mat_type="sell", **kw),
        "sell_from_scipy": lambda **kw: sell_from_scipy(A, G=8, **kw),
        "DA.create_matrix": lambda **kw: DA((40, 40)).create_matrix(**kw),
        "stencil_from_scipy": lambda **kw: stencil_from_scipy(
            A, (40, 40), **kw),
        "make_nullspace": lambda **kw: make_nullspace(
            10, vecs=[np.arange(10.0)], **kw).vecs,
        "make_fischer_guess": lambda **kw: make_fischer_guess(10, **kw).X,
        "sell_template": lambda **kw: sell_template(A, G=8, **kw),
        "SpGEMMPlan.plan": lambda **kw: SpGEMMPlan.plan(A, A, **kw).template,
        "gamg_device_plan": lambda **kw: gamg_device_plan(
            A, coarse_n=200, **kw).csr_from_ell,
        "gamg_probe_plan": lambda **kw: gamg_probe_plan(
            A, coarse_n=200, **kw).csr_from_ell,
        "bratu_initial_guess": lambda **kw: bratu.bratu_initial_guess(
            DA((6, 6)), **kw),
        "bratu_jacobian_template": lambda **kw:
            bratu.bratu_jacobian_template(DA((6, 6)), **kw).coeffs,
        "bratu3d_initial_guess": lambda **kw: bratu.bratu3d_initial_guess(
            5, **kw),
        "bratu3d_fd_jacobian": lambda **kw: bratu.bratu3d_fd_jacobian(
            5, **kw).template.vals,
        "cavity_initial_guess": lambda **kw: cavity.cavity_initial_guess(
            5, 5, **kw),
        "pbratu_initial_guess": lambda **kw: pbratu.pbratu_initial_guess(
            5, 5, 1.0, **kw),
        "radiative_initial_guess": lambda **kw:
            radiative.radiative_initial_guess(5, 5, **kw),
        "adr_initial": lambda **kw: adr1d.adr_initial(6, **kw),
        "heat2d_initial": lambda **kw: heat.heat2d_initial(6, **kw),
        "heat1d_initial": lambda **kw: heat.heat1d_initial(6, **kw),
        "heat2d_jacobian_template": lambda **kw:
            heat.heat2d_jacobian_template(6, 1, **kw).coeffs,
        "fem_assemble_poisson": lambda **kw: fem_assemble_poisson(
            Plex.create_box_mesh(3, 3), **kw)[0],
        "p2_assemble_poisson": lambda **kw: p2_assemble_poisson(
            Plex.create_box_mesh(2, 2), **kw)[2],
        "DMComposite.create_global_vector": lambda **kw: DMComposite.create(
            4, 2).create_global_vector(**kw),
        "DMRedundant.create_matrix": lambda **kw: DMRedundant(3).create_matrix(
            **kw),
        "probes.__main__": lambda **kw: probes_main(
            ["probe_gather6_C", *(("--device", kw["device"]) if kw
                                  else ())])[0]["out"],
        "entry": lambda **kw: entry(**kw)[1][0],
        "make_sbaij_cholesky": lambda **kw: make_sbaij_cholesky(
            A, 2, **kw).dinv,
        "sbaij_cholesky_from_arrays": lambda **kw: sbaij_cholesky_from_arrays(
            *sbaij_cholesky_factor(A, 2), **kw).dinv,
        "ScatterMat": lambda **kw: ScatterMat([2, 0, 1], (3, 3), **kw).idx,
        "Random": lambda **kw: Random(3, **kw).get_values((4,)),
        "aij_from_dense": lambda **kw: aij_from_dense(
            np.eye(4), **kw).vals,
        **{f"examples.{n}": _example(n) for n in EXAMPLES},
    }


def _example(name):
    """A build of CLI `name` on its small argv: a tensor of its result
    (ex10's solve, ex9's last first system, ex22's state)."""
    import importlib

    def build(**kw):
        mod = importlib.import_module(f"petsctpu_torch.examples.{name}")
        out = mod.main(EXAMPLES[name], **kw)
        if name == "ex10":
            return out.res.x
        if name == "ex9":
            return out[0].x
        return out.u if name == "ex22_imex" else out.x

    return build


@pytest.mark.parametrize("name", ["aij_from_scipy", "mat_from_options",
                                  "sell_from_scipy", "DA.create_matrix",
                                  "stencil_from_scipy", "probes.__main__",
                                  "make_nullspace", "make_fischer_guess",
                                  "sell_template", "SpGEMMPlan.plan",
                                  "gamg_device_plan", "gamg_probe_plan",
                                  "make_fieldsplit", "make_eisenstat_system",
                                  "make_svd", "make_tfs",
                                  "bratu_initial_guess",
                                  "bratu_jacobian_template",
                                  "bratu3d_initial_guess",
                                  "bratu3d_fd_jacobian",
                                  "cavity_initial_guess",
                                  "pbratu_initial_guess",
                                  "radiative_initial_guess", "adr_initial",
                                  "heat2d_initial", "heat1d_initial",
                                  "heat2d_jacobian_template",
                                  "fem_assemble_poisson",
                                  "p2_assemble_poisson",
                                  "DMComposite.create_global_vector",
                                  "DMRedundant.create_matrix", "entry",
                                  "make_sbaij_cholesky",
                                  "sbaij_cholesky_from_arrays",
                                  "ScatterMat", "Random", "aij_from_dense",
                                  *(f"examples.{n}" for n in EXAMPLES)])
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
