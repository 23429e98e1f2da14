"""The port's driver entry points (petsctpu_torch/entry.py) against the
reference's (__graft_entry__.py).

* entry(): the 64² Poisson CG + Jacobi block (fp32, 25 its) on the CPU
  against the reference's jitted step on the same system: x within
  1e-4 of its largest entry and the residual norm within 1e-3 relative
  (fp32 sums in another order over 25 iterations).
* dryrun_multichip(4): the port over 4 CPU rank threads of a World, the
  reference over 4 devices of its 8-device CPU mesh (tests/conftest.py),
  as tests/test_torch_parallel.py runs petsctpu's shard_map paths: the
  same "dryrun_multichip(4): ..." lines, the iteration, Newton and step
  counts in them equal, each solution error below 1e-2 on both sides
  (the dryrun's own bound; fp32 solves), and the same halo plan line;
  the port's counts and reasons equal chip_smoke.py's DRYRUN_4, the
  table its dryrun on the card is held to.
"""

import ast
import contextlib
import importlib.util
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from petsctpu_torch.entry import dryrun_multichip, entry

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke_table(name):
    """The literal `name` = {...} of chip_smoke.py, which the card's
    dryrun is held to."""
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def reference():
    spec = importlib.util.spec_from_file_location(
        "reference_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_step_matches_reference():
    fn, args = reference().entry()
    rx, rr = jax.jit(fn)(*args)
    tfn, targs = entry(device="cpu")
    tx, tr = tfn(*targs)
    assert tx.dtype == torch.float32 and tx.device.type == "cpu"
    rx = np.asarray(rx)
    assert np.abs(tx.numpy() - rx).max() <= 1e-4 * np.abs(rx).max()
    assert abs(float(tr) - float(rr)) <= 1e-3 * float(rr)


_ERR = re.compile(r"err=([0-9.e+-]+)")


def _dryrun_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("dryrun_multichip(4):")]


def test_dryrun_multichip_4_matches_reference():
    from petsctpu.core import commaudit as rcommaudit

    saved = (rcommaudit.AUDIT_ALWAYS, dict(rcommaudit.COMM_AUDITS))
    rbuf = io.StringIO()
    try:
        with contextlib.redirect_stdout(rbuf):
            reference().dryrun_multichip(4)
    finally:
        rcommaudit.AUDIT_ALWAYS = saved[0]
        rcommaudit.COMM_AUDITS.clear()
        rcommaudit.COMM_AUDITS.update(saved[1])
    tbuf = io.StringIO()
    with contextlib.redirect_stdout(tbuf):
        out = dryrun_multichip(4, device="cpu")
    rl, tl = _dryrun_lines(rbuf.getvalue()), _dryrun_lines(tbuf.getvalue())
    assert len(rl) == len(tl) == 12 == len(out)
    for r, t in zip(rl, tl):
        assert _ERR.sub("err=#", r) == _ERR.sub("err=#", t), (r, t)
        for e in _ERR.findall(r) + _ERR.findall(t):
            assert float(e) < 1e-2, (r, t)
    assert out["newton_dist_mg"][0] == 3 and out["ts_beuler"][0] == 3
    assert out == chip_smoke_table("DRYRUN_4")
    halo = [ln for ln in tbuf.getvalue().splitlines()
            if ln.startswith("halo plan")]
    assert halo and halo[0] in rbuf.getvalue().splitlines()
    assert "ksp:gmres[4]" in tbuf.getvalue()


def test_dryrun_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)
