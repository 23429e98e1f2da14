"""petsctpu_torch.probes against the TPU probe kernels of scripts/probe_*.py.

Each case of the port is held to the output of the Pallas kernel it
replaces, at the script's seed and size: the script is loaded by path and
run with `pallas_call` patched so that the kernel under test runs in
interpret mode on the CPU (jitted) and every other kernel of the script
returns zeros, and the script stops once the kernel under test has given
its first output. Pure gathers and the transpose must agree exactly; sums
within 1e-5 of max|ref| (XLA:CPU may fuse or reorder the fp32 adds).

The plain versions of H1-H3 are also held to direct numpy loops over
their slots at small sizes, and the wrappers' checks are exercised."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from petsctpu_torch.ops.gather_forms import gather_forms
from petsctpu_torch.ops.sell_pass import sell_pass
from petsctpu_torch.ops.window_spmv import window_spmv
from petsctpu_torch.probes import CASES, run
from petsctpu_torch.probes.__main__ import main
from petsctpu_torch.probes.sell import _k2_padded, _sell_bytes

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


class _Recorded(BaseException):
    """Carries the kernel's output out of the script (the scripts catch
    Exception around their kernels)."""


def reference_output(script, k, *argv):
    """The first output of the k-th kernel that scripts/<script>.py
    creates, in interpret mode on the CPU."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{script}", ROOT / "scripts" / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = pl.pallas_call
    made = []

    def patched(kernel, out_shape, **kw):
        made.append(kernel)
        if len(made) - 1 != k:
            return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)
        f = real(kernel, out_shape, interpret=True, **kw)

        def call(*a):
            with jax.disable_jit(False):
                out = jax.jit(f)(*a)
            raise _Recorded(np.asarray(out))
        return call

    pl.pallas_call = patched
    try:
        with jax.disable_jit():
            mod.main(*argv)
    except _Recorded as rec:
        return rec.args[0]
    finally:
        pl.pallas_call = real
    raise AssertionError(f"{script} created {len(made)} kernels, not {k + 1}")


# (case, script, index of its kernel in the script, main's arguments)
REFERENCES = [
    ("probe_pallas_gather_k1", "probe_pallas_gather", 0, ()),
    ("probe_pallas_gather_k2", "probe_pallas_gather", 1, ()),
    ("probe_pallas_gather_k3", "probe_pallas_gather", 2, ()),
    ("probe_pallas_gather_k4", "probe_pallas_gather", 3, ()),
    ("probe_pallas_gather2_rows", "probe_pallas_gather2", 0, ()),
    ("probe_pallas_gather2_window", "probe_pallas_gather2", 1, ()),
    ("probe_pallas_gather3_axis0_8x128", "probe_pallas_gather3", 0, ()),
    ("probe_pallas_gather3_axis0_256x128", "probe_pallas_gather3", 1, ()),
    ("probe_pallas_gather3_axis0_512x256", "probe_pallas_gather3", 2, ()),
    ("probe_pallas_gather3_kgather", "probe_pallas_gather3", 3, ()),
    ("probe_pallas_gather4_i32", "probe_pallas_gather4", 0, ()),
    ("probe_pallas_gather4_i16", "probe_pallas_gather4", 1, ()),
    ("probe_pallas_gather5_A", "probe_pallas_gather5", 0, ()),
    ("probe_pallas_gather5_B", "probe_pallas_gather5", 1, ()),
    ("probe_pallas_gather5_C", "probe_pallas_gather5", 2, ()),
    ("probe_pallas_gather5_D", "probe_pallas_gather5", 3, ()),
    ("probe_gather6_A", "probe_gather6", 0, ()),
    ("probe_gather6_B", "probe_gather6", 1, ()),
    ("probe_gather6_C", "probe_gather6", 2, ()),
    ("probe_gather6_D", "probe_gather6", 3, ()),
    ("probe_gather6_E", "probe_gather6", 4, ()),
    ("probe_gather7_base", "probe_gather7", 0, ()),
    ("probe_gather7_V1", "probe_gather7", 1, ()),
    ("probe_gather7_V2", "probe_gather7", 2, ()),
    *((f"probe_sell_bisect_{s}", "probe_sell_bisect", 0, (s,))
      for s in "abcdef"),
    ("probe_sell2_compact", "probe_sell2_compact", 0, ()),
    ("probe_sell2_onehot", "probe_sell2_onehot", 0, ()),
    ("probe_sellx_crossed", "probe_sellx_crossed", 0, ()),
]


def test_every_case_has_a_reference_and_every_script_a_case():
    assert sorted(r[0] for r in REFERENCES) == sorted(CASES)
    scripts = {p.stem for p in (ROOT / "scripts").glob("probe_*.py")
               if "pallas_call" in p.read_text()}
    assert scripts == {r[1] for r in REFERENCES} | {"probe_gather8"}


def test_gather8_is_the_sellx_script():
    """One case serves both SELL-X scripts: they are the same file."""
    scripts = ROOT / "scripts"
    assert (scripts / "probe_gather8.py").read_bytes() == \
        (scripts / "probe_sellx_crossed.py").read_bytes()


@pytest.mark.parametrize("name,script,k,argv", REFERENCES,
                         ids=[r[0] for r in REFERENCES])
def test_case_matches_the_reference_kernel(name, script, k, argv):
    ref = reference_output(script, k, *argv)
    case = CASES[name](CPU)
    out = case.run().numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if case.exact:
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


SMALL = [r[0] for r in REFERENCES
         if not r[0].startswith(("probe_gather7", "probe_sell2",
                                 "probe_sellx", "probe_pallas_gather2_w"))]


@pytest.mark.parametrize("name", SMALL)
def test_small_case_library_call_computes_the_same(name):
    """The yardstick timed on the card (one PyTorch call) computes the
    case's function: exactly for a gather, within 1e-5 for a sum."""
    case = CASES[name](CPU)
    out = case.run().reshape(-1)
    lib = case.library()().reshape(-1)
    if case.exact:
        assert torch.equal(lib, out)
    else:
        assert float((lib - out).abs().max()) <= 1e-5 * float(out.abs().max())


def _chunk_stream(rng, nch, P, G, Lx, idx_type=np.int8):
    nt = len(nch)
    NCH = int(sum(nch))
    return dict(vals=rng.standard_normal((NCH, P, G, 128)).astype(np.float32),
                idx=rng.integers(0, 128, (NCH, P, G, 128)).astype(idx_type),
                xp=rng.standard_normal((Lx, 128)).astype(np.float32),
                ws=rng.integers(0, 4, nt).astype(np.int32),
                cstart=(np.cumsum(nch) - nch).astype(np.int32),
                nch=np.asarray(nch, np.int32))


def _sell_loop(a, row_of):
    """y by a direct loop over slots, in the kernel's fold order."""
    nt, (NCH, P, G, _) = len(a["nch"]), a["vals"].shape
    y = np.zeros((nt, G, 128), np.float32)
    for t in range(nt):
        for c in range(a["nch"][t]):
            ch = a["cstart"][t] + c
            part = np.zeros((G, 128), np.float32)
            for p in range(P):
                for g in range(G):
                    for l in range(128):
                        j = int(a["idx"][ch, p, g, l])
                        row = a["ws"][t] + row_of(ch, p, g, j)
                        part[g, l] = part[g, l] + np.float32(
                            a["vals"][ch, p, g, l] * a["xp"][row, j])
            y[t] = part if c == 0 else y[t] + part
    return y


def _sell(a, mode, **kw):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    return sell_pass(t["vals"], t["idx"], t["xp"], t["ws"], t["cstart"],
                     t["nch"], mode=mode, **kw).numpy()


@pytest.mark.parametrize("idx_type", [np.int8, np.int32])
def test_sell_pass_plain_tile_rows_in_chunk_order(idx_type):
    rng = np.random.default_rng(1)
    a = _chunk_stream(rng, [2, 0, 3, 1], 3, 2, 12, idx_type)
    qs = rng.integers(0, 5, (a["vals"].shape[0], 3)).astype(np.int32)
    ref = _sell_loop(a, lambda ch, p, g, j: qs[ch, p] + g)
    np.testing.assert_array_equal(_sell(a, "tile", qs=qs), ref)
    assert not ref[1].any()                       # a tile with no chunks


@pytest.mark.parametrize("qbase_kind", [None, "chunk", "pass"])
@pytest.mark.parametrize("qoff_type", [np.int8, np.int32])
def test_sell_pass_plain_group_rows(qbase_kind, qoff_type):
    rng = np.random.default_rng(2)
    a = _chunk_stream(rng, [1, 2, 2], 3, 4, 16)
    NCH = a["vals"].shape[0]
    qoff = rng.integers(0, 6, (NCH, 3, 4)).astype(qoff_type)
    kw = {"qoff": qoff}
    qb = {None: None, "chunk": rng.integers(0, 4, NCH),
          "pass": rng.integers(0, 4, (NCH, 3))}[qbase_kind]
    if qb is not None:
        kw["qbase"] = qb.astype(np.int32)

    def row_of(ch, p, g, j):
        base = 0 if qb is None else (qb[ch] if qb.ndim == 1 else qb[ch, p])
        return base + qoff[ch, p, g]

    np.testing.assert_array_equal(_sell(a, "group", **kw),
                                  _sell_loop(a, row_of))


def test_sell_pass_plain_crossed_rows():
    rng = np.random.default_rng(3)
    P, G = 8, 16
    a = _chunk_stream(rng, [2, 1], P, G, 270)
    NCH = a["vals"].shape[0]
    hh = rng.integers(0, 2, NCH).astype(np.int32)
    i1 = rng.integers(0, 128, (NCH, 128, 128)).astype(np.int8)
    ref = _sell_loop(a, lambda ch, p, g, j: 128 * hh[ch] + i1[ch, j, G * p + g])
    np.testing.assert_array_equal(_sell(a, "crossed", hh=hh, i1=i1), ref)


def test_k2_on_the_padded_layout_agrees_with_sell_pass():
    """K2's padded form of a compacted tile-mode stream (as timed on the
    card) computes H1's function, in another order."""
    rng = np.random.default_rng(4)
    a = _chunk_stream(rng, [2, 3, 1, 3], 4, 4, 24)
    a["qs"] = rng.integers(0, 12, (a["vals"].shape[0], 4)).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y = sell_pass(t["vals"], t["idx"], t["xp"], t["ws"], t["cstart"],
                  t["nch"], mode="tile", qs=t["qs"])
    y2 = _k2_padded(t)()
    assert float((y2 - y).abs().max()) <= 1e-5 * float(y.abs().max())


def test_window_spmv_plain_matches_numpy_loop():
    rng = np.random.default_rng(5)
    n, K, Rb = 12, 5, 4
    starts = rng.integers(0, 3, n // Rb).astype(np.int32)
    q = rng.integers(0, 2, (n, K)).astype(np.int32)
    r = rng.integers(0, 128, (n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K)).astype(np.float32)
    x = rng.standard_normal(3 + 256).astype(np.float32)
    y = window_spmv(*map(torch.from_numpy, (starts, q, r, vals, x)),
                    Rb=Rb).numpy()
    ref = np.zeros(n, np.float32)
    for i in range(n):
        for k in range(K):
            col = starts[i // Rb] + 128 * q[i, k] + r[i, k]
            ref[i] = ref[i] + np.float32(vals[i, k] * x[col])
    np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("idx_type", [np.int32, np.int16])
def test_gather_forms_plain_match_numpy_loops(idx_type):
    rng = np.random.default_rng(6)
    S, L, R, M, t = 9, 6, 3, 4, 2
    x = rng.standard_normal((S, L)).astype(np.float32)
    xt = torch.from_numpy(x)

    def T(a):
        return torch.from_numpy(np.asarray(a).astype(idx_type))

    def fold(pick, rows, reps, width, blocks=1):
        out = np.zeros((rows, width), np.float32)
        for i in range(rows):
            for j in range(width):
                acc = np.float32(0)
                for r in range(reps):
                    s = pick(r, i, j)
                    for b in range(1, blocks):
                        s = np.float32(s + pick(r, i, j + b * width))
                    acc = s if reps == 1 else np.float32(acc + s)
                out[i, j] = acc
        return out

    flat = rng.integers(0, S * L, (3, 5))
    np.testing.assert_array_equal(
        gather_forms("take", xt.reshape(-1), T(flat)).numpy(),
        x.reshape(-1)[flat])
    rows = rng.integers(0, S, M)
    np.testing.assert_array_equal(gather_forms("rows", xt, T(rows)).numpy(),
                                  x[rows])
    i0 = rng.integers(0, S, (R, M, L))
    np.testing.assert_array_equal(
        gather_forms("axis0", xt, T(i0)).numpy(),
        fold(lambda r, i, j: x[i0[r, i, j], j], M, R, L))
    i1 = rng.integers(0, L, (R, S, 2 * L))
    np.testing.assert_array_equal(
        gather_forms("axis1", xt, T(i1), blocks=2).numpy(),
        fold(lambda r, i, j: x[i, i1[r, i, j]], S, R, L, blocks=2))
    rr, cc = rng.integers(0, S, (R, M, L)), rng.integers(0, L, (R, M, L))
    np.testing.assert_array_equal(
        gather_forms("chain", xt, T(rr), T(cc)).numpy(),
        fold(lambda r, i, j: x[rr[r, i, cc[r, i, j]], cc[r, i, j]], M, R, L))
    q = rng.integers(0, 3 * L, (M, 3 * L))
    np.testing.assert_array_equal(
        gather_forms("window", xt, T(q), t=t, blocks=3).numpy(),
        fold(lambda r, i, j: x[t + i + q[i, j] // L, q[i, j] % L], M, 1, L,
             blocks=3))
    np.testing.assert_array_equal(
        gather_forms("window", xt, t=t, size=(M, 2 * L)).numpy(),
        fold(lambda r, i, j: x[t + i + j // L, j % L], M, 1, 2 * L))
    np.testing.assert_array_equal(gather_forms("transpose", xt).numpy(), x.T)


def _gather_bytes(name, reached, idx_bytes, nout):
    assert CASES[name](CPU).nbytes() == 4 * reached + idx_bytes + 4 * nout


def test_gather_bounds_count_only_the_elements_the_indices_reach():
    """A window case reads 16-18 rows of its 64, an axis-0 or chained
    take one element of each picked (row, column): only those count."""
    _gather_bytes("probe_pallas_gather5_B", 16 * 128, 0, 16 * 128)
    _gather_bytes("probe_pallas_gather5_C", 18 * 128, 0, 16 * 384)
    rng = np.random.default_rng(0)
    rng.standard_normal((64, 128))
    idx = rng.integers(0, 384, size=(16, 384))
    src = (3 + np.arange(16)[:, None] + idx // 128) * 128 + idx % 128
    _gather_bytes("probe_pallas_gather4_i16", np.unique(src).size,
                  idx.size * 2, idx.size)
    rng = np.random.default_rng(0)
    rng.standard_normal((224, 128))
    R = rng.integers(0, 224, (16, 128))
    C = rng.integers(0, 128, (16, 128))
    _gather_bytes("probe_gather6_A",
                  np.unique(R * 128 + np.arange(128)).size, R.size * 4, R.size)
    picked = np.arange(16)[:, None] * 128 + C
    pick_src = np.take_along_axis(R, C, axis=1) * 128 + C
    _gather_bytes("probe_gather6_B", np.unique(pick_src).size,
                  4 * np.unique(picked).size + 4 * C.size, C.size)
    _gather_bytes("probe_gather6_C", 128 * 128, 0, 128 * 128)


def test_window_spmv_bound_counts_the_reached_window():
    """starts in {0, 128} and q·128 + r < 65,536 reach 65,664 of x's
    196,864 floats; the case's draws touch every one of them."""
    n, K = 131072, 32
    assert CASES["probe_pallas_gather2_window"](CPU).nbytes() == \
        4 * n * K * 3 + 4 * (n // 2048) + 4 * n + 4 * 65664


def test_sell_bytes_count_the_reached_x_and_i1_entries():
    rng = np.random.default_rng(7)
    P, G = 8, 16
    a = _chunk_stream(rng, [2, 1], P, G, 400)
    NCH = a["vals"].shape[0]
    hh = rng.integers(0, 2, NCH).astype(np.int32)
    i1 = rng.integers(0, 128, (NCH, 128, 128)).astype(np.int8)
    xs, i1s = set(), set()
    for t in range(2):
        for c in range(a["nch"][t]):
            ch = a["cstart"][t] + c
            for p in range(P):
                for g in range(G):
                    for j in a["idx"][ch, p, g].astype(int):
                        i1s.add((ch, j, G * p + g))
                        row = a["ws"][t] + 128 * hh[ch] + i1[ch, j, G * p + g]
                        xs.add((row, j))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t |= dict(hh=torch.from_numpy(hh), i1=torch.from_numpy(i1),
              mode="crossed")
    whole = sum(a[k].nbytes for k in ("vals", "idx", "ws", "cstart", "nch"))
    assert _sell_bytes(t) == (whole + hh.nbytes + 4 * len(xs) + len(i1s)
                              + 2 * G * 128 * 4)


def test_sell_pass_rejects_what_the_kernel_does_not_take():
    NCH, P, G = 2, 3, 4
    a = dict(vals=torch.zeros((NCH, P, G, 128)),
             idx=torch.zeros((NCH, P, G, 128), dtype=torch.int8),
             xp=torch.zeros((8, 128)), ws=torch.zeros(2, dtype=torch.int32),
             cstart=torch.arange(2, dtype=torch.int32),
             nch=torch.ones(2, dtype=torch.int32))
    qs = torch.zeros((NCH, P), dtype=torch.int32)
    assert sell_pass(**a, qs=qs).shape == (2, G, 128)
    with pytest.raises(ValueError, match="not supported"):
        sell_pass(**{k: v.to("meta") for k, v in a.items()}, qs=qs.to("meta"))
    bad = [dict(vals=torch.zeros((NCH, P, G, 128), dtype=torch.float64)),
           dict(idx=torch.zeros((NCH, P, G, 128), dtype=torch.int16)),
           dict(xp=torch.zeros((8, 64))),
           dict(ws=torch.zeros(3, dtype=torch.int32)),
           dict(vals=torch.zeros((NCH, P, G, 256))[..., ::2])]
    for over in bad:
        with pytest.raises(ValueError):
            sell_pass(**(a | over), qs=qs)
    with pytest.raises(ValueError, match="qs"):
        sell_pass(**a, qs=torch.zeros((NCH, P + 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="missing"):
        sell_pass(**a, mode="group")
    with pytest.raises(ValueError, match="not one"):
        sell_pass(**a, qs=qs, qoff=torch.zeros((NCH, P, G), dtype=torch.int8))
    with pytest.raises(ValueError, match="P\\*G"):
        sell_pass(**a, mode="crossed", hh=torch.zeros(NCH, dtype=torch.int32),
                  i1=torch.zeros((NCH, 128, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match="mode"):
        sell_pass(**a, mode="rows", qs=qs)


def test_window_spmv_rejects_what_the_kernel_does_not_take():
    n, K = 8, 3
    a = dict(starts=torch.zeros(2, dtype=torch.int32),
             q=torch.zeros((n, K), dtype=torch.int32),
             r=torch.zeros((n, K), dtype=torch.int32),
             vals=torch.zeros((n, K)), x=torch.zeros(300))
    assert window_spmv(**a, Rb=4).shape == (n,)
    with pytest.raises(ValueError, match="not supported"):
        window_spmv(**{k: v.to("meta") for k, v in a.items()}, Rb=4)
    bad = [dict(vals=torch.zeros((n, K), dtype=torch.float64)),
           dict(q=torch.zeros((n, K), dtype=torch.int64)),
           dict(starts=torch.zeros(3, dtype=torch.int32)),
           dict(x=torch.zeros((2, 150))),
           dict(r=torch.zeros((n, 2 * K), dtype=torch.int32)[:, ::2])]
    for over in bad:
        with pytest.raises(ValueError):
            window_spmv(**(a | over), Rb=4)
    with pytest.raises(ValueError, match="Rb"):
        window_spmv(**a, Rb=3)


def test_gather_forms_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((6, 8))
    i = torch.zeros((6, 8), dtype=torch.int32)
    assert gather_forms("axis1", x, i).shape == (6, 8)
    with pytest.raises(ValueError, match="not supported"):
        gather_forms("axis1", x.to("meta"), i.to("meta"))
    bad = [("axis1", x.double(), i, {}),
           ("axis1", x, i.long(), {}),
           ("axis1", x, torch.zeros((5, 8), dtype=torch.int32), {}),
           ("axis0", x, torch.zeros((6, 7), dtype=torch.int32), {}),
           ("axis1", x, torch.zeros((6, 16), dtype=torch.int32)[:, ::2], {}),
           ("axis1", x, i, {"blocks": 3}),
           ("rows", x, i, {}),
           ("take", x, i, {}),
           ("transpose", x, i, {}),
           ("window", x, None, {}),
           ("chain", x, i, {}),
           ("window", x, None, {"size": (4, 8), "t": 3}),
           ("window", x, None, {"size": (2, 16), "t": -1}),
           ("gather", x, i, {})]
    with pytest.raises(ValueError, match="idx2"):
        gather_forms("axis1", x, i, i)
    for form, xx, ii, kw in bad:
        with pytest.raises(ValueError):
            gather_forms(form, xx, ii, **kw)


def test_probes_entry_needs_cuda_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["probe_gather6_C"])
    res = main(["probe_gather6_C", "probe_sell_bisect_d", "--device", "cpu"])
    assert [r["name"] for r in res] == ["probe_gather6_C",
                                        "probe_sell_bisect_d"]
    assert all(r["out"].device.type == "cpu" and r["max_abs_err"] == 0
               for r in res)
    assert "times not measured (cpu)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown"):
        run(["probe_nothing"], device="cpu")
