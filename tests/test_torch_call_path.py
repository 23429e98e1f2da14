"""The kernel wrappers' one call path (petsctpu_torch/ops/_build.py):
a call's checks run before any launch, and the launch goes through
`_build.launch` on the raw current stream.

Each malformed input is tried twice: through the public wrapper on CPU
tensors (the plain version's path), and through the wrapper's CUDA path,
with tensors that report a CUDA device and an entry point that fails the
test if it is ever called. Both must raise the exception type the checks
raise. Also here: H1's crossed mode on indices outside [0, 128), which
both versions take mod 128, as the TPU kernel's take_along_axis does."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import petsctpu_torch
from petsctpu_torch.ops import _build
from petsctpu_torch.ops import gather_forms as h3
from petsctpu_torch.ops import sell_pass as h1
from petsctpu_torch.ops import sptrsv as trsv
from petsctpu_torch.ops import stencil_mult as k1
from petsctpu_torch.ops import window_spmv as h2

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

OPS = pathlib.Path(petsctpu_torch.__file__).resolve().parent / "ops"


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that a wrapper takes
    its CUDA path (its checks still read the real device, the CPU)."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _card(v):
    """A CPU tensor as one on "the card" (a tuple's tensors too); anything
    else as it is."""
    if isinstance(v, torch.Tensor) and v.device.type == "cpu":
        return v.as_subclass(_OnCard)
    if isinstance(v, tuple):
        return tuple(_card(t) for t in v)
    return v


# ------------------------------------------------ well-formed calls

def _sell_pass_call(mode="tile"):
    NCH, P, G = 2, 8, 16
    a = dict(vals=torch.zeros((NCH, P, G, 128)),
             idx=torch.zeros((NCH, P, G, 128), dtype=torch.int8),
             xp=torch.zeros((32, 128)), ws=torch.zeros(2, dtype=torch.int32),
             cstart=torch.arange(2, dtype=torch.int32),
             nch=torch.ones(2, dtype=torch.int32), mode=mode)
    if mode == "tile":
        a["qs"] = torch.zeros((NCH, P), dtype=torch.int32)
    elif mode == "group":
        a["qoff"] = torch.zeros((NCH, P, G), dtype=torch.int8)
    else:
        a["hh"] = torch.zeros(NCH, dtype=torch.int32)
        a["i1"] = torch.zeros((NCH, 128, 128), dtype=torch.int8)
    return a


def _gather_call(form="axis1"):
    a = dict(form=form, x=torch.zeros((6, 8)),
             idx=torch.zeros((6, 8), dtype=torch.int32))
    if form == "chain":
        a["idx2"] = torch.zeros((6, 8), dtype=torch.int32)
    return a


def _window_call():
    n, K = 8, 3
    return dict(starts=torch.zeros(2, dtype=torch.int32),
                q=torch.zeros((n, K), dtype=torch.int32),
                r=torch.zeros((n, K), dtype=torch.int32),
                vals=torch.zeros((n, K)), x=torch.zeros(300), Rb=4)


def _stencil_call():
    grid, offs = (5, 6), ((0, 0), (1, 0), (0, -1))
    return dict(coeffs=torch.zeros((3,) + grid), x=torch.zeros(30),
                offsets=offs, grid=grid, boundary=("none", "periodic"))


def _sptrsv_call(dtype=torch.float64):
    """Two stacked 3-row lower plans of one level each but row 2's, in
    level order."""
    nb, n, K = 2, 3, 2
    lr = np.array([[[0, 1], [2, 3]]] * nb, dtype=np.int32)
    cols = np.full((nb, n + 1, K), n, dtype=np.int32)
    cols[:, 2, 0] = 0
    vals = np.zeros((nb, n + 1, K))
    vals[:, 2, 0] = 0.5
    *order, nlevs = trsv.level_order(lr, cols, vals, np.ones((nb, n)))
    lseg = trsv.segments(order[0], order[1], n)
    lstart, lrows, lcols, lvals, ldinv = (trsv.with_slack(torch.from_numpy(a))
                                          for a in order)
    return dict(lstart=lstart, lrows=lrows, lcols=lcols,
                lvals=trsv.with_slack(lvals.to(dtype)),
                ldinv=trsv.with_slack(ldinv.to(dtype)),
                b=torch.ones((nb, n), dtype=dtype),
                nlevs=torch.from_numpy(nlevs),
                lseg=torch.from_numpy(lseg), rmax=2)


def _sptrsv_lu_call(dtype=torch.float64):
    """_sptrsv_call's plans as L, and their mirror image (row r of U is
    row n−1−r of L, its columns mirrored) as U."""
    a = _sptrsv_call(dtype)
    nb, n, _ = a["lvals"].shape
    lr = np.array([[[0, 1], [2, 3]]] * nb, dtype=np.int32)
    cols = np.full((nb, n + 1, 2), n, dtype=np.int32)
    cols[:, 0, 0] = 2
    vals = np.zeros((nb, n + 1, 2))
    vals[:, 0, 0] = 0.25
    lr = np.where(lr < n, n - 1 - lr, n)
    lr.sort(-1)
    *order, nlevs = trsv.level_order(lr.astype(np.int32), cols, vals,
                                     np.full((nb, n), 0.5))
    lseg = trsv.segments(order[0], order[1], n)
    upper = tuple(trsv.with_slack(torch.from_numpy(t)) for t in order)
    upper = upper[:3] + tuple(trsv.with_slack(t.to(dtype)) for t in upper[3:])
    return dict(lower=tuple(a[k] for k in SPTRSV_LEAD[:5]), upper=upper,
                b=a["b"], nlevs=(a["nlevs"], torch.from_numpy(nlevs)),
                lseg=(a["lseg"], torch.from_numpy(lseg)), rmax=(2, 2))


def _strided(shape, dtype=torch.float32):
    return torch.zeros(shape[:-1] + (2 * shape[-1],), dtype=dtype)[..., ::2]


SPTRSV_LEAD = ("lstart", "lrows", "lcols", "lvals", "ldinv", "b")

# kernel: (wrapper, a well-formed call, the wrapper's ops module)
KERNELS = {
    "sell_pass": (h1.sell_pass, _sell_pass_call, h1),
    "gather_forms": (h3.gather_forms, _gather_call, h3),
    "window_spmv": (h2.window_spmv, _window_call, h2),
    "stencil_mult": (k1.stencil_mult, _stencil_call, k1),
    "sptrsv": (trsv.sptrsv, _sptrsv_call, trsv),
    "sptrsv_lu": (trsv.sptrsv_lu, _sptrsv_lu_call, trsv),
}
SPTRSV_LU_LEAD = ("lower", "upper", "b")


def _call(kernel, a):
    wrapper = KERNELS[kernel][0]
    a = dict(a)
    lead = {"sell_pass": ("vals", "idx", "xp", "ws", "cstart", "nch"),
            "gather_forms": ("form", "x", "idx", "idx2"),
            "window_spmv": ("starts", "q", "r", "vals", "x"),
            "stencil_mult": ("coeffs", "x", "offsets", "grid",
                             "boundary"),
            "sptrsv": SPTRSV_LEAD, "sptrsv_lu": SPTRSV_LU_LEAD}[kernel]
    args = [a.pop(k, None) for k in lead]
    return wrapper(*args, **a)


# (kernel, kind, the well-formed call's arguments to replace (None drops
# one), the exception)
MALFORMED = [
    ("sell_pass", "device mix",
     lambda: {"idx": torch.zeros((2, 8, 16, 128), dtype=torch.int8,
                                 device="meta")}, ValueError),
    ("sell_pass", "non-contiguous",
     lambda: {"vals": _strided((2, 8, 16, 128))}, ValueError),
    ("sell_pass", "wrong dtype",
     lambda: {"vals": torch.zeros((2, 8, 16, 128), dtype=torch.float64)},
     ValueError),
    ("sell_pass", "wrong shape",
     lambda: {"ws": torch.zeros(3, dtype=torch.int32)}, ValueError),
    ("sell_pass", "not a tensor", lambda: {"nch": [1, 1]}, TypeError),
    ("sell_pass", "missing array",
     lambda: {"qs": None, "mode": "group"}, ValueError),
    ("sell_pass", "extra array",
     lambda: {"qoff": torch.zeros((2, 8, 16), dtype=torch.int8)},
     ValueError),
    ("sell_pass", "crossed: missing i1",
     lambda: {"qs": None, "mode": "crossed",
              "hh": torch.zeros(2, dtype=torch.int32)}, ValueError),
    ("sell_pass", "unknown mode", lambda: {"mode": "rows"}, ValueError),
    ("gather_forms", "device mix",
     lambda: {"idx": torch.zeros((6, 8), dtype=torch.int32,
                                 device="meta")}, ValueError),
    ("gather_forms", "non-contiguous",
     lambda: {"idx": _strided((6, 8), torch.int32)}, ValueError),
    ("gather_forms", "wrong dtype",
     lambda: {"idx": torch.zeros((6, 8), dtype=torch.int64)}, ValueError),
    ("gather_forms", "wrong dtype of x",
     lambda: {"x": torch.zeros((6, 8), dtype=torch.float64)}, ValueError),
    ("gather_forms", "wrong shape",
     lambda: {"idx": torch.zeros((5, 8), dtype=torch.int32)}, ValueError),
    ("gather_forms", "not a tensor", lambda: {"idx": [[0] * 8] * 6},
     TypeError),
    ("gather_forms", "missing array", lambda: {"form": "chain"},
     ValueError),
    ("gather_forms", "extra array",
     lambda: {"idx2": torch.zeros((6, 8), dtype=torch.int32)}, ValueError),
    ("gather_forms", "unknown form", lambda: {"form": "gather"},
     ValueError),
    ("window_spmv", "device mix",
     lambda: {"q": torch.zeros((8, 3), dtype=torch.int32, device="meta")},
     ValueError),
    ("window_spmv", "non-contiguous",
     lambda: {"r": _strided((8, 3), torch.int32)}, ValueError),
    ("window_spmv", "wrong dtype",
     lambda: {"vals": torch.zeros((8, 3), dtype=torch.float64)},
     ValueError),
    ("window_spmv", "wrong shape",
     lambda: {"starts": torch.zeros(3, dtype=torch.int32)}, ValueError),
    ("window_spmv", "not a tensor", lambda: {"starts": [0, 0]},
     TypeError),
    ("window_spmv", "Rb not dividing n", lambda: {"Rb": 3}, ValueError),
    ("stencil_mult", "device mix",
     lambda: {"coeffs": torch.zeros((3, 5, 6), device="meta")},
     ValueError),
    ("stencil_mult", "non-contiguous", lambda: {"x": _strided((30,))},
     ValueError),
    ("stencil_mult", "wrong dtype",
     lambda: {"x": torch.zeros(30, dtype=torch.float64)}, ValueError),
    ("stencil_mult", "wrong shape",
     lambda: {"coeffs": torch.zeros((3, 6, 5))}, ValueError),
    ("stencil_mult", "not a tensor", lambda: {"x": [0.0] * 30},
     TypeError),
    ("stencil_mult", "missing offset entries",
     lambda: {"offsets": ((0, 0), (1,), (0, -1))}, ValueError),
    ("stencil_mult", "unknown boundary",
     lambda: {"boundary": ("none", "wrap")}, ValueError),
    ("sptrsv", "device mix",
     lambda: {"lcols": torch.zeros((2, 3, 1), dtype=torch.int32,
                                   device="meta")}, ValueError),
    ("sptrsv", "non-contiguous",
     lambda: {"ldinv": _strided((2, 3), torch.float64)}, ValueError),
    ("sptrsv", "wrong dtype",
     lambda: {"lvals": torch.zeros((2, 3, 1), dtype=torch.float32)},
     ValueError),
    ("sptrsv", "wrong index dtype",
     lambda: {"lcols": torch.zeros((2, 3, 1), dtype=torch.int64)},
     ValueError),
    ("sptrsv", "half precision",
     lambda: _sptrsv_call(torch.float16), ValueError),
    ("sptrsv", "wrong shape",
     lambda: {"nlevs": torch.ones(3, dtype=torch.int32)}, ValueError),
    ("sptrsv", "unstacked plan",
     lambda: {"lvals": torch.zeros((3, 1), dtype=torch.float64)},
     ValueError),
    ("sptrsv", "not a tensor", lambda: {"nlevs": [2, 2]}, TypeError),
    ("sptrsv", "level starts of another plan",
     lambda: {"lstart": torch.zeros((1, 3), dtype=torch.int32)},
     ValueError),
    ("sptrsv", "rmax below one", lambda: {"rmax": 0}, ValueError),
    ("sptrsv", "segments of another plan",
     lambda: {"lseg": torch.zeros((2, 9), dtype=torch.int32)}, ValueError),
    ("sptrsv_lu", "device mix",
     lambda: {"upper": _sptrsv_lu_call()["upper"][:4] + (
         torch.ones((2, 3), dtype=torch.float64, device="meta"),)},
     ValueError),
    ("sptrsv_lu", "wrong dtype of U",
     lambda: {"upper": _sptrsv_lu_call(torch.float32)["upper"]},
     ValueError),
    ("sptrsv_lu", "U of another size",
     lambda: {"upper": _sptrsv_lu_call()["upper"][:4] + (
         torch.ones((2, 4), dtype=torch.float64),)}, ValueError),
    ("sptrsv_lu", "half precision",
     lambda: _sptrsv_lu_call(torch.float16), ValueError),
    ("sptrsv_lu", "a plan not a tuple",
     lambda: {"lower": list(_sptrsv_lu_call()["lower"])[:4]}, TypeError),
    ("sptrsv_lu", "one nlevs for two plans",
     lambda: {"nlevs": torch.ones(2, dtype=torch.int32)}, TypeError),
    ("sptrsv_lu", "U's segments of another plan",
     lambda: {"lseg": (_sptrsv_call()["lseg"],
                       torch.zeros((2, 9), dtype=torch.int32))},
     ValueError),
    ("sptrsv_lu", "rmax below one", lambda: {"rmax": (2, 0)}, ValueError),
]


@pytest.mark.parametrize("kernel,kind,change,exc", MALFORMED,
                         ids=[f"{k}-{kind}" for k, kind, _, _ in MALFORMED])
def test_malformed_input_raises_on_both_paths(kernel, kind, change, exc,
                                              monkeypatch):
    _, good, mod = KERNELS[kernel]
    bad = {k: v for k, v in (good() | change()).items() if v is not None}
    _call(kernel, good())                       # the CPU path, well-formed
    with pytest.raises(exc):
        _call(kernel, bad)
    # the CUDA path: the checks raise before the entry point is asked for
    monkeypatch.setattr(mod, "_launcher", lambda: pytest.fail("launched"))
    if hasattr(mod, "_lu_launcher"):
        monkeypatch.setattr(mod, "_lu_launcher",
                            lambda: pytest.fail("launched"))
    if hasattr(mod, "_num_sms"):
        monkeypatch.setattr(mod, "_num_sms", lambda index: 132)
    with pytest.raises(exc):
        _call(kernel, {k: _card(v) for k, v in bad.items()})


def _calls(tree):
    """Dotted names of every call in a module's code."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            parts, f = [], node.func
            while isinstance(f, ast.Attribute):
                parts.append(f.attr)
                f = f.value
            if isinstance(f, ast.Name):
                parts.append(f.id)
            yield ".".join(reversed(parts))


def test_no_wrapper_opens_a_device_context_or_builds_a_stream_object():
    offenders = []
    for path in sorted(OPS.glob("*.py")):
        for name in _calls(ast.parse(path.read_text(), str(path))):
            if name in ("torch.cuda.device", "torch.cuda.current_stream",
                        "torch.cuda.is_current_stream_capturing"):
                offenders.append(f"{path.name}: {name}(")
    assert not offenders, offenders


@pytest.mark.parametrize("module", ["gather_forms", "sell_pass",
                                    "window_spmv", "stencil_mult",
                                    "sell_spmv", "sell_spmvT", "sptrsv",
                                    "ell_spmv"])
def test_every_wrapper_launches_through_build_launch(module):
    """Each wrapper calls its kernel only through _build.launch, counts
    through _build.counted, and catches nothing around a build or a
    launch."""
    tree = ast.parse((OPS / f"{module}.py").read_text())
    names = list(_calls(tree))
    assert "_build.launch" in names and "_build.counted" in names
    assert "_launcher" in names
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            inside = set(_calls(ast.Module(body=node.body, type_ignores=[])))
            assert not inside & {"_build.launch", "_launcher", "_build.load",
                                 "_build.build_all"}, module


# ------------------------------- the CUDA path's arguments, on the CPU

def _k2_call():
    nt, P, G = 2, 3, 4
    return (torch.zeros((nt, P, G, 128)),
            torch.zeros((nt, P, G, 128), dtype=torch.int8),
            torch.zeros((nt, P), dtype=torch.int32),
            torch.zeros(nt, dtype=torch.int32), torch.zeros((16, 128))), \
        dict(G=G, S=8)


def _k3_call():
    import scipy.sparse as sp

    from petsctpu_torch.mat.sell import sell_from_scipy
    A = sp.random(300, 200, density=0.05, random_state=0, format="csr",
                  dtype="float32")
    T = sell_from_scipy(A, G=4, mode="chunk", device="cpu")
    return (T.transpose_plan(), torch.zeros(T.shape[0])), {}


def _launch_case(kernel):
    """(ops module, wrapper args, kwargs, output shape) of one well-formed
    call of each wrapper."""
    from petsctpu_torch.ops import ell_spmv as ell
    from petsctpu_torch.ops import sell_spmv as k2
    from petsctpu_torch.ops import sell_spmvT as k3
    if kernel == "ell_spmv":
        return ell, (torch.zeros((5, 3), dtype=torch.int32),
                     torch.zeros((5, 3), dtype=torch.float64),
                     torch.zeros(7, dtype=torch.float64)), {}
    if kernel in ("sell_spmv", "sell_spmvT"):
        mod = k2 if kernel == "sell_spmv" else k3
        args, kw = _k2_call() if kernel == "sell_spmv" else _k3_call()
        return mod, args, kw
    mod = {"sell_pass": h1, "gather_forms": h3, "window_spmv": h2,
           "stencil_mult": k1, "sptrsv": trsv, "sptrsv_lu": trsv}[kernel]
    a = {"sell_pass": lambda: _sell_pass_call("crossed"),
         "gather_forms": lambda: _gather_call("chain"),
         "window_spmv": _window_call, "stencil_mult": _stencil_call,
         "sptrsv": _sptrsv_call, "sptrsv_lu": _sptrsv_lu_call}[kernel]()
    lead = {"sell_pass": ("vals", "idx", "xp", "ws", "cstart", "nch"),
            "gather_forms": ("form", "x", "idx", "idx2"),
            "window_spmv": ("starts", "q", "r", "vals", "x"),
            "stencil_mult": ("coeffs", "x", "offsets", "grid",
                             "boundary"),
            "sptrsv": SPTRSV_LEAD, "sptrsv_lu": SPTRSV_LU_LEAD}[kernel]
    return mod, [a.pop(k) for k in lead], a


# a wrapper's entry point and its argument types, where not _launcher and
# ARGTYPES
ENTRIES = {"sptrsv_lu": ("_lu_launcher", "LU_ARGTYPES")}


@pytest.mark.parametrize("kernel", ["sell_pass", "gather_forms",
                                    "window_spmv", "stencil_mult",
                                    "sell_spmv", "sell_spmvT", "sptrsv",
                                    "sptrsv_lu", "ell_spmv"])
def test_cuda_path_arguments_convert_to_the_entry_points_types(kernel,
                                                               monkeypatch):
    """The wrapper's CUDA path, run on tensors that report the card: the
    arguments it hands _build.launch convert to its C entry point's
    ARGTYPES (a ctypes prototype of the same types checks them), one
    launch is counted, and the output has the plain version's shape."""
    import ctypes

    mod, args, kw = _launch_case(kernel)
    wrapper = getattr(mod, kernel)
    plain = wrapper(*args, **kw)                 # the CPU path
    launcher, argtypes = ENTRIES.get(kernel, ("_launcher", "ARGTYPES"))
    got = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *getattr(mod, argtypes))
    entry = proto(lambda *a: got.append(a) or 0)
    monkeypatch.setattr(mod, launcher, lambda: entry)
    if hasattr(mod, "_smem_optin"):
        monkeypatch.setattr(mod, "_smem_optin", lambda index: 232448)
    if hasattr(mod, "_num_sms"):
        monkeypatch.setattr(mod, "_num_sms", lambda index: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda fn, index, a: fn(*a, None))
    monkeypatch.setattr(_build, "counted",
                        lambda w: setattr(w, "launches", w.launches + 1))
    card = [(_card(v) if not isinstance(v, str) else v) for v in args]
    if kernel == "sell_spmvT":
        card = [args[0], _card(args[1])]
    before = wrapper.launches
    out = wrapper(*card, **{k: _card(v) for k, v in kw.items()})
    assert len(got) == 1 and len(got[0]) == len(getattr(mod, argtypes))
    assert wrapper.launches == before + 1
    assert out.shape == plain.shape and out.dtype == plain.dtype


@pytest.mark.parametrize("name", ["vals", "idx", "xp", "i1"])
def test_crossed_mode_rejects_a_misaligned_array_before_the_launch(
        name, monkeypatch):
    """The crossed kernel reads vals as float4 and bulk-copies xp and i1
    in 16-byte units: on the card a view 4 bytes off raises, and nothing
    is launched."""
    a = _sell_pass_call("crossed")
    t = a[name]
    flat = torch.zeros(t.numel() * t.element_size() + 16, dtype=torch.uint8)
    a[name] = flat[4:4 + t.numel() * t.element_size()].view(t.dtype) \
        .view(t.shape)
    assert a[name].data_ptr() % 16 and a[name].is_contiguous()
    monkeypatch.setattr(h1, "_launcher", lambda: pytest.fail("launched"))
    mode = a.pop("mode")
    args = [_card(a.pop(k)) for k in ("vals", "idx", "xp", "ws", "cstart",
                                      "nch")]
    with pytest.raises(ValueError, match="aligned"):
        h1.sell_pass(*args, mode=mode, **{k: _card(v) for k, v in a.items()})


# ---------------------------- H1's crossed mode: indices taken mod 128

def _crossed_inputs(G, idx_dtype, seed=0):
    """A crossed-mode call of 3 tiles of 2 chunks, with idx and i1 drawn
    over the whole int8 range."""
    rng = np.random.default_rng(seed)
    P, NT, C = 128 // G, 3, 2
    a = dict(vals=rng.standard_normal((NT * C, P, G, 128)).astype(np.float32),
             idx=rng.integers(-128, 128, (NT * C, P, G, 128)),
             xp=rng.standard_normal((16 + 256, 128)).astype(np.float32),
             ws=np.array([0, 8, 16], np.int32),
             cstart=np.array([0, 2, 4], np.int32),
             nch=np.array([2, 2, 2], np.int32),
             hh=rng.integers(0, 2, NT * C).astype(np.int32),
             i1=rng.integers(-128, 128, (NT * C, 128, 128)).astype(np.int8))
    a["idx"] = a["idx"].astype(np.int8 if idx_dtype == torch.int8
                               else np.int32)
    return a


def _crossed_emulation(a):
    """What the TPU kernel of scripts/probe_sellx_crossed.py computes:
    take_along_axis of the half window's transpose by i1, then of each
    pass's rows by idx (numpy's, which counts a negative index from the
    end of the row, as JAX's does)."""
    vals, J, I1, xp = a["vals"], a["idx"], a["i1"], a["xp"]
    NCH, P, G = vals.shape[:3]
    ref = np.zeros((len(a["ws"]), G, 128), np.float32)
    for t, (ws, c0, n) in enumerate(zip(a["ws"], a["cstart"], a["nch"])):
        for ch in range(c0, c0 + n):
            row0 = ws + 128 * a["hh"][ch]
            T = xp[row0:row0 + 128].T
            Ut = np.take_along_axis(T, I1[ch].astype(np.int64), axis=1).T
            for p in range(P):
                ref[t] += vals[ch, p] * np.take_along_axis(
                    Ut[G * p:G * p + G], J[ch, p].astype(np.int64), axis=1)
    return ref


@pytest.mark.parametrize("G,idx_dtype", [
    (4, torch.int8), (8, torch.int8), (8, torch.int32), (16, torch.int8),
    (16, torch.int32), (32, torch.int8), (64, torch.int8)])
def test_crossed_mode_takes_indices_mod_128(G, idx_dtype):
    """idx and i1 outside [0, 128) are taken mod 128 by the plain version,
    as the crossed kernel does (j & 127, i1 & 127): the result equals
    that of the masked indices bit for bit, and the TPU kernel's
    emulation within 1e-5 relative (it folds in another order)."""
    a = _crossed_inputs(G, idx_dtype)
    assert (a["idx"] < 0).any() and (a["i1"] < 0).any()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    lead = [t.pop(k) for k in ("vals", "idx", "xp", "ws", "cstart", "nch")]
    got = h1.sell_pass(*lead, mode="crossed", **t)
    masked = dict(t, i1=t["i1"] & 127)
    lead_masked = lead[:1] + [lead[1] & 127] + lead[2:]
    assert torch.equal(got, h1.sell_pass(*lead_masked, mode="crossed",
                                         **masked))
    ref = _crossed_emulation(a)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err


def test_sptrsv_launch_shapes_and_the_barrier_counter(monkeypatch):
    """launch_shape picks x in shared memory where it fits (one block's,
    then a cluster's), else one block a plan for levels of at most
    BLOCK_ROWS rows, clusters for wider stacked plans and the grid for a
    single one, which alone gets a barrier counter; sptrsv_lu launches
    only a shared shape."""
    import ctypes

    H100 = 232448
    assert [trsv.launch_shape(nb, n, r, es, H100) for nb, n, r, es in (
        (8, 32768, 512, 4), (8, 262144, 1984, 4), (8, 262144, 1984, 8),
        (1, 2097152, 12288, 4), (1, 4194304, 1, 4))] == \
        ["block-smem", "cluster-smem", "cluster", "grid", "block"]
    got, lu = [], []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *trsv.ARGTYPES)
    entry = proto(lambda *a: got.append(a) or 0)
    lu_proto = ctypes.CFUNCTYPE(ctypes.c_int, *trsv.LU_ARGTYPES)
    lu_entry = lu_proto(lambda *a: lu.append(a) or 0)
    monkeypatch.setattr(trsv, "_launcher", lambda: entry)
    monkeypatch.setattr(trsv, "_lu_launcher", lambda: lu_entry)
    monkeypatch.setattr(_build, "launch", lambda fn, index, a: fn(*a, None))
    monkeypatch.setattr(_build, "counted",
                        lambda w: setattr(w, "launches", w.launches + 1))

    def call(nb, rmax):
        a = {k: v if k == "rmax" else v[:nb]
             for k, v in _sptrsv_call().items()}
        lead = [_card(a.pop(k)) for k in SPTRSV_LEAD]
        trsv.sptrsv(*lead, nlevs=_card(a["nlevs"]), lseg=_card(a["lseg"]),
                    rmax=rmax)

    # x in global memory (no shared memory to speak of), levels reported
    # wider than a block
    monkeypatch.setattr(trsv, "_smem_optin", lambda index: 0)
    for nb in (1, 2):
        call(nb, 2000)
    lu_call = {k: _card(v) for k, v in _sptrsv_lu_call().items()}
    lead = [lu_call.pop(k) for k in SPTRSV_LU_LEAD]
    with pytest.raises(ValueError, match="not a shared one"):
        trsv.sptrsv_lu(*lead, **dict(lu_call, rmax=(2000, 2000)))
    monkeypatch.setattr(trsv, "_smem_optin", lambda index: H100)
    call(2, 2)
    trsv.sptrsv_lu(*lead, **lu_call)
    one, two, shared = got
    # bar (argument 9) and the shape (the last before the stream)
    assert one[9] is not None and one[-2] == trsv.SHAPES["grid"]
    assert two[9] is None and two[-2] == trsv.SHAPES["cluster"]
    assert shared[9] is None and shared[-2] == trsv.SHAPES["block-smem"]
    (fused,) = lu
    assert fused[-2] == trsv.SHAPES["block-smem"]
    # the wider level of the two plans, and each plan's own K
    assert fused[16:25] == (2, 3, 2, 2, 2, 1, 1, 1, 3)


@pytest.mark.parametrize("kernel", ["sptrsv", "sptrsv_lu"])
def test_sptrsv_segments_are_needed_only_in_the_cluster_smem_shape(
        kernel, monkeypatch):
    """lseg may be None (a plan whose x does not fit a cluster's shared
    memory derives none): then a launch in the cluster-smem shape raises
    before the kernel, and any other shape launches with a null lseg."""
    import ctypes

    got = []
    argtypes = trsv.ARGTYPES if kernel == "sptrsv" else trsv.LU_ARGTYPES
    entry = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)(
        lambda *a: got.append(a) or 0)
    monkeypatch.setattr(trsv, "_launcher" if kernel == "sptrsv"
                        else "_lu_launcher", lambda: entry)
    monkeypatch.setattr(_build, "launch", lambda fn, index, a: fn(*a, None))
    monkeypatch.setattr(_build, "counted",
                        lambda w: setattr(w, "launches", w.launches + 1))
    monkeypatch.setattr(trsv, "_smem_optin", lambda index: 232448)
    a = (_sptrsv_call if kernel == "sptrsv" else _sptrsv_lu_call)()
    lead = [_card(a.pop(k)) for k in (SPTRSV_LEAD if kernel == "sptrsv"
                                      else SPTRSV_LU_LEAD)]
    kw = {k: _card(v) for k, v in a.items()}
    none = None if kernel == "sptrsv" else (None, None)
    wide = 2000 if kernel == "sptrsv" else (2000, 2000)
    # levels wider than a block: the cluster-smem shape
    with pytest.raises(ValueError, match="lseg must be given"):
        getattr(trsv, kernel)(*lead, **dict(kw, lseg=none, rmax=wide))
    assert not got
    getattr(trsv, kernel)(*lead, **dict(kw, lseg=none))
    (args,) = got
    assert args[-2] == trsv.SHAPES["block-smem"]
    # lseg's place: argument 1 (sptrsv), 1 and 8 (sptrsv_lu)
    assert [args[i] for i in ((1,) if kernel == "sptrsv" else (1, 8))] \
        == [None] * (1 if kernel == "sptrsv" else 2)


@pytest.mark.parametrize("kernel", ["sptrsv", "sptrsv_lu"])
def test_sptrsv_shared_shapes_need_slack_past_the_plan(kernel, monkeypatch):
    """The shared shapes' ring copies whole 16-byte units: on the card a
    plan array with less than SLACK readable bytes past its end raises
    before the launch (SpTRSVPlan allocates with_slack)."""
    a = (_sptrsv_call if kernel == "sptrsv" else _sptrsv_lu_call)()
    tight = a["lvals"].clone() if kernel == "sptrsv" else None
    if kernel == "sptrsv":
        a["lvals"] = tight
    else:
        a["upper"] = a["upper"][:3] + (a["upper"][3].clone(),) \
            + a["upper"][4:]
    monkeypatch.setattr(trsv, "_launcher", lambda: pytest.fail("launched"))
    monkeypatch.setattr(trsv, "_lu_launcher",
                        lambda: pytest.fail("launched"))
    monkeypatch.setattr(trsv, "_smem_optin", lambda index: 232448)
    lead = SPTRSV_LEAD if kernel == "sptrsv" else SPTRSV_LU_LEAD
    args = [_card(a.pop(k)) for k in lead]
    with pytest.raises(ValueError, match="readable 16 bytes past its end"):
        getattr(trsv, kernel)(*args, **{k: _card(v) for k, v in a.items()})


def test_sptrsv_plain_matches_a_row_loop():
    """The plain version against x solved row by row in level order,
    each row's slots folded left to right: the same bits."""
    import scipy.sparse as sp

    from petsctpu_torch.mat.factor import make_sptrsv_plan

    rng = np.random.default_rng(11)
    n = 60
    T = sp.random(n, n, density=0.08, random_state=rng, format="csr")
    T = (sp.tril(T, -1) + sp.diags(rng.uniform(1, 2, n))).tocsr()
    b = rng.standard_normal(n)
    plan = make_sptrsv_plan(T, True, False, device="cpu")
    x = plan.solve(torch.from_numpy(b)).numpy()
    ref = np.zeros(n)
    cols, vals, dinv = plan.cols, plan.vals, plan.dinv
    for rows in plan.level_rows:
        for r in rows[rows < n]:
            acc = 0.0
            for c, v in zip(cols[r], vals[r]):
                acc = acc + v * (ref[c] if c < n else 0.0)
            ref[r] = (b[r] - acc) * dinv[r]
    np.testing.assert_array_equal(x, ref)


def test_sellbaij_mult_on_the_card_launches_k2_or_raises(monkeypatch):
    """SellBAIJ.mult (the card's -mat_type baij route, mat/bsr.py) on
    tensors that report the card takes K2's CUDA path: one launch
    through the C entry point, counted; with no entry point (no nvcc)
    it raises and takes no plain version."""
    import ctypes

    from petsctpu_torch.mat import sell as msell
    from petsctpu_torch.mat.bsr import baij_from_scipy_bsr
    from petsctpu_torch.models.elasticity import ex55_system
    from petsctpu_torch.ops import sell_spmv as k2

    A = ex55_system(31, 1e-3)[0]
    M = baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="sell",
                            device="cpu")
    assert type(M).__name__ == "SellBAIJ"
    x = torch.rand(A.shape[0])
    plain = M.mult(x)
    got = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *k2.ARGTYPES)
    entry = proto(lambda *a: got.append(a) or 0)
    monkeypatch.setattr(k2, "_launcher", lambda: entry)
    monkeypatch.setattr(_build, "launch", lambda fn, index, a: fn(*a, None))
    monkeypatch.setattr(_build, "counted",
                        lambda w: setattr(w, "launches", w.launches + 1))
    real = msell.sell_spmv
    monkeypatch.setattr(msell, "sell_spmv",
                        lambda *a, **k: real(*_card(a), **k))
    before = k2.sell_spmv.launches
    out = M.mult(_card(x))
    assert len(got) == 1 and k2.sell_spmv.launches == before + 1
    assert out.shape == plain.shape and out.dtype == plain.dtype

    def no_entry():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(k2, "_launcher", no_entry)
    with pytest.raises(RuntimeError, match="nvcc"):
        M.mult(_card(x))
    assert k2.sell_spmv.launches == before + 1
