"""Build the port's CUDA kernels and load them with ctypes.

Each `petsctpu_torch/csrc/<name>.cu` is compiled by nvcc on its own
into `petsctpu_torch/_build/lib<name>.so`, a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). A
library is rebuilt when any source under `csrc/` is newer than it.
Nothing is built at import: `load` builds at first use, and
`build_all` starts one nvcc per source, all together.

The host sources `csrc/<name>.cpp` (the factor numerics, not kernels)
are built the same way by g++ into `_build/lib<name>.so` at first use
(`load_host`), and raise if they cannot be built.

Every wrapper of `petsctpu_torch/ops` calls its kernel the same way: it
runs its `_check` (which raises on a malformed call, before any launch,
and returns the kernel's static arguments), takes its entry point from
`entry` once, calls it through `launch` on PyTorch's raw current stream
and counts the launch with `counted`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIBS: dict = {}
_LOCK = threading.Lock()


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return newest > so.stat().st_mtime


def build_all(names=None) -> dict:
    """Compile the stale kernels, one nvcc per source, all started
    together. Returns {name: nvcc's stderr} (ptxas's register and
    shared-memory report) for the kernels it built."""
    names = kernel_names() if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, tmp, proc))
    reports, failed = {}, []
    for name, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, lib_path(name))
        reports[name] = err
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def build_host(name: str) -> None:
    """Compile the host source csrc/<name>.cpp with g++ (no -march, so no
    FMA contraction: the same bits as a numpy loop in fp64)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host library {name} is "
                           "built from petsctpu_torch/csrc at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name} failed: g++ exit "
                           f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path(name))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name`, built first if it is missing or
    older than csrc/<name>.cpp."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = lib_path(name)
            if not so.exists() or (CSRC / f"{name}.cpp").stat().st_mtime \
                    > so.stat().st_mtime:
                build_host(name)
            lib = ctypes.CDLL(str(so))
            _LIBS[name] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
        return lib


def entry(name: str, argtypes):
    """Kernel `name`'s C entry point `<name>_launch` (built and loaded at
    first use), taking `argtypes` (the stream last) and returning its
    CUDA error code."""
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(fn, index: int, args) -> int:
    """fn(*args, stream) with `stream` the raw cudaStream_t of CUDA device
    `index`'s current stream (where a PyTorch op on that device runs) and
    that device current during the call; returns fn's CUDA error code.
    The raw handle costs a fraction of a microsecond, where building
    torch.cuda.current_stream()'s Stream object costs several; the device
    is switched (as a torch.cuda.device context would) only when `index`
    is not the current one."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    prev = torch.cuda._exchange_device(index)
    try:
        return fn(*args, stream)
    finally:
        torch.cuda._maybe_exchange_device(prev)


def counted(wrapper) -> None:
    """Add one to wrapper.launches, unless the current stream is being
    captured into a CUDA graph (a captured call launches nothing)."""
    if not torch._C._cuda_isCurrentStreamCapturing():
        wrapper.launches += 1
