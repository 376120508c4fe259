"""Build and load the package's CUDA kernels.

All sources under ``csrc/`` compile in parallel (one ``nvcc`` per source)
and link into one shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds).  The library
goes into ``_build/`` beside this file, named by a hash of the sources and
flags, and is built at first use; nothing is downloaded and nothing
outside the package sources and the CUDA toolkit is read.

Each C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; `launch` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None     # wall time of this process's nvcc run, if any
build_log = ""           # nvcc/ptxas output of the library's build


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdtc_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is up to date:
    one nvcc per source, all started together, then one link.  The
    compiler's output is kept beside the library (`build_log`, also when
    another process built it)."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        if not build_log and out.with_suffix(".log").exists():
            build_log = out.with_suffix(".log").read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            lib = os.path.join(tmpdir, "lib.so")
            link = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", lib, *objs], capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            failed = [link.returncode] if link.returncode else []
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
        with open(os.path.join(tmpdir, "lib.log"), "w") as f:
            f.write(build_log)
        os.replace(os.path.join(tmpdir, "lib.log"), out.with_suffix(".log"))
        os.replace(lib, out)          # atomic: concurrent builds agree
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point `name`; ints go as c_int, floats as c_float, and
    device addresses (Ptr: tensor data pointers, the stream) and ctypes
    host arrays as c_void_p."""
    types = tuple(_ctype(a) for a in args)
    fn = _entry_points.get((name, types))
    if fn is None:
        fn = getattr(library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(types)
        _entry_points[(name, types)] = fn
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


_entry_points: dict = {}


class Ptr(int):
    """A device address (tensor.data_ptr() or a stream handle)."""


def _ctype(a):
    if isinstance(a, ctypes.Array):
        return ctypes.c_void_p        # a host array, passed by address
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        raise TypeError(f"unsupported kernel argument {a!r}")
    if isinstance(a, Ptr):
        return ctypes.c_void_p
    if isinstance(a, float):
        return ctypes.c_float
    return ctypes.c_int


def inv(x: float) -> float:
    """1/x rounded to float32, as PyTorch computes it on the card before it
    multiplies a tensor by it in place of dividing by the scalar x; the
    kernels use the same factor, so that they match the plain versions
    there."""
    return float(np.float32(1.0) / np.float32(x))


def ptr(t) -> Ptr:
    return Ptr(t.data_ptr())


def stream_ptr(device) -> Ptr:
    import torch
    return Ptr(torch.cuda.current_stream(device).cuda_stream)


def view(t, name, shape, dtype, device) -> list:
    """[address, s0, s1, s2] of tensor t broadcast to `shape` (at most 3
    dims), strides in elements, zero past its dims and on broadcast ones:
    a kernel reads the tensor where it lies.  Raises unless t is a tensor
    on `device` of this dtype whose shape broadcasts to `shape`."""
    import torch
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: a tensor is expected, not {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() > len(shape) or len(shape) > 3:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    try:
        v = t.expand(shape)
    except RuntimeError as e:
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not broadcast "
                         f"to {tuple(shape)}") from e
    # a dim the tensor lacks reads its one row: stride 0 (torch.expand
    # gives a new dim of size 1 a nonzero stride, which would make a table
    # look like one env's row at a single env)
    new = len(shape) - t.dim()
    strides = [0] * new + list(v.stride())[new:] + [0] * (3 - v.dim())
    if any(x < 0 for x in strides):
        raise ValueError(f"{name}: negative strides")
    return [v.data_ptr(), *strides]


def check(t, name, shape, dtype, device):
    """Raise unless tensor t lies on `device` with this dtype, shape and a
    contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
