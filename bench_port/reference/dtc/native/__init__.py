"""ctypes binding for the native terrain generator (terrain_gen.cpp).

A copy of the JAX package's native/ generator: the same C++ source, built
with the same `g++ -O2 -shared -fPIC`, so that a seed gives this package
the JAX package's world bit for bit.  The shared library is compiled on
first use into the package's `_build/` (named by a hash of the source,
written atomically, so that concurrent first uses agree) and never next
to the source; without g++ the library is unavailable and `Terrain`'s
"auto" backend takes the Python generators.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "terrain_gen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libdtcterrain_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    out = library_path()
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            so = os.path.join(tmp, "lib.so")
            subprocess.run(["g++", *CXX_FLAGS, "-o", so, str(_SRC)],
                           check=True, capture_output=True)
            os.replace(so, out)
    except (OSError, subprocess.CalledProcessError):
        return None
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.dtc_generate_terrain.restype = ctypes.c_int
    lib.dtc_generate_terrain.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def generate_terrain(cfg, seed: int):
    """Native world generation; returns (heightfield int16 (R,C),
    env_origins (rows, cols, 3)) or None if the library is unavailable.

    cfg is a TerrainCfg (env/config.py)."""
    lib = _load()
    if lib is None:
        return None
    lpx = int(cfg.terrain_length / cfg.horizontal_scale)
    wpx = int(cfg.terrain_width / cfg.horizontal_scale)
    border = int(cfg.border_size / cfg.horizontal_scale)
    rows = cfg.num_rows * lpx + 2 * border
    cols = cfg.num_cols * wpx + 2 * border
    hf = np.zeros((rows, cols), dtype=np.int16)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3), dtype=np.float64)
    props = np.ascontiguousarray(cfg.terrain_proportions, dtype=np.float64)
    ret = lib.dtc_generate_terrain(
        cfg.num_rows, cfg.num_cols, cfg.terrain_length, cfg.terrain_width,
        cfg.border_size, cfg.horizontal_scale, cfg.vertical_scale,
        props.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(props),
        1 if cfg.curriculum else 0, seed,
        hf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        origins.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert ret == rows * 100000 + cols, "native terrain shape mismatch"
    return hf, origins
