"""ctypes binding of the native binned-SAH builder, `native/bvh_native.cpp`.

Port of `lumenrenderer_tpu/native/bvh_native.py`. The JAX package loads a
library that `make -C native` writes into its own directory; the port
compiles the same source with g++ and the Makefile's flags into
`build/native/libbvh_native-<hash>.so` at first use (the hash covers the
source and the flags, so an edit rebuilds) and never loads the JAX
package's library. `accel/sah.py` tries this builder first and falls back
to the numpy one, whose partition it may not equal (ROADMAP C-8).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "bvh_native.cpp"
BUILD_DIR = REPO / "build" / "native"
# native/Makefile's CXXFLAGS, and -shared as its rule adds
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-shared")

_LIB = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libbvh_native-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the builder (if not built yet) and return its path; raises
    RuntimeError when no C++ compiler is found or the build fails."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "SAH builder")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        f, i = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.lumen_build_sah.restype = ctypes.c_int
        lib.lumen_build_sah.argtypes = [
            f, ctypes.c_int32, ctypes.c_int32, f, f, i, i, i,
            ctypes.c_int32, ctypes.c_int32, i, i, i]
        _LIB = lib
    return _LIB


def build_sah(tri_pos: np.ndarray, leaf_size: int = 4):
    """Same contract as `accel.sah.build_sah_arrays`: (node_lo, node_hi,
    child0, child1, order (S,) int64, max_depth)."""
    lib = _load()
    tp = np.ascontiguousarray(tri_pos, np.float32)
    n = tp.shape[0]
    max_nodes = max(2 * n, 16)
    max_slots = max(((2 * n + leaf_size - 1) // leaf_size + 2) * leaf_size,
                    4 * leaf_size)
    node_lo = np.empty((max_nodes, 3), np.float32)
    node_hi = np.empty((max_nodes, 3), np.float32)
    child0 = np.empty(max_nodes, np.int32)
    child1 = np.empty(max_nodes, np.int32)
    order = np.empty(max_slots, np.int32)
    n_nodes, n_leaves, max_depth = (ctypes.c_int32() for _ in range(3))

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.lumen_build_sah(
        fp(tp), n, leaf_size, fp(node_lo), fp(node_hi), ip(child0),
        ip(child1), ip(order), max_nodes, max_slots, ctypes.byref(n_nodes),
        ctypes.byref(n_leaves), ctypes.byref(max_depth))
    if rc != 0:
        raise RuntimeError(f"lumen_build_sah failed with code {rc}")
    nn, nl = n_nodes.value, n_leaves.value
    return (node_lo[:nn].copy(), node_hi[:nn].copy(), child0[:nn].copy(),
            child1[:nn].copy(), order[:nl * leaf_size].astype(np.int64),
            int(max_depth.value))
