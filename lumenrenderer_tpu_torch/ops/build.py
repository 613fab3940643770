"""Build, load and check the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` (with the shared headers `csrc/*.cuh`)
is compiled by nvcc for Hopper (`sm_90a`) into a shared library with a plain
C entry, `build/kernels/<name>-<hash>.so`, at first use. The hash covers the
source, the headers and the flags, so an edit rebuilds. The library is loaded
with ctypes; no PyTorch headers and no ninja are needed, and nothing is built
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_STATIC_SMEM = 48 * 1024  # launch limit without an opt-in attribute

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """The library's path, keyed by a hash of source, headers and flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names: Iterable[str], force: bool = False
                    ) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels, one nvcc process each, all started
    together; skip those already built unless `force`. Returns per name
    (seconds spent, compiler output); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists() and not force:
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, so)
    results, failed = {}, []
    for name, (proc, t0, tmp, so) in procs.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        results[name] = (seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load_function(name: str, entry: str, argtypes: Sequence):
    """The C entry `entry` of kernel library `name` (built if missing), with
    its argument types set; the entry returns a CUDA error code."""
    lib = _loaded.get(name)
    if lib is None:
        build_libraries([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_tensors(device: torch.device,
                  expect: Mapping[str, Tuple[torch.Tensor, torch.dtype, tuple]]
                  ) -> None:
    """Raise ValueError unless every tensor lies on `device`, has the dtype
    and shape given, and is contiguous."""
    for name, (x, dtype, shape) in expect.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch(fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry with `args` and the current stream of
    `device`, with `device` current; raise if the launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
