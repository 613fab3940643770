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
# flags of one kernel beside NVCC_FLAGS: D repeats PyTorch's rounding, each
# product and sum rounded apart (csrc/disney_bsdf.cu)
KERNEL_FLAGS = {"disney_bsdf": ("-fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc processes started and not yet waited for, by kernel name:
# (process, start time, temporary output, library path)
_building: Dict[str, Tuple[subprocess.Popen, float, Path, Path]] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def kernel_flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for kernel `name`: NVCC_FLAGS and its own."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    """The library's path, keyed by a hash of source, headers and flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(kernel_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def start_builds(names: Iterable[str], force: bool = False) -> None:
    """Start one nvcc process for each named kernel not built yet (each of
    them if `force`) and not being built already, and return without
    waiting; `build_libraries` and `load_function` wait for them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        so = library_path(name)
        if name in _building or (so.exists() and not force):
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *kernel_flags(name), "-o", str(tmp),
               str(source_path(name))]
        _building[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True),
                           time.perf_counter(), tmp, so)


def build_libraries(names: Iterable[str], force: bool = False
                    ) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels, one nvcc process each, all started
    together, and wait for them; skip those already built unless `force`.
    Returns per name built (seconds since its start, compiler output);
    raises if any build fails."""
    names = list(names)
    start_builds(names, force)
    results, failed = {}, []
    for name in names:
        if name not in _building:
            continue
        proc, t0, tmp, so = _building.pop(name)
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
