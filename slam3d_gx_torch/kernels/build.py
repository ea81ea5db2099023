"""Build the CUDA sources under `csrc/` with nvcc, load them with ctypes
and launch their C entries on PyTorch's current stream.

Each source becomes one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`), built at first use into `slam3d_gx_torch/_build/` (listed in
.gitignore) and reused by later calls. The library's file name carries
a hash of the source text and the compiler flags, so an edited source is
built anew and never answered with a stale library. `build_all` starts
one nvcc per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str, source_text: str) -> str:
    """Where the library of csrc/<name>.cu with this text is built."""
    key = hashlib.sha256("\0".join([source_text, *NVCC_FLAGS]).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        return lib_path(name, f.read())


def _nvcc_cmd(name: str, out: str):
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, in parallel.
    Returns {name: nvcc's ptxas report}; raises on the first failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if name in _libs or os.path.exists(path):
            continue
        tmp = path + f".{os.getpid()}.tmp"
        procs[name] = (tmp, path, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports = {}
    for name, (tmp, path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, path)
        reports[name] = out
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def bind(name: str, argtypes: Dict[str, list]) -> Dict[str, object]:
    """The C functions of csrc/<name>.cu named in `argtypes`, each typed
    (arguments as given, an int result), built and loaded first if needed.
    A wrapper calls this once and keeps the result."""
    lib = load(name)
    fns = {}
    for entry, types in argtypes.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = types, ctypes.c_int
        fns[entry] = fn
    return fns


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Call the C entry `fn` with `args` and `device`'s current stream;
    raise if the launch is refused. Enters `device` only when it is not
    the current one."""
    # PyTorch's own bindings for the current device and the handle of a
    # device's current stream, which build no torch.cuda.Stream object
    current = torch._C._cuda_getDevice()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    check(rc, name)
