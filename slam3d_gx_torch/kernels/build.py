"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each source becomes one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`), built at first use into `slam3d_gx_torch/_build/` (listed in
.gitignore) and reused by later calls of the same process. `build_all`
starts one nvcc per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc_cmd(name: str, out: str):
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, in parallel.
    Returns {name: nvcc's ptxas report}; raises on the first failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if name in _libs or os.path.exists(_lib_path(name)):
            continue
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, _lib_path(name))
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
