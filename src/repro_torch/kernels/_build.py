"""Build a CUDA source into a shared library with a plain C interface and
load it with ctypes.

Each library is compiled once for Hopper (``sm_90a``) with ``nvcc`` into
``build/`` at the root of the checkout, named by a hash of its sources and
flags, so an unchanged source is not rebuilt and a changed one never loads a
stale library. Nothing is built at import time: a kernel's wrapper calls
``load`` at its first launch, or a caller builds it before timing starts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from typing import Dict, Optional, Tuple

BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's report (ptxas: registers, shared memory, spills per kernel) of each
# library this process built, by name
REPORTS = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def load(name: str, sources: Tuple[str, ...],
         defines: Optional[Dict[str, int]] = None) -> ctypes.CDLL:
    """Compile ``sources`` (absolute paths) into ``build/<name>-<hash>.so``
    unless it is there already, and load it, with each of ``defines`` set
    as a macro (``-DNAME=VALUE``). nvcc's report (registers, shared memory,
    spills per kernel) goes to stderr and ``REPORTS`` when it builds."""
    flags = (*NVCC_FLAGS,
             *(f"-D{k}={v}" for k, v in sorted((defines or {}).items())))
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        REPORTS[name] = proc.stdout + proc.stderr
        print(f"built {os.path.basename(out)}:\n{REPORTS[name]}",
              file=sys.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(out)
