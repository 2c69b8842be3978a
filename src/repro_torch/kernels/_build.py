"""Build a CUDA source into a shared library with a plain C interface and
load it with ctypes.

Each library is compiled once for Hopper (``sm_90a``) with ``nvcc`` into
``build/`` at the root of the checkout, named by a hash of its flags, its
sources and the headers they include with ``#include "..."`` (found beside
the including file, followed through the headers' own includes), so an
unchanged library is not rebuilt and a changed source or header never loads
a stale one. Nothing is built at import time: a kernel's wrapper calls
``load`` at its first launch, or a caller builds it before timing starts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _files(sources: Tuple[str, ...]) -> List[str]:
    """The sources, then every header they include with ``#include "..."``
    that lies beside the including file, each once, in the order found."""
    out, todo = [], list(sources)
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for inc in _LOCAL_INCLUDE.findall(text):
            found = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(found):
                todo.append(os.path.abspath(found))
    return out


def library_path(name: str, sources: Tuple[str, ...],
                 defines: Optional[Dict[str, int]] = None
                 ) -> Tuple[str, Tuple[str, ...]]:
    """(``build/<name>-<hash>.so``, nvcc's flags): the hash covers the
    flags, the sources and the headers they include."""
    flags = (*NVCC_FLAGS,
             *(f"-D{k}={v}" for k, v in sorted((defines or {}).items())))
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _files(sources):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so"), flags


def load(name: str, sources: Tuple[str, ...],
         defines: Optional[Dict[str, int]] = None) -> ctypes.CDLL:
    """Compile ``sources`` (absolute paths) into ``library_path``'s file
    unless it is there already, and load it, with each of ``defines`` set
    as a macro (``-DNAME=VALUE``). nvcc's report (registers, shared memory,
    spills per kernel) goes to stderr and ``REPORTS`` when it builds."""
    out, flags = library_path(name, sources, defines)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # a name of this thread's own: threads may build one library at once
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
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
