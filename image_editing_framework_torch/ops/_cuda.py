"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one shared
library, built on first use into the build directory under a name
that carries a hash of the source and of the headers beside it
(``csrc/*.cuh``), so an edited source or header is rebuilt and an unchanged
one is loaded as it is. The assembler's report (``-Xptxas -v``:
registers, shared memory and spills of every kernel) is kept beside the
library. Nothing here runs at import time.

The build directory is ``$IEF_TORCH_BUILD_DIR`` when that variable is set
(for an installed package whose own directory is not writable), and the
package's ``_build/`` (ignored by git) otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR_ENV = "IEF_TORCH_BUILD_DIR"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

# name -> loaded library; a library is loaded once per process.
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def build_dir() -> str:
    """Where the libraries are built: ``$IEF_TORCH_BUILD_DIR`` if set, else
    the package's ``_build/``."""
    return os.environ.get(BUILD_DIR_ENV) or os.path.join(_PKG, "_build")


def _target(name: str) -> Tuple[str, str]:
    """The source and its library's path, named by a hash of the source and
    of every header in ``csrc/`` (which a source may include)."""
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for path in [src] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(build_dir(), f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already; returns the
    library's path. Raises with the compiler's output if nvcc fails."""
    src, out = _target(name)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write(proc.stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``csrc/<name>.cu`` (built
    here if it is not yet)."""
    with open(build(name) + ".ptxas.txt") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
