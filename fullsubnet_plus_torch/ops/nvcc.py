"""Build and load the port's CUDA kernels (csrc/*.cu, plain C entry points).

Each source is compiled by nvcc for sm_90a into a shared library under
fullsubnet_plus_torch/_build/ (git-ignored), named after the source and a
digest of its bytes and of the headers (csrc/*.cuh) it may include, once
per source version, at first use; the ptxas
report (`-Xptxas -v`: registers, spills) is kept beside it. The library is
loaded with ctypes. Nothing here runs at import, so the CPU tests import the
kernels' modules without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_libraries: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build(stem: str) -> Path:
    """Compile csrc/<stem>.cu (once per source version) and return the
    shared library's path. Raises RuntimeError with nvcc's output if the
    build fails."""
    from torch.utils.cpp_extension import CUDA_HOME

    source = CSRC_DIR / f"{stem}.cu"
    sha = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        sha.update(header.read_bytes())
    digest = sha.hexdigest()[:12]
    lib_path = BUILD_DIR / f"{stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        lib_path.with_name(lib_path.stem + ".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load(stem: str, symbol: str, argtypes: list) -> ctypes.CDLL:
    """The built library of csrc/<stem>.cu with `symbol`'s signature set
    (returns int: a cudaError_t). Builds it first if needed."""
    with _lock:
        lib = _libraries.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libraries[stem] = lib
    return lib
