"""Build a kernel source with nvcc into a shared library with a plain C
interface, for ``ctypes``.

Each library goes into ``build/`` beside this file (git-ignored), named
after the source and the hash of its text, so a changed source builds
anew and concurrent builds agree.  Nothing is built when a module is
imported: the wrappers build at their first launch (or when a caller such
as ``chip_smoke.py`` asks for it).
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless a library of the same hash exists.
    Returns (path of the library, compiler output, or '' when cached)."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return lib, proc.stdout + proc.stderr
