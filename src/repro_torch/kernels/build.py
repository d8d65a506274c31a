"""Build and load the hand-written CUDA kernels.

`nvcc` compiles ``csrc/fleet_kernels.cu`` for Hopper (sm_90a) into a shared
library with a plain C interface, which is loaded with ctypes.  The library
lands in ``src/repro_torch/_build/`` (listed in .gitignore), named by a hash
of the source and the flags, so a changed source rebuilds and an unchanged
one is built once per checkout.  Nothing is built when this module is
imported; `load()` builds at first use and raises if it cannot.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "fleet_kernels.cu"
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """`$CUDA_HOME/bin/nvcc`, else /usr/local/cuda's, else the PATH's."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME)")
    return found


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fleet_kernels-{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless this source's library already exists.
    Records the build seconds and nvcc's resource report in BUILD_INFO."""
    out = library_path()
    if out.is_file():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=(proc.stdout + proc.stderr).strip())
    return out


def load():
    """The loaded ctypes library, building it first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.uno_link_scatter.argtypes = [p, p, p, p, i, p]
        lib.uno_link_scatter.restype = i
        lib.uno_link_gathers.argtypes = [p, p, p, p, p, i, i, p]
        lib.uno_link_gathers.restype = i
        _LIB = lib
    return _LIB
