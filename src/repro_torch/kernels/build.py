"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` (`SOURCES`) is compiled by `nvcc` for Hopper
(sm_90a) into its own shared library with a plain C interface, loaded with
ctypes.  The libraries land in ``src/repro_torch/_build/`` (listed in
.gitignore), each named by a hash of its source and the flags, so a
changed source rebuilds and an unchanged one is built once per checkout.
`build_all()` starts one nvcc per missing library, all at once, and waits
for them.  Nothing is built when this module is imported; `load(name)`
builds at first use and raises if it cannot; its first call for a
library is the span `kernels.load` of `repro_torch.trace`.
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

from repro_torch.trace import span

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = {"fleet": _HERE / "csrc" / "fleet_kernels.cu",
           "unorc": _HERE / "csrc" / "unorc_kernels.cu"}
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> {C entry point: argtypes}; every entry point returns an int error
_SIGNATURES = {
    "fleet": {"uno_segsum_tile": [],
              "uno_link_scatter": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
              "uno_link_scatter_tiles": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _P],
              "uno_link_gathers": [_P, _P, _P, _P, _I, _P, _LL, _I, _P],
              "uno_pt_gathers": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _LL,
                                 _LL, _I, _P],
              "uno_rel_epoch": [_P, _P, _LL, _I, _LL, _I, _I, _P],
              "uno_lb_update": [_P, _P, _LL, _I, _P]},
    "unorc": {"uno_gf_matmul": [_P, _P, _P, _LL, _I, _I, _LL, _I, _P],
              "uno_quant_int8": [_P, _P, _P, _LL, _LL, _LL, _P],
              "uno_dequant_int8": [_P, _P, _P, _P, _LL, _LL, _LL, _P]},
}

_LIBS: dict = {}
BUILD_INFO: dict = {}       # name -> {"seconds", "cached", "ptxas"}


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


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCES[name].stem}-{digest}.so"


def build_all(names=None) -> dict:
    """Compile every named source (default: all) whose library is missing,
    one nvcc each, started together.  Records each build's seconds and
    nvcc's resource report in BUILD_INFO[name]; raises if any build
    fails.  Returns {name: library path}."""
    names = list(SOURCES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    for n in names:
        if n not in todo:
            BUILD_INFO.setdefault(n, dict(seconds=0.0, cached=True, ptxas=""))
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp, time.perf_counter())
        failed = []
        for n, (proc, tmp, t0) in jobs.items():
            report, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {SOURCES[n].name} failed "
                              f"({proc.returncode}):\n{report}")
                continue
            os.replace(tmp, paths[n])
            BUILD_INFO[n] = dict(seconds=time.perf_counter() - t0,
                                 cached=False, ptxas=report.strip())
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


def load(name: str):
    """The loaded ctypes library of source `name`, building it first if
    needed."""
    if name not in _LIBS:
        with span("kernels.load"):
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            _LIBS[name] = lib
    return _LIBS[name]
