"""Wrappers of the hand-written Hopper kernels for UnoRC
(``csrc/unorc_kernels.cu``), replacing the Pallas TPU kernels of
``repro.kernels.rs_pallas`` and ``repro.kernels.quant_pallas``.

  * `gf_matmul` — K3: a static (M, K) GF(2^8) coefficient matrix times a
    batch of (K, B) byte matrices.  `use` labels the launch count: the
    RS encode rows are "encode", a solved decode matrix "decode".  The
    kernel takes the matrix as one select word per (row, bit, input)
    (`gf_planes`).
  * `quant_int8` — K4: blockwise absmax int8 over the last axis (256
    values per block), q and one f32 scale per block.
  * `dequant_int8` — K5: q * scale[block] in float32, or with an addend
    the receiver's fused dequantize-and-add fma(q, scale, acc) (counted
    as "dequant_int8/acc").

Each wrapper checks its operands and calls its custom op,
``torch.ops.repro_torch.gf_matmul`` / ``quant_int8`` / ``dequant_int8``,
whose implementations are the device rule: CPU tensors run the kernel's
plain version (`repro_torch.kernels.ref`); CUDA tensors launch the kernel
or raise — there is no fallback; meta tensors take the op's fake, the
kernel's output shapes and dtypes (the card's branch, never the plain
one), so a meta-device trace of the Uno step (``launch.dryrun``) sees
every launch as one op with its operands and results.  Each launch adds
one to ``LAUNCHES["<kernel>[/<use>]"]`` (`launch_key` names the key of an
op call); nothing else touches the counts.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fleet_cuda import _on_cuda, _raise_on

QUANT_BLOCK = 256
MAX_M, MAX_K = 4, 16            # the kernel's coefficient capacity
GF_BITS = 8
GF_MUL_K = (np.arange(MAX_K) & 2) != 0    # K3 terms taken as a multiply

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# ------------------------------------------------------------------ K3

def gf_planes(coeffs) -> np.ndarray:
    """K3's coefficient block (`GfPlanes` in the kernel source), as the
    kernel takes it by value: (MAX_M * GF_BITS * MAX_K + 2,) uint32, read
    only.  The first MAX_M * GF_BITS * MAX_K words, word[m][b][k], select
    x_k into bit plane b of output row m when bit b of coeffs[m][k] is
    set: as an AND mask (0xFFFFFFFF, else 0) where k & 2 == 0, as a
    multiplier (1, else 0) where k & 2 != 0 (`GF_MUL_K`), so that the
    kernel runs half its terms on the multiply pipe.  Then `live`, whose
    bit 8 m + b says plane (m, b) has a set bit, and `dbl`, whose bit
    8 m + b says a plane above b of row m has one (so the Horner step
    before plane b doubles an accumulator that may be nonzero)."""
    return _gf_planes(tuple(tuple(int(c) for c in row) for row in coeffs))


@functools.lru_cache(maxsize=256)
def _gf_planes(coeffs) -> np.ndarray:
    c = np.zeros((MAX_M, MAX_K), dtype=np.uint32)
    for m, row in enumerate(coeffs):
        c[m, :len(row)] = row
    bits = (c[:, None, :] >> np.arange(GF_BITS, dtype=np.uint32)[:, None]) & 1
    live = bits.any(axis=2)                                 # (MAX_M, 8)
    above = np.flip(np.cumsum(np.flip(live, 1), axis=1), 1) - live > 0
    weight = 1 << np.arange(MAX_M * GF_BITS, dtype=np.uint64)
    flags = [int((weight * f.ravel()).sum()) for f in (live, above)]
    select = np.where(GF_MUL_K, 1, 0xFFFFFFFF).astype(np.uint32)
    block = np.concatenate([(bits * select).ravel(),
                            np.array(flags, dtype=np.uint32)])
    block.setflags(write=False)
    return block


def gf_matmul(x: torch.Tensor, coeffs, *, use: str = "encode"
              ) -> torch.Tensor:
    """(M, K) GF(256) coefficients (nested Python ints, M <= 4, K <= 16)
    times x (..., K, B) uint8 -> (..., M, B) uint8, through
    ``torch.ops.repro_torch.gf_matmul``."""
    if x.dtype != torch.uint8 or x.dim() < 2:
        raise TypeError(f"x must be (..., K, B) uint8, got {x.dtype} "
                        f"{tuple(x.shape)}")
    k = x.shape[-2]
    if coeffs and any(len(row) != k for row in coeffs):
        raise ValueError(f"coeffs rows must have K={k} entries: {coeffs}")
    flat = [int(c) for row in coeffs for c in row]
    _check_gf(x, flat, len(coeffs))
    _on_cuda(x, meta=True)
    return torch.ops.repro_torch.gf_matmul(x, flat, len(coeffs), use)


def _check_gf(x, flat, m: int):
    """K3's operands, as the wrapper and the op's CUDA kernel check them:
    x (..., K, B) uint8 and contiguous, M x K byte coefficients row by
    row, M <= 4, K <= 16, fewer than 2**32 16-byte columns."""
    if x.dtype != torch.uint8 or x.dim() < 2:
        raise TypeError(f"x must be (..., K, B) uint8, got {x.dtype} "
                        f"{tuple(x.shape)}")
    k = x.shape[-2]
    if m > MAX_M or k > MAX_K:
        raise ValueError(f"gf_matmul takes M <= {MAX_M}, K <= {MAX_K}; got "
                         f"({m}, {k})")
    if len(flat) != m * k:
        raise ValueError(f"{len(flat)} coefficients for ({m}, {k})")
    if any(not 0 <= c <= 255 for c in flat):
        raise ValueError(f"coefficients must be bytes: {flat}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n_groups = math.prod(x.shape[:-2])
    if n_groups * -(-x.shape[-1] // 16) >= 1 << 32:
        raise ValueError(f"gf_matmul takes fewer than 2**32 16-byte columns "
                         f"in all; got {n_groups} x {x.shape[-1]} bytes")


def _nested(flat, m: int):
    k = len(flat) // m if m else 0
    return tuple(tuple(flat[i * k:(i + 1) * k]) for i in range(m))


@torch.library.custom_op("repro_torch::gf_matmul", mutates_args=())
def _gf_matmul_op(x: torch.Tensor, coeffs: list[int], m: int,
                  use: str) -> torch.Tensor:
    _on_cuda(x)
    raise AssertionError("unreachable: cpu and cuda have their kernels")


@_gf_matmul_op.register_fake
def _(x, coeffs, m, use):
    return x.new_empty(*x.shape[:-2], m, x.shape[-1])


@_gf_matmul_op.register_kernel("cpu")
def _(x, coeffs, m, use):
    return ref.gf_matmul_ref(_nested(coeffs, m), x)


@_gf_matmul_op.register_kernel("cuda")
def _(x, coeffs, m, use):
    _check_gf(x, coeffs, m)
    width = x.shape[-1]
    out = torch.empty(*x.shape[:-2], m, width, dtype=torch.uint8,
                      device=x.device)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build
    lib = build.load("unorc")
    planes = gf_planes(_nested(coeffs, m))
    vec = int(width % 16 == 0 and _aligned(x, out))
    err = lib.uno_gf_matmul(x.data_ptr(), out.data_ptr(),
                            planes.ctypes.data_as(ctypes.c_void_p),
                            math.prod(x.shape[:-2]), m, x.shape[-2], width,
                            vec, _stream())
    _raise_on(err, "uno_gf_matmul")
    LAUNCHES["gf_matmul/" + use] += 1
    return out


# ------------------------------------------------------------------ K4

def quant_int8(x: torch.Tensor):
    """x (..., N) float32, N % 256 == 0 -> (q int8 (..., N), scales f32
    (..., N / 256)), through ``torch.ops.repro_torch.quant_int8``.
    Leading rows may be strided (a column slice of a wider tensor); the
    last axis must be dense."""
    _check_quant(x)
    _on_cuda(x, meta=True)
    return torch.ops.repro_torch.quant_int8(x)


def _check_quant(x):
    if x.dtype != torch.float32 or x.dim() < 1:
        raise TypeError(f"x must be (..., N) float32, got {x.dtype}")
    if x.shape[-1] % QUANT_BLOCK:
        raise ValueError(f"last axis {x.shape[-1]} is not a multiple of "
                         f"{QUANT_BLOCK}")


@torch.library.custom_op("repro_torch::quant_int8", mutates_args=())
def _quant_int8_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _on_cuda(x)
    raise AssertionError("unreachable: cpu and cuda have their kernels")


@_quant_int8_op.register_fake
def _(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty(*x.shape[:-1], x.shape[-1] // QUANT_BLOCK))


@_quant_int8_op.register_kernel("cpu")
def _(x):
    return ref.quant_int8_ref(x, QUANT_BLOCK)


@_quant_int8_op.register_kernel("cuda")
def _(x):
    _check_quant(x)
    n = x.shape[-1]
    x2 = x.reshape(-1, n) if x.dim() != 2 else x
    if x2.stride(-1) != 1 or (x2.shape[0] > 1 and x2.stride(0) % 4):
        raise ValueError("x rows must be dense with a stride that is a "
                         "multiple of 4 floats")
    if not _aligned(x2):
        raise ValueError("x must be 16-byte aligned")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(*x.shape[:-1], n // QUANT_BLOCK,
                         dtype=torch.float32, device=x.device)
    if q.numel() == 0:
        return q, scales
    from repro_torch.kernels import build
    lib = build.load("unorc")
    err = lib.uno_quant_int8(x2.data_ptr(), q.data_ptr(), scales.data_ptr(),
                             x2.shape[0], n, x2.stride(0), _stream())
    _raise_on(err, "uno_quant_int8")
    LAUNCHES["quant_int8"] += 1
    return q, scales


# ------------------------------------------------------------------ K5

def dequant_int8(q: torch.Tensor, scales: torch.Tensor,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (..., N) int8, scales (..., N / 256) f32 -> (..., N) float32
    q * scale; with `acc` (float32, q's shape; leading rows may be
    strided) the fused fma(q, scale, acc), one rounding, into a new
    tensor (`acc` is read, not written).  Through
    ``torch.ops.repro_torch.dequant_int8``."""
    _check_dequant(q, scales, acc)
    _on_cuda(*((q, scales) if acc is None else (q, scales, acc)), meta=True)
    return torch.ops.repro_torch.dequant_int8(q, scales, acc)


def _check_dequant(q, scales, acc):
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"expected int8 q and float32 scales, got {q.dtype} "
                        f"and {scales.dtype}")
    n = q.shape[-1]
    if n % QUANT_BLOCK or tuple(scales.shape) != (*q.shape[:-1],
                                                   n // QUANT_BLOCK):
        raise ValueError(f"q {tuple(q.shape)} and scales "
                         f"{tuple(scales.shape)} do not match in blocks of "
                         f"{QUANT_BLOCK}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q and scales must be contiguous")
    if acc is not None and (acc.dtype != torch.float32
                            or acc.shape != q.shape):
        raise ValueError(f"acc must be float32 of q's shape {tuple(q.shape)}")


@torch.library.custom_op("repro_torch::dequant_int8", mutates_args=())
def _dequant_int8_op(q: torch.Tensor, scales: torch.Tensor,
                     acc: Optional[torch.Tensor]) -> torch.Tensor:
    _on_cuda(q)
    raise AssertionError("unreachable: cpu and cuda have their kernels")


@_dequant_int8_op.register_fake
def _(q, scales, acc):
    return q.new_empty(q.shape, dtype=torch.float32)


@_dequant_int8_op.register_kernel("cpu")
def _(q, scales, acc):
    return ref.dequant_int8_ref(q, scales, QUANT_BLOCK, acc=acc)


@_dequant_int8_op.register_kernel("cuda")
def _(q, scales, acc):
    _check_dequant(q, scales, acc)
    _on_cuda(*((q, scales) if acc is None else (q, scales, acc)))
    n = q.shape[-1]
    q2 = q.reshape(-1, n)
    acc2, ld = None, 0
    if acc is not None:
        acc2 = acc.reshape(-1, n) if acc.dim() != 2 else acc
        ld = acc2.stride(0)
        if acc2.stride(-1) != 1 or (acc2.shape[0] > 1 and ld % 4) \
                or not _aligned(acc2):
            raise ValueError("acc rows must be dense, 16-byte aligned, with "
                             "a stride that is a multiple of 4 floats")
    if not _aligned(q2):
        raise ValueError("q must be 16-byte aligned")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build
    lib = build.load("unorc")
    err = lib.uno_dequant_int8(q2.data_ptr(), scales.data_ptr(),
                               None if acc2 is None else acc2.data_ptr(),
                               out.data_ptr(), q2.shape[0], n, ld, _stream())
    _raise_on(err, "uno_dequant_int8")
    LAUNCHES["dequant_int8" if acc is None else "dequant_int8/acc"] += 1
    return out


# ------------------------------------------------------- launch accounting

def launch_key(op_name: str, args, kwargs) -> Optional[str]:
    """The ``LAUNCHES`` key that a call of one of the three custom ops
    counts when its kernel launches (`op_name` as ``OpOverload.name()``
    gives it), or None for any other op.  The dry run's op counter
    (``launch.op_costs``) bills a meta trace's launches with it."""
    if op_name == "repro_torch::gf_matmul":
        use = args[3] if len(args) > 3 else kwargs["use"]
        return "gf_matmul/" + use
    if op_name == "repro_torch::quant_int8":
        return "quant_int8"
    if op_name == "repro_torch::dequant_int8":
        acc = args[2] if len(args) > 2 else kwargs.get("acc")
        return "dequant_int8" if acc is None else "dequant_int8/acc"
    return None
