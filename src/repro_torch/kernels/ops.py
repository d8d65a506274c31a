"""The UnoRC kernel API (``repro.kernels.ops``'s RS / quant / byte half):
pads, reshapes and calls the `unorc_cuda` wrappers, which launch the
Hopper kernels for CUDA tensors and run the plain versions for CPU ones.

The TPU kernels' tile paddings (``rs_pallas.TILE_B``, ``quant_pallas.ROWS
* 256``) are not part of the contract: RS calls take any row width, and
quantization pads only to the 256-value block, so (q, scales, n0) and the
row widths equal the reference's wire format in its ref mode.  Every
function takes leading batch dims; a 1-D (or (k, B)) input is the
reference's own contract.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import gf, unorc_cuda

QUANT_BLOCK = unorc_cuda.QUANT_BLOCK


def pad_to(x: torch.Tensor, width: int) -> torch.Tensor:
    """x zero-padded on the last axis to `width` (x itself if it is)."""
    pad = width - x.shape[-1]
    return F.pad(x, (0, pad)) if pad else x


def _pad_last(x: torch.Tensor, mult: int):
    n = x.shape[-1]
    return pad_to(x, n + (-n) % mult), n


# ----------------------------------------------------------------- RS coding

def rs_encode(data: torch.Tensor, r: int) -> torch.Tensor:
    """Systematic RS parity over packet rows: (..., k, B) uint8 -> (..., r,
    B) uint8."""
    return unorc_cuda.gf_matmul(
        data, gf.rs_generator_rows(data.shape[-2], r), use="encode")


def rs_decode(survivors: torch.Tensor, k: int, r: int, missing,
              parity_avail) -> torch.Tensor:
    """Reconstruct the `missing` data rows (..., m, B) from survivors (...,
    n_sur, B) ordered [present data rows asc] + [available parity asc]."""
    missing = tuple(sorted(int(i) for i in missing))
    parity_avail = tuple(sorted(int(i) for i in parity_avail))
    if not missing:
        return survivors[..., :0, :]
    return unorc_cuda.gf_matmul(
        survivors, gf.rs_decode_matrix(k, r, missing, parity_avail),
        use="decode")


def rs_block_roundtrip(data: torch.Tensor, r: int, missing,
                       parity_avail=None):
    """Encode, erase the `missing` data rows and every parity row not in
    `parity_avail` (default: none), decode the data rows back.  Returns
    (parity, recovered rows)."""
    k = data.shape[-2]
    parity = rs_encode(data, r)
    parity_avail = tuple(range(r)) if parity_avail is None \
        else tuple(sorted(parity_avail))
    present = [i for i in range(k) if i not in set(missing)]
    survivors = torch.cat([data[..., present, :],
                           parity[..., list(parity_avail), :]], dim=-2)
    return parity, rs_decode(survivors, k, r, missing, parity_avail)


# ---------------------------------------------------------------- int8 quant

def quant_int8(x: torch.Tensor):
    """(..., N) float -> (q int8 (..., Npad), scales f32 (..., Npad / 256),
    n0 = N), each leading row padded with zeros to a whole block."""
    padded, n0 = _pad_last(x.to(torch.float32), QUANT_BLOCK)
    q, s = unorc_cuda.quant_int8(padded)
    return q, s, n0


def dequant_int8(q: torch.Tensor, scales: torch.Tensor, n0: int,
                 dtype=torch.float32, acc=None) -> torch.Tensor:
    """(..., n0) q * scale cast to `dtype`; with `acc` ((..., n0) float32)
    the fused fma(q, scale, acc), one rounding."""
    if acc is not None:
        acc = pad_to(acc, q.shape[-1])
    return unorc_cuda.dequant_int8(q, scales, acc)[..., :n0].to(dtype)


# ------------------------------------------------------------ float <-> bytes

def f32_to_bytes_rows(x: torch.Tensor, k: int):
    """Pack a float32 vector into k equal uint8 rows (RS packet framing);
    returns (rows (k, B), n0 bytes)."""
    raw = x.to(torch.float32).contiguous().reshape(-1).view(torch.uint8)
    padded, n0 = _pad_last(raw, k)
    return padded.reshape(k, -1), n0


def bytes_rows_to_f32(rows: torch.Tensor, n0: int) -> torch.Tensor:
    return rows.reshape(-1)[:n0].contiguous().view(torch.float32)
