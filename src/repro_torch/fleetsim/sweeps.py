"""Fleet-wide summaries: compensated float32 sums and the Jain index.

The port of ``repro.fleetsim.sweeps.fleet_sum`` / ``jain``; the grid
sweeps themselves belong to a later slice.
"""
from __future__ import annotations

import torch

_SUM_CHUNK = 1024


def fleet_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Compensated float32 sum along `dim`, accurate at 10^6+ flows:
    per-chunk sums of `_SUM_CHUNK` values joined by a Neumaier-compensated
    carry across chunks."""
    x = torch.movedim(torch.as_tensor(x).to(torch.float32), dim, -1)
    n = x.shape[-1]
    pad = (-n) % _SUM_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    chunks = torch.movedim(x.reshape(x.shape[:-1] + (-1, _SUM_CHUNK)), -2, 0)
    s = x.new_zeros(x.shape[:-1])
    comp = x.new_zeros(x.shape[:-1])
    for c in chunks:
        y = torch.sum(c, dim=-1)
        t = s + y
        comp = comp + torch.where(torch.abs(s) >= torch.abs(y),
                                  (s - t) + y, (y - t) + s)
        s = t
    return s + comp


def jain(rates: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Jain fairness index along `dim` (1.0 = perfectly fair)."""
    s = fleet_sum(rates, dim=dim)
    s2 = fleet_sum(rates * rates, dim=dim)
    n = rates.shape[dim]
    return s * s / torch.clamp(n * s2, min=1e-12)
