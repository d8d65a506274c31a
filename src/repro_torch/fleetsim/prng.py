"""threefry2x32 in torch integer ops: the counter-based PRNG behind churn
and the Gilbert-Elliott burst chains, bit for bit as ``jax.random``
computes it with ``jax_threefry_partitionable=True`` (the default of
jax 0.9) and 64-bit types off (jax's default).

  * `PRNGKey(seed)` — the key (0, seed mod 2**32): jax wraps a Python
    seed to int32 before splitting it into two words, so the high word
    is always 0;
  * `split(key, num)` — row i is threefry2x32(key, (hi(i), lo(i))), the
    C-order index i cut into two 32-bit words;
  * `fold_in(key, d)` — threefry2x32(key, (0, d));
  * `random_bits(key, shape)` — bits1 ^ bits2 of threefry2x32 over the
    same index counters;
  * `uniform(key, shape)` — floats in [0, 1): the top 23 bits as a
    mantissa under exponent 0, bitcast, minus 1.0;
  * `split_uniform(key, n)` — an epoch's draw from a carried key: the
    key split, the first half carried on, n uniforms from the second.

torch's uint32 lacks most arithmetic, so every word is an int64 tensor
holding a value in [0, 2**32), masked after each add and left shift.  A
key is a (2,) int64 tensor on the device of the state it drives; a
batch of keys is a (..., 2) tensor, and each function above then draws
for every key at once, one threefry2x32 evaluation over the batch: the
result carries the keys' batch shape in front (`split` (..., num, 2),
`uniform` (...,) + shape), each row bitwise the single key's draw (as
`jax.vmap` of the same function).  This is plain torch on every device
(about 160 elementwise kernels a threefry2x32 call, whatever the batch);
nothing here reads a device value on the host.  `CALLS` counts the
threefry2x32 evaluations, each of which is one `prng.threefry2x32` span
of `repro_torch.trace`.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.trace import span

_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000      # 1.0f: exponent 0, mantissa 0

CALLS: Counter = Counter()


def reset_calls() -> None:
    CALLS.clear()


def PRNGKey(seed, device=None) -> torch.Tensor:   # noqa: N802 (jax's)
    """The (2,) int64 key of an integer seed, on `device` (default cuda);
    a sequence of seeds gives the (len(seed), 2) batch of their keys."""
    if isinstance(seed, (int, np.integer)):
        words = [0, int(seed) & _MASK]
    else:
        words = [[0, int(s) & _MASK] for s in np.asarray(seed).reshape(-1)]
    return torch.tensor(words, dtype=torch.int64,
                        device=resolve_device(device))


def threefry2x32(key: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    (x1, x2) under `key` ((..., 2); its words key[..., 0] and key[..., 1]
    broadcast against the counters); int64 words in [0, 2**32).  Returns
    the two output words."""
    CALLS["threefry2x32"] += 1
    with span("prng.threefry2x32"):
        k1, k2 = key[..., 0], key[..., 1]
        ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
        x1 = (x1 + k1).bitwise_and_(_MASK)
        x2 = (x2 + k2).bitwise_and_(_MASK)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x1.add_(x2).bitwise_and_(_MASK)
                x2 = (x2 << r).bitwise_and_(_MASK).bitwise_or_(x2 >> (32 - r))
                x2.bitwise_xor_(x1)
            x1.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
            x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
        return x1, x2


def _counters(shape: Sequence[int], device):
    """The (hi, lo) words of the C-order flat index over `shape`."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def _keyed(key: torch.Tensor, ndim: int) -> torch.Tensor:
    """`key` ((..., 2)) viewed so that its words broadcast against
    counters of `ndim` dimensions: (...,) + (1,) * ndim + (2,)."""
    return key.reshape(key.shape[:-1] + (1,) * ndim + (2,))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys of each key, a (..., num, 2) tensor."""
    b1, b2 = threefry2x32(_keyed(key, 1), *_counters((num,), key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key (each key of a batch) with the 32-bit `data` folded in."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(_keyed(key, 1), zero, zero + (int(data) & _MASK))
    return torch.cat([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Uniform 32-bit words of key.shape[:-1] + `shape` (int64 holding
    [0, 2**32))."""
    b1, b2 = threefry2x32(_keyed(key, len(shape)),
                          *_counters(shape, key.device))
    return b1.bitwise_xor_(b2)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 draws in [0, 1) of key.shape[:-1] + `shape`."""
    bits = (random_bits(key, shape) >> 9).bitwise_or_(_ONE_BITS)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def split_uniform(key: torch.Tensor, n: int):
    """One epoch's draw from a carried key: (key', u).  Each key splits
    in two, the first half carried on and the second drawing `n` float32
    uniforms in all, n / cells for each of a batch's keys, cell-major
    (a grid's (cells, 2) keys draw every cell's share in one
    threefry2x32 call, bitwise the cells' own draws)."""
    keys = split(key)
    cells = key.numel() // 2
    return keys[..., 0, :], uniform(keys[..., 1, :], (n // cells,)) \
        .reshape(-1)
