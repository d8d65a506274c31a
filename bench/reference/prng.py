"""threefry2x32 in plain torch integer ops (jax.random's counter-based
PRNG with partitionable threefry and 32-bit types): keys, splits, fold-in
and float32 uniforms, each word an int64 holding [0, 2**32).  A batch of
keys (..., 2) draws for every key at once."""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000


def key_of(seed, device) -> torch.Tensor:
    """(2,) key of an integer seed, (len, 2) of a sequence of seeds."""
    if isinstance(seed, (int, np.integer)):
        words = [0, int(seed) & _MASK]
    else:
        words = [[0, int(s) & _MASK] for s in np.asarray(seed).reshape(-1)]
    return torch.tensor(words, dtype=torch.int64, device=device)


def threefry2x32(key, x1, x2):
    k1, k2 = key[..., 0], key[..., 1]
    ks = (k1, k2, (k1 ^ k2) ^ _KS_PARITY)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) & _MASK) | (x2 >> (32 - r))
            x2 = x2 ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _counters(shape, device):
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def _keyed(key, ndim):
    return key.reshape(key.shape[:-1] + (1,) * ndim + (2,))


def split(key, num: int = 2):
    b1, b2 = threefry2x32(_keyed(key, 1), *_counters((num,), key.device))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int):
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(_keyed(key, 1), zero, zero + (int(data) & _MASK))
    return torch.cat([b1, b2], dim=-1)


def uniform(key, shape):
    b1, b2 = threefry2x32(_keyed(key, len(shape)),
                          *_counters(shape, key.device))
    bits = ((b1 ^ b2) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0


def split_uniform(key, n: int):
    """(key', u): the key split, its first half carried on, `n` uniforms
    from the second, n / cells for each of a batch's keys, cell-major."""
    keys = split(key)
    cells = key.numel() // 2
    return keys[..., 0, :], uniform(keys[..., 1, :], (n // cells,)).reshape(-1)
