"""Seeded operands of the epoch step's LB phase (`cc.lb_update_plain`:
the per-path mark filter, the repath count, the multiplicative weights
and the simplex projection), for its CPU tests (test_torch_lb_update.py)
and its kernel's on the card (test_torch_kernels_gpu.py).  Imports no
JAX.

Per flow: eta, the repath threshold and patience, w_floor and the filter
gain fb drawn apart (a tenth of the flows with w_floor 0); masks with
empty slots anywhere in the row, and a few rows with no path at all.
The edge rows, every 16 flows: a row whose filtered marks land exactly
on its threshold (not bad); one one bad epoch short of its patience with
every path marking (the repath fires, its weights drop to the floor);
one with no weight and no floor (the row sum is 0: the uniform split);
one whose eta drives every weight to 0 (exp underflows) with no floor.
"""
import numpy as np
import torch

from repro_torch.fleetsim.state import LbParams


def lb_inputs(n: int, n_paths: int, seed: int = 0, device="cpu"):
    """(lb, fb, mask, split, path_frac, sub_frac, bad_count) for `n`
    flows over `n_paths` path slots."""
    rng = np.random.default_rng(seed)
    p = n_paths
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    mask = rng.uniform(size=(n, p)) < 0.8
    mask[np.arange(n), rng.integers(0, p, n)] = True
    mask[7::97] = False                       # rows with no path
    eta = f32(rng.uniform(0.5, 20.0, n))
    thresh = f32(rng.uniform(0.05, 0.6, n))
    patience = rng.integers(1, 5, n).astype(np.int32)
    w_floor = f32(rng.uniform(0.0, 0.1, n))
    w_floor[::10] = 0.0
    fb = f32(rng.uniform(0.0, 1.0, n))
    fb[::9] = 1.0
    split = f32(rng.dirichlet(np.ones(p), n) * mask)
    path_frac = f32(rng.uniform(0.0, 1.0, (n, p)))
    sub_frac = f32(rng.uniform(0.0, 1.0, (n, p)))
    bad_count = rng.integers(0, 5, (n, p)).astype(np.int32) * mask
    # the edge rows
    path_frac[1::16] = sub_frac[1::16] = thresh[1::16, None]
    sub_frac[2::16] = path_frac[2::16] = 1.0
    thresh[2::16] = 0.5
    bad_count[2::16] = (patience[2::16, None] - 1) * mask[2::16]
    split[3::16] = 0.0
    w_floor[3::16] = 0.0
    eta[4::16] = 1e4
    path_frac[4::16] = sub_frac[4::16] = 0.9
    w_floor[4::16] = 0.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    lb = LbParams(eta=t(eta), repath_thresh=t(thresh),
                  repath_patience=t(patience), w_floor=t(w_floor),
                  ec_eff=t(np.ones(n, np.float32)))
    return (lb, t(fb), t(mask), t(split), t(path_frac), t(sub_frac),
            t(bad_count.astype(np.int32)))
