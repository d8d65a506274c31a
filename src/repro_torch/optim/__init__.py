"""Optimizers: AdamW, SGD-M, Muon (Newton–Schulz), Adafactor — the
reference's ``repro.optim`` on nested dicts of tensors.

States mirror the parameter tree (same shapes, `opt_state_dtype`);
Adafactor keeps factored row / column second moments for >= 2-D leaves.
Muon orthogonalizes the momentum of the >= 2-D weights in the `layers`
subtree with five Newton–Schulz iterations in bfloat16 and normalizes the
momentum of the rest.  The step counter ``state["step"]`` is an int32
tensor on the host, so the scalars derived from it (the learning rate,
AdamW's bias corrections) are computed without touching the device.

AdamW follows the reference's arithmetic as XLA compiles it on the CPU,
bit for bit (`_adamw_leaf`): the UnoRC train step is held bitwise against
the reference's sync + `apply_updates`.  Under jit XLA rewrites
``m / c1 / (sqrt(v / c2) + eps)`` into ``m / (c1 * (sqrt(v / c2) + eps))``
and contracts each multiply that feeds an add into one fused multiply-add
(`fma32`, ``torch.addcmul``).  Scalars go through the C library's ``powf``
and ``cosf``, as XLA's CPU backend computes them; `lr_schedule` follows
the jitted reference likewise (divisions by constants become reciprocal
multiplies; ``0.1 + 0.9 * (0.5 * (1 + cos))`` becomes
``fma(1 + cos, 0.45, 0.1)``).
SGD-M, Muon and Adafactor keep the reference's eager order.
``apply_updates(donate=True)`` writes each leaf's new values into the
given params and state as soon as they are computed, so that an update
never holds a second copy of them (a model that fills the card).

On a mesh the leaves are DTensors: the elementwise updates run on each
rank's block, Muon's Newton–Schulz products and the norms propagate
through DTensor (gathers and partial sums over the sharded dims), and
every new leaf is placed back as its old one was (`_leafwise`), so the
state keeps the placements `train.state_pspecs` gives it: factored and
scalar states replicated, the rest as their params.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from repro_torch import sharding

F32 = torch.float32


def _sdt(cfg):
    return getattr(torch, cfg.opt_state_dtype)


# ---------------------------------------------------------- f32 scalars

@functools.lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("powf", "cosf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * (2 if name == "powf" else 1)
    return lib


def _f32(x) -> float:
    return float(np.float32(x))


def _powf(a: float, b: float) -> float:
    return _f32(_libm().powf(_f32(a), _f32(b)))


def _cosf(a: float) -> float:
    return _f32(_libm().cosf(_f32(a)))


def _sqrt32(x):
    """Correctly rounded float32 sqrt, as XLA computes it.  CUDA's is;
    torch's CPU kernel can be one ulp off, so the CPU rounds the float64
    root.  A meta tensor (the dry run) takes the card's branch."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(F32)


def _scalar(x, like):
    return sharding.replicate_like(
        like, torch.full((), x, dtype=F32, device=like.device))


def fma32(a, b, c):
    """float32 a * b + c rounded once (XLA's contracted multiply-add):
    ``torch.addcmul``, whose kernels compute c + a * b as one fused
    multiply-add on the CPU and on CUDA.  `fma32_exact` is the
    definition; the tests and chip_smoke hold this against it."""
    return torch.addcmul(c, a, b)


def fma32_exact(a, b, c):
    """float32 a * b + c with one rounding (results in float32's normal
    range), from float64: the product is exact there; where the float64
    sum lands exactly on a float32 rounding midpoint it is moved one
    float64 step toward the exact sum (its rounding error, by TwoSum), so
    the second rounding breaks no tie the wrong way."""
    a, b, c = (torch.as_tensor(t, dtype=F32).to(torch.float64)
               for t in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    tie = ((s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)) & (err != 0)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where(tie, torch.nextafter(s, toward), s).to(F32)


# ---------------------------------------------------------------- init

def _zeros_like(p, dtype):
    """Zeros of p's shape: placed as p when p is a DTensor."""
    if sharding.is_dtensor(p):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _zeros_replicated(p, shape, dtype):
    """Zeros of `shape` (a factored state): replicated on p's mesh when p
    is a DTensor."""
    z = torch.zeros(shape, dtype=dtype, device=p.device)
    return sharding.replicate_like(p, z)


def _host_step():
    return torch.zeros((), dtype=torch.int32)


def init_opt_state(params, cfg) -> dict:
    sdt = _sdt(cfg)
    zl = lambda t: _map(lambda p: _zeros_like(p, sdt), t)
    if cfg.optimizer == "adamw":
        return {"m": zl(params), "v": zl(params), "step": _host_step()}
    if cfg.optimizer in ("muon", "sgdm"):
        return {"m": zl(params), "step": _host_step()}
    if cfg.optimizer == "adafactor":
        def factored(p):
            if p.ndim >= 2:
                return {"vr": _zeros_replicated(p, p.shape[:-1], F32),
                        "vc": _zeros_replicated(
                            p, p.shape[:-2] + p.shape[-1:], F32)}
            return {"v": _zeros_like(p, F32)}
        return {"f": _map(factored, params), "step": _host_step()}
    raise ValueError(cfg.optimizer)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------- updates

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


def _adamw_leaf(p, g, m, v, c1, c2, lr):
    """One AdamW leaf as the jitted reference computes it:
        m' = fma(b1, m, (1 - b1) g)       v' = fma(b2, v, ((1 - b2) g) g)
        r  = m' / (c1 (sqrt(v' / c2) + eps))
        p' = fma(-fma(wd, p, r), lr, p)
    with c1 = 1 - b1^step, c2 = 1 - b2^step (host f32 scalars)."""
    gf = g.to(F32)
    pf = p.to(F32)
    m2 = fma32(_scalar(B1, p), m.to(F32), _f32(1 - B1) * gf)
    v2 = fma32(_scalar(B2, p), v.to(F32), (_f32(1 - B2) * gf) * gf)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by
    # its reciprocal
    r = m2 / (c1 * (_sqrt32(v2 / _scalar(c2, p)) + _f32(EPS)))
    upd = fma32(_scalar(WD, p), pf, r)
    return fma32(-upd, _scalar(lr, p), pf).to(p.dtype), m2, v2


def _newton_schulz(G, iters: int = 5):
    """Batched NS5 orthogonalization (Muon).  G: (..., m, n), bf16
    products; G is not modified.  The float32 copy that normalizes G
    lives only until its bf16 cast (a stacked expert leaf's is GBs)."""
    a, b, c = 3.4445, -4.7750, 2.0315
    m, n = G.shape[-2], G.shape[-1]
    transpose = m > n
    X = G.transpose(-1, -2) if transpose else G
    X = (X / (torch.linalg.vector_norm(X, dim=(-2, -1), keepdim=True)
              + 1e-7)).to(torch.bfloat16)
    for _ in range(iters):
        A = X @ X.transpose(-1, -2)
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    X = X.to(F32)
    return X.transpose(-1, -2) if transpose else X


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-12)


def _leafwise(upd, targets: dict, donate: bool) -> dict:
    """{k: upd(k)} for every key of `targets`, each result a tuple of
    tensors (or of dicts of tensors) shaped as targets[k].  With `donate`
    each result is copied into targets[k] as soon as it is computed and
    targets[k] is kept in its place: the old values die leaf by leaf, so
    the update holds one leaf's new values at a time, not a second copy of
    the params and the optimizer state."""
    out = {}
    for k, dst in targets.items():
        res = upd(k)
        if sharding.is_dtensor(dst[0]):
            res = tuple(_placed_as(r, d) for r, d in zip(res, dst))
        if donate:
            for d, r in zip(dst, res):
                for dd, rr in (zip((d[n] for n in sorted(d)),
                                   (r[n] for n in sorted(r)))
                               if isinstance(d, dict) else ((d, r),)):
                    dd.copy_(rr)
            res = dst
        out[k] = res
    return out


def _placed_as(new, old):
    """`new` (a DTensor, or a dict of them) redistributed to the
    placements of `old`."""
    if isinstance(new, dict):
        return {n: _placed_as(new[n], old[n]) for n in new}
    if tuple(new.placements) == tuple(old.placements):
        return new
    return new.redistribute(old.device_mesh, old.placements)


@torch.no_grad()
def apply_updates(params, grads, state, cfg, lr, donate: bool = False):
    """Returns (new_params, new_state).  lr: a float32 value (the
    schedule applied upstream, `lr_schedule`).  `donate`: the new values
    are written into the tensors of `params` and `state` (the same
    arithmetic, the same bits), which are returned; the reference's
    ``jax.jit(..., donate_argnums=(0,))`` (its ``launch/train.py``) lets
    XLA do the same."""
    opt = cfg.optimizer
    step = state["step"] + 1
    sdt = _sdt(cfg)
    flat_p = flatten_with_paths(params)
    flat_g = flatten_with_paths(grads)

    if opt == "adamw":
        n = float(step)
        one = np.float32(1.0)
        c1 = float(one - np.float32(_powf(B1, n)))
        c2 = float(one - np.float32(_powf(B2, n)))
        flat_m = flatten_with_paths(state["m"])
        flat_v = flatten_with_paths(state["v"])

        def upd(k):
            p2, m2, v2 = _adamw_leaf(flat_p[k], flat_g[k], flat_m[k],
                                     flat_v[k], c1, c2, lr)
            return p2, m2.to(sdt), v2.to(sdt)

        out = _leafwise(upd, {k: (flat_p[k], flat_m[k], flat_v[k])
                              for k in flat_p}, donate)
        return (unflatten_like(params, {k: o[0] for k, o in out.items()}),
                {"m": unflatten_like(params, {k: o[1]
                                              for k, o in out.items()}),
                 "v": unflatten_like(params, {k: o[2]
                                              for k, o in out.items()}),
                 "step": step})

    if opt == "sgdm":
        flat_m = flatten_with_paths(state["m"])

        def upd(k):
            p, g, m = flat_p[k], flat_g[k], flat_m[k]
            m2 = 0.9 * m.to(F32) + g.to(F32)
            return (p.to(F32) - lr * m2).to(p.dtype), m2.to(sdt)

        out = _leafwise(upd, {k: (flat_p[k], flat_m[k]) for k in flat_p},
                        donate)
        return (unflatten_like(params, {k: o[0] for k, o in out.items()}),
                {"m": unflatten_like(params, {k: o[1]
                                              for k, o in out.items()}),
                 "step": step})

    if opt == "muon":
        flat_m = flatten_with_paths(state["m"])

        def upd(k):
            # the reference's arithmetic, one rounding per operation, on
            # fresh float32 copies updated in place (a stacked expert
            # leaf's float32 temporaries are GBs each)
            p, g, m = flat_p[k], flat_g[k], flat_m[k]
            m2 = m.to(F32, copy=True).mul_(0.95).add_(g)
            if p.ndim >= 2 and k.startswith("layers/"):
                scale = math.sqrt(max(1.0, p.shape[-2] / p.shape[-1]))
                u = _newton_schulz(m2).mul_(scale).mul_(0.2)
            else:
                u = m2 / (_rms(m2) + 1e-8)
            newp = p.to(F32, copy=True).mul_(1 - lr * WD).sub_(u.mul_(lr))
            return newp.to(p.dtype), m2.to(sdt)

        out = _leafwise(upd, {k: (flat_p[k], flat_m[k]) for k in flat_p},
                        donate)
        return (unflatten_like(params, {k: o[0] for k, o in out.items()}),
                {"m": unflatten_like(params, {k: o[1]
                                              for k, o in out.items()}),
                 "step": step})

    if opt == "adafactor":
        eps = 1e-30
        flat_f = flatten_with_paths(
            state["f"], stop=lambda d: set(d) <= {"v", "vr", "vc"})

        def upd(k):
            p, g, f = flat_p[k], flat_g[k], flat_f[k]
            gf = g.to(F32)
            g2 = gf * gf + eps
            if p.ndim >= 2:
                vr = 0.95 * f["vr"] + 0.05 * g2.mean(dim=-1)
                vc = 0.95 * f["vc"] + 0.05 * g2.mean(dim=-2)
                denom = (vr[..., None] / vr.mean(dim=-1, keepdim=True)[
                    ..., None]) * vc[..., None, :]
                u = gf / (torch.sqrt(denom) + 1e-12)
                f2 = {"vr": vr, "vc": vc}
            else:
                v = 0.95 * f["v"] + 0.05 * g2
                u = gf / (torch.sqrt(v) + 1e-12)
                f2 = {"v": v}
            u = u / torch.clamp(_rms(u), min=1.0)
            newp = (p.to(F32) * (1 - lr * WD) - lr * u).to(p.dtype)
            return newp, f2

        out = _leafwise(upd, {k: (flat_p[k], flat_f[k]) for k in flat_p},
                        donate)
        return (unflatten_like(params, {k: o[0] for k, o in out.items()}),
                {"f": unflatten_like(params, {k: o[1]
                                              for k, o in out.items()},
                                     leaf_is_dict=True),
                 "step": step})

    raise ValueError(opt)


# ---------------------------------------------------------------- path utils

def flatten_with_paths(tree, stop=None) -> dict:
    """{"a/b/c": leaf} in the tree's insertion order; `stop(node)` marks a
    dict to keep whole as one leaf."""
    out = {}

    def rec(prefix, node):
        if isinstance(node, dict) and not (stop and stop(node)):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        else:
            out[prefix] = node

    rec("", tree)
    return out


def unflatten_like(template, flat: dict, leaf_is_dict=False):
    def rec(prefix, node):
        if isinstance(node, dict) and not (leaf_is_dict and prefix in flat):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v)
                    for k, v in node.items()}
        return flat[prefix]

    return rec("", template)


def lr_schedule(step, base_lr: float, warmup: int,
                total: int = 100_000) -> float:
    """Linear warmup then cosine decay to 0.1 x base_lr, as a float32
    value: the jitted reference's arithmetic (reciprocal multiplies, the
    folded 0.45 constant, one fused multiply-add, the C library's cosf)."""
    s = np.float32(step)
    one = np.float32(1.0)
    warm = min(s * (one / np.float32(max(warmup, 1))), one)
    t = (s + np.float32(-warmup)) * (one / np.float32(max(total - warmup, 1)))
    t = min(max(t, np.float32(0.0)), one)
    c = np.float32(_cosf(t * np.float32(math.pi)))
    inner = float(fma32_exact(c + one, np.float32(0.9) * np.float32(0.5),
                              np.float32(0.1)))
    return _f32(warm * np.float32(base_lr) * np.float32(inner))
