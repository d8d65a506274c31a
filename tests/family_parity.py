"""Shared helpers of the model-family parity tests (test_torch_moe.py,
test_torch_ssm.py, test_torch_hybrid.py): reduced configs of both
packages, numpy-seeded parameter trees drawn from the port's ParamDefs
and handed to the reference in its own tree structure, the jitted
reference steps and the normalized error.

Parameters: a leaf initialized to ones is 1 + 0.1 N(0, 1), one
initialized to zeros 0.1 N(0, 1) (so biases, ``dt_bias`` and ``A_log``
are not trivial), any other N(0, 1) x its scale (1/sqrt(fan_in) by
default).  In float32 tests every leaf is float32 (the reference's
ParamDefs are bfloat16 whatever `param_dtype` says, so the config's
dtypes alone would not make its tree float32); in bfloat16 tests each
leaf takes its ParamDef's dtype, float32 for the router and the SSM's
``dt_bias``, ``A_log`` and ``D``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as RM
from repro.configs import base as RB
from repro.configs import registry as RR

from repro_torch import models as TM
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.models import params as TP


def close(port, want, rtol, what=""):
    """max |port - want| / max |want| <= rtol; returns the error."""
    got = port.detach().float().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= rtol, (what, err)
    return err


def cfgs(arch, f32=True, **kw):
    """(reference, port) reduced configs of `arch`, overrides `kw`; in
    float32 when `f32`."""
    ref = RB.reduced(RR.get_config(arch), **kw)
    port = TB.reduced(TR.get_config(arch), **kw)
    if f32:
        f = dict(param_dtype="float32", compute_dtype="float32")
        ref, port = (dataclasses.replace(ref, **f),
                     dataclasses.replace(port, **f))
    return ref, port


def draw(d, rng):
    """One leaf for ParamDef `d` (see the module docstring), float32."""
    if d.init == "ones":
        x = 1.0 + rng.normal(size=d.shape) * 0.1
    elif d.init == "zeros":
        x = rng.normal(size=d.shape) * 0.1
    else:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1 / math.sqrt(fan_in)
        x = rng.normal(size=d.shape) * scale
    return x.astype(np.float32)


def params(rcfg, tcfg, seed, f32=True):
    """A parameter tree of numpy arrays in the reference's structure,
    drawn leaf by leaf from the port's ParamDefs (same leaf order)."""
    rng = np.random.default_rng(seed)
    defs = TP.flatten(TM.param_defs(tcfg))[0]
    want, treedef = jax.tree.flatten(RM.abstract_params(rcfg))
    assert [d.shape for d in defs] == [w.shape for w in want]
    leaves = []
    for d in defs:
        x = draw(d, rng)
        if not f32 and d.dtype == torch.bfloat16:
            x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        leaves.append(x)
    return jax.tree.unflatten(treedef, leaves)


def batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    targets[0, :3] = -1
    return {"inputs": inputs, "targets": targets}


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def port_value_and_grad(params_np, batch_np, cfg):
    """(loss, grads in JAX leaf order) of the port's `loss_fn`."""
    tree = TP.tree_from_arrays(params_np, "cpu")
    leaves, treedef = TP.flatten(tree)
    leaves = [l.requires_grad_() for l in leaves]
    b = {k: to_torch(v) for k, v in batch_np.items()}
    loss = TM.loss_fn(TP.unflatten(treedef, leaves), b, cfg)
    return loss, torch.autograd.grad(loss, leaves)


def ref_value_and_grad(params_np, batch_np, rcfg):
    """(loss, grad leaves) of the jitted reference."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, rcfg)))(params_np, batch_np)
    return loss, jax.tree.leaves(grads)


def check_loss_and_grads(arch, remat, seed, rtol=1e-4, **kw):
    """The port's f32 loss and every gradient leaf within `rtol` of the
    jitted reference's with remat `remat`; with remat "full" the port's
    gradients also bitwise those of remat "none"."""
    rcfg, tcfg = cfgs(arch, **kw)
    p = params(rcfg, tcfg, seed)
    b = batch(rcfg, seed + 1)
    tcfg = dataclasses.replace(tcfg, remat_policy=remat)
    loss, grads = port_value_and_grad(p, b, tcfg)
    want, wgrads = ref_value_and_grad(
        p, b, dataclasses.replace(rcfg, remat_policy=remat))
    close(loss, want, rtol, "loss")
    assert len(grads) == len(wgrads)
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        close(g, w, rtol, f"{arch} grad leaf {i}")
    if remat != "none":
        base = port_value_and_grad(
            p, b, dataclasses.replace(tcfg, remat_policy="none"))
        assert torch.equal(base[0], loss)
        for a, g in zip(base[1], grads):
            assert torch.equal(a, g)


def check_loss_and_grads_bf16(arch, seed):
    """The reduced config in its own dtypes (bf16 params and activations,
    float32 leaves where the ParamDefs say so): loss within 5e-3, each
    gradient leaf within 5e-2 normalized (tests/test_torch_models.py's
    bf16 bars), each in its leaf's dtype."""
    rcfg, tcfg = cfgs(arch, f32=False)
    p = params(rcfg, tcfg, seed, f32=False)
    b = batch(rcfg, seed + 1)
    loss, grads = port_value_and_grad(p, b, tcfg)
    want, wgrads = ref_value_and_grad(p, b, rcfg)
    assert abs(float(loss.detach()) - float(want)) <= 5e-3, \
        (float(loss), float(want))
    errs = []
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        errs.append(close(g, w, 5e-2, f"bf16 grad leaf {i}"))
    return errs


def ref_steps(rcfg, max_len):
    pre = jax.jit(lambda p, x: RM.prefill(p, x, rcfg, max_len))
    dec = jax.jit(lambda p, c, x, pos: RM.decode_step(p, c, x, pos, rcfg))
    return pre, dec


def check_serving(arch, seed, rtol=1e-5, steps=8, **kw):
    """f32: the prefill logits and cache (every leaf), then `steps`
    successive decode steps' logits and the final cache, against the
    jitted reference on the same inputs; a left-padded prompt as the
    engine builds them.  Returns the port's final cache."""
    rcfg, tcfg = cfgs(arch, **kw)
    p = params(rcfg, tcfg, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, rcfg.vocab, (3, 8), dtype=np.int32)
    x[1, :3] = 0                                        # left padding
    toks = [rng.integers(0, rcfg.vocab, (3, 1), dtype=np.int32)
            for _ in range(steps)]
    max_len = 8 + steps
    pre, dec = ref_steps(rcfg, max_len)
    logits, cache, pos = pre(p, x)
    tparams = TP.tree_from_arrays(p, "cpu")
    with torch.inference_mode():
        tl, tcache, tpos = TM.prefill(tparams, to_torch(x), tcfg, max_len)
    assert tpos == int(pos) == 8
    close(tl, logits, rtol, f"{arch} prefill logits")
    assert sorted(tcache) == sorted(cache)
    for k in cache:
        assert str(tcache[k].dtype).removeprefix("torch.") == \
            str(cache[k].dtype), k
        close(tcache[k], cache[k], rtol, f"{arch} prefill cache {k}")
    with torch.inference_mode():
        for i, s in enumerate(toks):
            logits, cache = dec(p, cache, s, pos)
            tl, tcache = TM.decode_step(tparams, tcache, to_torch(s), tpos,
                                        tcfg)
            pos, tpos = pos + 1, tpos + 1
            close(tl, logits, rtol, f"{arch} decode step {i}")
    for k in cache:
        close(tcache[k], cache[k], rtol, f"{arch} cache {k}")
    return tcache
