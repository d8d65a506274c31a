"""Decoder-only LM, dense family: the reference's
``repro.models.transformer`` (training path) in PyTorch.

Parameters are a nested dict of tensors under the reference tree's names,
each layer's weights stacked along a leading layer axis
(``params["layers"]["attn"]["wq"]`` is (n_layers, d, q_dim)), so a tree
carries across to and from the reference leaf for leaf.  `forward` unbinds
every stacked leaf once and runs the layers in a Python loop in place of
the reference's scan: the backward pass then stacks each leaf's layer
gradients in one copy.  `Transformer` holds the same tree as an
``nn.Module``.  The serving functions (`prefill`, `decode_step`,
`cache_defs`) and the MoE FFN are not ported yet.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (apply_rope, chunked_softmax_xent,
                                       flash_attention, mlp, rms_norm,
                                       rope_cos_sin)

REMAT_POLICIES = ("full", "dots", "none")

# ---------------------------------------------------------------- blocks

def _qkv(h, p, cfg, positions):
    B, S, _ = h.shape
    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    q = torch.matmul(hn, p["wq"])
    k = torch.matmul(hn, p["wk"])
    v = torch.matmul(hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, h.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_block(h, p, cfg, *, positions, kv_block=1024):
    """Causal self-attention over the full input (train / prefill).
    Returns (residual_output, (k, v))."""
    B, S, _ = h.shape
    q, k, v = _qkv(h, p, cfg, positions)
    o = flash_attention(q, k, v, causal=True, kv_block=min(kv_block, S))
    out = torch.matmul(o.reshape(B, S, cfg.q_dim), p["wo"])
    return h + out, (k, v)


def _ffn(h, lp, cfg):
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family!r} FFN is not ported")
    p = lp["mlp"]
    return h + mlp(rms_norm(h, p["norm"], cfg.norm_eps), p, cfg.act)


def _layer(h, lp, cfg, positions):
    h, _ = attention_block(h, lp["attn"], cfg, positions=positions)
    return _ffn(h, lp, cfg)


# jax.checkpoint_policies.dots_with_no_batch_dims_saveable: keep the
# outputs of the products without batch dims (the projections, which
# torch.matmul folds to aten.mm), recompute everything else
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """The layer under the config's remat policy: "none" keeps every
    activation, "full" recomputes the layer in the backward pass, "dots"
    recomputes all but the projection outputs."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")
    if cfg.remat_policy == "none":
        return fn
    ctx = (functools.partial(create_selective_checkpoint_contexts,
                             _dots_policy)
           if cfg.remat_policy == "dots" else None)

    def wrapped(*args):
        kw = {"context_fn": ctx} if ctx is not None else {}
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def embed_inputs(params, batch_inputs, cfg):
    if cfg.input_mode == "embeddings":
        return batch_inputs.to(cfg.cdtype())
    table = params["embed"] if "embed" in params else params["lm_head"].T
    return torch.nn.functional.embedding(batch_inputs.long(),
                                         table).to(cfg.cdtype())


def _layer_params(layers) -> list[dict]:
    """The stacked layer tree -> one tree of views per layer (unbind:
    its backward stacks the layer gradients in one copy)."""
    leaves, treedef = P.flatten(layers)
    per_leaf = [torch.unbind(l, 0) for l in leaves]
    return [P.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(len(per_leaf[0]))]


def forward(params, inputs, cfg):
    """inputs: tokens (B, S) int or embeddings (B, S, d).  Returns the
    final hidden states (B, S, d)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family!r} family is not ported")
    h = embed_inputs(params, inputs, cfg)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    body = _remat(functools.partial(_layer, cfg=cfg, positions=positions),
                  cfg)
    for lp in _layer_params(params["layers"]):
        h = body(h, lp)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def loss_fn(params, batch, cfg):
    h = forward(params, batch["inputs"], cfg)
    return chunked_softmax_xent(h, params["lm_head"], batch["targets"])


# ---------------------------------------------------------------- module

class _Tree(nn.Module):
    """A nested dict of tensors as modules: a sub-dict is a child module
    under its key, a leaf an ``nn.Parameter`` under its key."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Transformer(_Tree):
    """The dense LM as an ``nn.Module``: each leaf of the parameter tree an
    ``nn.Parameter`` under the reference tree's names (``layers.attn.wq``,
    ``lm_head`` ...), stacked by layer.  `tree()` returns the nested dict
    of those parameters; `forward` and `loss` are the functional
    `forward` / `loss_fn` on it."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, inputs):
        return forward(self.tree(), inputs, self.cfg)

    def loss(self, batch):
        return loss_fn(self.tree(), batch, self.cfg)
