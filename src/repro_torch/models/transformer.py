"""Decoder-only LM, dense and MoE families: the reference's
``repro.models.transformer`` (training and serving) in PyTorch.

Parameters are a nested dict of tensors under the reference tree's names,
each layer's weights stacked along a leading layer axis
(``params["layers"]["attn"]["wq"]`` is (n_layers, d, q_dim)), so a tree
carries across to and from the reference leaf for leaf.  `forward` unbinds
every stacked leaf once and runs the layers in a Python loop in place of
the reference's scan: the backward pass then stacks each leaf's layer
gradients in one copy.  The FFN is a dense MLP (``layers["mlp"]``) or,
for ``family == "moe"``, the top-k expert FFN (``layers["moe"]``,
`models.moe`).  `Transformer` holds the same tree as an ``nn.Module``.

Serving (`cache_defs`, `prefill`, `decode_step`) keeps the reference's
semantics: `prefill` runs the prompt as one causal pass (left padding is
attended to, as in the reference), pads the per-layer K/V to `max_len`
and returns ``pos = S``; `decode_step` writes the new token's K/V at
`pos` and attends to ``pos + 1`` entries.  Where the reference returns a
new cache, `decode_step` writes into the given one in place (a slice
store) and returns it; `pos` is a host integer.  Run serving with
gradients off (``torch.inference_mode()``): the checkpoints of the
training path are then skipped.

On a mesh (DTensor params and inputs) `shard` constrains q, k and v to
the "tensor" heads, the attention output and the embedded input to the
batch rows, and the prefill cache to "kv_batch" / "tensor", at the
reference's sites (``transformer.py:90-92, 107, 153, 196-197``); a q, k
or v projection whose head count does not divide the model axis is
gathered before its head split (`_split_heads`).  The decode step writes
the token's K/V into each rank's block of the cache.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (apply_rope, checkpointed,
                                       chunked_softmax_xent,
                                       decode_attention, embed_lookup,
                                       flash_attention, mlp, rms_norm,
                                       rope_cos_sin)
from repro_torch.sharding import shard
from repro_torch.models.moe import moe_ffn, moe_param_defs

REMAT_POLICIES = ("full", "dots", "none")
F32 = torch.float32


# ---------------------------------------------------------------- param defs

def attn_param_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    L = (n_layers,)
    ax = (None,)
    defs = {
        "norm": P.ParamDef(L + (d,), ax + (None,), init="ones"),
        "wq": P.ParamDef(L + (d, qd), ax + ("fsdp", "tensor")),
        "wk": P.ParamDef(L + (d, kvd), ax + ("fsdp", "tensor")),
        "wv": P.ParamDef(L + (d, kvd), ax + ("fsdp", "tensor")),
        "wo": P.ParamDef(L + (qd, d), ax + ("tensor", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = P.ParamDef(L + (qd,), ax + ("tensor",), init="zeros")
        defs["bk"] = P.ParamDef(L + (kvd,), ax + ("tensor",), init="zeros")
        defs["bv"] = P.ParamDef(L + (kvd,), ax + ("tensor",), init="zeros")
    return defs


def mlp_param_defs(cfg: ModelConfig, n_layers: int, d_ff: int) -> dict:
    d = cfg.d_model
    L = (n_layers,)
    ax = (None,)
    defs = {
        "norm": P.ParamDef(L + (d,), ax + (None,), init="ones"),
        "w_up": P.ParamDef(L + (d, d_ff), ax + ("fsdp", "tensor")),
        "w_down": P.ParamDef(L + (d_ff, d), ax + ("tensor", "fsdp")),
    }
    if cfg.act == "swiglu":
        defs["w_gate"] = P.ParamDef(L + (d, d_ff), ax + ("fsdp", "tensor"))
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of a dense or MoE decoder-only LM."""
    L = cfg.n_layers
    layers = {"attn": attn_param_defs(cfg, L)}
    if cfg.family == "moe":
        layers["moe"] = moe_param_defs(cfg, L, cfg.d_ff_expert)
    else:
        layers["mlp"] = mlp_param_defs(cfg, L, cfg.d_ff)
    defs = {
        "layers": layers,
        "final_norm": P.ParamDef((cfg.d_model,), (None,), init="ones"),
        "lm_head": P.ParamDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab")),
    }
    if cfg.input_mode == "tokens" and not cfg.tie_embeddings:
        defs["embed"] = P.ParamDef((cfg.vocab, cfg.d_model),
                                   ("vocab", "fsdp"), scale=1.0)
    return defs


# ---------------------------------------------------------------- blocks

def _split_heads(x, H, D):
    """(B, S, H * D) -> (B, S, H, D).  A DTensor is first placed as the
    "tensor" heads resolve for H (a projection split over a model axis
    that H does not divide is gathered whole: DTensor cannot split the
    dim across a shard boundary)."""
    B, S = x.shape[:2]
    if sharding.is_dtensor(x):
        spec = sharding.resolve("batch", None, "tensor", None,
                                shape=(B, S, H, D))
        mesh = sharding.active_mesh()
        x = x.redistribute(mesh.device_mesh,
                           sharding.placements(spec[:3]))
    return x.reshape(B, S, H, D)


def _qkv(h, p, cfg, positions):
    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    q = torch.matmul(hn, p["wq"])
    k = torch.matmul(hn, p["wk"])
    v = torch.matmul(hn, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    q = shard(q, "batch", None, "tensor", None)
    k = shard(k, "batch", None, "tensor", None)
    v = shard(v, "batch", None, "tensor", None)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, h.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attention_block(h, p, cfg, *, positions, kv_block=1024):
    """Causal self-attention over the full input (train / prefill).
    Returns (attention output, (k, v)); the residual add is the FFN
    block's (`_residual_ffn`)."""
    B, S, _ = h.shape
    q, k, v = _qkv(h, p, cfg, positions)
    o = flash_attention(q, k, v, causal=True, kv_block=min(kv_block, S))
    out = torch.matmul(o.reshape(B, S, cfg.q_dim), p["wo"])
    return shard(out, "batch", None, None), (k, v)


def attention_decode_block(h, p, cfg, k_cache, v_cache, pos: int):
    """One-token attention against the padded cache; writes the token's
    K/V at `pos` in place.  Returns the attention output (the residual
    add is `_residual_ffn`'s)."""
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = _qkv(h, p, cfg, positions)
    _write_token(k_cache, k, pos)
    _write_token(v_cache, v, pos)
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    return torch.matmul(o.reshape(B, 1, cfg.q_dim), p["wo"])


def _write_token(cache, x, pos: int):
    """cache[:, pos] = x[:, 0] in place; on DTensors into this rank's
    block of the cache, x placed as the cache is."""
    if sharding.is_dtensor(cache):
        x = x.redistribute(cache.device_mesh, cache.placements).to_local()
        cache = cache.to_local()
    cache[:, pos] = x[:, 0].to(cache.dtype)


def residual_ffn(h, out, p, cfg, moe: bool):
    """The residual sum h + out (`out` None: h alone), then the FFN block
    with params `p` on it: the MoE FFN when `moe`, else the MLP.  The
    jitted reference fuses that sum into the FFN norm's float32 cast:
    the norm reads the float32 sum, the residual stream its value
    rounded to the compute dtype.  The port does the same (in float32
    the two are one value)."""
    s = h.to(F32) if out is None else h.to(F32) + out.to(F32)
    h = s.to(h.dtype)
    hn = rms_norm(s, p["norm"], cfg.norm_eps).to(h.dtype)
    if moe:
        return h + moe_ffn(hn, p, cfg, cfg.d_ff_expert)
    return h + mlp(hn, p, cfg.act)


def _residual_ffn(h, out, lp, cfg):
    moe = cfg.family == "moe"
    return residual_ffn(h, out, lp["moe"] if moe else lp["mlp"], cfg, moe)


def _layer(h, lp, cfg, positions, want_kv=False):
    out, kv = attention_block(h, lp["attn"], cfg, positions=positions)
    h = _residual_ffn(h, out, lp, cfg)
    return (h, kv) if want_kv else h


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
    if cfg.remat_policy == "full":
        return checkpointed(fn)
    ctx = functools.partial(create_selective_checkpoint_contexts,
                            _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx,
                          preserve_rng_state=False)

    return wrapped


def embed_inputs(params, batch_inputs, cfg):
    if cfg.input_mode == "embeddings":
        h = batch_inputs.to(cfg.cdtype())
    else:
        table = params["embed"] if "embed" in params else params["lm_head"].T
        h = embed_lookup(table, batch_inputs).to(cfg.cdtype())
    return shard(h, "batch", None, None)


def _layer_params(layers) -> list[dict]:
    """The stacked layer tree -> one tree of views per layer (unbind:
    its backward stacks the layer gradients in one copy)."""
    leaves, treedef = P.flatten(layers)
    per_leaf = [torch.unbind(l, 0) for l in leaves]
    return [P.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(len(per_leaf[0]))]


def run_layers(layers, h, cfg):
    """h (B, S, d) through the stacked layer tree `layers`, one layer
    after another (each under the config's remat policy)."""
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    body = _remat(functools.partial(_layer, cfg=cfg, positions=positions),
                  cfg)
    for lp in _layer_params(layers):
        h = body(h, lp)
    return h


def forward(params, inputs, cfg, *, collect_kv=False, layers_fn=None):
    """inputs: tokens (B, S) int or embeddings (B, S, d).  Returns the
    final hidden states (B, S, d), and with `collect_kv` also (ks, vs),
    each layer's K and V stacked to (n_layers, B, S, Hkv, D).
    `layers_fn(layers, h) -> h` runs the layer stack (default
    `run_layers`; `sharding.pipeline.pipeline_layers` runs it through the
    pipeline)."""
    h = embed_inputs(params, inputs, cfg)
    if not collect_kv:
        run = layers_fn or functools.partial(run_layers, cfg=cfg)
        h = run(params["layers"], h)
        return rms_norm(h, params["final_norm"], cfg.norm_eps)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    body = _remat(functools.partial(_layer, cfg=cfg, positions=positions,
                                    want_kv=True), cfg)
    kvs = []
    for lp in _layer_params(params["layers"]):
        h, kv = body(h, lp)
        kvs.append(kv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, (torch.stack([k for k, _ in kvs]),
               torch.stack([v for _, v in kvs]))


def loss_fn(params, batch, cfg, layers_fn=None):
    h = forward(params, batch["inputs"], cfg, layers_fn=layers_fn)
    return chunked_softmax_xent(h, params["lm_head"], batch["targets"])


# ---------------------------------------------------------------- serving

def cache_defs(cfg, batch: int, max_len: int) -> dict:
    """The KV cache's ParamDefs: k and v, each (n_layers, batch, max_len,
    n_kv_heads, head_dim), zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = (None, "kv_batch", "seq_kv", "tensor", None)
    return {"k": P.ParamDef(shape, axes, init="zeros"),
            "v": P.ParamDef(shape, axes, init="zeros")}


def _logits(h, params):
    """The last position's logits, float32 (B, V).  The reference casts
    the product to float32 at once, and under jit XLA then computes it
    in float32 without rounding it to the compute dtype first: so does
    the port, on the compute-dtype operands."""
    return torch.matmul(h[:, -1].to(F32), params["lm_head"].to(F32))


def prefill(params, inputs, cfg, max_len: int):
    """Run the prompt; return (last-token logits f32 (B, V), cache, pos):
    the cache {"k", "v"} holds every layer's K/V padded to `max_len`
    along the sequence, and pos = S is where decoding writes next."""
    h, (ks, vs) = forward(params, inputs, cfg, collect_kv=True)
    B, S = h.shape[:2]
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    if pad:
        ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
    cache = {"k": shard(ks, None, "kv_batch", None, "tensor", None),
             "v": shard(vs, None, "kv_batch", None, "tensor", None)}
    return _logits(h, params), cache, S


def decode_step(params, cache, inputs, pos: int, cfg):
    """One decode step.  inputs: (B, 1) tokens or (B, 1, d) embeddings.
    The new token's K/V go to index `pos` of every layer's cache (in
    place); attention sees pos + 1 entries.  Returns (logits f32 (B, V),
    cache)."""
    h = embed_inputs(params, inputs, cfg)
    for i, lp in enumerate(_layer_params(params["layers"])):
        out = attention_decode_block(h, lp["attn"], cfg, cache["k"][i],
                                     cache["v"][i], pos)
        h = _residual_ffn(h, out, lp, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params), cache


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
    """The dense or MoE LM as an ``nn.Module``: each leaf of the parameter
    tree an ``nn.Parameter`` under the reference tree's names
    (``layers.attn.wq``, ``lm_head`` ...), stacked by layer.  `tree()`
    returns the nested dict of those parameters; `forward`, `loss`,
    `prefill` and `decode` are the functional `forward` / `loss_fn` /
    `prefill` / `decode_step` on it."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, inputs):
        return forward(self.tree(), inputs, self.cfg)

    def loss(self, batch):
        return loss_fn(self.tree(), batch, self.cfg)

    def prefill(self, inputs, max_len: int):
        return prefill(self.tree(), inputs, self.cfg, max_len)

    def decode(self, cache, inputs, pos: int):
        return decode_step(self.tree(), cache, inputs, pos, self.cfg)
