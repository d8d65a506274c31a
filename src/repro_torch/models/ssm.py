"""Pure-SSM LM (mamba2-130m): embed -> n_layers x `mamba_block` ->
final norm -> head, tied embeddings; the reference's ``repro.models.ssm``
in PyTorch.

The layers run in a Python loop over the stacked parameters (unbound
once, as `transformer.forward` does), each under a non-reentrant
checkpoint unless ``remat_policy == "none"`` (the reference checkpoints
the scan body for "full" and "dots" alike).  Serving keeps an O(1) state
per layer, whatever `max_len` is: `prefill` returns each layer's conv
tail and final SSD state; `decode_step` is position-free and writes the
new states into the given cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (checkpointed, chunked_softmax_xent,
                                       embed_lookup, rms_norm)
from repro_torch.models.mamba2 import (mamba_block, mamba_cache_defs,
                                       mamba_decode_step, mamba_param_defs)
from repro_torch.models.transformer import _layer_params, _logits
from repro_torch.sharding import shard


def param_defs(cfg: ModelConfig) -> dict:
    defs = {
        "layers": mamba_param_defs(cfg, cfg.n_layers),
        "final_norm": P.ParamDef((cfg.d_model,), (None,), init="ones"),
        "lm_head": P.ParamDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab")),
    }
    if not cfg.tie_embeddings:
        defs["embed"] = P.ParamDef((cfg.vocab, cfg.d_model),
                                   ("vocab", "fsdp"), scale=1.0)
    return defs


def _embed(params, tokens, cfg):
    table = params["embed"] if "embed" in params else params["lm_head"].T
    return shard(embed_lookup(table, tokens).to(cfg.cdtype()),
                 "batch", None, None)


def forward(params, tokens, cfg: ModelConfig, *, collect_state=False):
    """tokens (B, S) -> final hidden states (B, S, d); with
    `collect_state` also (convs, ssms), each layer's conv tail and final
    SSD state stacked to (n_layers, ...)."""
    h = _embed(params, tokens, cfg)

    def body(carry, lp):
        if collect_state:
            return mamba_block(carry, lp, cfg, return_state=True)
        return mamba_block(carry, lp, cfg)

    if cfg.remat_policy != "none":
        body = checkpointed(body)
    states = []
    for lp in _layer_params(params["layers"]):
        if collect_state:
            h, st = body(h, lp)
            states.append(st)
        else:
            h = body(h, lp)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if not collect_state:
        return h
    return h, (torch.stack([c for c, _ in states]),
               torch.stack([s for _, s in states]))


def loss_fn(params, batch, cfg: ModelConfig):
    h = forward(params, batch["inputs"], cfg)
    return chunked_softmax_xent(h, params["lm_head"], batch["targets"])


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    del max_len  # O(1) state: the point of the SSM's long_500k cell
    return mamba_cache_defs(cfg, cfg.n_layers, batch)


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """(last-token logits f32 (B, V), cache {"conv", "ssm"}, pos = S)."""
    del max_len
    h, (convs, ssms) = forward(params, tokens, cfg, collect_state=True)
    return _logits(h, params), {"conv": convs, "ssm": ssms}, tokens.shape[1]


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One token through every layer's decode step; the new conv and SSD
    states are written into `cache` in place.  Returns (logits, cache)."""
    del pos  # the SSM state is position-free
    h = _embed(params, tokens, cfg)
    for i, lp in enumerate(_layer_params(params["layers"])):
        h, (conv, ssm) = mamba_decode_step(
            h, (cache["conv"][i], cache["ssm"][i]), lp, cfg)
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params), cache
