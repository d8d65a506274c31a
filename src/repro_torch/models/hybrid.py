"""Jamba-style hybrid: one attention layer per `attn_period`, the rest
Mamba (SSD), every layer followed by an FFN that alternates dense / MoE
(`moe_every`); the reference's ``repro.models.hybrid`` in PyTorch.

Parameters are stacked per in-period position (``layers["pos0"]`` ...
``layers[f"pos{attn_period - 1}"]``, each with a leading axis of
n_layers / attn_period periods).  The period body is unrolled, and
checkpointed whole unless ``remat_policy == "none"``.  The attention
layer is the transformer's (`attention_block` / `attention_decode_block`,
its residual sum fused into the FFN norm as there); the cache holds K/V
(NP, B, max_len, Hkv, D) for the attention layers and the conv / SSD
states with a leading (NP, n_mamba) for the Mamba layers, written in
place by `decode_step`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (checkpointed, chunked_softmax_xent,
                                       embed_lookup, rms_norm)
from repro_torch.models.mamba2 import (mamba_block, mamba_cache_defs,
                                       mamba_decode_step, mamba_param_defs)
from repro_torch.models.moe import moe_param_defs
from repro_torch.models.transformer import (_layer_params, _logits,
                                            attention_block,
                                            attention_decode_block,
                                            attn_param_defs, mlp_param_defs,
                                            residual_ffn)
from repro_torch.sharding import shard


def _n_periods(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_period {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def _is_moe(cfg: ModelConfig, pos: int) -> bool:
    return cfg.n_experts > 0 and (pos % cfg.moe_every == 1)


def param_defs(cfg: ModelConfig) -> dict:
    NP = _n_periods(cfg)
    layers = {}
    for pos in range(cfg.attn_period):
        entry = {}
        if pos == 0:
            entry["attn"] = attn_param_defs(cfg, NP)
        else:
            entry["mamba"] = mamba_param_defs(cfg, NP)
        if _is_moe(cfg, pos):
            entry["ffn"] = moe_param_defs(cfg, NP, cfg.d_ff_expert)
        else:
            entry["ffn"] = mlp_param_defs(cfg, NP, cfg.d_ff)
        layers[f"pos{pos}"] = entry
    return {
        "layers": layers,
        "embed": P.ParamDef((cfg.vocab, cfg.d_model), ("vocab", "fsdp"),
                            scale=1.0),
        "final_norm": P.ParamDef((cfg.d_model,), (None,), init="ones"),
        "lm_head": P.ParamDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab")),
    }


def _embed(params, tokens, cfg):
    return shard(embed_lookup(params["embed"], tokens).to(cfg.cdtype()),
                 "batch", None, None)


def forward(params, tokens, cfg: ModelConfig, *, collect_state=False):
    """tokens (B, S) -> final hidden states; with `collect_state` also
    ((ks, vs), convs, ssms): the attention layers' K / V (NP, B, S, Hkv,
    D), the Mamba layers' conv tails and SSD states (NP, n_mamba, ...)."""
    h = _embed(params, tokens, cfg)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)[None].expand(B, S)

    def body(h, pp):
        kv = None
        convs, ssms = [], []
        for pos in range(cfg.attn_period):
            p = pp[f"pos{pos}"]
            out = None
            if pos == 0:
                out, kv = attention_block(h, p["attn"], cfg,
                                          positions=positions)
            elif collect_state:
                h, (ct, st) = mamba_block(h, p["mamba"], cfg,
                                          return_state=True)
                convs.append(ct)
                ssms.append(st)
            else:
                h = mamba_block(h, p["mamba"], cfg)
            h = residual_ffn(h, out, p["ffn"], cfg, _is_moe(cfg, pos))
        if collect_state:
            return h, kv[0], kv[1], torch.stack(convs), torch.stack(ssms)
        return h

    if cfg.remat_policy != "none":
        body = checkpointed(body)
    states = []
    for pp in _layer_params(params["layers"]):
        if collect_state:
            h, *st = body(h, pp)
            states.append(st)
        else:
            h = body(h, pp)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if not collect_state:
        return h
    ks, vs, convs, ssms = (torch.stack(t) for t in zip(*states))
    return h, ((ks, vs), convs, ssms)


def loss_fn(params, batch, cfg: ModelConfig):
    h = forward(params, batch["inputs"], cfg)
    return chunked_softmax_xent(h, params["lm_head"], batch["targets"])


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    NP = _n_periods(cfg)
    n_mamba = cfg.attn_period - 1
    kv_shape = (NP, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv_axes = (None, "kv_batch", "seq_kv", "tensor", None)
    out = {"k": P.ParamDef(kv_shape, kv_axes, init="zeros"),
           "v": P.ParamDef(kv_shape, kv_axes, init="zeros")}
    for name, d in mamba_cache_defs(cfg, n_mamba, batch).items():
        out[name] = P.ParamDef((NP,) + d.shape, (None,) + d.axes, d.dtype,
                               init="zeros")
    return out


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """(last-token logits f32 (B, V), cache, pos = S): K / V padded to
    `max_len` along the sequence, the Mamba states as the prompt left
    them."""
    h, ((ks, vs), convs, ssms) = forward(params, tokens, cfg,
                                         collect_state=True)
    S = tokens.shape[1]
    pad = max_len - S
    if pad < 0:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    if pad:
        ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
    cache = {"k": ks, "v": vs, "conv": convs, "ssm": ssms}
    return _logits(h, params), cache, S


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One token through every period; the token's K/V go to index `pos`
    of each attention layer's cache and the Mamba layers' new states
    replace theirs, in place.  Returns (logits f32 (B, V), cache)."""
    h = _embed(params, tokens, cfg)
    for i, pp in enumerate(_layer_params(params["layers"])):
        for j in range(cfg.attn_period):
            p = pp[f"pos{j}"]
            out = None
            if j == 0:
                out = attention_decode_block(h, p["attn"], cfg,
                                             cache["k"][i], cache["v"][i],
                                             pos)
            else:
                h, (conv, ssm) = mamba_decode_step(
                    h, (cache["conv"][i, j - 1], cache["ssm"][i, j - 1]),
                    p["mamba"], cfg)
                cache["conv"][i, j - 1] = conv
                cache["ssm"][i, j - 1] = ssm
            h = residual_ffn(h, out, p["ffn"], cfg, _is_moe(cfg, j))
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _logits(h, params), cache
