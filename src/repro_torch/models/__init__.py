"""Uniform model API with family dispatch (the reference's
``repro.models``): parameter shapes and initialization (`params`), the
four families for training and serving (`prefill`, `decode_step`, the
cache's `cache_defs`), and meta-device stand-ins for the params, the
cache and each shape cell's inputs.  Dense and MoE decoder-only LMs are
`transformer` (the expert FFN in `moe`), the pure-SSM LM is `ssm` (its
blocks in `mamba2`), the attention / Mamba / MoE hybrid is `hybrid`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import hybrid, params, ssm, transformer


def _mod(cfg: ModelConfig):
    if cfg.family in ("dense", "moe"):
        return transformer
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return hybrid
    raise ValueError(cfg.family)


def param_defs(cfg: ModelConfig) -> dict:
    return _mod(cfg).param_defs(cfg)


def init_params(cfg: ModelConfig, generator, mesh=None, check=None) -> dict:
    """The model's parameters, drawn from `generator` on its device.  On
    `mesh` (a `sharding.Mesh` with its DeviceMesh) each leaf is a DTensor
    placed by `param_pspecs` under the config's profile rules, this
    rank's block of the unsharded draw (`params.init_params`);
    generator None draws nothing (meta)."""
    shardings = None
    if mesh is not None:
        from repro_torch import sharding
        with sharding.use_mesh(mesh, sharding.profile_rules(cfg)):
            shardings = sharding.spec_tree_to_shardings(mesh,
                                                        param_pspecs(cfg))
    return params.init_params(param_defs(cfg), generator, shardings, check)


def abstract_params(cfg: ModelConfig) -> dict:
    return params.abstract_params(param_defs(cfg))


def param_pspecs(cfg: ModelConfig) -> dict:
    """The params' specs on the active mesh (``api.param_pspecs``)."""
    return params.param_pspecs(param_defs(cfg))


def loss_fn(params_tree, batch, cfg: ModelConfig):
    return _mod(cfg).loss_fn(params_tree, batch, cfg)


def prefill(params_tree, inputs, cfg: ModelConfig, max_len: int):
    return _mod(cfg).prefill(params_tree, inputs, cfg, max_len)


def decode_step(params_tree, cache, inputs, pos: int, cfg: ModelConfig):
    return _mod(cfg).decode_step(params_tree, cache, inputs, pos, cfg)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return _mod(cfg).cache_defs(cfg, batch, max_len)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    return params.abstract_params(cache_defs(cfg, batch, max_len))


# ---------------------------------------------------------------- input specs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for one global training batch."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":   # audio / vlm frontend stubs
        inputs = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        inputs = _meta((B, S), torch.int32)
    return {"inputs": inputs, "targets": _meta((B, S), torch.int32)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    """One-token decode inputs against a KV cache of shape.seq_len."""
    B = shape.global_batch
    if cfg.input_mode == "embeddings":
        return _meta((B, 1, cfg.d_model), torch.bfloat16)
    return _meta((B, 1), torch.int32)


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        return _meta((B, S, cfg.d_model), torch.bfloat16)
    return _meta((B, S), torch.int32)
