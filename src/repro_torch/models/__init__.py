"""Uniform model API with family dispatch (the reference's
``repro.models``): parameter shapes and initialization (`params`), the
dense decoder-only LM (`transformer`, `layers`).

Only the dense family is ported.  The MoE, SSM and hybrid families raise
NotImplementedError until ROADMAP item 9b (the remaining LLM families)
ports them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params, transformer

_NOT_PORTED = ("moe", "ssm", "hybrid")


def _mod(cfg: ModelConfig):
    if cfg.family == "dense":
        return transformer
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} model family is not ported yet "
            "(ROADMAP item 9b)")
    raise ValueError(cfg.family)


def param_defs(cfg: ModelConfig) -> dict:
    _mod(cfg)
    return params.param_defs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """The model's parameters, drawn from `generator` on its device."""
    return params.init_params(param_defs(cfg), generator)


def loss_fn(params_tree, batch, cfg: ModelConfig):
    return _mod(cfg).loss_fn(params_tree, batch, cfg)
