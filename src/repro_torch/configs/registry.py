"""Registry of the 10 assigned architectures + shape-cell applicability."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec

_MODULES = {
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is (arch x shape) a live dry-run cell?  Returns (supported, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment; DESIGN.md §4)"
        )
    return True, ""


def all_cells() -> list[tuple[str, str, bool, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out
