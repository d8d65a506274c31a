"""Config dataclasses: model architecture, input shapes, run/parallelism.

The reference's ``repro.configs.base``, with `pdtype`/`cdtype` returning
torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 for attention-free
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0                    # dense FFN hidden (0 = no FFN, e.g. pure SSM)
    vocab: int = 32000
    act: str = "swiglu"              # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    input_mode: str = "tokens"       # tokens | embeddings (audio/vlm frontend stubs)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1               # apply MoE every Nth layer (jamba: 2)

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0             # hybrid: 1 attention layer per `attn_period` layers

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # training-memory knobs
    optimizer: str = "adamw"         # adamw | adafactor | muon | sgdm
    opt_state_dtype: str = "float32"
    remat_policy: str = "full"       # full | dots | none
    fsdp_over_pod: bool = False      # ZeRO-3 across the pod (DCI) axis
    sharding_profile: str = "2d"     # 2d (fsdp x tensor) | dp (replicate
    #   weights, batch over every mesh axis — small models; §Perf HC2)

    # long-context capability (assignment: long_500k only for sub-quadratic archs)
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def cdtype(self):
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


# The assignment's four LM shape cells.
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run knobs (paper-relevant ones live under `uno_*`)."""
    microbatch: int = 0              # 0 = no gradient accumulation
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    seed: int = 0

    # Uno cross-pod sync (the paper's technique, adapted; see core/uno_collectives.py)
    uno_enabled: bool = True
    uno_chunks: int = 8              # chunked DCI exchange ("blocks")
    uno_subflows: int = 4            # parallel chunk streams (UnoLB analogue)
    uno_ec_data: int = 8             # RS data packets per block
    uno_ec_parity: int = 2           # RS parity packets per block
    uno_quant: str = "int8"          # int8 | none  (DCI payload compression)
    uno_impl: str = "leaf_local"     # leaf_local | flat (§Perf HC3)
    # AIMD/QA window scheduler (host side)
    uno_alpha: float = 0.001
    uno_beta: float = 0.5
    uno_md_k: float = 1.0 / 7.0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_period=min(cfg.attn_period, 2) if cfg.attn_period else 0,
        name=cfg.name + "-reduced",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
