"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8 per assignment — the real K2 uses MLA; recorded in
DESIGN.md) expert d_ff=2048 vocab=163840, MoE 384e top-8.

Memory note: 1T params cannot hold fp32 Adam states on 256/512 v5e chips; config
uses Muon with bf16 momentum + cross-pod ZeRO-3 (`fsdp_over_pod`) so the
multi-pod dry-run fits (see EXPERIMENTS.md §Dry-run).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    d_ff_expert=2048,
    n_experts=384,
    top_k=8,
    vocab=163840,
    act="swiglu",
    rope_theta=50_000.0,
    optimizer="muon",
    opt_state_dtype="bfloat16",
    fsdp_over_pod=True,
)
