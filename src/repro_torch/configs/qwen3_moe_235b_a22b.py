"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4, head_dim=128) expert d_ff=1536 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                 # all layers MoE
    d_ff_expert=1536,
    n_experts=128,
    top_k=8,
    vocab=151936,
    act="swiglu",
    rope_theta=1_000_000.0,
    optimizer="muon",       # big model: bf16 single-state optimizer to fit HBM
    opt_state_dtype="bfloat16",
)
