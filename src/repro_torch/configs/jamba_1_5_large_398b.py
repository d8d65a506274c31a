"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on every
other layer, one attention layer per 8 (attn_period=8).  Sub-quadratic (7/8 of
layers are O(1)-state SSM) -> runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    d_ff_expert=24576,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_period=8,
    vocab=65536,
    act="swiglu",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_conv_width=4,
    ssm_chunk=256,
    subquadratic=True,
    optimizer="muon",
    opt_state_dtype="bfloat16",
)
