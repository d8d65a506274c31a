"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768 attention-free, vocab=50280, ssm_state=128.  Sub-quadratic:
runs the long_500k cell.

ssm_head_dim=96 (16 heads) rather than the reference 64 (24 heads) so SSD heads
divide the 16-way `model` mesh axis; d_inner/state sizes match the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    sharding_profile="dp",
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=96,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    subquadratic=True,
    optimizer="adamw",
)
