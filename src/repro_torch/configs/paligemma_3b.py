"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726; hf].

Backbone only per assignment (SigLIP frontend is a stub; `input_specs()`
provides precomputed patch embeddings).  18L d_model=2048 8H (GQA kv=1,
head_dim=256) d_ff=16384 vocab=257216.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    act="gelu",
    input_mode="embeddings",
    optimizer="adamw",
)
