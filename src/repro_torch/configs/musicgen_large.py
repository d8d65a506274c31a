"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only per assignment: the EnCodec frontend is a stub; `input_specs()`
provides precomputed frame embeddings.  48L d_model=2048 32H (GQA kv=32)
d_ff=8192 vocab=2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    input_mode="embeddings",
    optimizer="adamw",
)
