"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8, head_dim=192) d_ff=73728 vocab=256000.
Big-model memory: Muon + bf16 states (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab=256000,
    act="squared_relu",
    optimizer="muon",
    opt_state_dtype="bfloat16",
)
