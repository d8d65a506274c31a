"""Shared control math (UnoCC constants and MD formulas)."""
from repro_torch.core.unocc import (UnoParams, derived_params,
                                    gentle_md_scale, md_ecn_gain, md_factor)

__all__ = ["UnoParams", "derived_params", "gentle_md_scale", "md_ecn_gain",
           "md_factor"]
