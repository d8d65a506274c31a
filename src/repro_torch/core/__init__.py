"""UnoCC: the shared control math (constants and MD formulas), the
stateful per-flow controller and the host chunk-window scheduler built on
it; the UnoRC gradient sync (`uno_collectives`)."""
from repro_torch.core.unocc import (UnoCC, UnoParams, derived_params,
                                    gentle_md_scale, md_ecn_gain, md_factor)

__all__ = ["UnoCC", "UnoParams", "derived_params", "gentle_md_scale",
           "md_ecn_gain", "md_factor"]
