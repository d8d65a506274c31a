"""UnoCC control constants and the Algorithm-1 MD arithmetic.

The port's own copy of the shared formulas in ``repro.core.unocc``: every
expression is plain +-*/ on its inputs, and the only order comparisons are
injected through ``minimum``/``maximum`` so the fleet model passes
``torch.minimum``/``torch.maximum`` for (n_flows,) tensors.  The scalar
per-ACK ``UnoCC`` state machine is the packet simulator's and is not part
of the port.
"""
from __future__ import annotations

import dataclasses


def derived_params(bdp, intra_bdp, intra_rtt, *, alpha_frac=0.001,
                   k_frac=1.0 / 7.0, epoch_period_frac=1.0):
    """(alpha, K, epoch_period) from the three path quantities (§4.1.1).

    alpha = alpha_frac * BDP        — AI step per clean RTT
    K     = k_frac * intra-DC BDP   — MD gain knee
    epoch = frac * intra-DC RTT     — ONE granularity for all flows
    """
    return alpha_frac * bdp, k_frac * intra_bdp, epoch_period_frac * intra_rtt


def md_ecn_gain(k_md, bdp):
    """BDP-compensating MD gain 4K/(K+BDP)."""
    return 4.0 * k_md / (k_md + bdp)


def md_factor(ecn_ewma, md_scale, k_md, bdp, md_cap, *, minimum=min):
    """Per-epoch multiplicative-decrease factor on cwnd (Alg 1 l.13),
    capped at md_cap."""
    return 1.0 - minimum(ecn_ewma * md_ecn_gain(k_md, bdp) * md_scale, md_cap)


def gentle_md_scale(md_scale, gentle_scale, gentle_floor, *, maximum=max):
    """Consecutive phantom-only epochs compound the gentle scaling,
    floored so it cannot decay to zero."""
    return maximum(md_scale * gentle_scale, gentle_floor)


@dataclasses.dataclass
class UnoParams:
    """UnoCC knobs; the fleet model reads the defaults of the fractions."""
    bdp: float                      # this flow's path BDP (bytes)
    intra_bdp: float                # intra-DC BDP (bytes) — sets K
    intra_rtt: float                # intra-DC base RTT (ns) — sets epoch
    mtu: int = 4096
    alpha_frac: float = 0.001       # AI factor: alpha = alpha_frac * BDP
    beta: float = 0.5               # QA ratio
    k_frac: float = 1.0 / 7.0       # K = k_frac * intra-DC BDP
    ewma_g: float = 0.2             # EWMA gain for the ECN fraction E
    delay_thresh_frac: float = 0.25 # "delay == 0" if rel delay < frac*rtt
    epoch_period_frac: float = 1.0  # epoch_period = frac * intra_rtt
    gentle_scale: float = 0.3
    gentle_floor: float = 0.09      # floor of the consecutive-epoch decay
    md_cap: float = 0.5             # per-epoch max multiplicative decrease
    cwnd0: float = 0.0              # initial cwnd (0 -> BDP)
    max_cwnd_bdps: float = 1.5      # cwnd cap in BDPs
