"""Array-of-flows parameters and state for the fluid fleet simulator, as
NamedTuples of torch tensors.

The port of ``repro.fleetsim.state``: field names, dtypes (float32 /
int32 / bool) and the parameter derivations are the reference's, so a
reference state flattened to numpy loads field for field
(`repro_torch.fleetsim.carry`).  The PRNG `key`, the reliability carry
`rel` and the fault carry `fault` stay None until the churn, reliability
and fault slices are ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.unocc import UnoParams, derived_params
from repro_torch.device import resolve_device

_DEFAULT = UnoParams(bdp=1.0, intra_bdp=1.0, intra_rtt=1.0)  # default fracs


class FleetParams(NamedTuple):
    """Per-flow constants, all (n_flows,) float32 unless noted."""
    bdp: torch.Tensor            # path BDP (bytes)
    rtt: torch.Tensor            # base (uncongested) flow RTT (ns)
    mtu: torch.Tensor            # bytes
    alpha: torch.Tensor          # AI step per clean RTT (bytes)
    k_md: torch.Tensor           # MD gain knee K (bytes)
    beta: torch.Tensor           # QA ratio
    ewma_g: torch.Tensor         # EWMA gain for the ECN fraction E
    gentle_scale: torch.Tensor
    gentle_floor: torch.Tensor
    md_cap: torch.Tensor
    delay_thresh: torch.Tensor   # "zero delay" bound (ns)
    min_cwnd: torch.Tensor
    max_cwnd: torch.Tensor
    cc_period: torch.Tensor      # int32: epochs between CC window reactions
    qa_period: torch.Tensor      # int32: epochs between QA evaluations


class LbParams(NamedTuple):
    """Per-flow load-balancing constants, all (n_flows,) float32/int32."""
    eta: torch.Tensor            # multiplicative-weights step on mark fracs
    repath_thresh: torch.Tensor  # per-path mark frac that counts as "bad"
    repath_patience: torch.Tensor  # int32: bad epochs before a repath
    w_floor: torch.Tensor        # min weight as a fraction of uniform
    ec_eff: torch.Tensor         # goodput efficiency k/(k+r); 1.0 = no EC


class ChurnParams(NamedTuple):
    """Per-flow open-loop on/off churn, all (n_flows,).  Compiled from a
    spec, but not yet run by the port's step."""
    churned: torch.Tensor        # bool: does this flow churn at all
    mean_on: torch.Tensor        # mean ON duration (ns)
    mean_off: torch.Tensor       # mean OFF duration (ns)


class FleetState(NamedTuple):
    """Dynamic state carried from epoch to epoch."""
    cwnd: torch.Tensor           # (n_flows,)
    ecn_ewma: torch.Tensor       # E — EWMA of per-window mark fraction
    md_scale: torch.Tensor       # gentle-reduction scale
    q_phys: torch.Tensor         # (n_links,) physical queue (bytes)
    q_phantom: torch.Tensor      # (n_links,) phantom queue (bytes)
    obs_frac: torch.Tensor       # feedback-lagged mark fraction
    obs_delay: torch.Tensor      # feedback-lagged rel. queueing delay (ns)
    win_acked: torch.Tensor      # bytes acked in the open CC window
    win_marked: torch.Tensor     # marked bytes in the open CC window
    win_delay_min: torch.Tensor  # min rel. queueing delay in the window
    win_delay_max: torch.Tensor  # max rel. queueing delay (Gemini signal)
    cc_countdown: torch.Tensor   # int32 epochs until the window closes
    qa_acked: torch.Tensor       # bytes acked since the last QA tick
    qa_prev_acked: torch.Tensor
    qa_deficits: torch.Tensor    # int32 consecutive deficient QA windows
    qa_countdown: torch.Tensor   # int32 epochs until the next QA tick
    skip: torch.Tensor           # int32 epochs of MD/QA skip left
    fi_clean: torch.Tensor       # int32 consecutive clean windows
    fi_active: torch.Tensor      # bool: fast increase engaged
    fi_ceiling: torch.Tensor     # last cwnd that saw congestion
    split: torch.Tensor          # (n_flows, n_paths) subflow weights
    path_frac: torch.Tensor      # (n_flows, n_paths) lagged per-path marks
    bad_count: torch.Tensor      # (n_flows, n_paths) int32 bad streak
    active: torch.Tensor         # (n_flows,) bool churn mask
    key: Optional[torch.Tensor] = None   # churn PRNG (churn slice)
    rel: Optional[object] = None         # reliability carry (rel slice)
    fault: Optional[object] = None       # fault carry (fault slice)


def make_params(bdp, rtt, intra_bdp: float, intra_rtt: float, *,
                mtu: float = 4096.0,
                alpha_frac: float = _DEFAULT.alpha_frac,
                beta: float = _DEFAULT.beta,
                k_frac: float = _DEFAULT.k_frac,
                ewma_g: float = _DEFAULT.ewma_g,
                delay_thresh_frac: float = _DEFAULT.delay_thresh_frac,
                epoch_period_frac: float = _DEFAULT.epoch_period_frac,
                gentle_scale: float = _DEFAULT.gentle_scale,
                gentle_floor: float = _DEFAULT.gentle_floor,
                md_cap: float = _DEFAULT.md_cap,
                max_cwnd_bdps: float = _DEFAULT.max_cwnd_bdps,
                cc_period_rtts: float = 0.0, device=None) -> FleetParams:
    """Vectorized UnoParams.  `bdp`/`rtt` are (n_flows,) arrays; the
    result lives on `device` (default: bdp's device if it is a tensor,
    else cuda).

    `cc_period_rtts == 0` gives the Uno cadence (every flow reacts once
    per epoch); `> 0` reacts once per that many OWN RTTs instead.
    """
    if device is None and isinstance(bdp, torch.Tensor):
        dev = bdp.device
    else:
        dev = resolve_device(device)
    bdp = torch.as_tensor(bdp, dtype=torch.float32, device=dev)
    rtt = torch.as_tensor(rtt, dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    alpha, k_md, epoch = derived_params(
        bdp, torch.tensor(intra_bdp, **f32), torch.tensor(intra_rtt, **f32),
        alpha_frac=alpha_frac, k_frac=k_frac,
        epoch_period_frac=epoch_period_frac)
    ones = torch.ones_like(bdp)
    if cc_period_rtts > 0:
        cc_period = torch.clamp(torch.round(cc_period_rtts * rtt / epoch),
                                min=1.0).to(torch.int32)
    else:
        cc_period = torch.ones_like(bdp, dtype=torch.int32)
    qa_period = torch.clamp(torch.round(rtt / epoch), min=1.0).to(torch.int32)
    return FleetParams(
        bdp=bdp, rtt=rtt, mtu=mtu * ones, alpha=alpha, k_md=k_md * ones,
        beta=beta * ones, ewma_g=ewma_g * ones,
        gentle_scale=gentle_scale * ones, gentle_floor=gentle_floor * ones,
        md_cap=md_cap * ones,
        delay_thresh=delay_thresh_frac * intra_rtt * ones,
        min_cwnd=mtu * ones, max_cwnd=max_cwnd_bdps * bdp,
        cc_period=cc_period, qa_period=qa_period)


def make_lb_params(n_flows: int, *, eta=0.25, repath_thresh=0.7,
                   repath_patience=8, w_floor=0.05, ec=None,
                   device=None) -> LbParams:
    """Broadcast scalar LB knobs to (n_flows,) tensors; `ec=(k, r)` scales
    goodput by k/(k+r)."""
    dev = resolve_device(device)
    ones = torch.ones(n_flows, dtype=torch.float32, device=dev)
    eff = 1.0 if ec is None else ec[0] / (ec[0] + ec[1])
    return LbParams(
        eta=eta * ones, repath_thresh=repath_thresh * ones,
        repath_patience=torch.full((n_flows,), repath_patience,
                                   dtype=torch.int32, device=dev),
        w_floor=w_floor * ones, ec_eff=eff * ones)


def init_state(params: FleetParams, n_links: int,
               cwnd0: Optional[torch.Tensor] = None, *,
               n_paths: int = 1, split0: Optional[torch.Tensor] = None,
               seed: int = 0, rel=None, fault=None) -> FleetState:
    """Line-rate start (cwnd = BDP), empty queues, on params' device.

    `split0` (n_flows, n_paths) is required for multipath nets (pass
    `links.uniform_split(net)`).  `seed` seeds churn, which is not ported
    yet; `rel` / `fault` raise until their slices land.
    """
    del seed
    if rel is not None or fault is not None:
        raise NotImplementedError("reliability / fault carries are not "
                                  "ported yet")
    dev = params.bdp.device
    n = params.bdp.shape[0]
    f0 = torch.zeros(n, dtype=torch.float32, device=dev)
    i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    lk0 = torch.zeros(n_links, dtype=torch.float32, device=dev)
    cwnd = params.bdp.clone() if cwnd0 is None else \
        torch.as_tensor(cwnd0, dtype=torch.float32, device=dev)
    if split0 is None:
        if n_paths != 1:
            raise ValueError(
                "init_state needs split0 (e.g. links.uniform_split(net)) "
                "when n_paths > 1")
        split0 = torch.ones((n, 1), dtype=torch.float32, device=dev)
    split0 = torch.as_tensor(split0, dtype=torch.float32, device=dev)
    return FleetState(
        cwnd=cwnd, ecn_ewma=f0, md_scale=torch.ones_like(f0),
        q_phys=lk0, q_phantom=lk0.clone(), obs_frac=f0, obs_delay=f0,
        win_acked=f0, win_marked=f0,
        win_delay_min=torch.full_like(f0, math.inf), win_delay_max=f0,
        cc_countdown=params.cc_period.clone(),
        qa_acked=f0, qa_prev_acked=f0, qa_deficits=i0,
        qa_countdown=params.qa_period.clone(), skip=i0,
        fi_clean=i0, fi_active=torch.zeros(n, dtype=torch.bool, device=dev),
        fi_ceiling=params.max_cwnd.clone(),
        split=split0,
        path_frac=torch.zeros((n, split0.shape[1]), dtype=torch.float32,
                              device=dev),
        bad_count=torch.zeros((n, split0.shape[1]), dtype=torch.int32,
                              device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev))
