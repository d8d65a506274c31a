"""Scenario -> fluid model: the (FluidNet, FleetParams, is_inter, LbParams,
ChurnParams) tensors the port's fleetsim steps on.

The port of the fluid compiler in ``repro.scenarios.compile_fleetsim``.
The route tensor is built host-side in numpy, the RouteLayout / PathTable
are compiled from it host-side (`links.with_layout`), and everything moves
to the device once.  Adaptive weight dynamics (LbParams) are enabled only
for groups whose LbSpec names an adaptive router over a real multipath set,
or that carry erasure coding.  Specs with a RelSpec on an inter group, or
with faults, raise until those slices are ported; the shard planner is not
part of this slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim.links import FluidNet, compute_layout
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, LbParams,
                                        make_params)
from repro_torch.scenarios.fat_tree import link_tiers
from repro_torch.scenarios.spec import Scenario

_ADAPTIVE_KINDS = ("unolb", "plb")
_NEVER = 2.0          # mark-frac threshold no path can exceed (fracs <= 1)


class FleetScenario(NamedTuple):
    """Everything the fluid simulator needs, compiled from one Scenario."""
    net: FluidNet
    params: FleetParams
    is_inter: torch.Tensor           # (n_flows,) bool
    lb: Optional[LbParams]           # None -> static split, no EC overhead
    churn: Optional[ChurnParams]     # None -> every flow backlogged
    seed: int
    link_tier: Optional[np.ndarray] = None   # (n_links,) locality tiers


def _flow_adaptive(g) -> bool:
    return g.lb.kind in _ADAPTIVE_KINDS and g.lb.eta > 0


def _refuse_unported(spec: Scenario):
    if spec.faults:
        raise NotImplementedError("fault specs are not ported yet")
    if any(g.rel is not None and g.inter for g in spec.groups):
        raise NotImplementedError("RelSpec (reliability axis) is not "
                                  "ported yet")


def fleet_arrays(spec: Scenario, device=None):
    """(FluidNet, bdp, rtt, is_inter) — topology + per-flow path constants,
    with the RouteLayout (and PathTable where it compresses) attached."""
    _refuse_unported(spec)
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    idx = spec.link_index()
    n_links = len(spec.links)

    cap = torch.tensor([l.rate for l in spec.links], **f32)
    qcap = torch.tensor([l.qcap for l in spec.links], **f32)
    vcap_derived = torch.tensor(
        [l.vcap_scale * spec.cap_bdps
         * (spec.inter_bdp if l.wan else spec.intra_bdp)
         for l in spec.links], **f32)
    if spec.phantom:
        ecn_lo = spec.min_frac * vcap_derived
        ecn_hi = spec.max_frac * vcap_derived
        drain = spec.drain_frac * cap
        use_phantom = torch.ones(n_links, dtype=torch.bool, device=dev)
        vcap = vcap_derived
    else:
        ecn_lo = spec.red_lo_frac * qcap
        ecn_hi = spec.red_hi_frac * qcap
        drain = cap
        use_phantom = torch.zeros(n_links, dtype=torch.bool, device=dev)
        vcap = qcap

    path_sets = [[[idx[name] for name in path] for path in g.path_set(k)]
                 for _, g, k in spec.flow_groups()]
    n_paths = max(len(ps) for ps in path_sets)
    max_hops = max(len(p) for ps in path_sets for p in ps)
    routes_np = np.full((spec.n_flows, n_paths, max_hops), -1, np.int32)
    for i, ps in enumerate(path_sets):
        for p, hops in enumerate(ps):
            routes_np[i, p, :len(hops)] = hops

    rtt = torch.tensor(
        [g.rtt if g.rtt is not None
         else (spec.inter_rtt if g.inter else spec.intra_rtt)
         for _, g, _ in spec.flow_groups()], **f32)
    bdp = spec.rate * rtt
    is_inter = torch.tensor([g.inter for _, g, _ in spec.flow_groups()],
                            dtype=torch.bool, device=dev)

    p_loss = None
    if any(l.p_loss > 0.0 for l in spec.links):
        p_loss = torch.tensor([l.p_loss for l in spec.links], **f32)

    net = FluidNet(cap=cap, qcap=qcap, ecn_lo=ecn_lo, ecn_hi=ecn_hi,
                   drain=drain, vcap=vcap, use_phantom=use_phantom,
                   routes=torch.as_tensor(routes_np, device=dev),
                   dt=torch.tensor(spec.epoch_period_frac * spec.intra_rtt,
                                   **f32),
                   p_loss=p_loss)
    # the layout (and the PathTable where it compresses) is compiled once
    # per scenario from the host copy of the routes
    net = net._replace(layout=compute_layout(routes_np, n_links, device=dev))
    return net, bdp, rtt, is_inter


def to_fleetsim(spec: Scenario, *, device=None,
                **make_params_kw) -> FleetScenario:
    """Compile the full fluid scenario onto `device` (default cuda).

    `make_params_kw` forwards to `fleetsim.state.make_params`;
    epoch_period_frac defaults to the spec's.
    """
    net, bdp, rtt, is_inter = fleet_arrays(spec, device)
    dev = net.device
    make_params_kw.setdefault("epoch_period_frac", spec.epoch_period_frac)
    params = make_params(bdp, rtt, spec.intra_bdp, spec.intra_rtt,
                         **make_params_kw)

    want_lb = any(_flow_adaptive(g)
                  or (g.lb.ec is not None and g.inter)
                  for g in spec.groups)
    lb = None
    if want_lb:
        eta, thresh, patience, floor, eff = [], [], [], [], []
        for _, g, _ in spec.flow_groups():
            adaptive = _flow_adaptive(g)
            eta.append(g.lb.eta if adaptive else 0.0)
            thresh.append(g.lb.repath_thresh if adaptive else _NEVER)
            patience.append(g.lb.repath_patience if adaptive else 2 ** 30)
            floor.append(g.lb.w_floor if adaptive else 0.0)
            k_r = g.lb.ec if g.inter else None   # EC is inter-DC only
            eff.append(1.0 if k_r is None else k_r[0] / (k_r[0] + k_r[1]))
        f32 = dict(dtype=torch.float32, device=dev)
        lb = LbParams(eta=torch.tensor(eta, **f32),
                      repath_thresh=torch.tensor(thresh, **f32),
                      repath_patience=torch.tensor(patience,
                                                   dtype=torch.int32,
                                                   device=dev),
                      w_floor=torch.tensor(floor, **f32),
                      ec_eff=torch.tensor(eff, **f32))

    churn = None
    if any(g.churn is not None for g in spec.groups):
        churned, mean_on, mean_off = [], [], []
        for _, g, _ in spec.flow_groups():
            c = g.churn
            churned.append(c is not None)
            mean_on.append(c.mean_on if c is not None else 1.0)
            mean_off.append(c.mean_off if c is not None else 1.0)
        churn = ChurnParams(
            churned=torch.tensor(churned, dtype=torch.bool, device=dev),
            mean_on=torch.tensor(mean_on, dtype=torch.float32, device=dev),
            mean_off=torch.tensor(mean_off, dtype=torch.float32, device=dev))

    return FleetScenario(net=net, params=params, is_inter=is_inter, lb=lb,
                         churn=churn, seed=spec.seed,
                         link_tier=link_tiers(spec))
