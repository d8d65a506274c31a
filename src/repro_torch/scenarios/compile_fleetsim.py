"""Scenario -> fluid model: the (FluidNet, FleetParams, is_inter, LbParams,
ChurnParams, RelParams, FaultSchedule) tensors the port's fleetsim steps
on.

The port of the fluid compiler in ``repro.scenarios.compile_fleetsim``.
The route tensor is built host-side in numpy, the RouteLayout / PathTable
are compiled from it host-side (`links.with_layout`), and everything moves
to the device once.  Adaptive weight dynamics (LbParams) are enabled only
for groups whose LbSpec names an adaptive router over a real multipath set,
or that carry erasure coding.  An inter group's RelSpec compiles to the
reliability machine (`_compile_rel`), the spec's faults to one
epoch-indexed schedule (`compile_faults`).  The shard planner
(`ShardPlan`, `plan_shards`), which groups flows by home link and
relabels links so each shard owns a contiguous private range, lives here
too.  `to_fleetsim` is the span `compile.to_fleetsim` of
`repro_torch.trace`, its phases `compile.arrays`, `compile.layout`,
`compile.rel` and `compile.faults`.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim.faults import FaultSchedule, make_schedule
from repro_torch.fleetsim.links import FluidNet, compute_layout
from repro_torch.fleetsim.reliability import (RelParams, make_rel_params,
                                              stack_rel_params)
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, LbParams,
                                        make_params)
from repro_torch.scenarios.fat_tree import link_tiers
from repro_torch.scenarios.multi_dc import link_dcs
from repro_torch.scenarios.spec import Scenario
from repro_torch.trace import span, traced

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
    link_dc: Optional[np.ndarray] = None     # (n_links,) datacenter id per
    # link, -1 on WAN mesh links (host-side; feeds the planner's DC-major
    # shard order — None on topologies without DC structure)
    rel: Optional[RelParams] = None  # None -> static EC only; its ec_eff
    # also carries the static LbSpec.ec efficiency of groups without a
    # RelSpec, since the step reads only rel.ec_eff once rel is set
    fault: Optional[FaultSchedule] = None    # None on fault-free specs


def _flow_adaptive(g) -> bool:
    return g.lb.kind in _ADAPTIVE_KINDS and g.lb.eta > 0


def fleet_arrays(spec: Scenario, device=None):
    """(FluidNet, bdp, rtt, is_inter) — topology + per-flow path constants,
    with the RouteLayout (and PathTable where it compresses) attached."""
    with span("compile.arrays"):
        net, bdp, rtt, is_inter, routes_np = _flat_arrays(
            spec, resolve_device(device))
    # the layout (and the PathTable where it compresses) is compiled once
    # per scenario from the host copy of the routes
    with span("compile.layout"):
        net = net._replace(layout=compute_layout(
            routes_np, len(spec.links), device=net.cap.device))
    return net, bdp, rtt, is_inter


def _flat_arrays(spec: Scenario, dev):
    """`fleet_arrays` before the layout, with the host copy of the
    routes."""
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
    return net, bdp, rtt, is_inter, routes_np


@traced("compile.to_fleetsim")
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

    with span("compile.rel"):
        rel = _compile_rel(spec, net)
    with span("compile.faults"):
        fault = compile_faults(spec, net)
    return FleetScenario(net=net, params=params, is_inter=is_inter, lb=lb,
                         churn=churn, seed=spec.seed,
                         link_tier=link_tiers(spec), link_dc=link_dcs(spec),
                         rel=rel, fault=fault)


def _compile_rel(spec: Scenario, net: FluidNet) -> Optional[RelParams]:
    """Per-flow RelParams from the groups' RelSpecs (None when no inter
    group carries one).  Time-valued knobs round to the epoch clock;
    `nack_period` defaults to max(rtt/4, 100 us), the packet simulator's
    NACK timeout.  Groups without a RelSpec ride along disabled, their
    static `LbSpec.ec` efficiency folded into `rel.ec_eff`."""
    if not any(g.rel is not None and g.inter for g in spec.groups):
        return None
    dev = net.device
    dt = float(net.dt)
    rows = []
    for g in spec.groups:
        if g.n == 0:
            continue
        r = g.rel if g.inter else None
        if r is not None:
            rtt_g = g.rtt if g.rtt is not None else (
                spec.inter_rtt if g.inter else spec.intra_rtt)
            period = r.nack_period if r.nack_period is not None \
                else max(0.25 * rtt_g, 100_000.0)
            rows.append(make_rel_params(
                g.n, ec=r.ec,
                nack_period=max(int(round(period / dt)), 1),
                nack_hold=int(round(r.debounce / dt)),
                loss_md=r.loss_md, rtx_cap=r.rtx_cap,
                ladder=r.ladder, ladder_up=r.ladder_up,
                ladder_down=r.ladder_down, device=dev))
        else:
            row = make_rel_params(g.n, enabled=np.zeros(g.n, bool),
                                  device=dev)
            k_r = g.lb.ec if g.inter else None
            if k_r is not None:
                row = row._replace(ec_eff=torch.full(
                    (g.n,), k_r[0] / (k_r[0] + k_r[1]), dtype=torch.float32,
                    device=dev))
            rows.append(row)
    return stack_rel_params(rows)


def compile_faults(spec: Scenario, net: FluidNet) -> Optional[FaultSchedule]:
    """spec.faults -> the epoch-indexed FaultSchedule (None when empty).

    An event covers epochs [round(t_start/dt), round(t_end/dt)), so flaps
    are epoch-quantized.  A "burst" takes the packet simulator's
    Gilbert-Elliott parameters, p_gb = loss_rate / (burst *
    mean_burst_len) and p_bg = 1 / mean_burst_len, on a chain that ticks
    once per epoch.
    """
    if not spec.faults:
        return None
    idx = spec.link_index()
    dt = float(net.dt)

    def ep(t):
        return max(int(round(t / dt)), 0)

    cap_ev, ge_ev = [], []
    for f in spec.faults:
        li = idx[f.link]
        e0 = ep(f.t_start)
        e1 = None if f.t_end is None else max(ep(f.t_end), e0)
        if f.kind == "down":
            cap_ev.append((li, e0, e1, 0.0, 0, 0.0))
        elif f.kind == "brownout":
            cap_ev.append((li, e0, e1, f.cap_frac, 0, 0.0))
        elif f.kind == "flap":
            cap_ev.append((li, e0, e1, f.cap_frac,
                           max(int(round(f.period / dt)), 1), f.duty))
        else:  # "burst" (spec.validate rejects anything else)
            p_bg = 1.0 / max(f.mean_burst_len, 1.0)
            p_gb = f.loss_rate / max(f.burst * f.mean_burst_len, 1e-12)
            ge_ev.append((li, e0, e1, 0.0, f.burst, min(p_gb, 1.0), p_bg))
    return make_schedule(cap_ev, ge_ev, device=net.device)


# ------------------------------------------------ locality shard planning

class ShardPlan(NamedTuple):
    """Host-side (numpy) link-locality flow partition.

    Link ids are RELABELED: `new2old` lists old ids in the new order —
    first every shard's private links as contiguous ranges (shard s owns
    new ids [owner_ptr[s], owner_ptr[s+1])), then the `n_boundary`
    boundary links (touched by flows of 2+ shards) at the tail.  Flows are
    permuted into per-shard rows: `gather[s, r]` is the ORIGINAL flow id
    sitting in shard s's r-th local row, with `n_real` marking inert
    padding rows (compiled to all-(-1) routes).  Links no flow touches are
    folded into shard 0's private range (their load is identically zero).
    """
    n_shards: int
    n_real: int              # original flow count (gather pads with this)
    n_links: int
    n_boundary: int
    gather: np.ndarray       # (n_shards, rows) int32 original flow ids
    new2old: np.ndarray      # (n_links,) int32: old link id per new id
    old2new: np.ndarray      # (n_links,) int32 inverse relabeling
    owner_ptr: np.ndarray    # (n_shards + 1,) int32 private-range offsets
    boundary_pairs: Optional[np.ndarray] = None  # (n_boundary, 2) int32
    # sorted toucher-shard pair per boundary link IN TAIL ORDER, (-1, -1)
    # when 3+ shards touch it — the neighbor halo exchange is legal only
    # when every row is a ring-adjacent pair (shard.neighbor_halo checks)

    @property
    def rows(self) -> int:
        return self.gather.shape[1]

    @property
    def boundary_frac(self) -> float:
        return self.n_boundary / max(self.n_links, 1)

    @property
    def flat_gather(self) -> np.ndarray:
        return self.gather.reshape(-1)

    @property
    def inverse_flow(self) -> np.ndarray:
        """(n_real,) position of each original flow in the permuted order."""
        flat = self.flat_gather
        real = flat < self.n_real
        inv = np.empty(self.n_real, np.int64)
        inv[flat[real]] = np.flatnonzero(real)
        return inv


def _home_links(routes3: np.ndarray, n_links: int, n_shards: int,
                link_tier: Optional[np.ndarray] = None):
    """Pick each flow's "home" link — the hop that best localizes it.

    Returns (home, no_nonhub): the chosen link per flow plus the mask of
    flows that had NO non-hub hop to choose from.  Without tiers the
    preference is the most-shared link that is not a hub (a link touched
    by >= ceil(n_flows / n_shards) distinct flows), falling back to the
    rarest hop; with `link_tier` the score is lexicographic (non-hub
    first, then lowest tier, then latest hop), so fat-tree flows home on
    their most receiver-side edge link.  Hub-ness counts FLOWS: link ids
    are deduped per flow before the fan-in count (multipath route tensors
    repeat the shared first/last hop on every path).
    """
    n = routes3.shape[0]
    pidx = np.where(routes3 >= 0, routes3, n_links).reshape(n, -1)
    srt = np.sort(pidx, axis=1)
    fresh = np.concatenate(
        [np.ones((n, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    counts = np.bincount(srt[fresh], minlength=n_links + 1)[:n_links]
    counts_ext = np.concatenate([counts, [0]])
    hub_ext = np.concatenate(
        [counts >= max(2, -(-n // n_shards)), [True]])
    c = counts_ext[pidx]                          # (n, p*h)
    nonhub_score = np.where((c > 0) & ~hub_ext[pidx], c, -1)
    no_nonhub = nonhub_score.max(axis=1) < 0

    if link_tier is not None:
        tiers = np.asarray(link_tier, np.int64)
        if tiers.shape != (n_links,):
            raise ValueError(
                f"link_tier must have shape ({n_links},), got {tiers.shape}")
        t_span = int(tiers.max() - tiers.min()) + 2 if n_links else 2
        tier_ext = np.concatenate([tiers - tiers.min(), [t_span - 1]])
        ph = pidx.shape[1]
        # lexicographic argmin over (is_hub, tier, prefer-latest-hop);
        # padding entries (c == 0) are pushed past every real key
        key = (hub_ext[pidx].astype(np.int64) * t_span + tier_ext[pidx]) \
            * (ph + 1) + (ph - np.arange(ph))
        key = np.where(c > 0, key, np.iinfo(np.int64).max)
        home = pidx[np.arange(n), np.argmin(key, axis=1)]
    else:
        home = pidx[np.arange(n), np.argmax(nonhub_score, axis=1)]
        if np.any(no_nonhub):
            rare = np.where(c > 0, c, np.iinfo(np.int64).max)
            fb = pidx[np.arange(n), np.argmin(rare, axis=1)]
            home = np.where(no_nonhub, fb, home)
    # routeless flows -> link 0
    return np.where(home >= n_links, 0, home), no_nonhub


def _rehome_sender_uplinks(r3: np.ndarray, home: np.ndarray,
                           n_links: int) -> np.ndarray:
    """Rehome every flow sharing a first hop (sender uplink) onto the
    group's MODAL home link (ties -> smaller link id), so first-hop links
    localize too."""
    f0 = r3[:, 0, 0]
    ok = f0 >= 0
    if not np.any(ok):
        return home
    uniq, inv = np.unique(f0[ok], return_inverse=True)
    key = inv.astype(np.int64) * (n_links + 1) + home[ok]
    pairs, counts = np.unique(key, return_counts=True)
    pg = pairs // (n_links + 1)
    ph = pairs % (n_links + 1)
    best = np.lexsort((ph, -counts, pg))      # group asc, count desc
    lead = np.unique(pg[best], return_index=True)[1]
    modal = np.empty(uniq.shape[0], np.int64)
    modal[pg[best[lead]]] = ph[best[lead]]
    out = home.copy()
    out[ok] = modal[inv]
    return out


def plan_shards(routes, n_links: int, n_shards: int,
                link_tier: Optional[np.ndarray] = None, *,
                seed: int = 0,
                link_dc: Optional[np.ndarray] = None,
                sender_private: bool = False) -> ShardPlan:
    """Partition flows by link locality into `n_shards` balanced shards.

    Flows are sorted by home link (`_home_links`) and cut into equal
    contiguous chunks (each padded to the common row count with inert
    flows); boundary status is then derived from the ACTUAL assignment —
    a link is private iff flows of at most one shard touch it.

    `link_dc` makes the shard order DC-major: flows sort by (home link's
    DC, home link), and at n_shards == n_dc the cut lands on the DC-group
    boundaries themselves (shard s IS datacenter s; shards pad to the
    largest DC's flow count).  `sender_private=True` rehomes every
    first-hop group onto its modal home (`_rehome_sender_uplinks`).

    Hub splitting: a home link saturated past one shard's row budget is
    split across ADJACENT shards by the contiguous cut, its flows dealt in
    seeded order.  Degenerate case: when every hop of every flow is a hub
    and no tiers are given, flows are dealt round-robin into balanced
    shards in a seed-determined order, with a RuntimeWarning.
    `boundary_pairs` records each boundary link's toucher pair.
    """
    r = routes.cpu().numpy() if hasattr(routes, "cpu") else \
        np.asarray(routes)
    r3 = r if r.ndim == 3 else r[:, None, :]
    n = r3.shape[0]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    home, no_nonhub = _home_links(r3, n_links, n_shards, link_tier)
    if sender_private and n:
        home = _rehome_sender_uplinks(r3, home, n_links)
    flow_shard = np.empty(n, np.int32)
    if link_tier is None and n and no_nonhub.all() and n_shards > 1:
        warnings.warn(
            "plan_shards: every hop of every flow is a hub — no home link "
            "localizes anything; dealing flows round-robin into balanced "
            "shards (pass link_tier for locality grouping on multi-tier "
            "topologies)", RuntimeWarning, stacklevel=2)
        rows = -(-n // n_shards)
        gather = np.full((n_shards, rows), n, np.int32)
        deal = np.random.default_rng([seed, 0x5EED]).permutation(n)
        deal = deal.astype(np.int32)
        flow_shard[deal] = np.arange(n, dtype=np.int32) % n_shards
        for s in range(n_shards):
            chunk = deal[s::n_shards]
            gather[s, :chunk.shape[0]] = chunk
    else:
        dc_home = None
        if link_dc is not None:
            dc = np.asarray(link_dc, np.int64)
            if dc.shape != (n_links,):
                raise ValueError(f"link_dc must have shape ({n_links},), "
                                 f"got {dc.shape}")
            dc_home = dc[home]
            key = (dc_home - dc.min()) * np.int64(n_links + 1) + home
        else:
            key = home.astype(np.int64)
        order = np.argsort(key, kind="stable")
        aligned = (dc_home is not None and n
                   and int(dc.max()) + 1 == n_shards
                   and dc_home.min() >= 0)
        if aligned:
            # DC-aligned cut: shard s = datacenter s
            sizes = np.bincount(dc_home, minlength=n_shards)
            rows = max(int(sizes.max()), 1)
            gather = np.full((n_shards, rows), n, np.int32)
            ptr = np.concatenate([[0], np.cumsum(sizes)])
            for s in range(n_shards):
                chunk = order[ptr[s]:ptr[s + 1]]
                gather[s, :chunk.shape[0]] = chunk
                flow_shard[chunk] = s
        else:
            rows = -(-n // n_shards)
            gather = np.full((n_shards, rows), n, np.int32)
            counts_home = np.bincount(home, minlength=n_links) if n else \
                np.zeros(n_links, np.int64)
            fat = np.flatnonzero(counts_home > rows)
            if fat.size:  # hub splitting: deal saturated groups seeded
                rng = np.random.default_rng([seed, 0x4B5])
                ksort = key[order]
                for h in fat:
                    kv = key[np.flatnonzero(home == h)[0]]
                    a, b = np.searchsorted(ksort, [kv, kv + 1])
                    seg = order[a:b].copy()
                    order[a:b] = seg[rng.permutation(b - a)]
            for s in range(n_shards):
                chunk = order[s * rows:(s + 1) * rows]
                gather[s, :chunk.shape[0]] = chunk
            flow_shard[order] = np.minimum(np.arange(n) // rows,
                                           n_shards - 1)
    flat = r3.reshape(n, -1)
    valid = flat >= 0
    touched = np.zeros((n_shards, n_links), bool)
    touched[np.repeat(flow_shard, flat.shape[1]).reshape(n, -1)[valid],
            flat[valid]] = True
    n_touching = touched.sum(axis=0)
    boundary = n_touching >= 2
    owner = np.where(n_touching == 1, np.argmax(touched, axis=0), 0)

    priv = [np.flatnonzero(~boundary & (owner == s))
            for s in range(n_shards)]
    new2old = np.concatenate(priv + [np.flatnonzero(boundary)]).astype(
        np.int32)
    old2new = np.empty(n_links, np.int32)
    old2new[new2old] = np.arange(n_links, dtype=np.int32)
    owner_ptr = np.concatenate(
        [[0], np.cumsum([p.shape[0] for p in priv])]).astype(np.int32)
    bidx = np.flatnonzero(boundary)
    pairs = np.full((bidx.shape[0], 2), -1, np.int32)
    if bidx.size:
        two = n_touching[bidx] == 2
        pairs[two, 0] = np.argmax(touched[:, bidx], axis=0)[two]
        pairs[two, 1] = (n_shards - 1
                         - np.argmax(touched[::-1, bidx], axis=0))[two]
    return ShardPlan(n_shards=n_shards, n_real=n, n_links=n_links,
                     n_boundary=int(boundary.sum()), gather=gather,
                     new2old=new2old, old2new=old2new, owner_ptr=owner_ptr,
                     boundary_pairs=pairs)
