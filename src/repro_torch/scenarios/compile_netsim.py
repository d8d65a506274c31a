"""Scenario -> packet simulator: a `repro_torch.netsim` Net whose links,
paths and marking config come from the same spec the fluid compiler
consumes (the port's copy of ``repro.scenarios.compile_netsim``).

Host convention: host 0 is the receiver, host 1 + i is the sender of global
flow i (spec flow ordering).  `spawn_backlogged` then wires one Flow per
spec flow with the group's router kind / subflow count / EC framing, rng
seeded from the spec — the packet-level ground truth cross-validation
(repro_torch.fleetsim.validate) compares against positionally.
`netsim_scenario_rates` and `netsim_recovery_rates` are that ground
truth: the packet halves of the comparisons (the reference keeps them in
``repro.fleetsim.validate``).
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np

from repro_torch.netsim.engine import Simulator
from repro_torch.netsim.topology import Net
from repro_torch.scenarios.spec import MIB, MS, Scenario


class ScenarioNet(Net):
    """A Net built link-by-link from a Scenario (no hand-coded topology)."""

    def __init__(self, spec: Scenario, seed: Optional[int] = None):
        self.spec = spec
        sim = Simulator(spec.seed if seed is None else seed)
        super().__init__(sim, 1 + spec.n_flows, spec.intra_rtt,
                         spec.inter_rtt, spec.rate)
        for li, l in enumerate(spec.links):
            ln = self._mk_link(l.name, l.rate, l.delay, int(l.qcap))
            ln.ecn_min = spec.red_lo_frac * l.qcap
            ln.ecn_max = spec.red_hi_frac * l.qcap
            if l.p_loss > 0.0:
                # Bernoulli random loss, rng pinned to (spec seed, link id)
                # so two compilations of one spec drop identically
                rng = random.Random(((spec.seed if seed is None else seed)
                                     << 16) ^ li)
                ln.loss_fn = (lambda r, p: lambda pkt, now:
                              r.random() < p)(rng, l.p_loss)
            if l.wan:
                self.wan_links.append(ln)
            if spec.phantom:
                vcap = (l.vcap_scale * spec.cap_bdps
                        * (spec.inter_bdp if l.wan else spec.intra_bdp))
                ln.attach_phantom(spec.drain_frac, vcap,
                                  spec.min_frac, spec.max_frac)
        self._schedule_faults(spec, sim, spec.seed if seed is None else seed)
        self._flow_paths = []
        self._flow_inter = []
        self._flow_rtt = []
        self._flow_group = []
        for _, g, k in spec.flow_groups():
            self._flow_paths.append(
                [tuple(self.links[name] for name in path)
                 for path in g.path_set(k)])
            self._flow_inter.append(g.inter)
            self._flow_rtt.append(
                g.rtt if g.rtt is not None
                else (spec.inter_rtt if g.inter else spec.intra_rtt))
            self._flow_group.append(g)

    def _schedule_faults(self, spec: Scenario, sim, seed: int) -> None:
        """Map spec.faults onto the packet engine's fault primitives.

        "down"/"flap" schedule `fail_link`/`repair_link` pairs through
        `sim.at`; "brownout" rescales the link's service rate (a 0.0
        fraction degenerates to a hard failure — a zero rate would divide
        the serialization time); "burst" wraps the link's loss_fn with a
        windowed GilbertElliott chain (seeded per (spec seed, fault idx),
        composed with any configured p_loss).  Netsim stays the oracle
        for the fluid fault axis.
        """
        from repro_torch.netsim.topology import (GilbertElliott,
                                                 fail_link, repair_link)
        for fi, f in enumerate(spec.faults):
            ln = self.links[f.link]
            if f.kind == "down" or (f.kind == "brownout"
                                    and f.cap_frac <= 0.0):
                sim.at(f.t_start, fail_link, ln)
                if f.t_end is not None:
                    sim.at(f.t_end, repair_link, ln)
            elif f.kind == "brownout":
                orig = ln.rate
                sim.at(f.t_start, setattr, ln, "rate",
                       orig * f.cap_frac)
                if f.t_end is not None:
                    sim.at(f.t_end, setattr, ln, "rate", orig)
            elif f.kind == "flap":
                _arm_flap(sim, ln, f, fail_link, repair_link)
                if f.t_end is not None:
                    sim.at(f.t_end, repair_link, ln)
            else:  # "burst" (spec.validate rejects anything else)
                rng = random.Random((seed << 16) ^ (0xFA17 * (fi + 1)))
                ge = GilbertElliott(rng, loss_rate=f.loss_rate,
                                    burst=f.burst,
                                    mean_burst_len=f.mean_burst_len)
                prev = ln.loss_fn
                ln.loss_fn = _windowed_loss(ge, prev, f.t_start, f.t_end)

    def _flow_of(self, src: int, dst: int) -> int:
        """Global flow index: the sender endpoint identifies the flow."""
        host = src if src > 0 else dst
        if not 1 <= host <= len(self._flow_paths):
            raise ValueError(f"host {host} is not a scenario sender")
        return host - 1

    def is_inter(self, src: int, dst: int) -> bool:
        return self._flow_inter[self._flow_of(src, dst)]

    def base_rtt(self, src: int, dst: int) -> float:
        return self._flow_rtt[self._flow_of(src, dst)]

    def bdp(self, src: int, dst: int) -> float:
        return self.rate * self.base_rtt(src, dst)

    def paths(self, src: int, dst: int) -> list:
        return self._flow_paths[self._flow_of(src, dst)]

    def group_of(self, flow_idx: int):
        return self._flow_group[flow_idx]


def _arm_flap(sim, ln, f, fail_link, repair_link) -> None:
    """Self-rescheduling down/up square wave (factored out of the fault
    loop so the recursive closure binds ITS OWN cycle, not the loop's
    last one)."""
    down_len = f.duty * f.period

    def cycle(t0):
        if f.t_end is not None and t0 >= f.t_end:
            return
        fail_link(ln)
        sim.at(t0 + down_len, repair_link, ln)
        sim.at(t0 + f.period, cycle, t0 + f.period)

    sim.at(f.t_start, cycle, f.t_start)


def _windowed_loss(ge, prev, t_start: float, t_end):
    """Compose a GilbertElliott chain active on [t_start, t_end) with the
    link's preexisting loss_fn (configured p_loss), if any."""
    def loss(pkt, now):
        hit = False
        if now >= t_start and (t_end is None or now < t_end):
            hit = ge(pkt, now)
        if not hit and prev is not None:
            hit = prev(pkt, now)
        return hit
    return loss


def to_netsim(spec: Scenario, seed: Optional[int] = None) -> ScenarioNet:
    """Compile the spec's topology (marking config included) to netsim."""
    return ScenarioNet(spec, seed=seed)


def spawn_backlogged(net: ScenarioNet, *, cc_scheme: str, size: int,
                     trace_rate: bool = True, lb: Optional[str] = None,
                     cc_kw: Optional[dict] = None) -> list:
    """One long flow per spec flow, in spec order (the cross-validation run).

    Router kind / subflow count / EC come from each group's LbSpec unless
    `lb` overrides the kind globally; a group's RelSpec (dynamic
    reliability) overrides the EC geometry and sets the receiver's NACK
    timeout, so the packet run exercises the same recovery config the
    fluid reliability machine models.  The rng is seeded from the spec so
    two spawns of the same spec route identically.
    """
    from repro_torch.netsim import workloads as W
    spec = net.spec
    rng = random.Random(spec.seed)
    flows = []
    for i, g, _ in spec.flow_groups():
        ec = g.rel.ec if g.rel is not None else g.lb.ec
        nack_timeout = g.rel.nack_period if g.rel is not None else None
        flows.append(W.spawn(
            net, 1 + i, 0, size, cc_scheme=cc_scheme,
            lb=lb if lb is not None else g.lb.kind, ec=ec,
            n_subflows=g.lb.n_subflows, rng=rng, trace_rate=trace_rate,
            cc_kw=cc_kw, router_salt=(spec.seed << 20) ^ i,
            nack_timeout=nack_timeout))
    return flows


def netsim_scenario_rates(spec: Scenario, *, horizon: float = 45 * MS,
                          t0: float = 15 * MS, size: int = 512 * MIB,
                          lb=None, cc_scheme: str = "uno",
                          info: Optional[dict] = None) -> np.ndarray:
    """Per-flow mean goodput (bytes/ns) over [t0, horizon), spec flow order
    — the packet-simulator ground truth.  `info`, if given, receives the
    number of events the run simulated (`events`)."""
    net = to_netsim(spec)
    flows = spawn_backlogged(net, cc_scheme=cc_scheme, size=size, lb=lb)
    net.sim.run(until=horizon)
    if info is not None:
        info["events"] = net.sim.events
    span = horizon - t0
    return np.array([sum(b for (t, b) in f.rate_trace if t0 <= t < horizon)
                     / span for f in flows])


def netsim_recovery_rates(spec: Scenario, *, horizon: float = 60 * MS,
                          t0: float = 20 * MS, size: int = 512 * MIB,
                          cc_scheme: str = "uno") -> tuple:
    """The recovery and adaptive-EC comparisons' packet run: (per-flow
    mean goodput over [t0, horizon), the retransmit fraction
    sum(n_retx) / sum(n_sent) of the packets sent after t0)."""
    net = to_netsim(spec)
    flows = spawn_backlogged(net, cc_scheme=cc_scheme, size=size)
    snap = {"sent": 0, "retx": 0}

    def _snapshot():
        snap["sent"] = sum(f.n_sent for f in flows)
        snap["retx"] = sum(f.n_retx for f in flows)

    net.sim.at(t0, _snapshot)
    net.sim.run(until=horizon)
    span = horizon - t0
    ns = np.array([sum(b for (t, b) in f.rate_trace if t0 <= t < horizon)
                   / span for f in flows])
    d_sent = sum(f.n_sent for f in flows) - snap["sent"]
    retx_ns = (sum(f.n_retx for f in flows) - snap["retx"]) \
        / max(d_sent, 1)
    return ns, float(retx_ns)
