"""Declarative scenario specs: the benchmark's own copy.

Field names, defaults and the flow ordering (groups in declaration order,
flows in index order) are those of the scenario specs that the fluid
compiler under test consumes, so a spec built here converts field for
field (`bench.harness.program.port_spec`) and the plain reference
(`bench.reference`) compiles the same spec on its own.  Plain Python, no
torch.

Units: ns / bytes / bytes-per-ns.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

GBPS = 0.125               # bytes per ns per Gbit/s
RATE_100G = 100 * GBPS
US = 1_000.0
MS = 1_000_000.0
MIB = 1024 * 1024

Path = Tuple[str, ...]
PathSet = Tuple[Path, ...]


class LinkSpec(NamedTuple):
    name: str
    rate: float                  # service rate (bytes/ns)
    delay: float                 # one-way propagation (ns; packet sim only)
    qcap: float = 1 * MIB        # physical queue capacity (bytes)
    wan: bool = False            # inter-DC link: phantom cap uses inter BDP
    vcap_scale: float = 1.0
    tier: int = 0                # locality tier (edge < agg < core < WAN)
    p_loss: float = 0.0          # configured random drop probability


class LbSpec(NamedTuple):
    kind: str = "ecmp"
    n_subflows: int = 8
    eta: float = 0.25
    repath_thresh: float = 0.7
    repath_patience: int = 8
    w_floor: float = 0.05
    ec: Optional[Tuple[int, int]] = None


def lb_spec(d: Optional[dict], default: Optional[LbSpec]) -> LbSpec:
    """A configuration file's LB object (LbSpec fields) as an LbSpec, or
    `default` where the file has none."""
    if d is None:
        return default
    d = dict(d)
    if d.get("ec") is not None:
        d["ec"] = tuple(d["ec"])
    return LbSpec(**d)


class ChurnSpec(NamedTuple):
    mean_on: float
    mean_off: float


class RelSpec(NamedTuple):
    ec: Tuple[int, int] = (8, 2)
    nack_period: Optional[float] = None
    debounce: float = 0.0
    loss_md: float = 0.5
    rtx_cap: float = 1.0
    ladder: Optional[Tuple[Tuple[int, int], ...]] = None
    ladder_up: Optional[Tuple[float, ...]] = None
    ladder_down: Optional[Tuple[float, ...]] = None


class FaultSpec(NamedTuple):
    link: str
    kind: str = "down"
    t_start: float = 0.0
    t_end: Optional[float] = None
    cap_frac: float = 0.0
    period: float = 0.0
    duty: float = 0.5
    loss_rate: float = 5.01e-5
    burst: float = 0.25
    mean_burst_len: float = 3.0


class FlowGroup(NamedTuple):
    name: str
    n: int
    path_sets: Tuple[PathSet, ...]
    inter: bool = False
    rtt: Optional[float] = None
    lb: LbSpec = LbSpec()
    churn: Optional[ChurnSpec] = None
    rel: Optional[RelSpec] = None

    def path_set(self, i: int) -> PathSet:
        return self.path_sets[i if len(self.path_sets) > 1 else 0]


class Scenario(NamedTuple):
    name: str
    links: Tuple[LinkSpec, ...]
    groups: Tuple[FlowGroup, ...]
    rate: float = RATE_100G
    intra_rtt: float = 14 * US
    inter_rtt: float = 2 * MS
    phantom: bool = True
    drain_frac: float = 0.9
    cap_bdps: float = 1.0
    min_frac: float = 0.05
    max_frac: float = 0.35
    red_lo_frac: float = 0.25
    red_hi_frac: float = 0.75
    epoch_period_frac: float = 1.0
    seed: int = 0
    faults: Tuple[FaultSpec, ...] = ()

    @property
    def n_flows(self) -> int:
        return sum(g.n for g in self.groups)

    @property
    def intra_bdp(self) -> float:
        return self.rate * self.intra_rtt

    @property
    def inter_bdp(self) -> float:
        return self.rate * self.inter_rtt

    @property
    def dt(self) -> float:
        return self.epoch_period_frac * self.intra_rtt

    def link_index(self) -> dict:
        return {l.name: i for i, l in enumerate(self.links)}

    def flow_groups(self):
        i = 0
        for g in self.groups:
            for k in range(g.n):
                yield i, g, k
                i += 1


def dumbbell_scenario(n_intra: int, n_inter: int, *,
                      rate: float = RATE_100G,
                      intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                      qcap: float = 1 * MIB, n_wan: int = 8,
                      n_bottleneck: int = 1, phantom: bool = True,
                      drain_frac: float = 0.9, cap_bdps: float = 1.0,
                      min_frac: float = 0.05, max_frac: float = 0.35,
                      red_lo_frac: float = 0.25, red_hi_frac: float = 0.75,
                      epoch_period_frac: float = 1.0,
                      multipath: bool = False,
                      intra_lb: Optional[LbSpec] = None,
                      inter_lb: Optional[LbSpec] = None,
                      intra_churn: Optional[ChurnSpec] = None,
                      inter_churn: Optional[ChurnSpec] = None,
                      inter_rel: Optional[RelSpec] = None,
                      wan_p_loss: float = 0.0,
                      faults: Tuple[FaultSpec, ...] = (),
                      seed: int = 0, name: str = "dumbbell") -> Scenario:
    """The inter/intra dumbbell: one private uplink per intra sender, the
    WAN border (one aggregated pipe of n_wan * rate, or n_wan links with
    `multipath`), and `n_bottleneck` receiver downlinks; flows intra
    first, flow i to downlink i % n_bottleneck."""
    d_inb = intra_rtt / 8.0
    wan_delay = (inter_rtt - intra_rtt) / 2.0
    links = [LinkSpec(f"up{i}", rate, d_inb, qcap) for i in range(n_intra)]
    if multipath:
        wan_names = [f"wan{w}" for w in range(n_wan)]
        links += [LinkSpec(w, rate, wan_delay, qcap, wan=True,
                           p_loss=wan_p_loss) for w in wan_names]
    else:
        wan_names = ["wan"]
        links += [LinkSpec("wan", n_wan * rate, wan_delay, qcap, wan=True,
                           vcap_scale=float(n_wan), p_loss=wan_p_loss)]
    links += [LinkSpec(f"down{j}", rate, d_inb, qcap)
              for j in range(n_bottleneck)]
    groups = []
    if n_intra:
        groups.append(FlowGroup(
            "intra", n_intra,
            tuple(((f"up{i}", f"down{i % n_bottleneck}"),)
                  for i in range(n_intra)),
            inter=False, lb=intra_lb or LbSpec(), churn=intra_churn))
    if n_inter:
        groups.append(FlowGroup(
            "inter", n_inter,
            tuple(tuple((w, f"down{(n_intra + j) % n_bottleneck}")
                        for w in wan_names) for j in range(n_inter)),
            inter=True,
            lb=inter_lb or LbSpec(kind="unolb" if multipath else "rps",
                                  n_subflows=n_wan),
            churn=inter_churn, rel=inter_rel))
    return Scenario(
        name=name, links=tuple(links), groups=tuple(groups), rate=rate,
        intra_rtt=intra_rtt, inter_rtt=inter_rtt, phantom=phantom,
        drain_frac=drain_frac, cap_bdps=cap_bdps, min_frac=min_frac,
        max_frac=max_frac, red_lo_frac=red_lo_frac,
        red_hi_frac=red_hi_frac, epoch_period_frac=epoch_period_frac,
        seed=seed, faults=tuple(faults))
