"""Declarative scenario specs: links, flow groups over explicit path-sets,
inter/intra tags with per-class RTTs, and optional load balancing and
churn per group.

The port's own copy of ``repro.scenarios.spec``; field names, defaults and
the flow ordering (groups in declaration order, flows in index order) are
the reference's, so one spec compiles to the same arrays in both packages.
A group's ``RelSpec`` compiles to the reliability machine and the
spec's ``FaultSpec``s to the fault schedule
(`repro_torch.scenarios.compile_fleetsim`).  `fingerprint` is the
reference's content hash of a spec or of a builder's kwargs, string for
string.

Units follow the repo convention: ns / bytes / bytes-per-ns.
"""
from __future__ import annotations

import hashlib
import json
from typing import NamedTuple, Optional, Tuple

GBPS = 0.125               # bytes per ns per Gbit/s
RATE_100G = 100 * GBPS
US = 1_000.0
MS = 1_000_000.0
MIB = 1024 * 1024

Path = Tuple[str, ...]           # link names, sender -> receiver order
PathSet = Tuple[Path, ...]       # the paths one flow may use


class LinkSpec(NamedTuple):
    """One directed link.

    `vcap_scale` multiplies the derived phantom virtual capacity
    (cap_bdps * class BDP); aggregated pipes set it to the aggregation
    factor.  `tier` is the locality tier (edge < agg < core < WAN).
    `p_loss` is a configured random per-byte drop probability.
    """
    name: str
    rate: float                  # service rate (bytes/ns)
    delay: float                 # one-way propagation (ns; packet sim only)
    qcap: float = 1 * MIB        # physical queue capacity (bytes)
    wan: bool = False            # inter-DC link: phantom cap uses inter BDP
    vcap_scale: float = 1.0
    tier: int = 0                # locality tier (edge < agg < core < WAN)
    p_loss: float = 0.0          # configured random drop probability


class LbSpec(NamedTuple):
    """Load-balancing for one flow group.

    Any adaptive `kind` ("unolb" / "plb") maps onto the fluid LbParams
    weight dynamics, `eta == 0` onto a static uniform split.  `ec=(k, r)`
    is the k/(k+r) goodput overhead, applied on inter-DC groups only.
    """
    kind: str = "ecmp"
    n_subflows: int = 8
    eta: float = 0.25
    repath_thresh: float = 0.7
    repath_patience: int = 8
    w_floor: float = 0.05
    ec: Optional[Tuple[int, int]] = None


class ChurnSpec(NamedTuple):
    """Poisson on/off churn: exponential ON/OFF holding times (ns)."""
    mean_on: float
    mean_off: float


class RelSpec(NamedTuple):
    """Dynamic reliability (EC + NACK recovery) for one INTER-DC flow
    group (ignored on intra groups).  `nack_period` / `debounce` are ns,
    rounded to epochs by the compiler; `nack_period=None` is a quarter of
    the flow RTT (at least 100 us).  `ladder=((k0, r0), ...)` turns on the
    adaptive EC-strength controller, rung 0 replacing `ec`."""
    ec: Tuple[int, int] = (8, 2)
    nack_period: Optional[float] = None   # ns between NACK batch ticks
    debounce: float = 0.0                 # ns of holdoff after a NACK fires
    loss_md: float = 0.5                  # cwnd factor on a NACK event
    rtx_cap: float = 1.0                  # retransmit rate cap vs CC rate
    ladder: Optional[Tuple[Tuple[int, int], ...]] = None
    ladder_up: Optional[Tuple[float, ...]] = None
    ladder_down: Optional[Tuple[float, ...]] = None


class FaultSpec(NamedTuple):
    """One scheduled fault on a named link, times in ns from the start
    (`t_end=None` never clears): "down" (capacity 0), "brownout"
    (capacity x `cap_frac`), "flap" (a `period` / `duty` square wave at
    `cap_frac`), "burst" (Gilbert-Elliott loss, `loss_rate` / `burst` /
    `mean_burst_len`, one chain tick per epoch)."""
    link: str
    kind: str = "down"
    t_start: float = 0.0
    t_end: Optional[float] = None
    cap_frac: float = 0.0          # brownout/flap capacity multiplier
    period: float = 0.0            # flap period (ns)
    duty: float = 0.5              # fraction of the period spent faulted
    loss_rate: float = 5.01e-5     # burst: mean loss prob (paper Table 1)
    burst: float = 0.25            # burst: loss prob in the bad state
    mean_burst_len: float = 3.0    # burst: mean bad-state dwell (ticks)


FAULT_KINDS = ("down", "brownout", "flap", "burst")


class FlowGroup(NamedTuple):
    """`n` flows sharing a traffic class.

    `path_sets` has length n (one PathSet per flow) or length 1 (all flows
    share the PathSet).  `rtt=None` uses the class default.
    """
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
    """The complete spec the compiler consumes."""
    name: str
    links: Tuple[LinkSpec, ...]
    groups: Tuple[FlowGroup, ...]
    rate: float = RATE_100G          # access line rate (sets BDPs)
    intra_rtt: float = 14 * US
    inter_rtt: float = 2 * MS
    phantom: bool = True             # Uno marking (phantom) vs physical RED
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

    def link_index(self) -> dict:
        return {l.name: i for i, l in enumerate(self.links)}

    def flow_groups(self):
        """Yield (global_flow_idx, group, idx_within_group) in the shared
        ordering: groups in declaration order, flows in index order."""
        i = 0
        for g in self.groups:
            for k in range(g.n):
                yield i, g, k
                i += 1

    def validate(self) -> "Scenario":
        """Cheap structural checks; returns self so builders can chain."""
        idx = self.link_index()
        if len(idx) != len(self.links):
            raise ValueError(f"{self.name}: duplicate link names")
        for g in self.groups:
            if len(g.path_sets) not in (1, g.n):
                raise ValueError(
                    f"{self.name}/{g.name}: path_sets must have length 1 "
                    f"or n={g.n}, got {len(g.path_sets)}")
            for ps in g.path_sets:
                if not ps:
                    raise ValueError(f"{self.name}/{g.name}: empty path set")
                for path in ps:
                    for name in path:
                        if name not in idx:
                            raise ValueError(
                                f"{self.name}/{g.name}: unknown link "
                                f"{name!r}")
        for f in self.faults:
            if f.link not in idx:
                raise ValueError(
                    f"{self.name}: fault on unknown link {f.link!r}")
            if f.kind not in FAULT_KINDS:
                raise ValueError(
                    f"{self.name}: unknown fault kind {f.kind!r} "
                    f"(expected one of {FAULT_KINDS})")
            if f.kind == "flap" and f.period <= 0.0:
                raise ValueError(
                    f"{self.name}: flap fault on {f.link!r} needs a "
                    f"positive period")
        return self


# -------------------------------------------------------------- fingerprint

def _canonical(obj):
    """Nested spec value -> a JSON-stable structure: NamedTuples tagged
    with their class name (a RelSpec never collides with an equal plain
    tuple), dicts sorted by key, tuples and lists as lists.  Only
    str / int / float / bool / None leaves are accepted: hash the spec
    that built an array, not the array."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return ["#" + type(obj).__name__] + [_canonical(v) for v in obj]
    if isinstance(obj, (tuple, list)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(f"unfingerprintable spec value {obj!r} "
                    f"({type(obj).__name__})")


def fingerprint(obj, *extra) -> str:
    """Deterministic content hash (20 hex digits of a SHA-256) of a nested
    spec structure, a builder's kwargs or both; `extra` tokens (a cache
    version) fold into the digest.  Equal to the reference's string for
    string: the same JSON (sorted keys, no spaces) of the same canonical
    form."""
    payload = json.dumps([_canonical(obj), [_canonical(e) for e in extra]],
                         sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:20]


def spec_fingerprint(spec: Scenario, *extra) -> str:
    """`fingerprint` of a Scenario."""
    return fingerprint(spec, *extra)


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
    """The inter/intra dumbbell.

    Links: one private uplink per intra sender, the WAN border
    (`multipath=False`: ONE aggregated pipe of n_wan * rate;
    `multipath=True`: n_wan separate links), and `n_bottleneck` receiver
    downlinks.  Flows are numbered intra first, then inter, and flow i
    sends to downlink `down{i % n_bottleneck}`.  `multipath=True` gives
    every inter flow one path per WAN link.
    """
    d_inb = intra_rtt / 8.0
    wan_delay = (inter_rtt - intra_rtt) / 2.0
    links = [LinkSpec(f"up{i}", rate, d_inb, qcap) for i in range(n_intra)]
    if multipath:
        wan_names = [f"wan{w}" for w in range(n_wan)]
        links += [LinkSpec(w, rate, wan_delay, qcap, wan=True,
                           p_loss=wan_p_loss)
                  for w in wan_names]
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
                        for w in wan_names)
                  for j in range(n_inter)),
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
        seed=seed, faults=tuple(faults)).validate()
