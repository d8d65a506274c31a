"""Two-DC fat-tree scenarios: the paper's evaluation topology (§5.1) as a
declarative `Scenario`.

The port's own copy of ``repro.scenarios.fat_tree``.  `fat_tree_spec`
builds `TwoDCFatTree` once as a path oracle, lifts its links and
pod-structured flow groups into a `Scenario`, and draws the (src, dst)
pairs deterministically from the spec seed, exactly as the reference does.

Flow groups, intra first: "intra_pod" (same pod), "cross_pod" (same DC,
different pod) and "inter" (cross-DC, adaptive UnoLB-style LbSpec by
default).  Workloads: "permutation" (rounds of per-scope permutations)
and "incast" (every group converges on one victim host).  Path-sets are
capped at `n_paths` ECMP candidates per flow.
"""
from __future__ import annotations

import random
import re
from typing import Optional, Tuple

import numpy as np

from repro_torch.scenarios.spec import (ChurnSpec, FlowGroup, LbSpec,
                                        LinkSpec, MIB, MS, RATE_100G,
                                        Scenario, US)
from repro_torch.netsim.topology import TwoDCFatTree

# locality tiers (LinkSpec.tier): lower = more local to one flow group
TIER_EDGE, TIER_AGG, TIER_CORE, TIER_WAN = 0, 1, 2, 3

WORKLOADS = ("permutation", "incast")

_CORE_RE = re.compile(r"^d\d+c\d+->")        # core -> pod-agg downlinks
_AGG_CORE_RE = re.compile(r"a\d+->c\d+$")    # pod-agg -> core uplinks
_WAN_RE = re.compile(r"^B\d+->B\d+\.")       # border <-> border mesh links


def link_tier_from_name(name: str) -> int:
    """Classify a fat-tree link name into a locality tier."""
    if _WAN_RE.match(name):
        return TIER_WAN
    if name.endswith("->B") or "B->" in name:
        return TIER_WAN          # core<->border attach: inter-DC only
    if name.startswith("h") or name.startswith("e->h"):
        return TIER_EDGE
    if _CORE_RE.match(name) or _AGG_CORE_RE.search(name):
        return TIER_CORE
    return TIER_AGG              # pod-internal edge<->agg


def link_tiers(spec: Scenario) -> Optional[np.ndarray]:
    """(n_links,) int tier array, or None on single-tier topologies."""
    t = np.asarray([l.tier for l in spec.links], np.int32)
    return t if np.any(t != t[0]) else None


def _split_counts(n_flows: int, mix: Tuple[float, float, float]):
    """Largest-remainder split of `n_flows` into the three classes."""
    w = np.asarray(mix, np.float64)
    if w.sum() <= 0:
        raise ValueError("mix must have positive mass")
    exact = n_flows * w / w.sum()
    base = np.floor(exact).astype(int)
    rem = n_flows - int(base.sum())
    order = np.argsort(-(exact - base))
    base[order[:rem]] += 1
    return int(base[0]), int(base[1]), int(base[2])


class _PairPicker:
    """Deterministic (src, dst) pair streams over a TwoDCFatTree."""

    def __init__(self, net, workload: str, seed: int):
        self.net = net
        self.k = net.k
        self.half = net.k // 2
        self.hpd = net.hosts_per_dc
        self.workload = workload
        self.rng = np.random.default_rng([seed, 0xFA77EE])
        # incast: one victim per class, all in DC0 pod 0
        self.victim = net.host_id(0, 0, 0, 0)

    def _pod_hosts(self, dc: int, pod: int) -> np.ndarray:
        base = dc * self.hpd + pod * self.half * self.half
        return np.arange(base, base + self.half * self.half)

    def _perm(self, src: np.ndarray) -> np.ndarray:
        """A nonzero cyclic shift of a shuffled sender list: a derangement."""
        return np.roll(src, int(self.rng.integers(1, src.shape[0])))

    def intra_pod(self, n: int) -> list:
        if self.workload == "incast":
            pool = [h for h in self._pod_hosts(0, 0) if h != self.victim]
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        scopes = [(dc, p) for dc in range(2) for p in range(self.k)]
        while len(out) < n:
            for dc, p in scopes:
                hosts = self._pod_hosts(dc, p)
                src = hosts[self.rng.permutation(hosts.shape[0])]
                dst = self._perm(src)
                out.extend(zip(src.tolist(), dst.tolist()))
        return out[:n]

    def cross_pod(self, n: int) -> list:
        if self.workload == "incast":
            pool = [h for dc_p in range(1, self.k)
                    for h in self._pod_hosts(0, dc_p)]
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        while len(out) < n:
            for dc in range(2):
                podshift = int(self.rng.integers(1, self.k))
                for p in range(self.k):
                    src = self._pod_hosts(dc, p)
                    dstp = self._pod_hosts(dc, (p + podshift) % self.k)
                    dst = dstp[self.rng.permutation(dstp.shape[0])]
                    out.extend(zip(src.tolist(), dst.tolist()))
        return out[:n]

    def inter(self, n: int) -> list:
        if self.workload == "incast":
            pool = list(range(self.hpd, 2 * self.hpd))
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        direction = 0
        while len(out) < n:
            src_dc = direction % 2
            src = np.arange(src_dc * self.hpd, (src_dc + 1) * self.hpd)
            dst = (1 - src_dc) * self.hpd + self.rng.permutation(self.hpd)
            out.extend(zip(src.tolist(), dst.tolist()))
            direction += 1
        return out[:n]


def fat_tree_spec(k: int = 4, n_wan: int = 4, *,
                  n_flows: Optional[int] = None,
                  mix: Tuple[float, float, float] = (0.25, 0.25, 0.5),
                  n_intra_pod: Optional[int] = None,
                  n_cross_pod: Optional[int] = None,
                  n_inter: Optional[int] = None,
                  workload: str = "permutation",
                  n_paths: int = 8,
                  rate: float = RATE_100G,
                  wan_rate: Optional[float] = None,
                  intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                  qcap: float = 1 * MIB,
                  phantom: bool = True, drain_frac: float = 0.9,
                  cap_bdps: float = 1.0,
                  min_frac: float = 0.05, max_frac: float = 0.35,
                  red_lo_frac: float = 0.25, red_hi_frac: float = 0.75,
                  epoch_period_frac: float = 1.0,
                  intra_lb: Optional[LbSpec] = None,
                  inter_lb: Optional[LbSpec] = None,
                  intra_churn: Optional[ChurnSpec] = None,
                  inter_churn: Optional[ChurnSpec] = None,
                  seed: int = 0,
                  name: Optional[str] = None) -> Scenario:
    """Two k-ary fat-tree DCs joined by `n_wan` WAN links, as ONE spec.

    Flow counts: either `n_flows` split by `mix` (intra_pod, cross_pod,
    inter fractions; largest-remainder rounding) or the three explicit
    counts.  `n_paths` caps every flow's ECMP path-set.
    """
    if workload not in WORKLOADS:
        raise ValueError(f"unknown fat-tree workload {workload!r}; "
                         f"expected one of {WORKLOADS}")
    if k < 4 or k % 2:
        raise ValueError(f"k must be even and >= 4, got {k}")
    if n_paths < 1:
        raise ValueError(f"n_paths must be >= 1, got {n_paths}")
    if n_intra_pod is None and n_cross_pod is None and n_inter is None:
        if n_flows is None:
            raise ValueError("give n_flows (+ mix) or explicit class counts")
        n_intra_pod, n_cross_pod, n_inter = _split_counts(n_flows, mix)
    else:
        n_intra_pod = n_intra_pod or 0
        n_cross_pod = n_cross_pod or 0
        n_inter = n_inter or 0

    oracle = TwoDCFatTree(k=k, n_wan=n_wan, rate=rate, qcap=int(qcap),
                          intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                          seed=seed, max_paths=n_paths, wan_rate=wan_rate)
    wan_names = {ln.name for ln in oracle.wan_links}
    links = tuple(
        LinkSpec(ln.name, ln.rate, ln.pdelay, float(ln.qcap),
                 wan=ln.name in wan_names,
                 tier=link_tier_from_name(ln.name))
        for ln in oracle.links.values())

    picker = _PairPicker(oracle, workload, seed)
    path_cache: dict = {}

    def _path_set(src: int, dst: int):
        key = (src, dst)
        ps = path_cache.get(key)
        if ps is None:
            ps = oracle.path_link_names(src, dst)
            if len(ps) > n_paths:
                # sample rather than take the source-agg-major prefix
                # int(): the pools hold numpy integers, which
                # random.Random refuses as a seed on Python 3.12
                rng = random.Random(int((src * 131071 + dst)
                                        ^ (seed << 12) ^ 0x5A17))
                ps = tuple(rng.sample(ps, n_paths))
            path_cache[key] = ps
        return ps

    groups = []
    specs = [("intra_pod", n_intra_pod, picker.intra_pod, False),
             ("cross_pod", n_cross_pod, picker.cross_pod, False),
             ("inter", n_inter, picker.inter, True)]
    for gname, n, pairs_fn, inter in specs:
        if not n:
            continue
        pairs = pairs_fn(n)
        path_sets = tuple(_path_set(s, d) for s, d in pairs)
        if inter:
            lb = inter_lb or LbSpec(kind="unolb", n_subflows=n_paths)
            churn = inter_churn
        else:
            lb = intra_lb or LbSpec(kind="ecmp", n_subflows=n_paths)
            churn = intra_churn
        groups.append(FlowGroup(gname, n, path_sets, inter=inter,
                                lb=lb, churn=churn))
    if not groups:
        raise ValueError("fat_tree_spec: zero flows requested")

    return Scenario(
        name=name or f"fat_tree_k{k}_{workload}",
        links=links, groups=tuple(groups), rate=rate,
        intra_rtt=intra_rtt, inter_rtt=inter_rtt, phantom=phantom,
        drain_frac=drain_frac, cap_bdps=cap_bdps, min_frac=min_frac,
        max_frac=max_frac, red_lo_frac=red_lo_frac,
        red_hi_frac=red_hi_frac, epoch_period_frac=epoch_period_frac,
        seed=seed).validate()
