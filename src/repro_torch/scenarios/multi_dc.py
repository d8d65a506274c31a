"""N-datacenter fat-tree scenarios as one declarative `Scenario`.

The port's own copy of ``repro.scenarios.multi_dc``.  `multi_dc_spec` lifts
`MultiDCFatTree` (per-DC k-ary fat-trees behind dedicated DCI border
switches, joined by a ring / full / hub-spoke WAN mesh) into a Scenario,
and draws the (src, dst) pairs deterministically from the spec seed exactly
as the reference does, so link ids, path-sets and flow order are identical.
``n_dc=2, mesh="full", oversub=1.0`` reproduces `fat_tree_spec`'s link set.

Workload presets:

  * "hotcold" — each DC's first `n_hot` pods are HOT: they carry only
    inter-DC traffic, and hot pod j is pinned to ONE WAN-adjacent remote DC
    (``adj[j % len(adj)]``).  The COLD pods carry the intra classes.  The
    pinning is what lets a DC-major shard plan (`plan_shards(link_dc=...,
    sender_private=True)`) keep every link below the DCI attach / WAN tiers
    private to one shard.
  * "incast" — every class converges on host 0's downlink (DC 0, pod 0).

`link_dcs` labels every link with its datacenter (-1 on WAN mesh links);
it feeds the planner's DC-major shard order.
"""
from __future__ import annotations

import random
import re
from typing import Optional, Tuple

import numpy as np

from repro_torch.scenarios.fat_tree import _split_counts, link_tier_from_name
from repro_torch.scenarios.spec import (ChurnSpec, FlowGroup, LbSpec,
                                        LinkSpec, MIB, MS, RATE_100G,
                                        Scenario, US)
from repro_torch.netsim.topology import MultiDCFatTree

MULTI_DC_WORKLOADS = ("hotcold", "incast")
MESHES = ("ring", "full", "hubspoke")

_DC_RE = re.compile(r"^d(\d+)")
_WAN_RE = re.compile(r"^B\d+->B\d+\.")


def link_dcs(spec: Scenario) -> Optional[np.ndarray]:
    """(n_links,) int64 datacenter id per link, -1 for the WAN mesh links,
    parsed from the fat-tree link-name grammar; None on any other topology
    (a dumbbell has no DC structure)."""
    names = [l.name for l in spec.links]
    n_hosts = sum(1 for nm in names
                  if nm.startswith("h") and nm.endswith("->e"))
    dcs = [int(m.group(1)) for nm in names if (m := _DC_RE.match(nm))]
    if not n_hosts or not dcs:
        return None
    hpd = n_hosts // (max(dcs) + 1)
    out = np.empty(len(names), np.int64)
    for i, nm in enumerate(names):
        m = _DC_RE.match(nm)
        if m:
            out[i] = int(m.group(1))
        elif _WAN_RE.match(nm):
            out[i] = -1
        elif nm.startswith("h") and nm.endswith("->e"):
            out[i] = int(nm[1:-3]) // hpd
        elif nm.startswith("e->h"):
            out[i] = int(nm[4:]) // hpd
        else:
            return None
    return out


class _MultiDCPairPicker:
    """Deterministic (src, dst) pair streams over a MultiDCFatTree."""

    def __init__(self, net, workload: str, n_hot: int, seed: int):
        self.net = net
        self.k = net.k
        self.half = net.k // 2
        self.hpd = net.hosts_per_dc
        self.n_dc = net.n_dc
        self.n_hot = n_hot
        self.workload = workload
        self.rng = np.random.default_rng([seed, 0xD0D0])
        self.adj = {d: sorted(net._adj[d]) for d in range(net.n_dc)}
        self.victim = net.host_id(0, 0, 0, 0)

    def _pod_hosts(self, dc: int, pod: int) -> np.ndarray:
        base = dc * self.hpd + pod * self.half * self.half
        return np.arange(base, base + self.half * self.half)

    def _hot_hosts(self, dc: int) -> np.ndarray:
        return np.concatenate([self._pod_hosts(dc, p)
                               for p in range(self.n_hot)])

    def _perm(self, src: np.ndarray) -> np.ndarray:
        """A nonzero cyclic shift of a shuffled list: a derangement."""
        return np.roll(src, int(self.rng.integers(1, src.shape[0])))

    def pod_target(self, dc: int, pod: int) -> int:
        """The ONE remote DC hot pod `pod` of `dc` is pinned to."""
        a = self.adj[dc]
        return a[pod % len(a)]

    def intra_pod(self, n: int) -> list:
        if self.workload == "incast":
            pool = [h for h in self._pod_hosts(0, 0) if h != self.victim]
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        scopes = [(dc, p) for dc in range(self.n_dc)
                  for p in range(self.n_hot, self.k)]
        while len(out) < n:
            for dc, p in scopes:
                hosts = self._pod_hosts(dc, p)
                src = hosts[self.rng.permutation(hosts.shape[0])]
                out.extend(zip(src.tolist(), self._perm(src).tolist()))
        return out[:n]

    def cross_pod(self, n: int) -> list:
        if self.workload == "incast":
            pool = [h for p in range(1, self.k)
                    for h in self._pod_hosts(0, p)]
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        cold = list(range(self.n_hot, self.k))
        while len(out) < n:
            for dc in range(self.n_dc):
                shift = int(self.rng.integers(1, len(cold)))
                for i, p in enumerate(cold):
                    src = self._pod_hosts(dc, p)
                    dstp = self._pod_hosts(dc, cold[(i + shift) % len(cold)])
                    dst = dstp[self.rng.permutation(dstp.shape[0])]
                    out.extend(zip(src.tolist(), dst.tolist()))
        return out[:n]

    def inter(self, n: int) -> list:
        if self.workload == "incast":
            pool = [h for dc in self.adj[0] for h in self._hot_hosts(dc)]
            return [(pool[i % len(pool)], self.victim) for i in range(n)]
        out = []
        while len(out) < n:
            for dc in range(self.n_dc):
                for p in range(self.n_hot):
                    t = self.pod_target(dc, p)
                    src = self._pod_hosts(dc, p)
                    src = src[self.rng.permutation(src.shape[0])]
                    pool = self._hot_hosts(t)
                    dst = pool[self.rng.permutation(pool.shape[0])]
                    out.extend(zip(src.tolist(),
                                   dst[:src.shape[0]].tolist()))
        return out[:n]


def multi_dc_spec(k: int = 4, n_dc: int = 3, *,
                  mesh: str = "ring",
                  oversub: float = 1.0,
                  n_wan: int = 4,
                  n_flows: Optional[int] = None,
                  mix: Tuple[float, float, float] = (0.25, 0.25, 0.5),
                  n_intra_pod: Optional[int] = None,
                  n_cross_pod: Optional[int] = None,
                  n_inter: Optional[int] = None,
                  workload: str = "hotcold",
                  hot_frac: float = 0.5,
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
    """`n_dc` k-ary fat-tree DCs on a `mesh` WAN, as ONE spec.

    `oversub` divides the DCI attach-link rate.  Flow counts: `n_flows`
    split by `mix` (intra_pod, cross_pod, inter; largest-remainder
    rounding) or the three explicit counts.  `hot_frac` sets the hot-pod
    count per DC (``max(1, round(hot_frac * k))``, capped at k-1 whenever
    intra flows are requested).  Groups are declared intra-first.
    """
    if workload not in MULTI_DC_WORKLOADS:
        raise ValueError(f"unknown multi-DC workload {workload!r}; "
                         f"expected one of {MULTI_DC_WORKLOADS}")
    if mesh not in MESHES:
        raise ValueError(f"unknown WAN mesh {mesh!r}; "
                         f"expected one of {MESHES}")
    if k < 4 or k % 2:
        raise ValueError(f"k must be even and >= 4, got {k}")
    if n_dc < 2:
        raise ValueError(f"n_dc must be >= 2, got {n_dc}")
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
    n_hot = max(1, int(round(hot_frac * k)))
    if n_intra_pod or n_cross_pod:
        n_hot = min(n_hot, k - 1)
    if n_cross_pod and k - n_hot < 2:
        raise ValueError("cross_pod flows need >= 2 cold pods; lower "
                         f"hot_frac (k={k}, n_hot={n_hot})")

    oracle = MultiDCFatTree(k=k, n_dc=n_dc, mesh=mesh, oversub=oversub,
                            n_wan=n_wan, rate=rate, qcap=int(qcap),
                            intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                            seed=seed, max_paths=n_paths, wan_rate=wan_rate)
    wan_names = {ln.name for ln in oracle.wan_links}
    links = tuple(
        LinkSpec(ln.name, ln.rate, ln.pdelay, float(ln.qcap),
                 wan=ln.name in wan_names,
                 tier=link_tier_from_name(ln.name))
        for ln in oracle.links.values())

    picker = _MultiDCPairPicker(oracle, workload, n_hot, seed)
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
        raise ValueError("multi_dc_spec: zero flows requested")

    return Scenario(
        name=name or f"multi_dc_k{k}_dc{n_dc}_{mesh}_{workload}",
        links=links, groups=tuple(groups), rate=rate,
        intra_rtt=intra_rtt, inter_rtt=inter_rtt, phantom=phantom,
        drain_frac=drain_frac, cap_bdps=cap_bdps, min_frac=min_frac,
        max_frac=max_frac, red_lo_frac=red_lo_frac,
        red_hi_frac=red_hi_frac, epoch_period_frac=epoch_period_frac,
        seed=seed).validate()
