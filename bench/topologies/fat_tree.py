"""Topology `fat_tree`: two k-ary fat trees, each behind a border switch,
joined by `n_wan` WAN links each way, under the permutation workload.

The links and path sets are a copy of the two-DC fat tree that the
program's scenario builder samples (link names and order, ECMP
enumeration, the seeded path sampling), and the (src, dst) pairs a copy
of that builder's pair streams, so `seed` picks the same flows the
program's own `fat_tree_spec(seed=)` would.  Plain Python and numpy.
"""
from __future__ import annotations

import random
import re

import numpy as np

from bench.harness.spec import (MS, US, FlowGroup, LbSpec, LinkSpec,
                                Scenario, lb_spec)

TIER_EDGE, TIER_AGG, TIER_CORE, TIER_WAN = 0, 1, 2, 3

_CORE_RE = re.compile(r"^d\d+c\d+->")        # core -> pod-agg downlinks
_AGG_CORE_RE = re.compile(r"a\d+->c\d+$")    # pod-agg -> core uplinks
_WAN_RE = re.compile(r"^B\d+->B\d+\.")       # border <-> border links


def _link_tier(name: str) -> int:
    """A fat-tree link's locality tier, from its name."""
    if _WAN_RE.match(name):
        return TIER_WAN
    if name.endswith("->B") or "B->" in name:
        return TIER_WAN
    if name.startswith("h") or name.startswith("e->h"):
        return TIER_EDGE
    if _CORE_RE.match(name) or _AGG_CORE_RE.search(name):
        return TIER_CORE
    return TIER_AGG


class FatTree:
    """Two k-ary fat trees, each behind a border switch, joined by `n_wan`
    links each way: the links (name, rate, one-way delay, qcap, wan) in
    creation order and each host pair's ECMP path set."""

    def __init__(self, k, n_wan, rate, qcap, intra_rtt, inter_rtt,
                 max_paths, wan_rate=None):
        self.k, self.n_wan, self.max_paths = k, n_wan, max_paths
        half = k // 2
        self.hosts_per_dc = k * half * half
        d = intra_rtt / 14.0
        wan_d = (inter_rtt - intra_rtt) / 2.0
        wr = wan_rate if wan_rate is not None else rate
        links = []

        def mk(name, r, dl, wan=False):
            links.append((name, r, dl, qcap, wan))
        for dc in range(2):
            for p in range(k):
                for e in range(half):
                    for h in range(half):
                        hid = self.host_id(dc, p, e, h)
                        mk(f"h{hid}->e", rate, d)
                        mk(f"e->h{hid}", rate, d)
                    for a in range(half):
                        mk(f"d{dc}p{p}e{e}->a{a}", rate, d)
                        mk(f"d{dc}p{p}a{a}->e{e}", rate, d)
                for a in range(half):
                    for c in range(half):
                        ci = a * half + c
                        mk(f"d{dc}p{p}a{a}->c{ci}", rate, d)
                        mk(f"d{dc}c{ci}->p{p}a{a}", rate, d)
            for ci in range(half * half):
                mk(f"d{dc}c{ci}->B", rate, d)
                mk(f"d{dc}B->c{ci}", rate, d)
        for w in range(n_wan):
            mk(f"B0->B1.{w}", wr, wan_d, True)
            mk(f"B1->B0.{w}", wr, wan_d, True)
        self.links = links

    def host_id(self, dc, pod, edge, h) -> int:
        half = self.k // 2
        return dc * self.hosts_per_dc + pod * half * half + edge * half + h

    def host_loc(self, hid):
        half = self.k // 2
        dc, r = divmod(hid, self.hosts_per_dc)
        pod, r = divmod(r, half * half)
        edge, h = divmod(r, half)
        return dc, pod, edge, h

    def paths(self, src: int, dst: int) -> tuple:
        half = self.k // 2
        sdc, spod, sedge, _ = self.host_loc(src)
        ddc, dpod, dedge, _ = self.host_loc(dst)
        up0, down_last = f"h{src}->e", f"e->h{dst}"
        if sdc == ddc and spod == dpod and sedge == dedge:
            return ((up0, down_last),)
        if sdc == ddc and spod == dpod:
            return tuple((up0, f"d{sdc}p{spod}e{sedge}->a{a}",
                          f"d{sdc}p{spod}a{a}->e{dedge}", down_last)
                         for a in range(half))
        if sdc == ddc:
            return tuple((up0, f"d{sdc}p{spod}e{sedge}->a{a}",
                          f"d{sdc}p{spod}a{a}->c{a * half + c}",
                          f"d{sdc}c{a * half + c}->p{dpod}a{a}",
                          f"d{sdc}p{dpod}a{a}->e{dedge}", down_last)
                         for a in range(half) for c in range(half))
        rng = random.Random(int((src * 131071 + dst) ^ 0xABCDEF))
        total = half ** 4 * self.n_wan
        out = []
        for idx in rng.sample(range(total), min(self.max_paths, total)):
            idx, c2 = divmod(idx, half)
            idx, a2 = divmod(idx, half)
            idx, w = divmod(idx, self.n_wan)
            a, c = divmod(idx, half)
            ci, ci2 = a * half + c, a2 * half + c2
            out.append((up0, f"d{sdc}p{spod}e{sedge}->a{a}",
                        f"d{sdc}p{spod}a{a}->c{ci}", f"d{sdc}c{ci}->B",
                        f"B{sdc}->B{ddc}.{w}", f"d{ddc}B->c{ci2}",
                        f"d{ddc}c{ci2}->p{dpod}a{a2}",
                        f"d{ddc}p{dpod}a{a2}->e{dedge}", down_last))
        return tuple(out)


class _PairPicker:
    """Deterministic (src, dst) pair streams of the permutation workload:
    rounds of per-scope permutations."""

    def __init__(self, net: FatTree, seed: int):
        self.k, self.half, self.hpd = net.k, net.k // 2, net.hosts_per_dc
        self.rng = np.random.default_rng([seed, 0xFA77EE])

    def _pod_hosts(self, dc, pod):
        base = dc * self.hpd + pod * self.half * self.half
        return np.arange(base, base + self.half * self.half)

    def _perm(self, src):
        return np.roll(src, int(self.rng.integers(1, src.shape[0])))

    def intra_pod(self, n):
        out = []
        scopes = [(dc, p) for dc in range(2) for p in range(self.k)]
        while len(out) < n:
            for dc, p in scopes:
                hosts = self._pod_hosts(dc, p)
                src = hosts[self.rng.permutation(hosts.shape[0])]
                out.extend(zip(src.tolist(), self._perm(src).tolist()))
        return out[:n]

    def cross_pod(self, n):
        out = []
        while len(out) < n:
            for dc in range(2):
                shift = int(self.rng.integers(1, self.k))
                for p in range(self.k):
                    src = self._pod_hosts(dc, p)
                    dstp = self._pod_hosts(dc, (p + shift) % self.k)
                    dst = dstp[self.rng.permutation(dstp.shape[0])]
                    out.extend(zip(src.tolist(), dst.tolist()))
        return out[:n]

    def inter(self, n):
        out, direction = [], 0
        while len(out) < n:
            src_dc = direction % 2
            src = np.arange(src_dc * self.hpd, (src_dc + 1) * self.hpd)
            dst = (1 - src_dc) * self.hpd + self.rng.permutation(self.hpd)
            out.extend(zip(src.tolist(), dst.tolist()))
            direction += 1
        return out[:n]


def _split_counts(n_flows, mix):
    w = np.asarray(mix, np.float64)
    exact = n_flows * w / w.sum()
    base = np.floor(exact).astype(int)
    order = np.argsort(-(exact - base))
    base[order[:n_flows - int(base.sum())]] += 1
    return int(base[0]), int(base[1]), int(base[2])


def spec(cfg: dict, tr: dict, seed: int) -> Scenario:
    """The two-DC fat tree of `cfg` under the pair workload of `tr`."""
    if tr["workload"] != "permutation":
        raise ValueError(f"fat-tree workload {tr['workload']!r}: the "
                         "generator has the permutation workload only")
    k, n_paths = int(cfg["k"]), int(cfg["n_paths"])
    rate = cfg["rate_gbps"] * 0.125
    intra_rtt, inter_rtt = cfg["intra_rtt_us"] * US, cfg["inter_rtt_ms"] * MS
    n_ip, n_cp, n_in = _split_counts(int(tr["n_flows"]), tr["mix"])
    oracle = FatTree(k, int(cfg["n_wan"]), rate, int(cfg["qcap_bytes"]),
                     intra_rtt, inter_rtt, max_paths=n_paths)
    links = tuple(LinkSpec(name, r, dl, float(q), wan=wan,
                           tier=_link_tier(name))
                  for name, r, dl, q, wan in oracle.links)
    picker = _PairPicker(oracle, seed)
    cache: dict = {}

    def path_set(src, dst):
        ps = cache.get((src, dst))
        if ps is None:
            ps = oracle.paths(src, dst)
            if len(ps) > n_paths:
                rng = random.Random(int((src * 131071 + dst)
                                        ^ (seed << 12) ^ 0x5A17))
                ps = tuple(rng.sample(ps, n_paths))
            cache[(src, dst)] = ps
        return ps

    groups = []
    for gname, n, fn, inter in (("intra_pod", n_ip, picker.intra_pod, False),
                                ("cross_pod", n_cp, picker.cross_pod, False),
                                ("inter", n_in, picker.inter, True)):
        if not n:
            continue
        sets = tuple(path_set(s, d) for s, d in fn(n))
        lb = lb_spec(cfg.get("inter_lb" if inter else "intra_lb"),
                 LbSpec(kind="unolb" if inter else "ecmp",
                        n_subflows=n_paths))
        groups.append(FlowGroup(gname, n, sets, inter=inter, lb=lb))
    return Scenario(
        name=f"fat_tree_k{k}_{tr['workload']}", links=links,
        groups=tuple(groups), rate=rate, intra_rtt=intra_rtt,
        inter_rtt=inter_rtt, phantom=bool(cfg["phantom"]),
        drain_frac=cfg["drain_frac"], cap_bdps=cfg["cap_bdps"],
        min_frac=cfg["min_frac"], max_frac=cfg["max_frac"],
        red_lo_frac=cfg["red_lo_frac"], red_hi_frac=cfg["red_hi_frac"],
        epoch_period_frac=cfg["epoch_period_frac"], seed=seed)
