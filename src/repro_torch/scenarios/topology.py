"""Fat-tree path oracle: link naming and ECMP path-sets of the paper's
multi-DC fat tree (§5.1), with no packet simulator behind it.

The port's own copy of the path-building half of
``repro.netsim.topology``.  Links are plain name -> `LinkRec` records in
creation order, and paths are tuples of link names.  Link creation order
and the per-pair ``random.Random((src*131071+dst) ^ 0xABCDEF)`` sampling of
cross-DC paths are the reference's, so link ids and paths are identical.

Units: ns / bytes / bytes-per-ns (100 Gbps = 12.5 B/ns).
"""
from __future__ import annotations

import random
from typing import NamedTuple, Optional

GBPS = 0.125               # bytes per ns per Gbit/s
RATE_100G = 100 * GBPS     # 12.5 B/ns
US = 1_000.0
MS = 1_000_000.0
MIB = 1024 * 1024


class LinkRec(NamedTuple):
    """One directed link of the oracle: service rate, propagation, queue."""
    name: str
    rate: float
    pdelay: float
    qcap: int


def wan_mesh_pairs(n_dc: int, mesh: str) -> tuple:
    """Unordered DC pairs joined by a WAN link group under `mesh`
    ("ring", "full" or "hubspoke" with DC 0 as the hub)."""
    if n_dc < 2:
        raise ValueError("need at least two datacenters")
    if mesh == "full":
        return tuple((a, b) for a in range(n_dc) for b in range(a + 1, n_dc))
    if mesh == "ring":
        if n_dc == 2:
            return ((0, 1),)
        return tuple(sorted(tuple(sorted((i, (i + 1) % n_dc)))
                            for i in range(n_dc)))
    if mesh == "hubspoke":
        return tuple((0, b) for b in range(1, n_dc))
    raise ValueError(f"unknown WAN mesh {mesh!r}")


class MultiDCFatTree:
    """`n_dc` k-ary fat-trees, each behind a border switch, joined by a WAN
    mesh of `n_wan`-link groups per connected DC pair.  `oversub` divides
    the core<->border attach rate."""

    def __init__(self, k: int = 8, n_dc: int = 2, mesh: str = "full",
                 oversub: float = 1.0, n_wan: int = 8,
                 rate: float = RATE_100G,
                 qcap: int = 1 * MIB, wan_qcap: Optional[int] = None,
                 intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                 seed: int = 0, max_paths: int = 24,
                 wan_rate: Optional[float] = None):
        self.k = k
        half = k // 2
        self.hosts_per_dc = k * half * half          # k=8: 8*4*4 = 128
        if oversub < 1.0:
            raise ValueError("oversub must be >= 1.0")
        self.n_hosts = n_dc * self.hosts_per_dc
        self.intra_rtt = intra_rtt
        self.inter_rtt = inter_rtt
        self.rate = rate
        self.n_dc = n_dc
        self.mesh = mesh
        self.oversub = oversub
        self.max_paths = max_paths
        self.seed = seed
        self.links: dict[str, LinkRec] = {}
        self.wan_links: list[LinkRec] = []
        self.wan_pairs = wan_mesh_pairs(n_dc, mesh)
        self._adj = {a: set() for a in range(n_dc)}
        for a, b in self.wan_pairs:
            self._adj[a].add(b)
            self._adj[b].add(a)

        d = intra_rtt / 14.0
        wan_d = (inter_rtt - intra_rtt) / 2.0        # one-way WAN propagation
        wq = wan_qcap if wan_qcap is not None else qcap
        wr = wan_rate if wan_rate is not None else rate
        attach_rate = rate / oversub                 # DCI tier oversubscription

        L = self._mk_link
        for dc in range(n_dc):
            for p in range(k):
                for e in range(half):
                    for h in range(half):
                        hid = self.host_id(dc, p, e, h)
                        L(f"h{hid}->e", rate, d, qcap)
                        L(f"e->h{hid}", rate, d, qcap)
                    for a in range(half):
                        L(f"d{dc}p{p}e{e}->a{a}", rate, d, qcap)
                        L(f"d{dc}p{p}a{a}->e{e}", rate, d, qcap)
                for a in range(half):
                    for c in range(half):       # agg a -> cores a*half+c
                        ci = a * half + c
                        L(f"d{dc}p{p}a{a}->c{ci}", rate, d, qcap)
                        L(f"d{dc}c{ci}->p{p}a{a}", rate, d, qcap)
            for ci in range(half * half):
                L(f"d{dc}c{ci}->B", attach_rate, d, qcap)
                L(f"d{dc}B->c{ci}", attach_rate, d, qcap)
        for pa, pb in self.wan_pairs:
            for w in range(n_wan):
                a = L(f"B{pa}->B{pb}.{w}", wr, wan_d, wq)
                b = L(f"B{pb}->B{pa}.{w}", wr, wan_d, wq)
                self.wan_links += [a, b]
        self.n_wan = n_wan

    def _mk_link(self, name: str, rate: float, pdelay: float,
                 qcap: int) -> LinkRec:
        rec = LinkRec(name, rate, pdelay, qcap)
        self.links[name] = rec
        return rec

    # host ids: dc*hosts_per_dc + pod*(k/2)^2 + edge*(k/2) + h
    def host_id(self, dc, pod, edge, h) -> int:
        half = self.k // 2
        return dc * self.hosts_per_dc + pod * half * half + edge * half + h

    def host_loc(self, hid: int):
        half = self.k // 2
        dc, r = divmod(hid, self.hosts_per_dc)
        pod, r = divmod(r, half * half)
        edge, h = divmod(r, half)
        return dc, pod, edge, h

    def is_inter(self, src, dst) -> bool:
        return (src // self.hosts_per_dc) != (dst // self.hosts_per_dc)

    def wan_route(self, sdc: int, ddc: int) -> list:
        """Ordered border-to-border hops from `sdc` to `ddc`."""
        if ddc in self._adj[sdc]:
            return [(sdc, ddc)]
        if self.mesh == "hubspoke":
            return [(sdc, 0), (0, ddc)]
        # ring: walk the shorter way round; ties break clockwise
        n = self.n_dc
        fwd = (ddc - sdc) % n
        step = 1 if fwd <= n - fwd else -1
        route, cur = [], sdc
        while cur != ddc:
            nxt = (cur + step) % n
            route.append((cur, nxt))
            cur = nxt
        return route

    def path_link_names(self, src: int, dst: int) -> tuple:
        """The (src, dst) ECMP path-set as link-name tuples."""
        return tuple(tuple(path) for path in self._build_paths(src, dst))

    def _build_paths(self, src: int, dst: int) -> list:
        half = self.k // 2
        sdc, spod, sedge, _ = self.host_loc(src)
        ddc, dpod, dedge, _ = self.host_loc(dst)
        up0 = f"h{src}->e"
        down_last = f"e->h{dst}"
        out = []
        if sdc == ddc and spod == dpod and sedge == dedge:
            return [(up0, down_last)]
        if sdc == ddc and spod == dpod:
            for a in range(half):
                out.append((up0, f"d{sdc}p{spod}e{sedge}->a{a}",
                            f"d{sdc}p{spod}a{a}->e{dedge}", down_last))
            return out
        if sdc == ddc:
            for a in range(half):
                for c in range(half):
                    ci = a * half + c
                    out.append((
                        up0,
                        f"d{sdc}p{spod}e{sedge}->a{a}",
                        f"d{sdc}p{spod}a{a}->c{ci}",
                        f"d{sdc}c{ci}->p{dpod}a{a}",
                        f"d{sdc}p{dpod}a{a}->e{dedge}",
                        down_last))
            return out
        # cross-DC: up-core (half^2) x WAN link per hop (n_wan each) x
        # down-core (half^2) — sample max_paths combo INDICES directly
        hops = self.wan_route(sdc, ddc)
        rng = random.Random(int((src * 131071 + dst) ^ 0xABCDEF))  # numpy ints
        total = half * half * half * half * self.n_wan ** len(hops)
        picks = rng.sample(range(total), min(self.max_paths, total))
        for idx in picks:
            idx, c2 = divmod(idx, half)
            idx, a2 = divmod(idx, half)
            wan_legs = []
            for ha, hb in hops:
                idx, w = divmod(idx, self.n_wan)
                wan_legs.append(f"B{ha}->B{hb}.{w}")
            a, c = divmod(idx, half)
            ci = a * half + c
            ci2 = a2 * half + c2
            out.append((
                up0,
                f"d{sdc}p{spod}e{sedge}->a{a}",
                f"d{sdc}p{spod}a{a}->c{ci}",
                f"d{sdc}c{ci}->B",
                *wan_legs,
                f"d{ddc}B->c{ci2}",
                f"d{ddc}c{ci2}->p{dpod}a{a2}",
                f"d{ddc}p{dpod}a{a2}->e{dedge}",
                down_last))
        return out


class TwoDCFatTree(MultiDCFatTree):
    """Two k-ary fat-trees joined by 2 border switches x `n_wan` links
    (`MultiDCFatTree` with n_dc=2, full mesh, no oversubscription)."""

    def __init__(self, k: int = 8, n_wan: int = 8, rate: float = RATE_100G,
                 qcap: int = 1 * MIB, wan_qcap: Optional[int] = None,
                 intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                 seed: int = 0, max_paths: int = 24,
                 wan_rate: Optional[float] = None):
        super().__init__(k=k, n_dc=2, mesh="full", oversub=1.0, n_wan=n_wan,
                         rate=rate, qcap=qcap, wan_qcap=wan_qcap,
                         intra_rtt=intra_rtt, inter_rtt=inter_rtt, seed=seed,
                         max_paths=max_paths, wan_rate=wan_rate)
