"""Topologies: two 8-ary fat-tree DCs joined by border switches (paper §5.1),
plus a small dumbbell for controlled microbenchmarks: the port's copy of
``repro.netsim.topology``.  Its fat-tree path sampler is the port's only
one: the scenario specs (`repro_torch.scenarios.fat_tree`, `multi_dc`)
take their path sets from it, as the reference's do.

Per DC (k=8 fat-tree): 8 pods x (4 edge + 4 agg), 16 cores, 4 servers/edge
-> 128 servers.  Every core connects to the DC's border switch; the two
border switches are joined by eight WAN links (100 Gbps, ~1 ms one-way).
All links 100 Gbps, 1 MiB/port queues unless overridden.

Units: ns / bytes / bytes-per-ns (100 Gbps = 12.5 B/ns).

Uno runs attach phantom queues (drain 0.9x line rate) to every egress and
move ECN marking onto them; baseline runs use physical RED at 25/75 % of the
queue (paper §5.1 parameter table).
"""
from __future__ import annotations

import random
from typing import Optional

from repro_torch.netsim.engine import Link, Simulator
from repro_torch.netsim import protocol

GBPS = 0.125               # bytes per ns per Gbit/s
RATE_100G = 100 * GBPS     # 12.5 B/ns
US = 1_000.0
MS = 1_000_000.0
KIB = 1024
MIB = 1024 * 1024


class Net:
    """Holds the simulator, hosts (ints), directed links and path tables."""

    def __init__(self, sim: Simulator, n_hosts: int, intra_rtt: float,
                 inter_rtt: float, rate: float):
        self.sim = sim
        self.n_hosts = n_hosts
        self.intra_rtt = intra_rtt
        self.inter_rtt = inter_rtt
        self.rate = rate
        self.links: dict[str, Link] = {}
        self.wan_links: list[Link] = []
        self._path_cache: dict[tuple[int, int], list] = {}

    @property
    def intra_bdp(self) -> float:
        return self.rate * self.intra_rtt

    @property
    def inter_bdp(self) -> float:
        return self.rate * self.inter_rtt

    def bdp(self, src: int, dst: int) -> float:
        return self.inter_bdp if self.is_inter(src, dst) else self.intra_bdp

    def base_rtt(self, src: int, dst: int) -> float:
        return self.inter_rtt if self.is_inter(src, dst) else self.intra_rtt

    def is_inter(self, src: int, dst: int) -> bool:
        raise NotImplementedError

    def paths(self, src: int, dst: int) -> list:
        raise NotImplementedError

    def path_link_names(self, src: int, dst: int) -> tuple:
        """Path-set metadata: the (src, dst) paths as link-name tuples.

        This is the declarative view of a Net the scenario compiler
        (repro_torch.scenarios) consumes — a hand-built topology can be
        lifted into a Scenario path-set (and from there into the fleetsim
        route tensor) without touching Link objects.
        """
        return tuple(tuple(ln.name for ln in path)
                     for path in self.paths(src, dst))

    def link(self, name: str) -> Link:
        return self.links[name]

    def _mk_link(self, name: str, rate: float, pdelay: float, qcap: int) -> Link:
        ln = Link(self.sim, name, rate, pdelay, qcap, dst=protocol.forward)
        self.links[name] = ln
        return ln

    def attach_phantoms(self, drain_frac: float = 0.9,
                        cap_bdps: float = 1.0,
                        min_frac: float = 0.05, max_frac: float = 0.35,
                        inter_cap: Optional[float] = None,
                        intra_cap: Optional[float] = None) -> None:
        """Uno mode: ECN moves onto per-egress phantom queues.

        Virtual capacity matches the BDP of the longest flows crossing the
        link: WAN links get the inter-DC BDP, everything else the intra-DC
        BDP (paper §4.1.3: "arbitrary sizes ... to match the high BDPs").
        """
        icap = inter_cap if inter_cap is not None else cap_bdps * self.inter_bdp
        dcap = intra_cap if intra_cap is not None else cap_bdps * self.intra_bdp
        wan = set(id(l) for l in self.wan_links)
        for ln in self.links.values():
            cap = icap if id(ln) in wan else dcap
            ln.attach_phantom(drain_frac, cap, min_frac, max_frac)


# ------------------------------------------------------------------ dumbbell

class Dumbbell(Net):
    """N senders -> 1 bottleneck -> 1 receiver-side link -> M receivers.

    Hosts 0..n_left-1 are in the "local" DC; hosts n_left.. are remote
    (reached through a WAN hop).  Used for the fig-3/4-style incast
    microbenchmarks where the paper also uses a simplified model.
    """

    def __init__(self, n_left: int = 8, n_right: int = 1,
                 rate: float = RATE_100G, qcap: int = 1 * MIB,
                 intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                 seed: int = 0, n_wan: int = 8):
        sim = Simulator(seed)
        super().__init__(sim, n_left + n_right, intra_rtt, inter_rtt, rate)
        self.n_left = n_left
        # per-link delay chosen so host->host round trips hit the targets:
        # intra path = up + bottleneck down (2 links each way, ACK direct)
        d_inb = intra_rtt / 8.0
        self.up = [self._mk_link(f"up{i}", rate, d_inb, qcap)
                   for i in range(n_left)]
        self.down = [self._mk_link(f"down{j}", rate, d_inb, qcap)
                     for j in range(n_right)]
        # WAN hop for "remote" sources: n_wan parallel border links (as in
        # the paper's topology) -> remote senders are multipathed
        wan_delay = (inter_rtt - intra_rtt) / 2.0
        self.wan = [self._mk_link(f"wan{w}", rate, wan_delay, qcap)
                    for w in range(n_wan)]
        self.wan_links = list(self.wan)

    def is_inter(self, src: int, dst: int) -> bool:
        return (src >= self.n_left) != (dst >= self.n_left)

    def paths(self, src: int, dst: int) -> list:
        dj = dst - self.n_left if dst >= self.n_left else dst
        down = self.down[dj % len(self.down)]
        if src < self.n_left:
            return [(self.up[src % self.n_left], down)]
        return [(w, down) for w in self.wan]


# ----------------------------------------------------------------- fat-tree

def wan_mesh_pairs(n_dc: int, mesh: str) -> tuple:
    """Unordered DC pairs joined by a WAN link group under `mesh`.

    ring      — i <-> i+1 around the circle (for n_dc <= 3 this equals full)
    full      — every pair
    hubspoke  — DC 0 is the hub; every spoke attaches only to it
    """
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


class MultiDCFatTree(Net):
    """`n_dc` k-ary fat-trees, each behind a dedicated DCI (border) switch,
    joined by a WAN mesh of `n_wan`-link groups per connected DC pair.

    The DCI tier is the per-DC border switch plus its core-attach links;
    `oversub` divides the attach-link rate (oversub=1.0 keeps attach links
    at line rate, matching the historical two-DC topology bit-for-bit).
    WAN meshes: "full" (every pair), "ring" (i <-> i+1), "hubspoke"
    (DC 0 relays for all spokes).  Non-adjacent traffic transits
    intermediate border switches WAN-hop by WAN-hop without re-entering
    the intermediate DC's core.
    """

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
        sim = Simulator(seed)
        super().__init__(sim, n_dc * self.hosts_per_dc,
                         intra_rtt, inter_rtt, rate)
        self.n_dc = n_dc
        self.mesh = mesh
        self.oversub = oversub
        self.max_paths = max_paths
        self.wan_pairs = wan_mesh_pairs(n_dc, mesh)
        self._adj = {a: set() for a in range(n_dc)}
        for a, b in self.wan_pairs:
            self._adj[a].add(b)
            self._adj[b].add(a)
        self._prng = random.Random(seed ^ 0xDEADBEEF)

        # Per-hop propagation so the server-server RTT lands on intra_rtt:
        # cross-pod data path = 6 links one way; ACK returns by pure delay.
        # 6*d (data) + 6*d (ack) + serialization ~= intra_rtt.
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

    def dc_of(self, hid: int) -> int:
        return hid // self.hosts_per_dc

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

    # ------------------------------------------------------------- paths

    def paths(self, src: int, dst: int) -> list:
        key = (src, dst)
        hit = self._path_cache.get(key)
        if hit is not None:
            return hit
        p = self._build_paths(src, dst)
        if len(self._path_cache) < 200_000:
            self._path_cache[key] = p
        return p

    def _build_paths(self, src: int, dst: int) -> list:
        half = self.k // 2
        sdc, spod, sedge, _ = self.host_loc(src)
        ddc, dpod, dedge, _ = self.host_loc(dst)
        ln = self.links
        up0 = ln[f"h{src}->e"]
        down_last = ln[f"e->h{dst}"]
        out = []
        if sdc == ddc and spod == dpod and sedge == dedge:
            return [(up0, down_last)]
        if sdc == ddc and spod == dpod:
            for a in range(half):
                out.append((up0, ln[f"d{sdc}p{spod}e{sedge}->a{a}"],
                            ln[f"d{sdc}p{spod}a{a}->e{dedge}"], down_last))
            return out
        if sdc == ddc:
            for a in range(half):
                for c in range(half):
                    ci = a * half + c
                    out.append((
                        up0,
                        ln[f"d{sdc}p{spod}e{sedge}->a{a}"],
                        ln[f"d{sdc}p{spod}a{a}->c{ci}"],
                        ln[f"d{sdc}c{ci}->p{dpod}a{a}"],
                        ln[f"d{sdc}p{dpod}a{a}->e{dedge}"],
                        down_last))
            return out
        # cross-DC: up-core (half^2) x WAN link per hop (n_wan each) x
        # down-core (half^2) — sample max_paths combo INDICES directly
        # (materializing + shuffling all half^4 * n_wan^hops tuples per host
        # pair made 100k-flow fat-tree scenario builds take minutes)
        hops = self.wan_route(sdc, ddc)
        # int(): scenario pools hold numpy integers, which random.Random
        # refuses as a seed on Python 3.12 (the reference raises here)
        rng = random.Random(int((src * 131071 + dst) ^ 0xABCDEF))
        total = half * half * half * half * self.n_wan ** len(hops)
        picks = rng.sample(range(total), min(self.max_paths, total))
        for idx in picks:
            idx, c2 = divmod(idx, half)
            idx, a2 = divmod(idx, half)
            wan_legs = []
            for ha, hb in hops:
                idx, w = divmod(idx, self.n_wan)
                wan_legs.append(ln[f"B{ha}->B{hb}.{w}"])
            a, c = divmod(idx, half)
            ci = a * half + c
            ci2 = a2 * half + c2
            out.append((
                up0,
                ln[f"d{sdc}p{spod}e{sedge}->a{a}"],
                ln[f"d{sdc}p{spod}a{a}->c{ci}"],
                ln[f"d{sdc}c{ci}->B"],
                *wan_legs,
                ln[f"d{ddc}B->c{ci2}"],
                ln[f"d{ddc}c{ci2}->p{dpod}a{a2}"],
                ln[f"d{ddc}p{dpod}a{a2}->e{dedge}"],
                down_last))
        return out


class TwoDCFatTree(MultiDCFatTree):
    """Two k-ary fat-trees joined by 2 border switches x `n_wan` links.

    Thin specialization of :class:`MultiDCFatTree` (n_dc=2, full mesh,
    no oversubscription) kept for the historical name; link names and
    creation order are bit-identical to the original two-DC topology.
    """

    def __init__(self, k: int = 8, n_wan: int = 8, rate: float = RATE_100G,
                 qcap: int = 1 * MIB, wan_qcap: Optional[int] = None,
                 intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                 seed: int = 0, max_paths: int = 24,
                 wan_rate: Optional[float] = None):
        super().__init__(k=k, n_dc=2, mesh="full", oversub=1.0, n_wan=n_wan,
                         rate=rate, qcap=qcap, wan_qcap=wan_qcap,
                         intra_rtt=intra_rtt, inter_rtt=inter_rtt, seed=seed,
                         max_paths=max_paths, wan_rate=wan_rate)


# --------------------------------------------------------------- loss models

class GilbertElliott:
    """Two-state correlated loss (fits the paper's Table 1 measurements).

    Good state: loss p_good (rare isolated drops).  Bad state: loss p_bad
    (bursty, link-correlated).  Transition per packet.  Fitted so overall
    loss rate ~= `rate` and multi-loss-per-10-packet-block probabilities
    reproduce Table 1's correlated-drop pattern.
    """

    def __init__(self, rng, loss_rate: float = 5.01e-5, burst: float = 0.25,
                 mean_burst_len: float = 3.0):
        self.rng = rng
        self.p_bad = burst
        self.p_gb = loss_rate / max(burst * mean_burst_len, 1e-12)  # enter bad
        self.p_bg = 1.0 / mean_burst_len                            # leave bad
        self.bad = False

    def __call__(self, pkt, now) -> bool:
        r = self.rng.random()
        if self.bad:
            if r < self.p_bg:
                self.bad = False
            return self.rng.random() < self.p_bad
        if r < self.p_gb:
            self.bad = True
            return self.rng.random() < self.p_bad
        return False


def fail_link(link: Link) -> None:
    link.failed = True


def repair_link(link: Link) -> None:
    link.failed = False
