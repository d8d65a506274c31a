"""Workload generators + flow factory + metrics (paper §5.1): the port's
copy of ``repro.netsim.workloads``, with the reference's CDFs.

Flow-size distributions:
  - WebSearch (DCTCP) for intra-DC traffic,
  - Alibaba regional-WAN (FlashPass) for inter-DC traffic,
  - Google-RPC-style small messages (fig 4's latency probes).
Piecewise-linear CDF approximations of the published curves (exact tables are
not public); means match the sources to within ~20%.

`spawn` wires a Flow to its CC (per scheme), router (per LB kind) and UnoRC
EC framing (inter-DC only, paper §4.2).
"""
from __future__ import annotations

import bisect
import math
import random
from typing import Optional

from repro_torch.core.baselines import make_cc
from repro_torch.netsim.protocol import Flow
from repro_torch.netsim.routing import make_router
from repro_torch.netsim.topology import KIB, MIB, Net

# (size_bytes, cum_prob) — piecewise-linear CDFs
WEBSEARCH_CDF = [
    (6 * KIB, 0.15), (13 * KIB, 0.30), (19 * KIB, 0.40), (33 * KIB, 0.53),
    (53 * KIB, 0.60), (133 * KIB, 0.70), (667 * KIB, 0.80),
    (1333 * KIB, 0.90), (3333 * KIB, 0.95), (6667 * KIB, 0.98),
    (20 * MIB, 1.00),
]
ALIBABA_WAN_CDF = [
    (50 * KIB, 0.10), (200 * KIB, 0.25), (1 * MIB, 0.45), (4 * MIB, 0.65),
    (16 * MIB, 0.80), (64 * MIB, 0.92), (128 * MIB, 0.97), (300 * MIB, 1.00),
]
GOOGLE_RPC_CDF = [
    (256, 0.40), (1 * KIB, 0.60), (4 * KIB, 0.80), (16 * KIB, 0.95),
    (64 * KIB, 1.00),
]


def sample_cdf(cdf, rng: random.Random) -> int:
    u = rng.random()
    probs = [p for _, p in cdf]
    i = bisect.bisect_left(probs, u)
    if i == 0:
        lo_s, lo_p = 0, 0.0
    else:
        lo_s, lo_p = cdf[i - 1]
    hi_s, hi_p = cdf[min(i, len(cdf) - 1)]
    if hi_p <= lo_p:
        return int(hi_s)
    frac = (u - lo_p) / (hi_p - lo_p)
    return max(1, int(lo_s + frac * (hi_s - lo_s)))


def cdf_mean(cdf) -> float:
    mean, lo_s, lo_p = 0.0, 0, 0.0
    for s, p in cdf:
        mean += (p - lo_p) * (lo_s + s) / 2.0
        lo_s, lo_p = s, p
    return mean


# ------------------------------------------------------------------ factory

def spawn(net: Net, src: int, dst: int, size: int, *, cc_scheme: str,
          lb: str = "ecmp", ec: Optional[tuple[int, int]] = None,
          start_t: float = 0.0, rng: Optional[random.Random] = None,
          n_subflows: int = 8, on_done=None, mtu: int = 4096,
          trace_rate: bool = False, cc_kw: Optional[dict] = None,
          router_salt: Optional[int] = None,
          nack_timeout: Optional[float] = None) -> Flow:
    """`router_salt` pins the router's hash/PRNG identity.  The default is
    the process-global Flow id, so ECMP/subflow choices differ between two
    otherwise-identical runs in one process; workload generators that
    promise seed-reproducibility pass an explicit per-flow salt instead.
    `nack_timeout` overrides the receiver's block-recovery timer (default
    max(rtt/4, 100us) — see protocol.Flow)."""
    paths = net.paths(src, dst)
    is_inter = net.is_inter(src, dst)
    bdp = net.bdp(src, dst)
    base_rtt = net.base_rtt(src, dst)
    cc = make_cc(cc_scheme, bdp=bdp, intra_bdp=net.intra_bdp,
                 intra_rtt=net.intra_rtt, is_inter=is_inter, mtu=mtu,
                 **(cc_kw or {}))
    router = make_router(
        lb, paths, Flow._next_id if router_salt is None else router_salt,
        rng=rng, base_rtt=base_rtt, n_subflows=n_subflows)
    f = Flow(net.sim, net, src, dst, size, cc, router, mtu=mtu,
             ec=ec if is_inter else None, start_t=start_t,
             base_rtt=base_rtt, on_done=on_done, is_inter=is_inter,
             nack_timeout=nack_timeout)
    if trace_rate:
        f.rate_trace = []
    return f


# ---------------------------------------------------------------- workloads

def incast(net: Net, *, n_intra: int, n_inter: int, size: int,
           cc_scheme: str, lb: str = "rps", ec=None, seed: int = 1,
           trace_rate: bool = True, cc_kw=None) -> list[Flow]:
    """n_intra local + n_inter remote senders -> one local receiver."""
    rng = random.Random(seed)
    dst = 0
    flows = []
    # local senders: same DC, different edges (so the fan-in is at the edge)
    local = [h for h in range(1, net.n_hosts // 2)]
    remote = [h for h in range(net.n_hosts // 2, net.n_hosts)]
    rng.shuffle(local)
    rng.shuffle(remote)
    for i in range(n_intra):
        flows.append(spawn(net, local[i], dst, size, cc_scheme=cc_scheme,
                           lb=lb, ec=ec, rng=rng, trace_rate=trace_rate,
                           cc_kw=cc_kw))
    for i in range(n_inter):
        flows.append(spawn(net, remote[i], dst, size, cc_scheme=cc_scheme,
                           lb=lb, ec=ec, rng=rng, trace_rate=trace_rate,
                           cc_kw=cc_kw))
    return flows


def permutation(net: Net, *, size: int, cc_scheme: str, lb: str,
                ec=None, seed: int = 1, n_hosts: Optional[int] = None,
                cc_kw=None) -> list[Flow]:
    """Each selected host sends to one random other host (src/dst distinct)."""
    rng = random.Random(seed)
    hosts = list(range(net.n_hosts))
    n = n_hosts or net.n_hosts
    srcs = rng.sample(hosts, n)
    dsts = srcs[:]
    while True:                      # derangement: nobody sends to itself
        rng.shuffle(dsts)
        if all(s != d for s, d in zip(srcs, dsts)):
            break
    return [spawn(net, s, d, size, cc_scheme=cc_scheme, lb=lb, ec=ec,
                  rng=rng, cc_kw=cc_kw) for s, d in zip(srcs, dsts)]


def poisson_mix(net: Net, *, load: float, n_flows: int, cc_scheme: str,
                lb: str, ec=None, seed: int = 1, inter_frac_bytes: float = 0.2,
                intra_cdf=WEBSEARCH_CDF, inter_cdf=ALIBABA_WAN_CDF,
                cc_kw=None) -> list[Flow]:
    """Mixed realistic workload: Poisson arrivals at `load` of aggregate host
    bandwidth; 4:1 intra:inter bytes (paper §5.1); uniform random src/dst.

    Fully reproducible from `seed`: arrivals, sizes, endpoints AND per-flow
    router identity (salted with the flow's index, not the process-global
    Flow id) — two calls with the same seed build identical workloads."""
    rng = random.Random(seed)
    m_i, m_e = cdf_mean(intra_cdf), cdf_mean(inter_cdf)
    byte_rate = load * net.n_hosts * net.rate          # offered bytes/ns
    lam_i = (1 - inter_frac_bytes) * byte_rate / m_i   # intra flows / ns
    lam_e = inter_frac_bytes * byte_rate / m_e
    lam = lam_i + lam_e
    p_inter = lam_e / lam
    half = net.n_hosts // 2
    flows = []
    t = 0.0
    for i in range(n_flows):
        t += rng.expovariate(lam)
        if rng.random() < p_inter:
            src = rng.randrange(net.n_hosts)
            dst_dc = 1 - (src // half)
            dst = rng.randrange(half) + dst_dc * half
            size = sample_cdf(inter_cdf, rng)
        else:
            src_dc = rng.randrange(2)
            src = rng.randrange(half) + src_dc * half
            dst = rng.randrange(half) + src_dc * half
            while dst == src:
                dst = rng.randrange(half) + src_dc * half
            size = sample_cdf(intra_cdf, rng)
        flows.append(spawn(net, src, dst, size, cc_scheme=cc_scheme, lb=lb,
                           ec=ec, start_t=t, rng=rng, cc_kw=cc_kw,
                           router_salt=(seed << 20) ^ i))
    return flows


def rpc_probes(net: Net, *, n: int, cc_scheme: str, lb: str = "ecmp",
               seed: int = 7, rate_per_ns: float = 2e-6, dst_pool=None,
               cc_kw=None) -> list[Flow]:
    """Small Google-RPC-style intra-DC messages (fig 4's latency victims)."""
    rng = random.Random(seed)
    half = net.n_hosts // 2
    flows = []
    t = 0.0
    for _ in range(n):
        t += rng.expovariate(rate_per_ns)
        src = rng.randrange(half)
        if dst_pool:
            dst = rng.choice(dst_pool)
        else:
            dst = rng.randrange(half)
        while dst == src:
            dst = rng.randrange(half)
        size = sample_cdf(GOOGLE_RPC_CDF, rng)
        flows.append(spawn(net, src, dst, size, cc_scheme=cc_scheme, lb=lb,
                           start_t=t, rng=rng, cc_kw=cc_kw))
    return flows


# ------------------------------------------------------------------ metrics

def fct_stats(flows) -> dict:
    """mean/p50/p99 FCT (ns) split intra/inter; unfinished flows counted."""
    out = {}
    for tag, sel in (("all", flows),
                     ("intra", [f for f in flows if not f.is_inter]),
                     ("inter", [f for f in flows if f.is_inter])):
        done = sorted(f.fct for f in sel if f.fct is not None)
        if not done:
            continue
        out[tag] = {
            "n": len(done), "unfinished": sum(1 for f in sel if f.fct is None),
            "mean": sum(done) / len(done),
            "p50": done[len(done) // 2],
            "p99": done[min(len(done) - 1, int(math.ceil(0.99 * len(done))) - 1)],
            "max": done[-1],
        }
    return out


def jain(values) -> float:
    vals = [v for v in values if v > 0]
    if not vals:
        return 0.0
    return sum(vals) ** 2 / (len(vals) * sum(v * v for v in vals))


def bin_rates(flows, bin_ns: float, until: float) -> dict:
    """Per-flow achieved rate curves from ack traces: {flow_id: [(t, Bps)]}."""
    out = {}
    n_bins = int(until / bin_ns) + 1
    for f in flows:
        if f.rate_trace is None:
            continue
        bins = [0.0] * n_bins
        for t, b in f.rate_trace:
            i = int(t / bin_ns)
            if i < n_bins:
                bins[i] += b
        out[f.id] = [(i * bin_ns, bins[i] / bin_ns) for i in range(n_bins)]
    return out


def mean_rate_gbps(trace_bins, t0, t1) -> float:
    sel = [r for (t, r) in trace_bins if t0 <= t < t1]
    return 8.0 * sum(sel) / max(len(sel), 1)   # bytes/ns -> Gbit/s
