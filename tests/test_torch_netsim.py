"""The port's packet simulator (`repro_torch.netsim`) and its baseline
controllers (`repro_torch.core.baselines`) against the reference's
(`repro.netsim`, `repro.core.baselines`) on the same inputs.

Every comparison is exact (`==`): the port keeps the reference's Python
floats, its order of arithmetic, of heap pushes and of random draws, so a
run gives the same event trace, rate traces, FCTs and counters.  Covered:

  * the engine: a scripted bursty packet trace through one `Link`, with
    and without a phantom queue, with random loss and a failed window
    (departures, marks, drops, the queue trace);
  * each router: a scripted event stream of sends, ACKs, ECN samples and
    NACK / timeouts (the path sequence, UnoLB's subflow paths and its
    suspect set);
  * each baseline controller and UnoCC through `make_cc`: a replayed
    on_ack / on_loss_signal trace, the state compared field by field;
  * whole runs on a `Dumbbell`: every `make_cc` scheme x every router, EC
    on and off, a lossy WAN, 5 ms (every flow's `rate_trace`, `fct`,
    `n_sent`, `n_retx`; `sim.dropped`, `sim.delivered`, the final
    `sim.now`);
  * the workloads (`incast`, `permutation`, `poisson_mix`, `rpc_probes`)
    with `fct_stats`, `jain` and `bin_rates` on their results;
  * the reference's own netsim behaviours (tests/test_netsim.py) rerun on
    the port, each with the reference's assertions and its result equal
    to the reference's.

`Flow._next_id` (the process-wide flow counter that salts the default
router identity) is zeroed in both packages before each test.
"""
import dataclasses
import random

import numpy as np
import pytest

from repro.core import baselines as RB
from repro.netsim import engine as RE
from repro.netsim import protocol as RP
from repro.netsim import routing as RR
from repro.netsim import topology as RT
from repro.netsim import workloads as RW

from repro_torch.core import baselines as TB
from repro_torch.netsim import engine as TE
from repro_torch.netsim import protocol as TP
from repro_torch.netsim import routing as TR
from repro_torch.netsim import topology as TT
from repro_torch.netsim import workloads as TW

KIB, MIB, MS, US = TT.KIB, TT.MIB, TT.MS, TT.US


@dataclasses.dataclass(frozen=True)
class Pkg:
    E: object
    P: object
    R: object
    T: object
    W: object
    B: object


REF = Pkg(RE, RP, RR, RT, RW, RB)
PORT = Pkg(TE, TP, TR, TT, TW, TB)


@pytest.fixture(autouse=True)
def _flow_ids(monkeypatch):
    monkeypatch.setattr(RP.Flow, "_next_id", 0)
    monkeypatch.setattr(TP.Flow, "_next_id", 0)


def _flows(flows):
    return [(f.id, f.src, f.dst, f.size, f.rate_trace, f.fct, f.n_sent,
             f.n_retx, f.done) for f in flows]


def _sim(sim):
    return sim.now, sim.dropped, sim.delivered, sim._seq


def _links(net):
    return [(n, l.drops, l.marks, l.forwarded, l.busy_until)
            for n, l in net.links.items()]


# ---------------------------------------------------------------- engine

class _Pkt:
    __slots__ = ("id", "size", "ecn", "flow")

    def __init__(self, i, size):
        self.id, self.size, self.ecn, self.flow = i, size, False, None


def _link_trace(pkg, phantom, seed):
    """600 packets (sizes 64 / 1,500 / 4,096 B) in bursts of up to 30 at
    one instant through one link (64 KiB queue); random loss of 1 % and
    the link failed over [40, 45) us."""
    sim = pkg.E.Simulator(seed)
    out = []
    ln = pkg.E.Link(sim, "l0", 12.5, 1_000.0, 64 * KIB,
                    dst=lambda p: out.append((sim.now, p.id, p.ecn)))
    if phantom:
        ln.attach_phantom(0.9, 48 * KIB, 0.1, 0.5)
    ln.qocc_trace = []
    lrng = random.Random(seed + 1)
    ln.loss_fn = lambda pkt, now: lrng.random() < 0.01
    sim.at(40_000.0, setattr, ln, "failed", True)
    sim.at(45_000.0, setattr, ln, "failed", False)
    g = np.random.default_rng(seed)
    t, i = 0.0, 0
    while i < 600:
        t += float(g.exponential(400.0))
        burst = int(g.integers(1, 31)) if g.random() < 0.1 else 1
        for _ in range(burst):
            sim.at(t, ln.enqueue, _Pkt(i, int(g.choice([64, 1500, 4096]))),
                   t)
            i += 1
    sim.run()
    return (out, ln.drops, ln.marks, ln.forwarded, ln.qocc_trace,
            _sim(sim), ln.qocc(sim.now))


@pytest.mark.parametrize("phantom", [False, True])
def test_link_trace_matches_reference(phantom):
    ref, port = _link_trace(REF, phantom, 3), _link_trace(PORT, phantom, 3)
    assert port == ref
    out, drops, marks = port[:3]
    assert len(out) + drops == 600 and drops > 20 and marks > 20


def test_phantom_queue_matches_reference():
    qs = [pkg.E.PhantomQueue(drain_rate=11.25, cap=40_000.0)
          for pkg in (REF, PORT)]
    g = np.random.default_rng(0)
    t, trace = 0.0, ([], [])
    for _ in range(500):
        t += float(g.exponential(300.0))
        size = int(g.integers(64, 4097))
        for q, tr in zip(qs, trace):
            q.push(t, size)
            tr.append((q.occ, q.last))
    assert trace[0] == trace[1]


# ---------------------------------------------------------------- routers

def test_fmix32_matches_reference():
    xs = list(range(-5, 2000)) + [2 ** 32 - 1, 2 ** 40 + 7, 0x9E3779B9]
    assert [TR.fmix32(x) for x in xs] == [RR.fmix32(x) for x in xs]


def _router_trace(pkg, kind, with_rng):
    """A router over 12 paths through a seeded stream of 600 events:
    sends (the path index and subflow), ACKs on the last subflow, ECN
    samples (PLB's hook) and NACK / timeouts, with UnoLB's subflow paths,
    suspect set and reroute count after each NACK."""
    paths = [tuple(f"p{i}h{j}" for j in range(3)) for i in range(12)]
    index = {id(p): i for i, p in enumerate(paths)}
    rng = random.Random(11) if with_rng else None
    r = pkg.R.make_router(kind, paths, 5, rng=rng, base_rtt=2_000.0,
                          n_subflows=4)
    g = np.random.default_rng(7)
    now, sub, out = 0.0, 0, []
    hook = getattr(r, "on_ecn_sample", None)
    for _ in range(600):
        now += float(g.exponential(400.0))
        u = g.random()
        if u < 0.55:
            path, sub = r.path_for(0, 0)
            out.append(("send", paths.index(path), sub))
        elif u < 0.8:
            r.on_ack(sub, now)
            if hook is not None:
                hook(bool(g.random() < 0.6), now)
        else:
            r.on_nack_or_timeout(now)
            if kind == "unolb":
                out.append(("nack", [paths.index(p) for p in r.sub_paths],
                            sorted(index[s] for s in r.suspect),
                            r.n_reroutes))
    return out


@pytest.mark.parametrize("with_rng", [False, True])
@pytest.mark.parametrize("kind", ["ecmp", "rps", "plb", "unolb"])
def test_router_trace_matches_reference(kind, with_rng):
    ref = _router_trace(REF, kind, with_rng)
    port = _router_trace(PORT, kind, with_rng)
    assert port == ref
    if kind == "unolb":
        nacks = [o for o in port if o[0] == "nack"]
        assert nacks[-1][3] > 5 and any(o[2] for o in nacks)
    if kind in ("rps", "plb", "unolb"):
        assert len({o[1] for o in port if o[0] == "send"}) > 1


def test_make_router_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown router"):
        TR.make_router("spray", [("a",)], 0)


# ---------------------------------------------------------------- controllers

def _state(cc):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else
                list(v) if isinstance(v, list) else v)
            for k, v in vars(cc).items()}


def _cc_trace(pkg, scheme, is_inter):
    """`make_cc` for a 100 Gbps flow (2 ms inter / 14 us intra RTT) fed
    2,000 ACKs of 4 KiB with queueing-delay noise and ECN in congested
    spells, a loss signal every 150 ACKs and, where the controller has
    one, the QA tick every 40; the state after every event."""
    rtt = 2 * MS if is_inter else 14 * US
    cc = pkg.B.make_cc(scheme, bdp=12.5 * rtt, intra_bdp=12.5 * 14 * US,
                       intra_rtt=14 * US, is_inter=is_inter)
    g = np.random.default_rng(5)
    now, out = 0.0, []
    for i in range(2_000):
        now += float(g.exponential(330.0))
        congested = (i // 200) % 2 == 1
        sample = rtt * (1.0 + float(g.exponential(0.4 if congested
                                                  else 0.05)))
        ecn = bool(g.random() < (0.5 if congested else 0.02))
        cc.on_ack(4096, ecn, sample, now - sample, now)
        out.append(_state(cc))
        if i % 150 == 149:
            cc.on_loss_signal(now)
            out.append(_state(cc))
        if i % 40 == 39 and hasattr(cc, "on_qa_tick"):
            out.append(cc.on_qa_tick(now, float(g.uniform(0, 2 * cc.cwnd))))
            out.append(_state(cc))
    return type(cc).__name__, out


@pytest.mark.parametrize("is_inter", [False, True])
@pytest.mark.parametrize("scheme", ["uno", "gemini", "mprdma+bbr",
                                    "mprdma", "bbr"])
def test_controller_trace_matches_reference(scheme, is_inter):
    ref = _cc_trace(REF, scheme, is_inter)
    port = _cc_trace(PORT, scheme, is_inter)
    assert port == ref
    states = [s for s in port[1] if isinstance(s, dict)]
    assert len({s["cwnd"] for s in states}) > 10


def test_make_cc_rejects_unknown_scheme():
    with pytest.raises(ValueError, match="unknown CC scheme"):
        TB.make_cc("cubic", bdp=1.0, intra_bdp=1.0, intra_rtt=1.0,
                   is_inter=False)


# ---------------------------------------------------------------- dumbbell

def _dumbbell_run(pkg, scheme, lb, ec):
    """Two intra and two inter senders (1 ms inter RTT, 4 WAN links, 1 %
    random loss on each) into host 0, 5 ms."""
    net = pkg.T.Dumbbell(n_left=4, n_right=1, inter_rtt=1 * MS, n_wan=4,
                         seed=3)
    if scheme == "uno":
        net.attach_phantoms()
    lrng = random.Random(17)
    for ln in net.wan_links:
        ln.loss_fn = lambda pkt, now, r=lrng: r.random() < 0.01
    rng = random.Random(5)
    flows = [pkg.W.spawn(net, src, 0, size, cc_scheme=scheme, lb=lb, ec=ec,
                         rng=rng, trace_rate=True, start_t=t)
             for src, size, t in ((1, 256 * KIB, 0.0), (2, 4 * MIB, 10e3),
                                  (4, 1 * MIB, 0.0), (5, 8 * MIB, 50e3))]
    net.sim.run(until=5 * MS)
    return _flows(flows), _sim(net.sim), _links(net)


@pytest.mark.parametrize("ec", [None, (8, 2)], ids=["no_ec", "ec"])
@pytest.mark.parametrize("lb", ["ecmp", "rps", "plb", "unolb"])
@pytest.mark.parametrize("scheme", ["uno", "gemini", "mprdma+bbr",
                                    "mprdma", "bbr"])
def test_dumbbell_run_matches_reference(scheme, lb, ec):
    ref = _dumbbell_run(REF, scheme, lb, ec)
    port = _dumbbell_run(PORT, scheme, lb, ec)
    assert port == ref
    flows, (now, dropped, delivered, _), _ = port
    assert 0 < now <= 5 * MS and delivered > 500
    assert any(f[5] is not None for f in flows)   # the short flow finishes


# ---------------------------------------------------------------- workloads

def _metrics(pkg, flows, until):
    W = pkg.W
    return (W.fct_stats(flows), W.jain([f.n_sent for f in flows]),
            W.bin_rates(flows, 0.5 * MS, until))


def _incast(pkg):
    net = pkg.T.TwoDCFatTree(k=4, n_wan=2, seed=2)
    net.attach_phantoms()
    flows = pkg.W.incast(net, n_intra=3, n_inter=3, size=256 * KIB,
                         cc_scheme="uno", lb="unolb", ec=(8, 2), seed=2)
    net.sim.run(until=6 * MS)
    return flows, net, 6 * MS


def _permutation(pkg):
    net = pkg.T.TwoDCFatTree(k=4, n_wan=2, seed=4)
    flows = pkg.W.permutation(net, size=128 * KIB, cc_scheme="mprdma+bbr",
                              lb="rps", seed=4, n_hosts=10)
    for f in flows:
        f.rate_trace = []
    net.sim.run(until=4 * MS)
    return flows, net, 4 * MS


def _poisson_mix(pkg):
    net = pkg.T.TwoDCFatTree(k=4, n_wan=2, seed=6)
    net.attach_phantoms()
    flows = pkg.W.poisson_mix(net, load=0.3, n_flows=25, cc_scheme="uno",
                              lb="plb", ec=(8, 2), seed=6)
    for f in flows:
        f.rate_trace = []
    net.sim.run(until=5 * MS)
    return flows, net, 5 * MS


def _rpc_probes(pkg):
    net = pkg.T.TwoDCFatTree(k=4, n_wan=2, seed=8)
    flows = pkg.W.rpc_probes(net, n=12, cc_scheme="gemini", lb="ecmp",
                             seed=8, rate_per_ns=2e-5, dst_pool=[0, 3, 5])
    for f in flows:
        f.rate_trace = []
    net.sim.run(until=3 * MS)
    return flows, net, 3 * MS


WORKLOADS = {"incast": _incast, "permutation": _permutation,
             "poisson_mix": _poisson_mix, "rpc_probes": _rpc_probes}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_matches_reference(name):
    out = {}
    for tag, pkg in (("ref", REF), ("port", PORT)):
        flows, net, until = WORKLOADS[name](pkg)
        out[tag] = (_flows(flows), _sim(net.sim),
                    _metrics(pkg, flows, until))
    assert out["port"] == out["ref"]
    stats = out["port"][2][0]
    assert stats["all"]["n"] >= 1


def test_cdfs_and_sampling_match_reference():
    for name in ("WEBSEARCH_CDF", "ALIBABA_WAN_CDF", "GOOGLE_RPC_CDF"):
        cdf = getattr(TW, name)
        assert cdf == getattr(RW, name)
        assert TW.cdf_mean(cdf) == RW.cdf_mean(cdf)
        a, b = random.Random(1), random.Random(1)
        assert [TW.sample_cdf(cdf, a) for _ in range(3000)] == \
            [RW.sample_cdf(cdf, b) for _ in range(3000)]
    trace = [(t * 1e3, 1.5) for t in range(100)]
    assert TW.mean_rate_gbps(trace, 10e3, 50e3) == \
        RW.mean_rate_gbps(trace, 10e3, 50e3)
    assert TW.jain([0.0, 1.0, 3.0]) == RW.jain([0.0, 1.0, 3.0])
    assert TW.jain([]) == 0.0


# ------------------------------------------ the reference's behaviours

def _net(pkg, **kw):
    net = pkg.T.Dumbbell(n_left=8, n_right=1, **kw)
    net.attach_phantoms()
    return net


def _b_single_flow_completes_at_line_rate(pkg):
    net = _net(pkg)
    f = pkg.W.spawn(net, 1, 0, 8 * MIB, cc_scheme="uno", lb="ecmp",
                    rng=random.Random(0))
    net.sim.run(until=200 * MS)
    assert f.fct is not None
    ideal = 8 * MIB / net.rate + net.intra_rtt
    assert f.fct < 2.0 * ideal, (f.fct, ideal)
    return f.fct, _sim(net.sim)


def _b_packet_conservation(pkg):
    net = _net(pkg)
    rng = random.Random(1)
    flows = [pkg.W.spawn(net, i, 0, 4 * MIB, cc_scheme="uno", lb="ecmp",
                         rng=rng) for i in range(1, 6)]
    net.sim.run(until=400 * MS)
    sent = sum(f.n_sent for f in flows)
    assert net.sim.delivered + net.sim.dropped == sent
    assert all(f.fct is not None for f in flows)
    return _flows(flows), _sim(net.sim)


def _b_receiver_gets_every_byte_exactly_once(pkg):
    net = _net(pkg)
    f = pkg.W.spawn(net, 2, 0, 3 * MIB + 777, cc_scheme="uno", lb="ecmp",
                    rng=random.Random(2))
    net.sim.run(until=200 * MS)
    assert f.receiver.n_got == f.n_pkts
    assert f.fct is not None
    return f.receiver.n_got, f.fct, bytes(f.receiver.got)


def _b_rtt_measurement_matches_base(pkg):
    net = _net(pkg)
    f = pkg.W.spawn(net, 1, 0, 256 * KIB, cc_scheme="uno", lb="ecmp",
                    rng=random.Random(3))
    net.sim.run(until=50 * MS)
    assert f.cc.rtt_base == pytest.approx(net.intra_rtt, rel=0.5)
    return f.cc.rtt_base, f.cc.rtt_est


def _b_phantom_queue_drains(pkg):
    pq = pkg.E.PhantomQueue(drain_rate=1.0, cap=1000.0)
    pq.push(0.0, 500)
    pq.update(200.0)
    first = pq.occ
    assert first == pytest.approx(300.0)
    pq.update(10_000.0)
    assert pq.occ == 0.0
    return first, pq.occ


def _b_inter_flow_uses_ec_and_recovers_from_loss(pkg):
    net = _net(pkg)
    rng = random.Random(4)
    for ln in net.wan_links:
        ln.loss_fn = lambda pkt, now, r=rng: r.random() < 0.10
    f = pkg.W.spawn(net, 8, 0, 2 * MIB, cc_scheme="uno", lb="unolb",
                    ec=(8, 2), rng=rng)
    assert f.ec == (8, 2) and f.n_parity > 0
    net.sim.run(until=900 * MS)
    assert f.fct is not None
    assert f.receiver.complete_t is not None
    return _flows([f]), _sim(net.sim)


def _b_ec_not_applied_intra_dc(pkg):
    net = _net(pkg)
    f = pkg.W.spawn(net, 1, 0, 1 * MIB, cc_scheme="uno", lb="unolb",
                    ec=(8, 2), rng=random.Random(5))
    assert f.ec is None
    return f.ec, f.n_pkts


def _b_block_recovery_without_retransmit(pkg):
    net = pkg.T.Dumbbell(n_left=2, n_right=1)
    net.attach_phantoms()
    rng = random.Random(6)
    dropped = []

    def lossf(pkt, now):
        if pkt.flow.is_inter and pkt.block == 0 and not pkt.is_parity \
                and pkt.seq in (0, 1) and not dropped.count(pkt.seq):
            dropped.append(pkt.seq)
            return True
        return False

    for w in net.wan:
        w.loss_fn = lossf
    f = pkg.W.spawn(net, 2, 0, 320 * KIB, cc_scheme="uno", lb="unolb",
                    ec=(8, 2), rng=rng)
    net.sim.run(until=400 * MS)
    assert sorted(dropped) == [0, 1]
    assert f.fct is not None
    assert f.n_retx == 0
    return _flows([f]), _sim(net.sim)


def _b_unolb_reroutes_away_from_failed_link(pkg):
    net = pkg.T.TwoDCFatTree(seed=7)
    net.attach_phantoms()
    rng = random.Random(7)
    pkg.T.fail_link(net.link("B0->B1.0"))
    f = pkg.W.spawn(net, 3, 200, 4 * MIB, cc_scheme="uno", lb="unolb",
                    ec=(8, 2), rng=rng, n_subflows=8)
    net.sim.run(until=600 * MS)
    assert f.fct is not None
    assert f.router.n_reroutes >= 0
    return _flows([f]), f.router.n_reroutes, _sim(net.sim)


def _b_link_fail_repair_cycle(pkg):
    net = _net(pkg)
    rng = random.Random(8)
    f = pkg.W.spawn(net, 8, 0, 8 * MIB, cc_scheme="uno", lb="unolb",
                    ec=(8, 2), rng=rng)
    net.sim.at(2 * MS, pkg.T.fail_link, net.wan[0])
    net.sim.at(30 * MS, pkg.T.repair_link, net.wan[0])
    net.sim.run(until=900 * MS)
    assert f.fct is not None
    return _flows([f]), _sim(net.sim)


def _b_gilbert_elliott_rate(pkg):
    rng = random.Random(9)
    ge = pkg.T.GilbertElliott(rng, loss_rate=1e-3, burst=0.3)
    n = 400_000
    losses = sum(1 for _ in range(n) if ge(None, 0.0))
    assert 0.3e-3 < losses / n < 3e-3
    return losses


def _b_mixed_incast_fair_and_complete(pkg):
    net = _net(pkg)
    rng = random.Random(10)
    flows = [pkg.W.spawn(net, i, 0, 24 * MIB, cc_scheme="uno", lb="rps",
                         rng=rng, trace_rate=True) for i in range(1, 5)]
    flows += [pkg.W.spawn(net, 8 + i, 0, 24 * MIB, cc_scheme="uno",
                          lb="rps", rng=rng, trace_rate=True)
              for i in range(4)]
    net.sim.run(until=400 * MS)
    assert all(f.fct is not None for f in flows)
    rates = pkg.W.bin_rates(flows, 1 * MS, 40 * MS)
    mid = [pkg.W.mean_rate_gbps(rates[f.id], 8 * MS, 24 * MS)
           for f in flows]
    assert pkg.W.jain(mid) > 0.7, mid
    return mid, [f.fct for f in flows]


def _schemes_complete(scheme):
    def run(pkg):
        net = pkg.T.Dumbbell(n_left=8, n_right=1)
        if scheme == "uno":
            net.attach_phantoms()
        rng = random.Random(11)
        flows = [pkg.W.spawn(net, i, 0, 1 * MIB, cc_scheme=scheme,
                             lb="ecmp", rng=rng) for i in (1, 2, 8)]
        net.sim.run(until=600 * MS)
        assert all(f.fct is not None for f in flows)
        return _flows(flows), _sim(net.sim)
    return run


def _b_fattree_paths_valid(pkg):
    net = pkg.T.TwoDCFatTree(seed=12)
    out = []
    for (s, d) in [(0, 1), (0, 5), (0, 17), (0, 130), (130, 5)]:
        paths = net.paths(s, d)
        assert len(paths) >= 1
        for p in paths:
            assert p[0].name == f"h{s}->e"
            assert p[-1].name == f"e->h{d}"
        out.append(net.path_link_names(s, d))
    assert net.is_inter(0, 130) and not net.is_inter(0, 5)
    return out


def _b_workload_cdf_sampling(pkg):
    rng = random.Random(13)
    W = pkg.W
    xs = [W.sample_cdf(W.WEBSEARCH_CDF, rng) for _ in range(4000)]
    assert min(xs) >= 1
    assert max(xs) <= 20 * MIB
    mean = sum(xs) / len(xs)
    assert 0.3 * W.cdf_mean(W.WEBSEARCH_CDF) < mean \
        < 3 * W.cdf_mean(W.WEBSEARCH_CDF)
    return xs


BEHAVIOURS = {
    "single_flow_completes_at_line_rate":
        _b_single_flow_completes_at_line_rate,
    "packet_conservation": _b_packet_conservation,
    "receiver_gets_every_byte_exactly_once":
        _b_receiver_gets_every_byte_exactly_once,
    "rtt_measurement_matches_base": _b_rtt_measurement_matches_base,
    "phantom_queue_drains": _b_phantom_queue_drains,
    "inter_flow_uses_ec_and_recovers_from_loss":
        _b_inter_flow_uses_ec_and_recovers_from_loss,
    "ec_not_applied_intra_dc": _b_ec_not_applied_intra_dc,
    "block_recovery_without_retransmit":
        _b_block_recovery_without_retransmit,
    "unolb_reroutes_away_from_failed_link":
        _b_unolb_reroutes_away_from_failed_link,
    "link_fail_repair_cycle": _b_link_fail_repair_cycle,
    "gilbert_elliott_rate": _b_gilbert_elliott_rate,
    "mixed_incast_fair_and_complete": _b_mixed_incast_fair_and_complete,
    "all_schemes_complete_small_workload[uno]": _schemes_complete("uno"),
    "all_schemes_complete_small_workload[gemini]":
        _schemes_complete("gemini"),
    "all_schemes_complete_small_workload[mprdma+bbr]":
        _schemes_complete("mprdma+bbr"),
    "fattree_paths_valid": _b_fattree_paths_valid,
    "workload_cdf_sampling": _b_workload_cdf_sampling,
}


def _names(x):
    """Link objects (in path tuples) by name, for comparing across the
    two packages."""
    if isinstance(x, (RE.Link, TE.Link)):
        return x.name
    if isinstance(x, (list, tuple)):
        return type(x)(_names(v) for v in x)
    return x


@pytest.mark.parametrize("case", list(BEHAVIOURS))
def test_reference_netsim_behaviour_on_port(case):
    """tests/test_netsim.py's case with its assertions, on the port; the
    port's outcome equal to the reference's."""
    port = BEHAVIOURS[case](PORT)
    RP.Flow._next_id = TP.Flow._next_id = 0
    assert _names(port) == _names(BEHAVIOURS[case](REF))
