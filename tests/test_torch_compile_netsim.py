"""`repro_torch.scenarios.to_netsim` / `spawn_backlogged` against the
reference's (`repro.scenarios`), each from equal specs
(`tuple(ref_spec) == tuple(port_spec)`): the dumbbell, the multipath
dumbbell, a lossy dumbbell with EC, the four fault kinds (`down`,
`brownout` at half and at zero capacity, `flap`, `burst`), the k=4 two-DC
fat tree and the 3-DC ring.

Checked exactly: the links (names in order, rate, delay, queue, RED
thresholds, phantom queue, whether a loss function is set), the WAN set,
every flow's path set (link names), class, RTT and BDP, the fault events
armed on the event heap (time, order, function, arguments), the flows
`spawn_backlogged` wires (router kind and identity, EC geometry, NACK
timer), then a short run of every spec (3 ms, the fat trees 1 ms): each
flow's `rate_trace`, `fct`, `n_sent`, `n_retx` and the simulator's
counters.
"""
import pytest

import repro.scenarios as RS
from repro.netsim import engine as RE
from repro.netsim import protocol as RP

import repro_torch.scenarios as TS
from repro_torch.netsim import engine as TE
from repro_torch.netsim import protocol as TP

MS = 1e6


def _faulted(fault):
    return lambda M: M.dumbbell_scenario(
        1, 4, multipath=True, n_wan=4, seed=3,
        inter_lb=M.LbSpec(kind="unolb", n_subflows=4),
        faults=(M.FaultSpec(link="wan0", **fault),))


SPECS = {
    "dumbbell": lambda M: M.dumbbell_scenario(2, 2, seed=2),
    "multipath": lambda M: M.dumbbell_scenario(
        2, 3, multipath=True, n_wan=4, n_bottleneck=2, seed=4),
    "lossy": lambda M: M.dumbbell_scenario(
        0, 4, qcap=64 * 2 ** 20, wan_p_loss=0.02, seed=5,
        inter_rel=M.RelSpec(ec=(8, 2), nack_period=4 * MS)),
    "down": _faulted(dict(kind="down", t_start=1 * MS, t_end=2 * MS)),
    "brownout": _faulted(dict(kind="brownout", t_start=1 * MS,
                              t_end=2.5 * MS, cap_frac=0.5)),
    "brownout_zero": _faulted(dict(kind="brownout", t_start=1 * MS,
                                   cap_frac=0.0)),
    "flap": _faulted(dict(kind="flap", t_start=0.5 * MS, t_end=2.6 * MS,
                          period=0.4 * MS, duty=0.5)),
    "burst": _faulted(dict(kind="burst", t_start=0.5 * MS, t_end=2 * MS,
                           loss_rate=2e-2, burst=0.3)),
    "fat_tree_k4": lambda M: M.fat_tree_spec(k=4, n_flows=12, n_paths=4,
                                             seed=1),
    "multi_dc_3": lambda M: M.multi_dc_spec(k=4, n_dc=3, n_flows=12,
                                            n_paths=4, seed=1),
}


def _arg(x):
    return x.name if isinstance(x, (RE.Link, TE.Link)) else x


def _net_view(net):
    links = [(n, l.name, l.rate, l.pdelay, l.qcap, l.ecn_min, l.ecn_max,
              l.p_ecn_min, l.p_ecn_max,
              None if l.phantom is None else (l.phantom.drain_rate,
                                              l.phantom.cap),
              l.loss_fn is not None, l.failed)
             for n, l in net.links.items()]
    flows = [(tuple(tuple(ln.name for ln in p) for p in net.paths(1 + i, 0)),
              net.is_inter(1 + i, 0), net.base_rtt(1 + i, 0),
              net.bdp(1 + i, 0)) for i in range(net.spec.n_flows)]
    heap = sorted((t, seq, getattr(fn, "__name__", None),
                   tuple(_arg(a) for a in args))
                  for t, seq, fn, args in net.sim._heap)
    return (links, [l.name for l in net.wan_links], flows, heap,
            net.n_hosts, net.intra_rtt, net.inter_rtt, net.rate)


def _flow_view(flows):
    return [(f.id, f.src, f.dst, f.size, f.ec, f.n_pkts, f.nack_timeout,
             f.base_rtt, f.is_inter, type(f.router).__name__,
             getattr(f.router, "n", None), type(f.cc).__name__)
            for f in flows]


def _run(M, spec, horizon):
    net = M.to_netsim(spec)
    view = _net_view(net)
    flows = M.spawn_backlogged(net, cc_scheme="uno", size=64 * 2 ** 20)
    fview = _flow_view(flows)
    net.sim.run(until=horizon)
    out = [(f.rate_trace, f.fct, f.n_sent, f.n_retx) for f in flows]
    return view, fview, out, (net.sim.now, net.sim.dropped,
                              net.sim.delivered,
                              [(l.drops, l.marks, l.forwarded)
                               for l in net.links.values()])


@pytest.mark.parametrize("name", list(SPECS))
def test_to_netsim_matches_reference(name, monkeypatch):
    monkeypatch.setattr(RP.Flow, "_next_id", 0)
    monkeypatch.setattr(TP.Flow, "_next_id", 0)
    ref_spec, port_spec = SPECS[name](RS), SPECS[name](TS)
    assert tuple(ref_spec) == tuple(port_spec)
    horizon = 1 * MS if name in ("fat_tree_k4", "multi_dc_3") else 3 * MS
    ref = _run(RS, ref_spec, horizon)
    port = _run(TS, port_spec, horizon)
    assert port[0] == ref[0]          # links, paths, armed faults
    assert port[1] == ref[1]          # the flows spawn_backlogged wired
    assert port[2] == ref[2]          # each flow's run
    assert port[3] == ref[3]          # simulator and link counters
    delivered = port[3][2]
    assert delivered > 100
    if name in ("down", "brownout", "flap", "brownout_zero"):
        assert any(h[2] != "_start" for h in port[0][3])
    if name == "burst":
        assert dict((l[0], l[10]) for l in port[0][0])["wan0"]
    if name in ("lossy", "burst", "down", "flap"):
        assert port[3][1] > 0         # the packet run dropped packets


def test_scenario_net_rejects_a_host_that_is_not_a_sender():
    net = TS.to_netsim(SPECS["dumbbell"](TS))
    with pytest.raises(ValueError, match="not a scenario sender"):
        net.paths(0, 0)
    with pytest.raises(ValueError, match="not a scenario sender"):
        net.is_inter(9, 0)
