"""The port's fluid halves of the fluid-vs-packet cross-validation
(`repro_torch.fleetsim.validate`) against the reference's
`repro.fleetsim.validate`, at a reduced depth.

Each of the reference's eight comparisons runs whole, with only its
packet simulator stubbed: `netsim_scenario_rates`, or for the recovery
and adaptive-EC comparisons (which run netsim inline) `to_netsim` and
`spawn_backlogged`, return fixed per-flow rates and packet counters.  The
port's comparison gets the same packet numbers as arguments.  Checked:

  * the spec each side builds, with the reference's own defaults, equal
    field for field (the stub records the reference's);
  * the result dicts: the same keys, the packet entries equal, and the
    port's dict helpers, given the reference's two rate vectors (and
    counters), equal to the reference's dict exactly;
  * the fluid halves: per-flow rates within 1e-5 of the link rate on the
    dumbbells (ROADMAP's bar); on the fat tree and the multi-DC mesh
    within max(1e-5 x the link rate, 4 x the reference's own divergence
    between two of its backends at the same depth) (the yardstick of
    tests/test_fat_tree_scenarios.py:317-356); the recovery counters
    within 1e-5 relative, the settled rung exactly.

Depth: 3,000 warm-up and 300 measured epochs (the recovery comparison
2,000, so that its window holds NACKs), except the fault comparison,
which keeps its own window at its defaults (t0 / dt = 3,214 warm-up and
1,786 measured epochs, dt = 14 us)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import cc as RC  # noqa: E402
from repro.fleetsim import validate as RV  # noqa: E402

from repro_torch.fleetsim import validate as TV  # noqa: E402

N_WARM, N_MEAS = 3_000, 300
RECOVERY_MEAS = 2_000  # the window sees NACKs (the period is 143 epochs)
RATE_ATOL = 1e-5       # x the link rate
COUNTER_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _synthetic(n, seed):
    return np.random.default_rng(seed).uniform(1.0, 6.0, n)


class _FakeFlow:
    """A packet flow's trace: `rate` bytes/ns over [t0, horizon), and
    n_sent / n_retx counters that move during the run."""

    def __init__(self, rate, t0, horizon, sent, retx):
        self.rate_trace = [(t0, rate * (horizon - t0))]
        self.n_sent, self.n_retx = 100, 1
        self._end = (100 + sent, 1 + retx)


class _FakeNet:
    """A packet net whose `sim` runs the t0 snapshot, then moves every
    flow's counters to their end values."""

    def __init__(self, spec):
        self.spec, self.flows, self._at = spec, [], []
        self.sim = self

    def at(self, t, fn):
        self._at.append(fn)

    def run(self, until):
        for fn in self._at:
            fn()
        for f in self.flows:
            f.n_sent, f.n_retx = f._end


def _stub_inline_netsim(monkeypatch, rates, sent, retx, t0, horizon):
    """`to_netsim` / `spawn_backlogged` of the reference's inline packet
    run: fake flows at `rates`; the specs it was given, in order."""
    specs = []

    def to_netsim(spec):
        specs.append(spec)
        return _FakeNet(spec)

    def spawn(net, **kw):
        net.flows = [_FakeFlow(r, t0, horizon, s, x)
                     for r, s, x in zip(rates, sent, retx)]
        return net.flows

    monkeypatch.setattr(RV, "to_netsim", to_netsim)
    monkeypatch.setattr(RV, "spawn_backlogged", spawn)
    return specs


def _stub_netsim_rates(monkeypatch, seed):
    """`netsim_scenario_rates`: synthetic rates, the spec recorded."""
    specs = []

    def rates(spec, **kw):
        specs.append(spec)
        return _synthetic(spec.n_flows, seed)

    monkeypatch.setattr(RV, "netsim_scenario_rates", rates)
    return specs


def _rate_err(got, want, rate):
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)))) / rate


def _same_keys_and_packet_side(port, ref, packet_keys=("netsim",)):
    assert list(port) == list(ref)
    for k in packet_keys:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


def _assert_dict_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# ---------------------------------------------------------- the dict helper

def test_scenario_result_equals_reference_compare_scenario(monkeypatch):
    """The reference's `compare_scenario` with both halves fixed to the
    same two rate vectors gives exactly the port's `scenario_result`."""
    spec = TV.steady_state_spec(1, 1)
    ns, fm = np.array([6.1, 4.4]), np.array([5.9, 4.7], np.float32)
    monkeypatch.setattr(RV, "netsim_scenario_rates", lambda s, **kw: ns)
    monkeypatch.setattr(RV, "fluid_scenario_rates", lambda s, **kw: fm)
    want = RV.compare_scenario(RS.dumbbell_scenario(
        1, 1, multipath=True, seed=1,
        inter_lb=RS.LbSpec(kind="rps", n_subflows=8)))
    _assert_dict_equal(TV.scenario_result(spec, ns, fm), want)


# ---------------------------------------------------------- dumbbells

@pytest.mark.parametrize("case", ["steady_2flow", "steady_8flow",
                                  "multipath"])
def test_dumbbell_comparisons_match_reference(case, monkeypatch):
    specs = _stub_netsim_rates(monkeypatch, seed=3)
    depth = dict(n_warm=N_WARM, n_meas=N_MEAS)
    if case == "multipath":
        ref = RV.compare_multipath_steady_state(2, 2, n_bottleneck=2,
                                                **depth)
        ns = ref["netsim"]
        port = TV.compare_multipath_steady_state(
            2, 2, n_bottleneck=2, netsim=ns, device="cpu", **depth)
        spec = TV.multipath_spec(2, 2, n_bottleneck=2)
    else:
        n_intra, n_inter = (1, 1) if case == "steady_2flow" else (8, 0)
        ref = RV.compare_steady_state(n_intra, n_inter, **depth)
        ns = ref["netsim"]
        port = TV.compare_steady_state(n_intra, n_inter, netsim=ns,
                                       device="cpu", **depth)
        spec = TV.steady_state_spec(n_intra, n_inter)
    assert tuple(specs[0]) == tuple(spec)
    _same_keys_and_packet_side(port, ref)
    err = _rate_err(port["fluid"], ref["fluid"], spec.rate)
    assert err <= RATE_ATOL, err
    _assert_dict_equal(TV.scenario_result(spec, ns, ref["fluid"]), ref)


# ---------------------------------------------------------- fat tree, N-DC

def _backend_noise(spec):
    """The reference's own divergence between its default backend and
    its `reference` backend on `spec` at the test depth."""
    fs = RS.to_fleetsim(spec)
    kw = dict(n_warm=N_WARM, n_meas=N_MEAS, is_inter=fs.is_inter, lb=fs.lb,
              churn=fs.churn, seed=fs.seed)
    _, a = RC.steady_state(fs.net, fs.params, **kw)
    _, b = RC.steady_state(fs.net, fs.params, backend="reference", **kw)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("case", ["fat_tree", "multi_dc"])
def test_fat_tree_and_multi_dc_comparisons_match_reference(case,
                                                           monkeypatch):
    specs = _stub_netsim_rates(monkeypatch, seed=4)
    depth = dict(n_warm=N_WARM, n_meas=N_MEAS)
    if case == "fat_tree":
        ref = RV.compare_fat_tree_steady_state(**depth)
        port = TV.compare_fat_tree_steady_state(netsim=ref["netsim"],
                                                device="cpu", **depth)
        spec = TV.fat_tree_steady_spec()
    else:
        ref = RV.compare_multi_dc_steady_state(**depth)
        port = TV.compare_multi_dc_steady_state(netsim=ref["netsim"],
                                                device="cpu", **depth)
        spec = TV.multi_dc_steady_spec()
    assert tuple(specs[0]) == tuple(spec)
    _same_keys_and_packet_side(port, ref)
    tol = max(RATE_ATOL, 4.0 * _backend_noise(specs[0]) / spec.rate)
    err = _rate_err(port["fluid"], ref["fluid"], spec.rate)
    assert err <= tol, (err, tol)
    _assert_dict_equal(TV.scenario_result(spec, ref["netsim"], ref["fluid"]),
                       ref)


# ---------------------------------------------------------- recovery

def _counters_close(port, ref, keys):
    for k in keys:
        assert abs(port[k] - ref[k]) <= COUNTER_RTOL * max(abs(ref[k]),
                                                            1e-12), \
            (k, port[k], ref[k])


def test_recovery_comparison_matches_reference(monkeypatch):
    n = 6
    rates = _synthetic(n, 5)
    specs = _stub_inline_netsim(monkeypatch, rates, [4000] * n,
                                [3, 0, 5, 1, 0, 2], 20e6, 60e6)
    ref = RV.compare_recovery_steady_state(n_inter=n, n_warm=N_WARM,
                                           n_meas=RECOVERY_MEAS)
    port = TV.compare_recovery_steady_state(
        n, netsim=ref["netsim"], retx_netsim=ref["retx_netsim"],
        n_warm=N_WARM, n_meas=RECOVERY_MEAS, device="cpu")
    spec = TV.recovery_spec(n)
    assert tuple(specs[0]) == tuple(spec)
    _same_keys_and_packet_side(port, ref, ("netsim", "retx_netsim"))
    assert _rate_err(port["fluid"], ref["fluid"], spec.rate) <= RATE_ATOL
    _counters_close(port, ref, ("retx_fluid", "rec_fluid", "nack_fluid",
                                "loss_fluid"))
    assert ref["loss_fluid"] > 0 and ref["nack_fluid"] > 0
    fluid = {k: ref[k] for k in ("fluid", "retx_fluid", "rec_fluid",
                                 "nack_fluid", "loss_fluid")}
    _assert_dict_equal(TV.recovery_result(spec, ref["netsim"],
                                          ref["retx_netsim"], fluid), ref)


# ---------------------------------------------------------- fault

def test_fault_comparison_matches_reference(monkeypatch):
    """The comparison's own window: warm-up to t0 = 45 ms, measurement to
    70 ms, in epochs of the spec's dt (14 us)."""
    specs = _stub_netsim_rates(monkeypatch, seed=6)
    ref = RV.compare_fault_recovery()
    spec = TV.fault_spec()
    assert tuple(specs[0]) == tuple(spec)
    assert TV.fault_window(spec, 45e6, 70e6) == (3214, 1786)
    port = TV.compare_fault_recovery(netsim=ref["netsim"], device="cpu")
    _same_keys_and_packet_side(port, ref, ("netsim", "agg_netsim",
                                           "util_netsim"))
    assert _rate_err(port["fluid"], ref["fluid"], spec.rate) <= RATE_ATOL
    assert abs(port["agg_fluid"] - ref["agg_fluid"]) <= \
        RATE_ATOL * spec.rate
    _assert_dict_equal(TV.fault_result(spec, ref["netsim"], ref["fluid"]),
                       ref)
    with pytest.raises(ValueError, match="t_fail"):
        TV.compare_fault_recovery(netsim=ref["netsim"], t_fail=50e6,
                                  device="cpu")


# ---------------------------------------------------------- adaptive EC

def test_adaptive_ec_comparison_matches_reference(monkeypatch):
    """Two-stage: the settled rung equal, the packet replay handed a spec
    equal to the one the reference hands netsim at that rung."""
    n = 6
    rates = _synthetic(n, 7)
    specs = _stub_inline_netsim(monkeypatch, rates, [5000] * n,
                                [1, 2, 0, 0, 4, 1], 20e6, 60e6)
    ladder_kw = dict(ladder=((8, 1), (8, 2), (8, 4)),
                     ladder_up=(0.008, 0.05, 1.0),
                     ladder_down=(0.0, 0.004, 0.025))
    recorded = []
    ref_fleet = RV.to_fleetsim

    def to_fleetsim(spec):
        recorded.append(spec)
        return ref_fleet(spec)

    monkeypatch.setattr(RV, "to_fleetsim", to_fleetsim)
    ref = RV.compare_adaptive_ec(0.02, n_warm=N_WARM, n_meas=N_MEAS,
                                 **ladder_kw)
    replayed = []

    def replay(spec):
        replayed.append(spec)
        return ref["netsim"], ref["retx_netsim"]

    port = TV.compare_adaptive_ec(0.02, replay=replay, n_warm=N_WARM,
                                  n_meas=N_MEAS, device="cpu", **ladder_kw)
    spec = TV.adaptive_ec_spec(0.02, **ladder_kw)
    assert tuple(recorded[0]) == tuple(spec)
    assert tuple(specs[0]) == tuple(replayed[0])
    assert port["rung_fluid"] == ref["rung_fluid"]
    assert port["rung_geometry"] == ref["rung_geometry"]
    _same_keys_and_packet_side(port, ref, ("netsim", "retx_netsim"))
    assert _rate_err(port["fluid"], ref["fluid"], spec.rate) <= RATE_ATOL
    _counters_close(port, ref, ("retx_fluid", "rec_fluid", "loss_fluid"))
    fluid = {k: ref[k] for k in ("fluid", "rung_fluid", "rung_geometry",
                                 "retx_fluid", "rec_fluid", "loss_fluid")}
    _assert_dict_equal(TV.adaptive_ec_result(spec, ref["netsim"],
                                             ref["retx_netsim"], fluid), ref)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.fluid_scenario_rates(TV.steady_state_spec(1, 1), n_warm=1,
                                n_meas=1)
