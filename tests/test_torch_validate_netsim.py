"""The port's eight fluid-vs-packet comparisons run whole
(`repro_torch.fleetsim.validate.compare_*` with no packet numbers given):
the packet half on the port's netsim, the fluid half on the port's fleet
model, against the reference's `compare_*` on equal arguments.

Checked: the packet half bitwise the reference's (the per-flow rates and,
where the comparison has it, the retransmit fraction), the fluid half
within tests/test_torch_validate.py's tolerances (1e-5 x the link rate on
the dumbbells; on the fat tree and the multi-DC mesh within max(1e-5 x
the rate, 4 x the reference's own divergence between two of its
backends); the recovery counters within 1e-5 relative, the settled rung
exactly), and the port's dict equal to the one its helpers build from the
reference's numbers.  Short packet horizons (the measurement window
[2, 6) ms, the fault comparison [6, 8) ms after wan0 fails at 4 ms) and
that file's fluid depth keep this cheap; the reference's packet depth
runs in tests/test_torch_validate_accept.py.  The packet halves alone are
also held bitwise at other routers and controllers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import validate as RV  # noqa: E402

import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import validate as TV  # noqa: E402

from test_torch_validate import (COUNTER_RTOL, N_MEAS, N_WARM,  # noqa: E402
                                 RATE_ATOL, RECOVERY_MEAS,
                                 _assert_dict_equal, _backend_noise,
                                 _rate_err)

MS = 1e6
WINDOW = dict(horizon=6 * MS, t0=2 * MS)
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(name):
    """(reference dict, port dict, port spec) of one comparison."""
    depth = dict(n_warm=N_WARM, n_meas=N_MEAS)
    if name == "steady_2flow":
        kw = dict(**WINDOW, **depth)
        return (RV.compare_steady_state(1, 1, **kw),
                TV.compare_steady_state(1, 1, device="cpu", **kw),
                TV.steady_state_spec(1, 1))
    if name == "multipath":
        kw = dict(n_bottleneck=2, **WINDOW, **depth)
        return (RV.compare_multipath_steady_state(2, 2, **kw),
                TV.compare_multipath_steady_state(2, 2, device="cpu", **kw),
                TV.multipath_spec(2, 2, n_bottleneck=2))
    if name == "scenario":
        kw = dict(lb="ecmp", size=64 * 2 ** 20, **WINDOW, **depth)
        return (RV.compare_scenario(RS.dumbbell_scenario(
                    2, 2, multipath=True, n_wan=4, seed=6), **kw),
                TV.compare_scenario(TS.dumbbell_scenario(
                    2, 2, multipath=True, n_wan=4, seed=6), device="cpu",
                    **kw),
                TS.dumbbell_scenario(2, 2, multipath=True, n_wan=4, seed=6))
    if name == "recovery":
        kw = dict(n_warm=N_WARM, n_meas=RECOVERY_MEAS, **WINDOW)
        return (RV.compare_recovery_steady_state(6, **kw),
                TV.compare_recovery_steady_state(6, device="cpu", **kw),
                TV.recovery_spec(6))
    if name == "fault":
        kw = dict(horizon=8 * MS, t0=6 * MS)
        return (RV.compare_fault_recovery(**kw),
                TV.compare_fault_recovery(device="cpu", **kw),
                TV.fault_spec())
    if name == "adaptive_ec":
        kw = dict(**LADDER, **WINDOW, **depth)
        return (RV.compare_adaptive_ec(0.02, **kw),
                TV.compare_adaptive_ec(0.02, device="cpu", **kw),
                TV.adaptive_ec_spec(0.02, **LADDER))
    if name == "fat_tree":
        kw = dict(**WINDOW, **depth)
        return (RV.compare_fat_tree_steady_state(**kw),
                TV.compare_fat_tree_steady_state(device="cpu", **kw),
                TV.fat_tree_steady_spec())
    kw = dict(**WINDOW, **depth)
    return (RV.compare_multi_dc_steady_state(**kw),
            TV.compare_multi_dc_steady_state(device="cpu", **kw),
            TV.multi_dc_steady_spec())


@pytest.mark.parametrize("name", ["steady_2flow", "multipath", "scenario",
                                  "recovery", "fault", "adaptive_ec",
                                  "fat_tree", "multi_dc"])
def test_comparison_runs_whole_on_the_port(name):
    ref, port, spec = _both(name)
    np.testing.assert_array_equal(port["netsim"], ref["netsim"])
    assert port["netsim"].dtype == ref["netsim"].dtype
    assert np.all(port["netsim"] > 0), port["netsim"]
    tol = RATE_ATOL
    if name in ("fat_tree", "multi_dc"):
        incast = dict(k=4, n_wan=4, n_intra_pod=0, n_cross_pod=6,
                      n_inter=0, workload="incast", n_paths=4, seed=1)
        ref_spec = RS.fat_tree_spec(**incast) if name == "fat_tree" \
            else RS.multi_dc_spec(n_dc=3, mesh="ring", **incast)
        assert tuple(ref_spec) == tuple(spec)
        tol = max(RATE_ATOL, 4.0 * _backend_noise(ref_spec) / spec.rate)
    err = _rate_err(port["fluid"], ref["fluid"], spec.rate)
    assert err <= tol, (err, tol)
    if name == "fault":
        _assert_dict_equal(port, TV.fault_result(spec, ref["netsim"],
                                                 port["fluid"]))
        return
    if name in ("recovery", "adaptive_ec"):
        assert port["retx_netsim"] == ref["retx_netsim"]
        for k in ("retx_fluid", "rec_fluid", "loss_fluid"):
            assert abs(port[k] - ref[k]) <= \
                COUNTER_RTOL * max(abs(ref[k]), 1e-12), (k, port[k], ref[k])
    if name == "adaptive_ec":
        assert port["rung_geometry"] == ref["rung_geometry"]
        fluid = {k: port[k] for k in ("fluid", "rung_fluid", "rung_geometry",
                                      "retx_fluid", "rec_fluid",
                                      "loss_fluid")}
        _assert_dict_equal(port, TV.adaptive_ec_result(
            spec, ref["netsim"], ref["retx_netsim"], fluid))
    elif name == "recovery":
        fluid = {k: port[k] for k in ("fluid", "retx_fluid", "rec_fluid",
                                      "nack_fluid", "loss_fluid")}
        _assert_dict_equal(port, TV.recovery_result(
            spec, ref["netsim"], ref["retx_netsim"], fluid))
    else:
        _assert_dict_equal(port, TV.scenario_result(spec, ref["netsim"],
                                                    port["fluid"]))


@pytest.mark.parametrize("lb,cc_scheme", [(None, "gemini"),
                                          ("ecmp", "mprdma+bbr"),
                                          ("plb", "uno"), ("unolb", "bbr")])
def test_packet_half_matches_reference_at_other_routers(lb, cc_scheme):
    """`netsim_scenario_rates(lb=, cc_scheme=)` on the multipath dumbbell
    (2 + 2 flows, [1, 4) ms)."""
    kw = dict(horizon=4 * MS, t0=1 * MS, lb=lb, cc_scheme=cc_scheme,
              size=32 * 2 ** 20)
    ref = RV.netsim_scenario_rates(RS.dumbbell_scenario(
        2, 2, multipath=True, n_wan=4, seed=7), **kw)
    port = TV.netsim_scenario_rates(TS.dumbbell_scenario(
        2, 2, multipath=True, n_wan=4, seed=7), **kw)
    np.testing.assert_array_equal(port, ref)
    assert port.shape == (4,) and np.all(port > 0)


def test_recovery_needs_both_packet_numbers():
    with pytest.raises(ValueError, match="together"):
        TV.compare_recovery_steady_state(6, netsim=np.ones(6),
                                         device="cpu")
