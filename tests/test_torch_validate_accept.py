"""One fluid-vs-packet acceptance at the reference's full depth, whole on
the port: `compare_steady_state(1, 1)` (the 2-flow inter / intra-DC
dumbbell), the port's fluid half on the CPU (200,000 warm-up and 20,000
measured epochs) against the port's packet simulator on the same spec
(45 ms, measured over [15, 45) ms), at the reference's bars
(tests/test_fleetsim.py:264-269): every flow within 15 %, utilization
within 0.06.  The packet half is also held bitwise against the
reference's `netsim_scenario_rates` on the equal reference spec, and both
against the rates chip_smoke.py pins (`VALIDATE_2FLOW_NETSIM`), which the
card machine's run of the port must give too.

The port's epoch is eager (~0.6 ms on one CPU thread), so this file
takes minutes; besides it the file holds only the fault comparison,
whose own window is short (3,214 + 1,786 epochs): the post-failure
aggregate within 10 % of the packet simulator's
(tests/test_faults.py:386-391), its packet half held the same way
(`VALIDATE_FAULT_NETSIM`).  The other full-depth acceptances are run by
hand (`tools/validate_accept.py`)."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import validate as RV  # noqa: E402
from repro.netsim.topology import MS  # noqa: E402

from repro_torch.fleetsim import validate as TV  # noqa: E402


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _chip_smoke()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_cross_validation_2flow_inter_intra_full_depth():
    ref_spec = RS.dumbbell_scenario(
        1, 1, multipath=True, seed=1,
        inter_lb=RS.LbSpec(kind="rps", n_subflows=8))
    assert tuple(ref_spec) == tuple(TV.steady_state_spec(1, 1))
    ns = RV.netsim_scenario_rates(ref_spec, horizon=45 * MS, t0=15 * MS)
    res = TV.compare_steady_state(1, 1, n_warm=200_000, n_meas=20_000,
                                  device="cpu")
    np.testing.assert_array_equal(res["netsim"], ns)
    assert [x.hex() for x in ns] == list(chip_smoke.VALIDATE_2FLOW_NETSIM)
    assert np.all(np.isfinite(res["fluid"])) and res["fluid"].shape == (2,)
    assert res["max_rel_err"] < 0.15, res
    assert res["util_fluid"] == pytest.approx(res["util_netsim"], abs=0.06)


def test_cross_validation_fault_recovery_full_depth():
    ref_spec = RS.dumbbell_scenario(
        0, 8, multipath=True, n_wan=4,
        inter_lb=RS.LbSpec(kind="unolb", n_subflows=4),
        faults=(RS.FaultSpec(link="wan0", kind="down", t_start=4 * MS),),
        seed=1)
    assert tuple(ref_spec) == tuple(TV.fault_spec())
    ns = RV.netsim_scenario_rates(ref_spec, horizon=70 * MS, t0=45 * MS)
    res = TV.compare_fault_recovery(device="cpu")
    np.testing.assert_array_equal(res["netsim"], ns)
    assert [x.hex() for x in ns] == list(chip_smoke.VALIDATE_FAULT_NETSIM)
    assert np.isfinite(res["agg_fluid"]) and np.isfinite(res["agg_netsim"])
    assert res["agg_netsim"] > 0.0
    assert res["agg_rel_err"] < 0.10, res
    assert np.isfinite(res["fluid"]).all()
