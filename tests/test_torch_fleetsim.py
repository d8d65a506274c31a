"""The port's fleet simulator slice against the JAX reference: steady state
of all three schemes on single-path and multipath dumbbells, the k=4 fat
tree with adaptive load balancing inside the reference's own backend-swap
noise, one `make_step` epoch from a scenario and state carried across as
plain numpy arrays (the reference's bundle format), and the compensated
fleet summaries."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleetsim as RF  # noqa: E402
import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import links as RL  # noqa: E402
from repro.fleetsim import service as RSV  # noqa: E402
from repro.fleetsim import sweeps as RSW  # noqa: E402

import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import carry  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _compile(mod, multipath, scheme, **kw):
    spec = mod.dumbbell_scenario(4, 4, n_bottleneck=2, n_wan=4,
                                 multipath=multipath)
    # the baselines react once per own RTT (their cadence), Uno per epoch
    mk = {} if scheme == "uno" else dict(cc_period_rtts=1.0)
    return mod.to_fleetsim(spec, **mk, **kw)


@pytest.mark.parametrize("multipath", [False, True], ids=["single", "mp"])
@pytest.mark.parametrize("scheme", ["uno", "gemini", "dctcp"])
def test_dumbbell_steady_state_matches_reference(scheme, multipath):
    ref = _compile(RS, multipath, scheme)
    port = _compile(TS, multipath, scheme, device="cpu")
    kw = dict(n_warm=1000, n_meas=300, scheme=scheme)
    s_r, g_r = RF.steady_state(ref.net, ref.params, is_inter=ref.is_inter,
                               lb=ref.lb, **kw)
    s_p, g_p = TF.steady_state(port.net, port.params,
                               is_inter=port.is_inter, lb=port.lb, **kw)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(s_p.cwnd.numpy(), np.asarray(s_r.cwnd),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s_p.split.numpy(), np.asarray(s_r.split),
                               rtol=1e-4, atol=1e-5)
    assert torch.isfinite(g_p).all()


def test_fat_tree_lb_within_reference_backend_noise():
    """k=4 two-DC fat tree with UnoLB weights: adaptive-LB dynamics on
    9-hop paths amplify float-summation-order noise, so the port is held
    to max(1e-4 * scale, 4 * noise), `noise` being the reference's own
    divergence between its "reference" and "auto" backends."""
    kw = dict(k=4, n_wan=4, n_flows=30, n_paths=4, seed=5)
    ref = RS.to_fleetsim(RS.fat_tree_spec(**kw))
    port = TS.to_fleetsim(TS.fat_tree_spec(**kw), device="cpu")
    run = dict(n_warm=2000, n_meas=500)
    _, g_a = RF.steady_state(ref.net, ref.params, is_inter=ref.is_inter,
                             lb=ref.lb, **run)
    _, g_b = RF.steady_state(ref.net, ref.params, is_inter=ref.is_inter,
                             lb=ref.lb, backend="reference", **run)
    _, g_p = TF.steady_state(port.net, port.params, is_inter=port.is_inter,
                             lb=port.lb, **run)
    g_a, g_b, g_p = np.asarray(g_a), np.asarray(g_b), g_p.numpy()
    noise = float(np.max(np.abs(g_a - g_b)))
    scale = float(np.max(np.abs(g_a)))
    err = float(np.max(np.abs(g_p - g_a)))
    assert err < max(1e-4 * max(1.0, scale), 4.0 * noise), (err, noise)


@pytest.mark.parametrize("backend", ["cuda", "pt_cuda"])
def test_kernel_backends_on_cpu_follow_plain_path(backend):
    """On CPU tensors the kernel backends run their wrappers' plain
    versions: a whole run agrees with the plain backends."""
    spec = TS.fat_tree_spec(k=4, n_wan=4, n_flows=40, n_paths=4, seed=2)
    fs = TS.to_fleetsim(spec, device="cpu")
    net = TL.with_layout(fs.net, path_table=True)
    plain = "pt" if backend == "pt_cuda" else "reference"
    run = dict(n_epochs=300, is_inter=fs.is_inter, lb=fs.lb)
    s_k, _ = TF.simulate(net, fs.params, backend=backend, **run)
    s_p, _ = TF.simulate(net, fs.params, backend=plain, **run)
    np.testing.assert_allclose(s_k.cwnd.numpy(), s_p.cwnd.numpy(),
                               rtol=1e-4)


def _state_arrays(state):
    return {f: np.asarray(getattr(state, f))
            for f in state._fields if getattr(state, f) is not None}


@pytest.mark.parametrize("kind", ["dumbbell_mp", "fat_tree_pt"])
def test_carry_across_one_step_matches_reference(kind, tmp_path):
    """A reference FleetScenario written as a service bundle and a
    reference FleetState flattened to numpy load into the port unchanged,
    and one make_step epoch from them matches the reference's."""
    if kind == "dumbbell_mp":
        fs = RS.to_fleetsim(RS.dumbbell_scenario(3, 5, n_bottleneck=2,
                                                 n_wan=4, multipath=True))
        backend = "reference"
    else:
        fs = RS.to_fleetsim(RS.fat_tree_spec(k=4, n_wan=4, n_flows=60,
                                             n_paths=4, seed=7))
        fs = fs._replace(net=RL.with_layout(fs.net, path_table=True))
        backend = "pt"
    state, _ = RF.simulate(fs.net, fs.params, n_epochs=200,
                           is_inter=fs.is_inter, lb=fs.lb, backend=backend)
    path = RSV.save_bundle(tmp_path / "bundle.npz", fs)
    with np.load(path, allow_pickle=False) as z:
        port = carry.scenario_from_arrays(z, device="cpu")
    port_state = carry.state_from_arrays(_state_arrays(state), device="cpu")
    assert (port.net.layout.path_table is None) == \
        (fs.net.layout.path_table is None)
    assert port.seed == fs.seed

    step_r = RF.make_step(fs.net, fs.params, "uno", fs.is_inter, lb=fs.lb,
                          backend=backend)
    new_r, g_r = jax.jit(step_r)(state, None)
    step_p = TF.make_step(port.net, port.params, "uno", port.is_inter,
                          lb=port.lb, backend=backend)
    new_p, g_p = step_p(port_state)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-5,
                               atol=1e-6)
    for f in TF.FleetState._fields:
        rv, pv = getattr(new_r, f), getattr(new_p, f)
        if f in ("rel", "fault"):
            assert rv is None and pv is None
            continue
        np.testing.assert_allclose(pv.numpy().astype(np.float64),
                                   np.asarray(rv).astype(np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_simulate_record_and_unported_axes():
    """`simulate(record=True)` gives the (n_epochs, n_flows) trajectory;
    the churn axis, once refused, runs: the seeded on/off masks flip
    exactly the reference's flows and the churned trajectory matches it."""
    fs = TS.to_fleetsim(TS.dumbbell_scenario(2, 2), device="cpu")
    final, traj = TF.simulate(fs.net, fs.params, n_epochs=5, record=True)
    assert tuple(traj.shape) == (5, 4) and torch.isfinite(traj).all()
    specs = [M.dumbbell_scenario(2, 2, inter_churn=M.ChurnSpec(3e4, 2e4),
                                 intra_churn=M.ChurnSpec(5e4, 5e4), seed=3)
             for M in (RS, TS)]
    ref, port = RS.to_fleetsim(specs[0]), TS.to_fleetsim(specs[1],
                                                         device="cpu")
    run = dict(n_epochs=300, record=True)
    s_r, t_r = RF.simulate(ref.net, ref.params, churn=ref.churn,
                           seed=ref.seed, **run)
    s_p, t_p = TF.simulate(port.net, port.params, churn=port.churn,
                           seed=port.seed, **run)
    np.testing.assert_array_equal(s_p.active.numpy(), np.asarray(s_r.active))
    np.testing.assert_array_equal(s_p.key.numpy(), np.asarray(s_r.key))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_r), rtol=1e-4,
                               atol=1e-5)
    assert float((t_p == 0.0).sum()) > 0      # flows really went idle
    with pytest.raises(ValueError, match="scheme"):
        TF.make_step(fs.net, fs.params, "cubic")


def test_fleet_sum_and_jain_match_reference_at_100k():
    rng = np.random.default_rng(3)
    x = rng.lognormal(0.0, 1.5, 100_003).astype(np.float32)
    truth = float(np.sum(x.astype(np.float64)))
    got = float(TF.fleet_sum(torch.as_tensor(x)))
    assert abs(got - truth) <= 4 * np.spacing(np.float32(truth))
    assert abs(got - float(RSW.fleet_sum(jnp.asarray(x)))) <= \
        2 * np.spacing(np.float32(truth))
    np.testing.assert_allclose(float(TF.jain(torch.as_tensor(x))),
                               float(RSW.jain(jnp.asarray(x))), rtol=1e-6)
    two = torch.as_tensor(np.stack([x[:1000], np.ones(1000, np.float32)]))
    j = TF.jain(two, dim=1)
    assert tuple(j.shape) == (2,) and float(j[1]) == pytest.approx(1.0)
