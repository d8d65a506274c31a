"""The port's dynamics axes against the JAX reference: open-loop churn on
the threefry key, the reliability machine (`fleetsim.reliability`) and
fault injection (`fleetsim.faults`), module by module and as a whole.

  * `recovery_split`, `rel_epoch`, `fault_modulation`, `apply_modulation`
    and `degrade_split` on seeded inputs within rtol 1e-6, normalized by
    each output's largest magnitude (XLA contracts `a - b * c` into a
    fused multiply-add and its `pow` differs from torch's by ulps, which
    shows where terms cancel: the NACK window, the drained backlog); the
    q = 0 rows of the recovery split exactly 0, the burst chains and keys
    bitwise;
  * the churn `active` and Gilbert-Elliott `ge_bad` trajectories bitwise
    equal to the reference's over 600 epochs (they depend on the PRNG
    alone, not on rates);
  * `steady_state` with churn, an adaptive-EC RelSpec and faults within
    rtol 1e-4 / atol 1e-5 of the reference on a small dumbbell, on the
    plain and the kernel backends' CPU path;
  * the reference's zero-loss contract: at zero loss a reliability step
    equals the static-EC step bitwise;
  * the stacked and the gloo `dist` sharded runners with all three axes
    against the port's single-device run;
  * a reference scenario bundle and a reference FleetState taken mid-run
    (churn key, RelState, FaultCarry) continuing in the port.

The reference runs under `jax.jit`."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fleetsim as RF  # noqa: E402
import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import faults as RFa  # noqa: E402
from repro.fleetsim import links as RL  # noqa: E402
from repro.fleetsim import reliability as RR  # noqa: E402
from repro.fleetsim import service as RSV  # noqa: E402

import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import carry  # noqa: E402
from repro_torch.fleetsim import faults as TFa  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import reliability as TR  # noqa: E402
from repro_torch.fleetsim import shard as TSH  # noqa: E402

US, MS = 1e3, 1e6
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, what, rtol=1e-6, atol=None):
    """Within rtol; `atol` defaults to rtol times want's largest value."""
    want = _np(want)
    if atol is None:
        atol = rtol * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _eq(got, want, what):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)


def _tuple_close(got, want, what, **kw):
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, (what, f)
        elif np.asarray(w).dtype.kind in "biu":
            _eq(g, w, f"{what}.{f}")
        else:
            _close(g, w, f"{what}.{f}", **kw)


def _to_port(tup, cls):
    """A reference NamedTuple of arrays as the port's, on the CPU."""
    return cls(*(None if v is None else
                 torch.as_tensor(np.asarray(v).astype(np.int64)
                                 if np.asarray(v).dtype == np.uint32
                                 else np.array(v)) for v in tup))


# ------------------------------------------------------------ scenarios

def _dumbbell(M, **kw):
    """The small multipath dumbbell of these tests: churn on both groups,
    the adaptive-EC ladder on the inter group, WAN loss, wan0 down from 1
    to 3 ms, a Gilbert-Elliott burst on wan1."""
    args = dict(
        n_bottleneck=2, multipath=True, n_wan=4, wan_p_loss=1e-3, seed=1,
        intra_churn=M.ChurnSpec(50 * 14 * US, 50 * 14 * US),
        inter_churn=M.ChurnSpec(1 * MS, 1 * MS),
        inter_rel=M.RelSpec(**LADDER),
        faults=(M.FaultSpec("wan0", "down", t_start=1 * MS, t_end=3 * MS),
                M.FaultSpec("wan1", "burst", loss_rate=2e-2, burst=0.3)))
    args.update(kw)
    return M.dumbbell_scenario(4, 6, **args)


@functools.lru_cache(maxsize=None)
def _ref_fs(**kw):
    return RS.to_fleetsim(_dumbbell(RS, **kw))


def _port_fs(**kw):
    return TS.to_fleetsim(_dumbbell(TS, **kw), device="cpu")


def _axes(fs):
    return dict(is_inter=fs.is_inter, lb=fs.lb, churn=fs.churn, rel=fs.rel,
                fault=fs.fault, seed=fs.seed)


# ------------------------------------------------------ module parity

def _rel_pair(n, rng):
    enabled = rng.uniform(size=n) < 0.8
    ref = RR.make_rel_params(n, enabled=jnp.asarray(enabled), nack_period=3,
                             nack_hold=2, **LADDER)
    port = TR.make_rel_params(n, enabled=enabled, nack_period=3,
                              nack_hold=2, device="cpu", **LADDER)
    return ref, port


def _rel_state(rel, n, rng):
    """A seeded mid-run RelState (the port's) and its reference copy."""
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    i = lambda hi: rng.integers(0, hi, n).astype(np.int32)  # noqa
    vals = dict(pending=f(0, 9e3), backlog=f(0, 5e4), ack_cd=i(4),
                hold=i(3), md_cd=f(-1e3, 2e4), rtx_ewma=f(0, 1),
                lat_ewma=f(0, 1e5), nacks=f(0, 9), rec_bytes=f(0, 1e6),
                rtx_bytes=f(0, 1e6), wire_bytes=f(0, 1e8),
                lost_bytes=f(0, 1e6), rung=i(3), loss_ewma=f(0, 0.06),
                adapt_cd=f(-1e3, 1e4))
    return (RR.RelState(**{k: jnp.asarray(v) for k, v in vals.items()}),
            TR.RelState(**{k: torch.as_tensor(v) for k, v in vals.items()}))


def test_make_rel_params_matches_reference():
    rng = np.random.default_rng(0)
    ref, port = _rel_pair(9, rng)
    _tuple_close(port, ref, "rel", rtol=0.0, atol=0.0)
    for kw in (dict(ec=(8, 2)), dict(ec=(4, 0), rtx_cap=0.5, loss_md=0.7),
               dict(ec=(10, 16), nack_quantum=1e3),
               dict(ladder=((8, 1), (8, 2)))):
        _tuple_close(TR.make_rel_params(3, device="cpu", **kw),
                     RR.make_rel_params(3, **kw), str(kw), rtol=0.0,
                     atol=0.0)
    for bad in (dict(ec=(0, 2)), dict(ec=(8, TR.MAX_R + 1)),
                dict(ladder=()), dict(ladder=((8, 1),), ladder_up=(1, 2))):
        with pytest.raises(ValueError):
            TR.make_rel_params(2, device="cpu", **bad)
    two = [TR.make_rel_params(2, device="cpu", ladder=((8, 1), (8, 2))),
           TR.make_rel_params(2, device="cpu", ladder=((8, 1), (8, 4)))]
    with pytest.raises(ValueError, match="ladder"):
        TR.stack_rel_params(two)


def _zero_past_r(coef, r) -> bool:
    cols = torch.arange(coef.shape[-1], dtype=r.dtype)
    return bool((coef[cols > r[..., None]] == 0.0).all())


def test_coef_is_zero_past_r_on_every_built_rel_params(tmp_path):
    """The reliability kernel evaluates the pmf terms up to r only: every
    RelParams the port builds or loads holds 0.0 past r in `coef`, and in
    `ladder_coef` past each rung's r (`make_rel_params`, with and without
    a ladder and a disabled mask; `stack_rel_params`; a grid's per-cell
    tables from `sweeps._stack_rel`; a reference bundle through
    `carry`)."""
    from repro_torch.fleetsim import sweeps as TSW
    en = np.array([True, False, True, True, False])
    built = [TR.make_rel_params(5, device="cpu", enabled=en, **kw)
             for kw in (dict(), dict(ec=(4, 0)), dict(ec=(10, 16)), LADDER)]
    rels = built + [
        TR.stack_rel_params(built[:3]),
        TR.stack_rel_params([built[3], built[0]]),
        TSW._stack_rel([TR.make_rel_params(4, ladder=lad, device="cpu")
                        for lad in (((8, 1), (8, 2)), ((4, 1), (4, 16)))])]
    path = RSV.save_bundle(tmp_path / "bundle.npz", _ref_fs())
    with np.load(path, allow_pickle=False) as z:
        rels.append(carry.scenario_from_arrays(z, device="cpu").rel)
    assert rels[-2].ladder_k.dim() == 2 and rels[-1].ladder_k is not None
    for i, rel in enumerate(rels):
        assert _zero_past_r(rel.coef, rel.ec_r), i
        if rel.ladder_k is not None:
            assert _zero_past_r(rel.ladder_coef, rel.ladder_r), i


def test_make_churn_params_and_init_state_carries_match_reference():
    """`make_churn_params`, and the key / RelState / FaultCarry a fresh
    `init_state` starts from, equal the reference's."""
    churned = np.array([True, False, True, True])
    _tuple_close(TF.make_churn_params(4, mean_on=3e4, mean_off=2e5,
                                      churned=churned, device="cpu"),
                 RF.make_churn_params(4, mean_on=3e4, mean_off=2e5,
                                      churned=jnp.asarray(churned)),
                 "churn", rtol=0.0, atol=0.0)
    _tuple_close(TF.make_churn_params(2, mean_on=1.0, mean_off=2.0,
                                      device="cpu"),
                 RF.make_churn_params(2, mean_on=1.0, mean_off=2.0),
                 "churn default", rtol=0.0, atol=0.0)
    ref, port = _ref_fs(), _port_fs()
    s_r = RF.init_state(ref.params, ref.net.n_links, n_paths=4,
                        split0=RL.uniform_split(ref.net), seed=11,
                        rel=ref.rel, fault=ref.fault)
    s_p = TF.init_state(port.params, port.net.n_links, n_paths=4,
                        split0=TL.uniform_split(port.net), seed=11,
                        rel=port.rel, fault=port.fault)
    _eq(s_p.key, np.asarray(s_r.key).astype(np.int64), "key")
    _tuple_close(s_p.rel, s_r.rel, "rel", rtol=0.0, atol=0.0)
    _tuple_close(s_p.fault, _to_port(s_r.fault, TFa.FaultCarry), "fault")


def test_recovery_split_matches_reference_and_zero_loss_is_exact():
    rng = np.random.default_rng(1)
    n = 64
    ref, port = _rel_pair(n, rng)
    st_r, st_p = _rel_state(port, n, rng)
    q = rng.uniform(0, 0.3, n).astype(np.float32)
    q[::5] = 0.0
    q[1] = 1.0
    for st in ((None, None), (st_r, st_p)):
        rec_r, nack_r = jax.jit(RR.recovery_split)(ref, jnp.asarray(q),
                                                   st[0])
        rec_p, nack_p = TR.recovery_split(port, _t(q), st[1])
        _close(rec_p, rec_r, "recovered")
        _close(nack_p, nack_r, "nack")
        zero = q == 0.0
        assert (rec_p.numpy()[zero] == 0.0).all()
        assert (nack_p.numpy()[zero] == 0.0).all()
        off = ~port.enabled.numpy()
        assert (rec_p.numpy()[off] == 0.0).all()
    _close(TR.effective_eff(port, st_p), RR.effective_eff(ref, st_r), "eff")


def test_rel_epoch_matches_reference():
    rng = np.random.default_rng(2)
    n = 64
    ref, port = _rel_pair(n, rng)
    st_r, st_p = _rel_state(port, n, rng)
    rate = rng.uniform(0, 12.5, n).astype(np.float32)
    rtt = rng.choice([14e3, 2e6], n).astype(np.float32)
    loss = rng.uniform(0, 0.08, n).astype(np.float32)
    loss[::4] = 0.0
    dt = np.float32(14e3)
    rtx_r = jax.jit(RR.rtx_rate)(ref, st_r, jnp.asarray(rate),
                                 jnp.asarray(rtt))
    rtx_p = TR.rtx_rate(port, st_p, _t(rate), _t(rtt))
    _close(rtx_p, rtx_r, "rtx")
    want = jax.jit(RR.rel_epoch)(ref, st_r, jnp.asarray(rate), rtx_r,
                                 jnp.asarray(rate) + rtx_r,
                                 jnp.asarray(loss), jnp.asarray(dt),
                                 jnp.asarray(rtt))
    got = TR.rel_epoch(port, st_p, _t(rate), rtx_p, _t(rate) + rtx_p,
                       _t(loss), torch.tensor(dt), _t(rtt))
    _tuple_close(got[0], want[0], "rel_state")
    _eq(got[1], want[1], "cut")
    _close(got[2], want[2], "recovered")
    assert bool(got[1].any()) and bool((got[0].rung != st_p.rung).any())


def _schedule(M, device=None):
    cap = [(0, 2, 9, 0.0, 0, 0.0), (2, 0, None, 0.4, 0, 0.0),
           (3, 1, 30, 0.0, 4, 0.5), (0, 5, 7, 0.3, 0, 0.0)]
    ge = [(1, 0, None, 0.0, 0.3, 0.3, 0.4), (4, 3, 20, 0.01, 0.5, 0.5, 0.2),
          (1, 6, 25, 0.0, 0.9, 0.6, 0.5)]
    if M is RFa:
        return M.make_schedule(cap, ge)
    return M.make_schedule(cap, ge, device=device)


def _small_net(M, path_table=False):
    rng = np.random.default_rng(3)
    n_links = 6
    routes = rng.integers(-1, n_links, (9, 3, 3)).astype(np.int32)
    routes[:, 0, 0] = rng.integers(0, n_links, 9)
    cap = rng.uniform(1, 20, n_links).astype(np.float32)
    qcap = rng.uniform(10, 1000, n_links).astype(np.float32)
    p_loss = rng.uniform(0, 0.05, n_links).astype(np.float32)
    if M is RL:
        arr = jnp.asarray
        net = RL.FluidNet(cap=arr(cap), qcap=arr(qcap), ecn_lo=arr(qcap),
                          ecn_hi=arr(qcap), drain=arr(0.9 * cap),
                          vcap=arr(qcap), use_phantom=arr(np.zeros(6, bool)),
                          routes=arr(routes), dt=jnp.float32(1.0),
                          p_loss=arr(p_loss))
        return RL.with_layout(net, path_table=path_table)
    net = TL.FluidNet(cap=_t(cap), qcap=_t(qcap), ecn_lo=_t(qcap),
                      ecn_hi=_t(qcap), drain=_t(0.9 * cap), vcap=_t(qcap),
                      use_phantom=torch.zeros(6, dtype=torch.bool),
                      routes=_t(routes), dt=torch.tensor(1.0),
                      p_loss=_t(p_loss))
    return TL.with_layout(net, path_table=path_table)


def test_fault_modulation_apply_and_degrade_match_reference():
    """40 epochs of every event kind on one schedule (flaps, overlapping
    events on one link, windowed and open chains): the capacity and loss
    modulation, the carry (epoch, chains, key) bitwise, the modulated net
    and the degraded split on flat and PathTable nets."""
    sch_r, sch_p = _schedule(RFa), _schedule(TFa, "cpu")
    _tuple_close(sch_p, sch_r, "schedule", rtol=0.0, atol=0.0)
    c_r, c_p = RFa.init_fault_carry(sch_r, 7), TFa.init_fault_carry(sch_p, 7)
    _tuple_close(c_p, _to_port(c_r, TFa.FaultCarry), "carry0")
    net_r = _small_net(RL)
    nets_p = [_small_net(TL), _small_net(TL, path_table=True)]
    mod = jax.jit(RFa.fault_modulation, static_argnums=2)
    degrade = jax.jit(RFa.degrade_split)
    rng = np.random.default_rng(4)
    split = rng.uniform(0, 1, (9, 3)).astype(np.float32)
    mask = (np.asarray(net_r.routes) >= 0).any(axis=2)
    split = (split * mask) / (split * mask).sum(1, keepdims=True)
    seen_down = seen_bad = False
    for ep in range(40):
        cs_r, pe_r, c_r = mod(sch_r, c_r, 6)
        cs_p, pe_p, c_p = TFa.fault_modulation(sch_p, c_p, 6)
        _eq(cs_p, cs_r, f"cap_scale {ep}")
        _eq(pe_p, pe_r, f"p_extra {ep}")
        _tuple_close(c_p, _to_port(c_r, TFa.FaultCarry), f"carry {ep}")
        e_r = RFa.apply_modulation(net_r, cs_r, pe_r)
        for net_p in nets_p:
            e_p = TFa.apply_modulation(net_p, cs_p, pe_p)
            for f in ("cap", "drain", "p_loss"):
                _close(getattr(e_p, f), getattr(e_r, f), f"{f} {ep}")
            _close(TFa.degrade_split(net_p, _t(split), cs_p,
                                     TL.path_mask(net_p)),
                   degrade(net_r, jnp.asarray(split), cs_r,
                           RL.path_mask(net_r)), f"degrade {ep}")
        seen_down |= bool((cs_p == 0.0).any())
        seen_bad |= bool(c_p.ge_bad.any())
    assert seen_down and seen_bad


# ------------------------------------------------- trajectories, bitwise

def test_churn_and_burst_trajectories_bitwise_equal_reference():
    """The churn `active` mask and the burst chains' `ge_bad` state of
    every one of 600 epochs equal the reference's bit for bit."""
    kw = dict(inter_rel=None, wan_p_loss=0.0,
              faults=(RS.FaultSpec("wan1", "burst", loss_rate=2e-2,
                                   burst=0.3),
                      RS.FaultSpec("wan2", "burst", t_start=2 * MS,
                                   loss_rate=5e-2, burst=0.5)))
    ref = RS.to_fleetsim(_dumbbell(RS, **kw))
    kw["faults"] = tuple(TS.FaultSpec(*f) for f in kw["faults"])
    port = TS.to_fleetsim(_dumbbell(TS, **kw), device="cpu")
    step_r = jax.jit(RF.make_step(ref.net, ref.params, "uno", ref.is_inter,
                                  lb=ref.lb, churn=ref.churn,
                                  fault=ref.fault))
    step_p = TF.make_step(port.net, port.params, "uno", port.is_inter,
                          lb=port.lb, churn=port.churn, fault=port.fault)
    s_r = RF.cc._default_state(ref.net, ref.params, ref.seed, None,
                               ref.fault)
    s_p = TF.cc._default_state(port.net, port.params, port.seed, None,
                               port.fault)
    act, bad = [], []
    for ep in range(600):
        s_r, _ = step_r(s_r, None)
        s_p, _ = step_p(s_p)
        _eq(s_p.active, s_r.active, f"active {ep}")
        _eq(s_p.fault.ge_bad, s_r.fault.ge_bad, f"ge_bad {ep}")
        act.append(s_p.active.numpy())
        bad.append(s_p.fault.ge_bad.numpy())
    _eq(s_p.key, np.asarray(s_r.key).astype(np.int64), "churn key")
    _eq(s_p.fault.key, np.asarray(s_r.fault.key).astype(np.int64),
        "chain key")
    act, bad = np.array(act), np.array(bad)
    assert 0.2 < act.mean() < 0.9 and bad[:, 0].any() and bad[:, 1].any()


# ------------------------------------------------------ whole runs

@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_steady_state_with_all_axes_matches_reference(backend):
    """Churn + adaptive EC + WAN loss + a down window and a burst: the
    mean goodput within rtol 1e-4 / atol 1e-5 of the reference, the final
    masks, keys, chains and rungs equal.  "cuda" runs the kernel
    backends' plain versions on the CPU."""
    ref, port = _ref_fs(), _port_fs()
    run = dict(n_warm=300, n_meas=200)
    s_r, g_r = RF.steady_state(ref.net, ref.params, **run, **_axes(ref))
    s_p, g_p = TF.steady_state(port.net, port.params, backend=backend,
                               **run, **_axes(port))
    _close(g_p, g_r, "goodput", rtol=1e-4, atol=1e-5)
    _close(s_p.cwnd, s_r.cwnd, "cwnd", rtol=1e-4, atol=1e-5)
    _eq(s_p.active, s_r.active, "active")
    _eq(s_p.rel.rung, s_r.rel.rung, "rung")
    _eq(s_p.fault.ge_bad, s_r.fault.ge_bad, "ge_bad")
    _eq(s_p.fault.epoch, s_r.fault.epoch, "epoch")
    _close(s_p.rel.lost_bytes, s_r.rel.lost_bytes, "lost", rtol=1e-3,
           atol=1.0)
    assert float(s_p.rel.lost_bytes.sum()) > 0.0
    assert torch.isfinite(g_p).all()


def test_zero_loss_rel_step_equals_static_ec_step():
    """The reference's contract: with no loss anywhere the reliability
    machine is inert, its goodput trajectory bitwise the static-EC one,
    and it agrees with the reference's."""
    kw = dict(qcap=512 * 1024 * 1024, seed=3)
    trajs = {}
    for name, extra in (("rel", lambda M: dict(inter_rel=M.RelSpec())),
                        ("static", lambda M: dict(inter_lb=M.LbSpec(
                            kind="rps", n_subflows=8, ec=(8, 2))))):
        fs = TS.to_fleetsim(TS.dumbbell_scenario(0, 4, **kw, **extra(TS)),
                            device="cpu")
        final, traj = TF.simulate(fs.net, fs.params, n_epochs=1500,
                                  record=True, **_axes(fs))
        trajs[name] = traj
        if name == "rel":
            assert fs.rel is not None
            for f in ("pending", "backlog", "rtx_bytes", "rec_bytes",
                      "lost_bytes", "nacks"):
                assert float(getattr(final.rel, f).abs().sum()) == 0.0, f
            ref = RS.to_fleetsim(RS.dumbbell_scenario(0, 4, **kw,
                                                      **extra(RS)))
            _, t_r = RF.simulate(ref.net, ref.params, n_epochs=1500,
                                 record=True, **_axes(ref))
            _close(traj, t_r, "vs reference", rtol=1e-4, atol=1e-5)
    _eq(trajs["rel"], trajs["static"], "rel vs static EC")


def test_sharded_stacked_with_all_axes_matches_single_device():
    """Two stacked shards with churn, the EC ladder and faults: the churn
    masks, keys, fault carry and rungs equal the single-device run's, the
    rates within the reference's multipath sharded bar (1e-4)."""
    fs = _port_fs()
    run = dict(n_warm=200, n_meas=100, **_axes(fs))
    s1, g1 = TF.steady_state(fs.net, fs.params, **run)
    s2, g2 = TSH.steady_state_sharded(fs.net, fs.params, n_shards=2, **run)
    assert float((g2 - g1).abs().max()) < 1e-4
    _eq(s2.active, s1.active, "active")
    _eq(s2.key, s1.key, "key")
    _eq(s2.rel.rung, s1.rel.rung, "rung")
    for f in TFa.FaultCarry._fields:
        _eq(getattr(s2.fault, f), getattr(s1.fault, f), f"fault.{f}")
    _close(s2.rel.backlog, s1.rel.backlog, "backlog", rtol=1e-4, atol=1.0)
    with pytest.raises(ValueError, match="rel"):
        TSH.steady_state_sharded(fs.net, fs.params, n_shards=2,
                                 state0=s1._replace(rel=None), **run)


_FAT = dict(k=4, n_wan=4, n_flows=40, n_paths=4, seed=2)

_RANK = r"""
import datetime, json, sys
import numpy as np, torch
import torch.distributed as dist
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
sys.path.insert(0, sys.argv[4])
import test_torch_dynamics as T
from repro_torch.fleetsim import shard as SH
fs = T._fat_tree_fs()
st, g = SH.steady_state_sharded(fs.net, fs.params, group=dist.group.WORLD,
                                link_tier=fs.link_tier, **T._FAT_RUN,
                                **T._axes(fs))
if rank == 0:
    np.savez(out, **T._flat_state(st), rates=g.numpy())
dist.destroy_process_group()
print("ok")
"""
_FAT_RUN = dict(n_warm=100, n_meas=50)


def _fat_tree_fs():
    """A k=4 fat tree with churn, the EC ladder on its inter group, the
    first WAN link down from 0.3 to 0.9 ms and a burst on the second."""
    spec = TS.fat_tree_spec(**_FAT, intra_churn=TS.ChurnSpec(7e4, 7e4),
                            inter_churn=TS.ChurnSpec(2e5, 2e5))
    wan = [l.name for l in spec.links if l.wan]
    groups = tuple(g._replace(rel=TS.RelSpec(**LADDER)) if g.inter else g
                   for g in spec.groups)
    spec = spec._replace(groups=groups, faults=(
        TS.FaultSpec(wan[0], "down", t_start=3e5, t_end=9e5),
        TS.FaultSpec(wan[1], "burst", loss_rate=5e-2, burst=0.5)))
    return TS.to_fleetsim(spec, device="cpu")


def _flat_state(st):
    out = {}
    for f, v in st._asdict().items():
        if hasattr(v, "_fields"):
            out.update({f"{f}_{g}": w.numpy() for g, w in v._asdict().items()})
        elif v is not None:
            out[f] = v.numpy()
    return out


def test_dist_gloo_with_all_axes_bitwise_equal_stacked(tmp_path):
    """One shard per rank over gloo, each rank advancing its own copy of
    the churn key and the fault carry: bitwise the stacked runner's
    rates and final state (RelState and FaultCarry included)."""
    out = tmp_path / "dist.npz"
    init = f"file://{tmp_path / 'rendezvous'}"
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(out), here],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ)) for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            errs.append(err[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    got = dict(np.load(out))
    fs = _fat_tree_fs()
    st, g = TSH.steady_state_sharded(fs.net, fs.params, n_shards=2,
                                     link_tier=fs.link_tier, **_FAT_RUN,
                                     **_axes(fs))
    want = _flat_state(st)
    assert set(got) == set(want) | {"rates"}
    _eq(got["rates"], g, "rates")
    for k, v in want.items():
        _eq(got[k], v, k)
    assert int(got["fault_epoch"]) == sum(_FAT_RUN.values())


def test_reference_state_mid_run_continues_in_port(tmp_path):
    """A reference scenario written as a service bundle (its rel_* and
    fault_* families included) and a reference FleetState taken after 250
    epochs (uint32 churn key, RelState, FaultCarry) load into the port;
    250 more epochs from there match the reference's."""
    ref = _ref_fs()
    state, _ = RF.simulate(ref.net, ref.params, n_epochs=250, **_axes(ref))
    path = RSV.save_bundle(tmp_path / "bundle.npz", ref)
    with np.load(path, allow_pickle=False) as z:
        port = carry.scenario_from_arrays(z, device="cpu")
    for f in ("churn", "rel", "fault"):
        assert getattr(port, f) is not None, f
    arrays = {}
    for f in state._fields:
        v = getattr(state, f)
        if hasattr(v, "_fields"):
            arrays.update({f"{f}_{g}": np.asarray(w)
                           for g, w in v._asdict().items()})
        else:
            arrays[f] = np.asarray(v)
    assert arrays["key"].dtype == np.uint32
    state_p = carry.state_from_arrays(arrays, device="cpu")
    assert state_p.key.dtype == torch.int64
    assert state_p.fault.epoch.shape == () and int(state_p.fault.epoch) == 250
    run = dict(n_epochs=250, record=True)
    s_r, t_r = RF.simulate(ref.net, ref.params, state0=state, **run,
                           **_axes(ref))
    s_p, t_p = TF.simulate(port.net, port.params, state0=state_p, **run,
                           **_axes(port))
    _close(t_p, t_r, "trajectory", rtol=1e-4, atol=1e-5)
    _eq(s_p.active, s_r.active, "active")
    _eq(s_p.key, np.asarray(s_r.key).astype(np.int64), "key")
    _eq(s_p.fault.ge_bad, s_r.fault.ge_bad, "ge_bad")
    _eq(s_p.rel.rung, s_r.rel.rung, "rung")
