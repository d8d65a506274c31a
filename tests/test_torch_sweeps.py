"""The port's scenario sweeps (`repro_torch.fleetsim.sweeps`) against the
JAX reference's (`repro.fleetsim.sweeps`).

The port steps a grid of B cells as one fluid net of B·F flows and B·L
links (block-diagonal routes, per-cell keys, chains and ladders); the
reference vmaps one simulation over the stacked cells.  Held here:

  * `links.dumbbell` bitwise against the reference's;
  * batched `prng.split` / `uniform` / `fold_in` bitwise against one
    draw per key and against `jax.vmap` of `jax.random`'s, in one
    threefry2x32 call whatever the batch;
  * `run_grid` per cell within rtol 1e-4 / atol 1e-5 of the reference's
    `run_grid` on the same cells (single-path and multipath dumbbells
    with an lb axis; a churned grid, masks and keys bitwise; a rel +
    fault grid with per-cell ladders, chains and keys bitwise, rungs
    equal);
  * the five concrete sweeps against the reference's at their own
    tests' sizes, 2,000 epochs, every output key (config dicts equal);
  * `run_grid` per cell bitwise equal to the port's `steady_state` of the
    cell alone on the CPU (plain and kernel backends' CPU path);
  * a grid of two `dt` values equal to two grids, in order;
    `run_grid_streamed` equal to `run_grid`, padding dropped;
  * a grid epoch makes as many threefry2x32 calls and fleet-kernel calls
    as one cell's, whatever B;
  * the refusals: mixed axes, mismatched PathTables (warned, flat),
    unknown fault kinds, differing ladder lengths, a sharded grid with
    no shard count (`tests/test_torch_sharded_grid.py` holds the
    sharded grid).

The reference runs under `jax.jit` (its `run_grid` jits itself)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import links as RL  # noqa: E402
from repro.fleetsim import sweeps as RW  # noqa: E402

import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import prng  # noqa: E402
from repro_torch.fleetsim import sweeps as TW  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402

US, MS = 1e3, 1e6
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))
RUN = dict(n_warm=300, n_meas=200)
SWEEP_EPOCHS = dict(n_warm=1_600, n_meas=400)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _eq(got, want, what):
    want = _np(want)
    if want.dtype == np.uint32:         # PRNG key words: int64 in the port
        want = want.astype(np.int64)
    np.testing.assert_array_equal(_np(got), want, err_msg=what)


def _states_equal(a, b, what):
    """Two port FleetStates bitwise equal, nested carries included."""
    for f, v in a._asdict().items():
        w = getattr(b, f)
        if hasattr(v, "_fields"):
            _states_equal(v, w, f"{what}.{f}")
        elif v is None:
            assert w is None, (what, f)
        else:
            assert torch.equal(v, w), f"{what}.{f}"


# ------------------------------------------------------------ builders

@pytest.mark.parametrize("kw", [
    dict(n_intra=3, n_inter=2),
    dict(n_intra=2, n_inter=3, multipath=True, n_wan=4, n_bottleneck=2),
    dict(n_intra=0, n_inter=5, phantom=False, qcap=64 * 1024,
         red_lo_frac=0.85, red_hi_frac=0.98, epoch_period_frac=0.5),
])
def test_dumbbell_matches_reference(kw):
    kw = dict(kw)
    a, b = kw.pop("n_intra"), kw.pop("n_inter")
    net_r, bdp_r, rtt_r = RL.dumbbell(a, b, **kw)
    net_p, bdp_p, rtt_p = TL.dumbbell(a, b, device="cpu", **kw)
    _eq(bdp_p, bdp_r, "bdp")
    _eq(rtt_p, rtt_r, "rtt")
    for f in net_r._fields:
        v = getattr(net_r, f)
        if f == "layout":
            for g in TL.RouteLayout._fields:
                want = getattr(v, g)
                if want is None:
                    assert getattr(net_p.layout, g) is None, g
                else:
                    _eq(getattr(net_p.layout, g), want, f"layout.{g}")
        elif v is None:
            assert getattr(net_p, f) is None, f
        else:
            _eq(getattr(net_p, f), v, f)
    assert "dumbbell" in TF.__all__


# ------------------------------------------------------------ batched PRNG

def test_batched_prng_matches_single_draws_and_vmap():
    """(B, 2) keys: split, fold_in and uniform bitwise equal to B single
    draws and to jax.vmap of jax.random's, one threefry2x32 call each."""
    seeds = [0, 1, 7, 2 ** 31 - 1, 2 ** 32 + 5]
    keys = prng.PRNGKey(seeds, "cpu")
    assert keys.shape == (5, 2)
    ref_keys = jnp.stack([jax.random.PRNGKey(s & 0xFFFFFFFF)
                          for s in seeds])
    _eq(keys, ref_keys, "keys")
    prng.reset_calls()
    sp = prng.split(keys, 3)
    fi = prng.fold_in(keys, 0xFA)
    u = prng.uniform(keys, (4, 257))
    assert prng.CALLS["threefry2x32"] == 3
    assert sp.shape == (5, 3, 2) and fi.shape == (5, 2) and \
        u.shape == (5, 4, 257)
    _eq(sp, jax.vmap(lambda k: jax.random.split(k, 3))(ref_keys), "split")
    _eq(fi, jax.vmap(lambda k: jax.random.fold_in(k, 0xFA))(ref_keys),
        "fold_in")
    _eq(u, jax.vmap(lambda k: jax.random.uniform(k, (4, 257)))(ref_keys),
        "uniform")
    for i, s in enumerate(seeds):
        k = prng.PRNGKey(s, "cpu")
        assert torch.equal(prng.split(k, 3), sp[i])
        assert torch.equal(prng.fold_in(k, 0xFA), fi[i])
        assert torch.equal(prng.uniform(k, (4, 257)), u[i])
        assert torch.equal(prng.random_bits(k, (9,)),
                           prng.random_bits(keys, (9,))[i])


# ------------------------------------------------------------ run_grid

def _grid(M, kind):
    """The cells of one grid, built by the reference's (`M is RS`) or the
    port's scenario layer."""
    dev = {} if M is RS else dict(device="cpu")
    cells = []
    if kind == "single_lb":
        for ratio, drain in ((2.0, 0.8), (10.0, 0.9), (50.0, 0.95)):
            cells.append(M.to_fleetsim(M.dumbbell_scenario(
                2, 3, n_bottleneck=2, inter_rtt=ratio * 14 * US,
                drain_frac=drain, inter_lb=M.LbSpec(
                    kind="rps", n_subflows=8, ec=(8, 2))), **dev))
    elif kind == "multipath_lb":
        for ratio, drain in ((2.0, 0.8), (20.0, 0.9), (140.0, 0.95)):
            cells.append(M.to_fleetsim(M.dumbbell_scenario(
                2, 3, multipath=True, n_wan=3, inter_rtt=ratio * 14 * US,
                drain_frac=drain), **dev))
    elif kind == "churn":
        for on, off in ((20.0, 20.0), (50.0, 200.0), (300.0, 30.0)):
            cells.append(M.to_fleetsim(M.dumbbell_scenario(
                3, 3, multipath=True, n_wan=2,
                intra_churn=M.ChurnSpec(on * 14 * US, off * 14 * US),
                inter_churn=M.ChurnSpec(on * 50 * US, off * 50 * US)),
                **dev))
    else:                   # rel_fault: per-cell ladders and fault windows
        ladders = (LADDER, dict(ladder=((8, 2), (8, 4), (8, 8))),
                   dict(ladder=((8, 1), (8, 1), (8, 2)),
                        ladder_up=(0.004, 0.004, 1.0)))
        for i, lad in enumerate(ladders):
            cells.append(M.to_fleetsim(M.dumbbell_scenario(
                3, 4, multipath=True, n_wan=3, wan_p_loss=1e-3, seed=1,
                intra_churn=M.ChurnSpec(50 * 14 * US, 50 * 14 * US),
                inter_churn=M.ChurnSpec(1 * MS, 1 * MS),
                inter_rel=M.RelSpec(**lad),
                faults=(M.FaultSpec("wan0", "down", t_start=(1 + i) * MS,
                                    t_end=(3 + i) * MS),
                        M.FaultSpec("wan1", "burst", loss_rate=2e-2 * (i + 1),
                                    burst=0.3))), **dev))
    return cells


GRIDS = ("single_lb", "multipath_lb", "churn", "rel_fault")


@pytest.mark.parametrize("kind", GRIDS)
def test_run_grid_matches_reference(kind):
    """Per cell: rates and final cwnd within rtol 1e-4 / atol 1e-5 of the
    reference's run_grid; churn masks, keys, burst chains, chain keys,
    epoch counters and rungs bitwise; every leaf with its cell axis."""
    f_r, r_r = RW.run_grid(_grid(RS, kind), seed=5, **RUN)
    f_p, r_p = TW.run_grid(_grid(TS, kind), seed=5, **RUN)
    assert tuple(r_p.shape) == tuple(r_r.shape)
    _close(r_p, r_r, "rates")
    _close(f_p.cwnd, f_r.cwnd, "cwnd")
    _close(f_p.split, f_r.split, "split")
    for f in ("active", "key", "cc_countdown", "qa_countdown"):
        _eq(getattr(f_p, f), getattr(f_r, f), f)
    for f in f_r._fields:
        v = getattr(f_r, f)
        if v is not None and not hasattr(v, "_fields"):
            assert tuple(getattr(f_p, f).shape) == tuple(np.shape(v)), f
    if kind == "churn":
        assert 0.1 < float(f_p.active.float().mean()) < 0.95
    if kind == "rel_fault":
        _eq(f_p.rel.rung, f_r.rel.rung, "rung")
        for f in ("epoch", "ge_bad", "key"):
            _eq(getattr(f_p.fault, f), getattr(f_r.fault, f), f"fault.{f}")
        _close(f_p.rel.lost_bytes, f_r.rel.lost_bytes, "lost", rtol=1e-3,
               atol=1.0)
        # the cells' ladders differ: each flow reads its own cell's
        assert TW.stack_scenarios(_grid(TS, kind)).rel.ladder_k.shape == \
            (3, 3)
        assert bool((f_p.rel.rung > 0).any())


@pytest.mark.parametrize("kind,backend", [
    ("multipath_lb", "reference"), ("multipath_lb", "cuda"),
    ("churn", "reference"), ("rel_fault", "cuda")])
def test_run_grid_cell_bitwise_equals_cell_alone(kind, backend):
    """On the CPU every cell of a grid is bitwise the port's own
    steady_state of that cell alone, seeded `seed + i` (the kernel
    backends' CPU path included): block-diagonal links keep each link's
    entries, and their order, the cell's own."""
    cells = _grid(TS, kind)
    run = dict(n_warm=150, n_meas=100)
    final, rates = TW.run_grid(cells, seed=3, backend=backend, **run)
    for i, fs in enumerate(cells):
        st, g = TF.steady_state(fs.net, fs.params, is_inter=fs.is_inter,
                                lb=fs.lb, churn=fs.churn, rel=fs.rel,
                                fault=fs.fault, seed=3 + i,
                                backend=backend, **run)
        assert torch.equal(rates[i], g), i
        _states_equal(TW._map(lambda v, j=i: v[j], final), st, f"cell {i}")


def test_run_grid_groups_dt_in_submission_order():
    """Cells of two dt values: the same as one grid per dt, results back
    in cell order."""
    def cell(frac, drain):
        return TS.to_fleetsim(TS.dumbbell_scenario(
            2, 2, multipath=True, n_wan=2, epoch_period_frac=frac,
            drain_frac=drain, intra_churn=TS.ChurnSpec(7e5, 7e5)),
            device="cpu")
    cells = [cell(1.0, 0.8), cell(0.5, 0.9), cell(1.0, 0.95),
             cell(0.5, 0.85)]
    final, rates = TW.run_grid(cells, seed=11, **RUN)
    fa, ra = TW.run_grid([cells[0], cells[2]], seeds=[11, 13], **RUN)
    fb, rb = TW.run_grid([cells[1], cells[3]], seeds=[12, 14], **RUN)
    for i, (f, r, j) in enumerate(((fa, ra, 0), (fb, rb, 0), (fa, ra, 1),
                                   (fb, rb, 1))):
        assert torch.equal(rates[i], r[j]), i
        _states_equal(TW._map(lambda v: v[i], final),
                      TW._map(lambda v: v[j], f), f"cell {i}")
    with pytest.raises(ValueError, match="dt"):
        TW.stack_scenarios(cells)
    # one dt: block-diagonal routes, each cell's flows on its own links
    g = TW.stack_scenarios([cells[0], cells[2]])
    assert (g.n_cells, g.flow_offsets) == (2, [0, 4])
    nl = cells[0].net.n_links
    assert g.link_offsets == [0, nl] and g.net.n_links == 2 * nl
    for b, (f0, l0) in enumerate(zip(g.flow_offsets, g.link_offsets)):
        r = g.net.routes[f0:f0 + g.cell_flows]
        assert torch.equal(torch.where(r >= 0, r - l0, r),
                           cells[2 * b].net.routes)


def test_run_grid_streamed_matches_run_grid():
    """Chunks of 2 over 5 cells: indices in order, the padded replica
    dropped, each cell bitwise its run_grid row (seed + i kept)."""
    cells = _grid(TS, "churn") + _grid(TS, "churn")[:2]
    final, rates = TW.run_grid(cells, seed=4, **RUN)
    got = list(TW.run_grid_streamed(cells, chunk=2, seed=4, **RUN))
    assert [i for i, _, _ in got] == [0, 1, 2, 3, 4]
    for i, st, r in got:
        assert torch.equal(r, rates[i]), i
        _states_equal(st, TW._map(lambda v, j=i: v[j], final), f"cell {i}")
    assert list(TW.run_grid_streamed([], chunk=2)) == []


def test_grid_epoch_calls_as_many_kernels_and_draws_as_one_cell(
        monkeypatch):
    """A grid of 1 and a grid of 4 cells call the flow -> link scatter
    and the link -> flow gathers (the fleet kernels on a card) once per
    epoch, and threefry2x32 four times per epoch (the churn split and
    draw, the chains' split and draw) plus once at the start (the chain
    keys' fold_in), whatever B."""
    calls = {"scatter": 0, "gathers": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(fleet_cuda, "link_scatter",
                        counted("scatter", fleet_cuda.link_scatter))
    monkeypatch.setattr(fleet_cuda, "link_gathers",
                        counted("gathers", fleet_cuda.link_gathers))
    cells = _grid(TS, "rel_fault")
    per_epoch = []
    for grid in ([cells[0]], cells + cells[:1]):
        for k in calls:
            calls[k] = 0
        prng.reset_calls()
        TW.run_grid(grid, backend="cuda", n_warm=20, n_meas=10)
        per_epoch.append((calls["scatter"], calls["gathers"],
                          prng.CALLS["threefry2x32"]))
    assert per_epoch[0] == per_epoch[1] == (30, 30, 4 * 30 + 1)


# ------------------------------------------------------------ the sweeps

_SPAN = 2_000 * 14e3
SWEEPS = {
    "fairness_sweep": dict(rtt_ratios=[2, 50], drain_fracs=[0.8, 0.95]),
    "fairness_sweep_multipath": dict(rtt_ratios=[2, 50],
                                     drain_fracs=[0.8, 0.95],
                                     multipath=True, n_wan=4),
    "load_mix_sweep": dict(inter_counts=[0, 4], loads=[1.0, 2.0],
                           n_total=4),
    "churn_sweep": dict(duty_fracs=[0.2, 1.0], mean_on_rtts=[200.0],
                        n_flows=8, seed=3),
    "recovery_sweep": dict(overloads=[1.5, 3.0], ec_configs=[(8, 2), (8, 0)],
                           debounce_rtts=[0.0, 1.0], n_inter=64),
    "fault_sweep": dict(fail_times=[0.2 * _SPAN, 0.75 * _SPAN],
                        fault_kinds=["down", "burst"],
                        ec_policies=[((8, 2),), ((8, 1), (8, 2), (8, 4))],
                        n_inter=64, fault_rtts=5.0),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_reference(name):
    """Every output key of the port's sweep against the reference's at
    the reference tests' sizes (2,000 epochs): arrays within rtol 1e-4 /
    atol 1e-5 (the nack counts and rungs exactly), axes, tuples and
    config dicts equal."""
    fn = name.replace("_multipath", "")
    kw = dict(SWEEPS[name], **SWEEP_EPOCHS)
    want = getattr(RW, fn)(**kw)
    got = getattr(TW, fn)(device="cpu", **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (dict, tuple)):
            assert g == w, k
        elif k in ("nacks", "rung_mean") or k in {
                "rtt_ratios", "drain_fracs", "inter_counts", "loads",
                "duty_fracs", "mean_on_rtts", "overloads", "debounce_rtts",
                "fail_times", "expected_on"}:
            _eq(g, w, k)
            assert _np(g).dtype == np.asarray(w).dtype, k
        else:
            assert tuple(g.shape) == tuple(w.shape), k
            _close(g, w, k)
    assert bool(torch.isfinite(got["rates"]).all())
    if fn == "fault_sweep":
        assert float(got["rung_mean"].max()) > 0.0


# ------------------------------------------------------------ refusals

def _tiny(M, **kw):
    dev = {} if M is RS else dict(device="cpu")
    return M.to_fleetsim(M.dumbbell_scenario(2, 2, **kw), **dev)


@pytest.mark.parametrize("axis", ["lb", "churn", "rel", "fault"])
def test_mixed_axes_raise(axis):
    extra = dict(
        lb=lambda M: dict(inter_lb=M.LbSpec(kind="rps", ec=(8, 2))),
        churn=lambda M: dict(intra_churn=M.ChurnSpec(7e5, 7e5)),
        rel=lambda M: dict(inter_rel=M.RelSpec()),
        fault=lambda M: dict(faults=(M.FaultSpec("down0", "down",
                                                 t_start=1e5),)))[axis]
    for M, W in ((RS, RW), (TS, TW)):
        cells = [_tiny(M), _tiny(M, **extra(M))]
        with pytest.raises(ValueError, match=f"{axis} must be set on all "
                           "scenarios or none"):
            W.run_grid(cells, n_warm=2, n_meas=1)


def test_stack_refusals():
    """Differing ladder lengths, fault event counts or shapes; a sharded
    grid given neither a shard count nor a process group; an empty
    grid."""
    a = _tiny(TS, inter_rel=TS.RelSpec(ladder=((8, 1), (8, 2))))
    b = _tiny(TS, inter_rel=TS.RelSpec(ladder=((8, 1), (8, 2), (8, 4))))
    with pytest.raises(ValueError, match="ladder"):
        TW.stack_scenarios([a, b])
    one = _tiny(TS, faults=(TS.FaultSpec("down0", "down", t_start=1e5),))
    two = _tiny(TS, faults=(TS.FaultSpec("down0", "down", t_start=1e5),
                            TS.FaultSpec("wan", "down", t_start=2e5)))
    with pytest.raises(ValueError, match="fault event"):
        TW.stack_scenarios([one, two])
    with pytest.raises(ValueError, match="shape"):
        TW.stack_scenarios([_tiny(TS), TS.to_fleetsim(
            TS.dumbbell_scenario(3, 2), device="cpu")])
    with pytest.raises(ValueError, match="n_shards or a process group"):
        TW.shard_grid(TW.stack_scenarios([_tiny(TS)] * 2, layout=False))
    with pytest.raises(ValueError):
        TW.run_grid([], n_warm=1, n_meas=1)


def test_fault_sweep_rejects_unknown_kind():
    with pytest.raises(ValueError, match="fault kind"):
        TW.fault_sweep([1e6], ["comet"], [((8, 2),)], n_inter=4,
                       n_warm=10, n_meas=10, device="cpu")


def _deep_nets():
    """Two nets of one route shape whose PathTables differ in shape (the
    reference's `test_stack_scenarios_strips_mismatched_tables`)."""
    rng = np.random.default_rng(41)
    deep_a = np.tile(np.arange(24, dtype=np.int32).reshape(4, 6), (8, 1, 1))
    deep_b = np.tile(np.repeat(rng.integers(0, 24, (2, 6)).astype(np.int32),
                               2, axis=0), (8, 1, 1))
    cap = torch.as_tensor(rng.uniform(1.0, 20.0, 24).astype(np.float32))
    qcap = torch.as_tensor(rng.uniform(10.0, 1000.0, 24).astype(np.float32))
    base = TL.FluidNet(cap=cap, qcap=qcap, ecn_lo=0.25 * qcap,
                       ecn_hi=0.75 * qcap, drain=0.9 * cap, vcap=qcap,
                       use_phantom=torch.as_tensor(
                           rng.integers(0, 2, 24).astype(bool)),
                       routes=torch.as_tensor(deep_a), dt=torch.tensor(1.0))
    return [TL.with_layout(base._replace(routes=torch.as_tensor(r)),
                           path_table=True) for r in (deep_a, deep_b)]


def test_mismatched_path_tables_warn_and_fall_back_to_flat():
    na, nb = _deep_nets()
    assert na.layout.path_table.seg_idx.shape != \
        nb.layout.path_table.seg_idx.shape
    bdp = torch.full((8,), 1.4e5)
    p = TF.make_params(bdp, torch.full((8,), 14e3), 1.4e5, 14e3)
    # same-shape tables: the grid keeps one, over the block-diagonal
    # routes, and runs the PathTable backend
    g = TW.stack_scenarios([(na, p, None), (na, p, None)])
    assert g.net.layout.path_table is not None
    assert TL._resolve_backend(g.net, "auto") == "pt"
    assert g.net.layout.path_table.n_segments <= \
        2 * na.layout.path_table.n_segments
    _, r_pt = TW.run_grid([(na, p, None)] * 2, n_warm=50, n_meas=20)
    flat = na._replace(layout=na.layout._replace(path_table=None))
    _, r_flat = TW.run_grid([(flat, p, None)] * 2, n_warm=50, n_meas=20)
    _close(r_pt, r_flat, "pt vs flat", rtol=1e-5, atol=1e-6)
    with pytest.warns(UserWarning, match="mismatched"):
        mixed = TW._strip_unstackable_path_tables((na, nb))
    assert all(n.layout.path_table is None for n in mixed)
    with pytest.warns(UserWarning, match="mismatched"):
        g = TW.stack_scenarios([(na, p, None), (nb, p, None)])
    assert g.net.layout.path_table is None
    assert TL._resolve_backend(g.net, "auto") == "reference"
