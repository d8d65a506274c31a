"""The port's sharded scenario grid (`sweeps.run_grid(n_shards=...)`,
`shard.lift_plan`, `sweeps.shard_grid`) against the JAX reference's grids.

The reference's own sharded grid runs on a device mesh, which fails on
the installed jax (ROADMAP "Reference caveats"), so the port's sharded
grid is held against the reference's UNSHARDED grid under the reference's
own sharded-vs-vmap bars (`tests/test_faults.py:385`,
`tests/test_reliability.py:305`), and against the port's own unsharded
grid and single-cell sharded runs:

  * the lifted plan: cell b's block of it is the reference's
    `plan_shards` of cell 0 offset by b·F flows and b·L links, bitwise
    (a k = 4 fat tree that keeps its PathTable on both shards, and the
    lossy dumbbell, whose every link is boundary);
  * `run_grid(n_shards=2)` per cell against the reference's `run_grid`
    (dumbbells within 1e-5 x the rate scale; the fat tree within
    max(1e-4 x scale, 4x the reference's backend-swap divergence), the
    bar of `tests/test_torch_shard.py`), the same compiled grid under
    the neighbor exchange bitwise the grid's psum;
  * `fault_sweep` / `recovery_sweep` with `n_shards=2` against the
    reference's unsharded sweeps at the kwargs of its sharded tests (cut
    to 64 inter flows), <= 1e-5 per output key;
  * churn masks and keys, per-cell EC rungs, fault carries and explicit
    seeds bitwise the port's unsharded grid; each cell bitwise its own
    `steady_state_sharded` under the same cell-0 plan;
  * differing routes warn and run unsharded; `shard._with_exchange`
    equal to a fresh compile under the other exchange;
  * two gloo ranks (`group=`) bitwise the stacked shards.
"""
import contextlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import sweeps as RW  # noqa: E402

import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import shard as TSH  # noqa: E402
from repro_torch.fleetsim import sweeps as TW  # noqa: E402

US, MS = 1e3, 1e6
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))
FAT_TREE = dict(k=4, n_wan=4, n_flows=240, n_paths=4, seed=5)
ALL_HUB = ".*every hop of every flow is a hub"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def pt_always(monkeypatch):
    """Small fat trees carry a PathTable (the auto policy's bar off)."""
    monkeypatch.setattr(TL, "PT_MIN_COMPRESS", 0.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what):
    want = _np(want)
    if want.dtype == np.uint32:         # PRNG key words: int64 in the port
        want = want.astype(np.int64)
    np.testing.assert_array_equal(_np(got), want, err_msg=what)


def _states_equal(a, b, what):
    for f, v in a._asdict().items():
        w = getattr(b, f)
        if hasattr(v, "_fields"):
            _states_equal(v, w, f"{what}.{f}")
        elif v is None:
            assert w is None, (what, f)
        else:
            assert torch.equal(v, w), f"{what}.{f}"


def _cells(M, kind):
    """The cells of one identically routed grid, built by the reference's
    (`M is RS`) or the port's scenario layer."""
    dev = {} if M is RS else dict(device="cpu")
    if kind == "fat_tree":
        fs = M.to_fleetsim(M.fat_tree_spec(**FAT_TREE), **dev)
        # the drain what-if: the routes stay cell 0's
        return [fs, fs._replace(net=fs.net._replace(drain=fs.net.drain
                                                    * 0.9))]
    if kind == "lossy":
        return [M.to_fleetsim(M.dumbbell_scenario(
            0, 6, qcap=64 * 1024, phantom=False, red_lo_frac=0.85,
            red_hi_frac=0.98, inter_rtt=r * MS), **dev)
            for r in (1.0, 2.0, 4.0)]
    if kind == "multipath_lb":
        return [M.to_fleetsim(M.dumbbell_scenario(
            2, 3, multipath=True, n_wan=3, inter_rtt=r * 14 * US,
            drain_frac=d), **dev)
            for r, d in ((2.0, 0.8), (20.0, 0.9), (140.0, 0.95))]
    if kind == "churn":
        return [M.to_fleetsim(M.dumbbell_scenario(
            3, 3, multipath=True, n_wan=2,
            intra_churn=M.ChurnSpec(on * 14 * US, off * 14 * US),
            inter_churn=M.ChurnSpec(on * 50 * US, off * 50 * US)), **dev)
            for on, off in ((20.0, 20.0), (50.0, 200.0), (300.0, 30.0))]
    # rel_fault: per-cell EC ladders, fault windows and burst losses
    ladders = (LADDER, dict(ladder=((8, 2), (8, 4), (8, 8))),
               dict(ladder=((8, 1), (8, 1), (8, 2)),
                    ladder_up=(0.004, 0.004, 1.0)))
    return [M.to_fleetsim(M.dumbbell_scenario(
        3, 4, multipath=True, n_wan=3, wan_p_loss=1e-3, seed=1,
        intra_churn=M.ChurnSpec(50 * 14 * US, 50 * 14 * US),
        inter_churn=M.ChurnSpec(1 * MS, 1 * MS), inter_rel=M.RelSpec(**lad),
        faults=(M.FaultSpec("wan0", "down", t_start=(1 + i) * MS,
                            t_end=(3 + i) * MS),
                M.FaultSpec("wan1", "burst", loss_rate=2e-2 * (i + 1),
                            burst=0.3))), **dev)
        for i, lad in enumerate(ladders)]


def _run(cells, **kw):
    with _all_hub_ok():
        return TW.run_grid(cells, **kw)


def _nbr(cells, *, seed=0, n_shards=2, group=None, **run):
    """The sharded grid under the neighbor exchange: `run_grid`'s own
    steps (`shard_grid`, `_run_sharded`), the compiled grid switched from
    its psum by `shard._with_exchange`."""
    g = TW.stack_scenarios(cells, layout=False)
    with _all_hub_ok():
        sf = TW.shard_grid(g, n_shards=None if group else n_shards,
                           group=group, link_tier=cells[0].link_tier)
        return TW._run_sharded(g, TSH._with_exchange(sf, "nbr"),
                               TW._grid_seeds(len(cells), seed, None),
                               scheme="uno", backend="auto", **run)


@contextlib.contextmanager
def _all_hub_ok():
    """The dumbbells' plans deal flows round-robin, with the reference
    planner's warning (every hop of a dumbbell flow is a hub)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=ALL_HUB)
        yield


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("kind", ["fat_tree", "lossy"])
def test_lifted_plan_is_cell0_plan_offset_per_cell(kind, pt_always):
    """Cell b's rows of each shard and its links of each private range
    and of the boundary tail are the reference's cell-0 plan offset by
    b·F and b·L, bitwise; ownership and pairs scale with the cells."""
    ref = _cells(RS, kind)[0]
    cells = _cells(TS, kind)
    with _all_hub_ok():
        plan = RS.plan_shards(np.asarray(ref.net.routes), ref.net.n_links,
                              2, link_tier=ref.link_tier)
        g = TW.stack_scenarios(cells, layout=False)
        sf = TW.shard_grid(g, n_shards=2, link_tier=cells[0].link_tier)
    assert g.net.layout is None
    lifted = sf.plan
    B, F, nl = len(cells), g.cell_flows, g.cell_links
    rows, nb = plan.gather.shape[1], plan.n_boundary
    assert (lifted.n_real, lifted.n_links, lifted.n_boundary) == \
        (B * F, B * nl, B * nb)
    _eq(lifted.owner_ptr, B * plan.owner_ptr, "owner_ptr")
    base = nl - nb
    for b in range(B):
        blk = lifted.gather[:, b * rows:(b + 1) * rows]
        _eq(blk, np.where(plan.gather < F, plan.gather + b * F, B * F),
            f"cell {b} rows")
        for s in range(2):
            lo, hi = plan.owner_ptr[s], plan.owner_ptr[s + 1]
            at = B * lo + b * (hi - lo)
            _eq(lifted.new2old[at:at + hi - lo], plan.new2old[lo:hi] + b * nl,
                f"cell {b} shard {s} private links")
        at = B * base + b * nb
        _eq(lifted.new2old[at:at + nb], plan.new2old[base:] + b * nl,
            f"cell {b} boundary tail")
    _eq(lifted.old2new[lifted.new2old], np.arange(B * nl), "old2new")
    _eq(lifted.boundary_pairs, np.tile(plan.boundary_pairs, (B, 1)),
        "boundary_pairs")
    assert TSH.neighbor_halo(lifted) is not None
    if kind == "fat_tree":
        assert 0 < nb < nl
        assert all(lay.path_table is not None for lay in sf.layouts)
        assert TL._resolve_backend(sf.shard_net(0), "auto") == "pt"
    else:                       # every link of the dumbbell is boundary
        assert nb == nl


def test_with_exchange_equals_a_fresh_compile(pt_always):
    """`shard._with_exchange` switches a compiled grid's exchange: its
    ownership masks and neighbor table equal those of a fresh
    `shard_scenario` of the grid under that exchange and the same lifted
    plan, the compiled arrays shared."""
    cells = _cells(TS, "fat_tree")
    g = TW.stack_scenarios(cells, layout=False)
    psum = TW.shard_grid(g, n_shards=2, link_tier=cells[0].link_tier)
    fresh = {"psum": psum, "nbr": TSH.shard_scenario(
        g.net, g.params, is_inter=g.is_inter, lb=g.lb, churn=g.churn,
        rel=g.rel, fault=g.fault, n_shards=2, plan=psum.plan,
        exchange="nbr")}
    assert psum.nbr is None and fresh["nbr"].nbr is not None
    for src, dst in (("psum", "nbr"), ("nbr", "psum")):
        sw = TSH._with_exchange(fresh[src], dst)
        assert torch.equal(sw.own, fresh[dst].own), (src, dst)
        assert (sw.nbr is None) == (fresh[dst].nbr is None)
        if sw.nbr is not None:
            assert torch.equal(sw.nbr, fresh[dst].nbr)
        assert sw.layouts is fresh[src].layouts
    with pytest.raises(ValueError, match="unknown boundary exchange"):
        TSH._with_exchange(fresh["psum"], "ring")


# ------------------------------------------------------------ against the reference

@pytest.mark.parametrize("kind", ["multipath_lb", "lossy"])
def test_sharded_grid_matches_reference_grid_dumbbells(kind):
    """Rates per cell within 1e-5 x scale of the reference's unsharded
    grid, psum and nbr bitwise equal."""
    run = dict(n_warm=400, n_meas=200, seed=3)
    _, r_ref = RW.run_grid(_cells(RS, kind), **run)
    cells = _cells(TS, kind)
    outs = {"psum": _run(cells, n_shards=2, **run), "nbr": _nbr(cells, **run)}
    r_ref = np.asarray(r_ref)
    scale = max(1.0, float(np.max(np.abs(r_ref))))
    for ex, (st, r) in outs.items():
        assert tuple(r.shape) == r_ref.shape
        err = float(np.max(np.abs(r.numpy() - r_ref)))
        assert err < 1e-5 * scale, (ex, err)
    (st_p, r_p), (st_n, r_n) = outs["psum"], outs["nbr"]
    assert torch.equal(r_p, r_n)
    _states_equal(st_p, st_n, "psum vs nbr")


def test_sharded_grid_matches_reference_grid_fat_tree(pt_always):
    """The 2-cell drain what-if fat tree on 2 shards (`pt` per shard):
    rates within max(1e-4 x scale, 4x the reference's own backend-swap
    divergence) of the reference's grid; queues within 1e-4 x their
    scale or that multiple of the reference's own divergence; psum and
    nbr bitwise equal."""
    run = dict(n_warm=600, n_meas=200)
    ref_cells = _cells(RS, "fat_tree")
    f_ref, r_ref = RW.run_grid(ref_cells, **run)
    f_swap, r_swap = RW.run_grid(ref_cells, backend="reference", **run)
    cells = _cells(TS, "fat_tree")
    outs = {"psum": TW.run_grid(cells, n_shards=2, **run),
            "nbr": _nbr(cells, **run)}
    r_ref, r_swap = np.asarray(r_ref), np.asarray(r_swap)
    scale = max(1.0, float(np.max(np.abs(r_ref))))
    noise = float(np.max(np.abs(r_swap - r_ref)))
    st, r = outs["psum"]
    err = float(np.max(np.abs(r.numpy() - r_ref)))
    assert err < max(1e-4 * scale, 4.0 * noise), (err, noise)
    for f in ("q_phys", "q_phantom"):
        want, other = np.asarray(getattr(f_ref, f)), \
            np.asarray(getattr(f_swap, f))
        q_err = float(np.max(np.abs(getattr(st, f).numpy() - want)))
        q_noise = float(np.max(np.abs(other - want)))
        assert q_err <= max(1e-4 * max(1.0, float(np.max(want))),
                            4.0 * q_noise), (f, q_err, q_noise)
    np.testing.assert_allclose(st.split.sum(dim=2).numpy(), 1.0, atol=1e-5)
    assert torch.equal(outs["nbr"][1], r)
    _states_equal(outs["nbr"][0], st, "psum vs nbr")


def _sweep_errs(want, got, keys):
    return {k: float(np.max(np.abs(np.asarray(want[k]) - got[k].numpy())))
            for k in keys}


def test_sharded_fault_sweep_matches_reference():
    """`fault_sweep(n_shards=2)` at the reference's sharded-test kwargs
    (`tests/test_faults.py:362-366`, 64 inter flows) within 1e-5 of the
    reference's unsharded sweep on every key that test reads."""
    span = 2500 * 14e3
    kw = dict(fail_times=[0.2 * span, 0.5 * span],
              fault_kinds=["brownout", "burst"],
              ec_policies=[((8, 1), (8, 2))], n_inter=64, fault_rtts=2.0,
              n_warm=2000, n_meas=500)
    want = RW.fault_sweep(**kw)
    with _all_hub_ok():
        got = TW.fault_sweep(n_shards=2, device="cpu", **kw)
    assert set(got) == set(want)
    assert got["fault_config"] == want["fault_config"]
    errs = _sweep_errs(want, got, ("rates", "util", "retx_ratio",
                                   "loss_ratio", "rung_mean"))
    assert max(errs.values()) <= 1e-5, errs


def test_sharded_recovery_sweep_matches_reference():
    """`recovery_sweep(n_shards=2)` at `tests/test_reliability.py:290-292`'s
    kwargs (64 inter flows) within 1e-5 of the reference's unsharded
    sweep on every key that test reads."""
    kw = dict(overloads=[1.5, 3.0], ec_configs=[(8, 2)],
              debounce_rtts=[0.0, 1.0], n_inter=64, n_warm=2000, n_meas=500)
    want = RW.recovery_sweep(**kw)
    with _all_hub_ok():
        got = TW.recovery_sweep(n_shards=2, device="cpu", **kw)
    assert got["rel_config"] == want["rel_config"]
    errs = _sweep_errs(want, got, ("rates", "util", "retx_ratio",
                                   "rec_ratio", "nacks"))
    assert max(errs.values()) <= 1e-5, errs


# ------------------------------------------------------------ against the port

@pytest.mark.parametrize("kind", ["churn", "rel_fault"])
def test_sharded_grid_axes_bitwise_unsharded_grid(kind):
    """The churned grid (per-cell seeds): masks and keys bitwise the
    unsharded grid's; the per-cell EC ladders: rungs bitwise, and the
    fault carries (epoch, burst chains, chain keys) too; rates within
    1e-5 x scale."""
    cells = _cells(TS, kind)
    run = dict(n_warm=300, n_meas=200, seed=9)
    f0, r0 = TW.run_grid(cells, **run)
    f1, r1 = _run(cells, n_shards=2, **run)
    for f in ("active", "key"):
        assert torch.equal(getattr(f1, f), getattr(f0, f)), f
    if kind == "churn":
        assert 0.1 < float(f1.active.float().mean()) < 0.95
    else:
        assert TW.stack_scenarios(cells).rel.ladder_k.shape == (3, 3)
        assert torch.equal(f1.rel.rung, f0.rel.rung)
        assert bool((f1.rel.rung > 0).any())
        for f in ("epoch", "ge_bad", "key"):
            assert torch.equal(getattr(f1.fault, f), getattr(f0.fault, f)), f
    scale = max(1.0, float(r0.abs().max()))
    assert float((r1 - r0).abs().max()) < 1e-5 * scale


@pytest.mark.parametrize("kind,backend", [("fat_tree", "auto"),
                                          ("fat_tree", "cuda"),
                                          ("rel_fault", "auto")])
def test_sharded_grid_cell_bitwise_cell_alone_sharded(kind, backend,
                                                      pt_always):
    """Every cell of the sharded grid is bitwise that cell alone through
    `steady_state_sharded` under the same cell-0 plan, seeded alike, on
    the CPU: the lifted relabeling keeps the order of each cell's links
    and rows, so every per-link sum adds the cell's own terms in the
    cell's own order (the PathTable's segments too)."""
    cells = _cells(TS, kind)
    run = dict(n_warm=150, n_meas=100)
    with _all_hub_ok():
        final, rates = TW.run_grid(cells, n_shards=2, seed=4,
                                   backend=backend, **run)
        fs = cells[0]
        plan = TS.plan_shards(fs.net.routes, fs.net.n_links, 2,
                              link_tier=fs.link_tier)
    for i, c in enumerate(cells):
        st, g = TSH.steady_state_sharded(
            c.net, c.params, is_inter=c.is_inter, lb=c.lb, churn=c.churn,
            rel=c.rel, fault=c.fault, n_shards=2, plan=plan, seed=4 + i,
            backend=backend, **run)
        assert torch.equal(rates[i], g), i
        _states_equal(TW._map(lambda v, j=i: v[j], final), st, f"cell {i}")


def test_sharded_grid_honours_explicit_seeds():
    """Explicit per-cell seeds reach the sharded grid (the reference's
    sharded grid reseeds with seed + i instead): keys and masks bitwise
    the unsharded grid under the same seeds, and not those of the
    default seeds."""
    cells = _cells(TS, "churn")
    run = dict(n_warm=100, n_meas=50)
    seeds = [17, 5, 11]
    f0, _ = TW.run_grid(cells, seeds=seeds, **run)
    f1, _ = _run(cells, seeds=seeds, n_shards=2, **run)
    fd, _ = _run(cells, n_shards=2, **run)
    assert torch.equal(f1.key, f0.key) and torch.equal(f1.active, f0.active)
    assert not torch.equal(fd.key, f1.key)


def test_differing_routes_warn_and_run_unsharded():
    """Cells that route differently cannot share a plan: RuntimeWarning,
    and the unsharded grid's result, bitwise."""
    fs = _cells(TS, "multipath_lb")[0]
    # the same links, the flows' routes in reverse order
    other = fs._replace(net=TL.with_layout(fs.net._replace(
        routes=fs.net.routes.flip(0).contiguous())))
    cells = [fs, other]
    run = dict(n_warm=100, n_meas=50)
    with pytest.warns(RuntimeWarning, match="identical routes"):
        f1, r1 = TW.run_grid(cells, n_shards=2, **run)
    f0, r0 = TW.run_grid(cells, **run)
    assert torch.equal(r1, r0)
    _states_equal(f1, f0, "unsharded")


# --------------------------------------------- dist: gloo, two ranks

_RANK = r"""
import datetime, json, sys, warnings
import numpy as np, torch
import torch.distributed as dist
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
warnings.filterwarnings("ignore", message=".*every hop")
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
sys.path.insert(0, sys.argv[4])
from test_torch_sharded_grid import _cells, _nbr, TS, TW, RUN_DIST
res = {}
for ex in ("psum", "nbr"):
    run = TW.run_grid if ex == "psum" else _nbr
    st, g = run(_cells(TS, "rel_fault"), group=dist.group.WORLD, **RUN_DIST)
    res[ex + "/rates"] = g.numpy()
    for f, v in st._asdict().items():
        if v is None:
            continue
        for g_, w in (v._asdict().items() if hasattr(v, "_fields")
                      else [("", v)]):
            res[ex + "/" + f + g_] = w.numpy()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
print("ok")
"""

RUN_DIST = dict(n_warm=120, n_meas=40, seed=2)


def test_dist_gloo_two_ranks_bitwise_equal_stacked(tmp_path):
    """One shard per rank over gloo gives bitwise the stacked shards'
    grid (rel, fault and churn axes on), under both exchanges."""
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
            _, err = p.communicate(timeout=240)
            errs.append(err[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), errs
    got = dict(np.load(out))
    for ex in ("psum", "nbr"):
        run = _run if ex == "psum" else _nbr
        st, g = run(_cells(TS, "rel_fault"), n_shards=2, **RUN_DIST)
        _eq(got[ex + "/rates"], g, f"{ex} rates")
        for f, v in st._asdict().items():
            if v is None:
                continue
            for g_, w in (v._asdict().items() if hasattr(v, "_fields")
                          else [("", v)]):
                _eq(got[ex + "/" + f + g_], w, f"{ex} state.{f}{g_}")
