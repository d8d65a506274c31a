"""The port's locality-sharded fleet simulator against the JAX reference.

  * the shard planner (`plan_shards`, `neighbor_halo`, `_contiguous_plan`)
    bitwise equal to the reference's numpy planner;
  * the sharded arrays of `shard_scenario` (permuted net and params,
    `own`, `nbr`, per-shard layouts and padded PathTables) equal to the
    reference's, which runs with forced host devices in one subprocess;
  * K6's plain version (the CPU path of `fleet_cuda.link_scatter_tiles`)
    against `fleet_pallas.link_scatter_tiles` in interpret mode and
    `kref.fleet_offered_load_tiles_ref`, and bitwise against K1's;
  * the psum and neighbor halo exchanges bitwise equal;
  * the stacked sharded steady state against the reference's
    single-device `steady_state` under the reference's own sharded bars
    (`tests/test_fleet_scale.py`), and psum == nbr bitwise;
  * the `torch.distributed` runner (gloo, two ranks) bitwise equal to the
    stacked one.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.fleetsim as RF  # noqa: E402
import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import shard as RSH  # noqa: E402
from repro.kernels import fleet_pallas  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

import repro_torch.fleetsim as TF  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import shard as TSH  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _eq(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ------------------------------------------------------------ scenarios

def _spec(name, M):
    return {
        "dumbbell": lambda: M.dumbbell_scenario(5, 6, n_bottleneck=2),
        "dumbbell_sp": lambda: M.dumbbell_scenario(5, 5),
        "dumbbell_mp": lambda: M.dumbbell_scenario(3, 5, multipath=True,
                                                   n_wan=4),
        "fat_tree": lambda: M.fat_tree_spec(k=4, n_wan=4, n_flows=60,
                                            n_paths=4, seed=5),
        "multi_dc": lambda: M.multi_dc_spec(k=4, n_dc=3, mesh="ring",
                                            n_flows=120, seed=5),
        "multi_dc_ring4": lambda: M.multi_dc_spec(k=4, n_dc=4, mesh="ring",
                                                  n_flows=160, seed=5,
                                                  n_paths=4),
        "dumbbell_dyn": lambda: M.dumbbell_scenario(
            3, 6, multipath=True, n_wan=4, n_bottleneck=2, seed=3,
            intra_churn=M.ChurnSpec(7e4, 7e4),
            inter_churn=M.ChurnSpec(2e5, 1e5),
            inter_rel=M.RelSpec(ladder=((8, 1), (8, 2), (8, 4)),
                                ladder_up=(0.008, 0.05, 1.0),
                                ladder_down=(0.0, 0.004, 0.025)),
            faults=(M.FaultSpec("wan0", "down", t_start=1e6, t_end=3e6),
                    M.FaultSpec("wan1", "burst", loss_rate=2e-2,
                                burst=0.3))),
    }[name]()


@functools.lru_cache(maxsize=None)
def _ref_fs(name):
    return RS.to_fleetsim(_spec(name, RS))


@functools.lru_cache(maxsize=None)
def _port_fs(name):
    return TS.to_fleetsim(_spec(name, TS), device="cpu")


def _plan_kw(fs, tier=False, dc=False):
    kw = {}
    if tier:
        kw["link_tier"] = fs.link_tier
    if dc:
        kw.update(link_dc=fs.link_dc, sender_private=True)
    return kw


# ------------------------------------------------------------ the planner

PLAN_CASES = {
    "dumbbell_s2": ("dumbbell", 2, {}),
    "dumbbell_s4": ("dumbbell", 4, {}),
    "fat_tree_tier": ("fat_tree", 2, dict(tier=True)),
    "fat_tree_dc": ("fat_tree", 2, dict(dc=True)),
    "multi_dc_ring3": ("multi_dc", 3, dict(tier=True, dc=True)),
    "multi_dc_ring4_refused": ("multi_dc_ring4", 4, dict(tier=True, dc=True)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_reference(case):
    name, S, flags = PLAN_CASES[case]
    ref, port = _ref_fs(name), _port_fs(name)
    seed = _spec(name, TS).seed
    p_r = RS.plan_shards(np.asarray(ref.net.routes), ref.net.n_links, S,
                         seed=seed, **_plan_kw(ref, **flags))
    p_p = TS.plan_shards(port.net.routes, port.net.n_links, S, seed=seed,
                         **_plan_kw(port, **flags))
    assert p_r._fields == p_p._fields
    for f in p_r._fields:
        _eq(getattr(p_p, f), getattr(p_r, f), f"{case}: plan.{f}")
    _eq(p_p.inverse_flow, p_r.inverse_flow, f"{case}: inverse_flow")
    n_r, n_p = RSH.neighbor_halo(p_r), TSH.neighbor_halo(p_p)
    assert (n_r is None) == (n_p is None), case
    if n_r is not None:
        _eq(n_p, n_r, f"{case}: nbr")
    if case == "multi_dc_ring4_refused":
        assert p_p.n_boundary > 0 and n_p is None
    if case == "dumbbell_s4":
        assert p_p.n_real == 11 and p_p.gather.shape == (4, 3)


def test_plan_all_hub_round_robin_warns():
    """Every hop of every flow a hub, no tiers: the seeded round-robin
    deal, with the reference's RuntimeWarning."""
    routes = np.tile(np.array([[[0, 1]]], np.int32), (9, 1, 1))
    with pytest.warns(RuntimeWarning, match="round-robin"):
        p_r = RS.plan_shards(routes, 2, 2, seed=3)
    with pytest.warns(RuntimeWarning, match="round-robin"):
        p_p = TS.plan_shards(routes, 2, 2, seed=3)
    for f in p_r._fields:
        _eq(getattr(p_p, f), getattr(p_r, f), f"plan.{f}")
    assert p_p.n_boundary == 2


def test_contiguous_plan_matches_reference():
    for n_real, S in ((11, 4), (12, 3)):
        p_r = RSH._contiguous_plan(n_real, 7, S)
        p_p = TSH._contiguous_plan(n_real, 7, S)
        for f in p_r._fields:
            _eq(getattr(p_p, f), getattr(p_r, f), f"plan.{f}")
        assert TSH.neighbor_halo(p_p) is None


# ---------------------------------------------- sharded arrays (subprocess)

SHARD_CASES = {
    "dumbbell_s4": ("dumbbell", 4, {}),
    "dumbbell_dyn_s2": ("dumbbell_dyn", 2, dict(dynamics=True)),
    "dumbbell_mp_contiguous": ("dumbbell_mp", 2, dict(locality=False)),
    "fat_tree_tier_pt": ("fat_tree", 2, dict(tier=True, path_table=True)),
    "multi_dc_nbr": ("multi_dc", 3, dict(tier=True, dc=True,
                                         exchange="nbr")),
    "multi_dc_ring4_psum": ("multi_dc_ring4", 4, dict(tier=True, dc=True)),
}


def _shard_kw(fs, name, flags):
    flags = dict(flags)
    kw = _plan_kw(fs, flags.pop("tier", False), flags.pop("dc", False))
    if flags.pop("dynamics", False):
        kw.update(churn=fs.churn, rel=fs.rel, fault=fs.fault)
    kw.update(flags)
    return dict(is_inter=fs.is_inter, lb=fs.lb, seed=_spec(name, RS).seed,
                **kw)


def _dump_reference_shards(path):
    """The reference's `shard_scenario` arrays of every SHARD_CASES entry,
    flattened to numpy; run in a process with four forced host devices."""
    import jax
    res = {}
    for case, (name, S, flags) in SHARD_CASES.items():
        fs = _ref_fs(name)
        mesh = jax.make_mesh((S,), ("flows",), devices=jax.devices()[:S])
        sf = RSH.shard_scenario(fs.net, fs.params, mesh=mesh,
                                **_shard_kw(fs, name, flags))
        out = {f"plan_{f}": v for f, v in sf.plan._asdict().items()
               if v is not None}
        for f in TL.FluidNet._fields:
            v = getattr(sf.net, f)
            if f != "layout" and v is not None:
                out["net_" + f] = v
        for f in sf.layouts._fields:
            v = getattr(sf.layouts, f)
            if f == "path_table":
                if v is not None:
                    out.update({"pt_" + g: w
                                for g, w in v._asdict().items()})
            else:
                out["lay_" + f] = v
        out.update({"par_" + f: v for f, v in sf.params._asdict().items()})
        for fam in ("lb", "churn", "rel", "fault"):
            val = getattr(sf, fam)
            if val is not None:
                out.update({fam + "_" + f: v for f, v in val._asdict().items()
                            if v is not None})
        if sf.churn_map is not None:
            out["churn_map"] = sf.churn_map
        out["is_inter"], out["own"] = sf.is_inter, sf.own
        if sf.nbr is not None:
            out["nbr"] = sf.nbr
        res.update({f"{case}/{k}": np.asarray(v) for k, v in out.items()})
    np.savez(path, **res)


_REF_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import test_torch_shard
test_torch_shard._dump_reference_shards(sys.argv[2])
print("ok")
"""


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("shard_ref") / "ref.npz"
    out = subprocess.run(
        [sys.executable, "-c", _REF_SHARDS, str(TESTS), str(path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_scenario_arrays_equal_reference(ref_shards, case):
    name, S, flags = SHARD_CASES[case]
    fs = _port_fs(name)
    sf = TSH.shard_scenario(fs.net, fs.params, n_shards=S,
                            **_shard_kw(fs, name, flags))
    ref = {k.split("/", 1)[1]: v for k, v in ref_shards.items()
           if k.startswith(case + "/")}
    for f, v in sf.plan._asdict().items():
        if v is not None:
            _eq(v, ref["plan_" + f], f"{case}: plan.{f}")
    for f in TL.FluidNet._fields:
        v = getattr(sf.net, f)
        if f != "layout" and v is not None:
            _eq(v, ref["net_" + f], f"{case}: net.{f}")
    for f in TL.RouteLayout._fields:
        if f == "path_table":
            continue
        for s in range(S):
            _eq(getattr(sf.layouts[s], f), ref["lay_" + f][s],
                f"{case}: layouts[{s}].{f}")
    has_pt = [lay.path_table is not None for lay in sf.layouts]
    assert all(has_pt) == ("pt_pre_id" in ref) and (any(has_pt)
                                                   == all(has_pt)), case
    if all(has_pt):
        for f in TL.PathTable._fields:
            for s in range(S):
                _eq(getattr(sf.layouts[s].path_table, f),
                    ref["pt_" + f][s], f"{case}: path_table[{s}].{f}")
    for f, v in sf.params._asdict().items():
        _eq(v, ref["par_" + f], f"{case}: params.{f}")
    for fam in ("lb", "churn", "rel", "fault"):
        val = getattr(sf, fam)
        if val is None:
            assert not any(k.startswith(fam + "_") for k in ref), case
            continue
        for f, v in val._asdict().items():
            if v is None:
                assert fam + "_" + f not in ref, (case, fam, f)
            else:
                _eq(v, ref[fam + "_" + f], f"{case}: {fam}.{f}")
    assert (sf.churn_map is None) == ("churn_map" not in ref), case
    if sf.churn_map is not None:
        _eq(sf.churn_map, ref["churn_map"], f"{case}: churn_map")
    _eq(sf.is_inter, ref["is_inter"], f"{case}: is_inter")
    _eq(sf.own, ref["own"], f"{case}: own")
    assert (sf.nbr is None) == ("nbr" not in ref), case
    if sf.nbr is not None:
        _eq(sf.nbr, ref["nbr"], f"{case}: nbr")


def test_shard_scenario_refusals():
    fs = _port_fs("multi_dc_ring4")
    kw = _shard_kw(fs, "multi_dc_ring4", dict(tier=True, dc=True))
    with pytest.raises(ValueError, match="neighbor"):
        TSH.shard_scenario(fs.net, fs.params, n_shards=4, exchange="nbr",
                           **kw)
    sf = TSH.shard_scenario(fs.net, fs.params, n_shards=4, **kw)
    assert sf.nbr is None                  # "auto" falls back to the psum
    with pytest.raises(ValueError, match="exchange"):
        TSH.shard_scenario(fs.net, fs.params, n_shards=4, exchange="bogus")
    with pytest.raises(ValueError, match="n_shards"):
        TSH.shard_scenario(fs.net, fs.params)
    # the churn axis, once refused, shards: every epoch each row reads the
    # global draw of its original flow, so the masks equal one device's
    churned = TS.to_fleetsim(TS.dumbbell_scenario(
        2, 3, inter_churn=TS.ChurnSpec(3e4, 2e4), seed=2), device="cpu")
    run = dict(n_warm=60, n_meas=40, churn=churned.churn, seed=2)
    st1, g1 = TF.steady_state(churned.net, churned.params, **run)
    st2, g2 = TSH.steady_state_sharded(churned.net, churned.params,
                                       n_shards=2, **run)
    _eq(st2.active, st1.active, "sharded churn mask")
    _eq(st2.key, st1.key, "churn key")
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-5, atol=1e-6)
    assert st1.key.tolist() != [0, 2]      # one draw per epoch happened


# ------------------------------------------------------------ K6

def _random_case(rng):
    """Random routes with -1 padding on both the hop and path axes."""
    n_links = int(rng.integers(3, 12))
    n, p, h = (int(rng.integers(2, 14)), int(rng.integers(1, 5)),
               int(rng.integers(1, 5)))
    routes = rng.integers(-1, n_links, size=(n, p, h)).astype(np.int32)
    routes[:, 0, 0] = rng.integers(0, n_links, size=n)   # >= 1 real path
    rates = rng.uniform(0.0, 10.0, n).astype(np.float32)
    mask = (routes >= 0).any(axis=2)
    split = rng.uniform(0, 1, (n, p)).astype(np.float32) * mask
    split = (split / split.sum(axis=1, keepdims=True)).astype(np.float32)
    return n_links, routes, rates, split


def test_k6_plain_version_matches_pallas_and_oracle():
    """The CPU path of K6's wrappers (flat, and PathTable stage 2) within
    1e-6 of the reference's tiled Pallas kernel in interpret mode and of
    the tile oracle on random routes, and bitwise equal to K1's."""
    rng = np.random.default_rng(21)
    for _ in range(4):
        n_links, routes, rates, split = _random_case(rng)
        nb = int(rng.integers(1, n_links))
        pad_idx = np.where(routes >= 0, routes, n_links).astype(np.int32)
        sub = rates[:, None] * split
        lay = TL.compute_layout(routes, n_links, path_table=True,
                                device="cpu")
        priv, bnd = fleet_cuda.link_scatter_tiles(
            lay.pad_idx, torch.as_tensor(sub), n_links, nb,
            csr=(lay.sort_sub, lay.link_ptr))
        assert priv.shape == (n_links - nb,) and bnd.shape == (nb + 1,)
        assert float(bnd[-1]) == 0.0
        got = torch.cat([priv, bnd]).numpy()
        k1 = fleet_cuda.link_scatter(lay.pad_idx, torch.as_tensor(sub),
                                     n_links, csr=(lay.sort_sub,
                                                   lay.link_ptr)).numpy()
        _eq(got[:n_links], k1[:n_links], "K6 vs K1")
        pp, pb = fleet_pallas.link_scatter_tiles(
            jnp.asarray(pad_idx), jnp.asarray(sub), n_links, nb, block=4)
        op, ob = kref.fleet_offered_load_tiles_ref(
            torch.as_tensor(routes), torch.as_tensor(rates),
            torch.as_tensor(split), n_links, nb)
        rp, rb = rref.fleet_offered_load_tiles_ref(
            jnp.asarray(routes), jnp.asarray(rates), jnp.asarray(split),
            n_links, nb)
        for want in (np.concatenate([np.asarray(pp), np.asarray(pb)]),
                     torch.cat([op, ob]).numpy(),
                     np.concatenate([np.asarray(rp), np.asarray(rb)])):
            np.testing.assert_allclose(got[:n_links], want[:n_links],
                                       atol=1e-6, rtol=1e-6)
        # PathTable: stage 1 (K1) + stage 2 (K6) against the Pallas pair
        pt = lay.path_table
        tp, tb = fleet_cuda.path_table_scatter(pt, torch.as_tensor(sub),
                                               n_boundary=nb)
        full = fleet_cuda.path_table_scatter(pt, torch.as_tensor(sub))
        _eq(torch.cat([tp, tb])[:n_links], full[:n_links], "pt K6 vs K1")
        qp, qb = fleet_pallas.path_table_scatter(
            jnp.asarray(_np(pt.pre_id)), jnp.asarray(_np(pt.suf_id)),
            jnp.asarray(_np(pt.seg_idx)), jnp.asarray(sub), n_links,
            n_boundary=nb, block=4)
        np.testing.assert_allclose(
            torch.cat([tp, tb]).numpy()[:n_links],
            np.concatenate([np.asarray(qp), np.asarray(qb)])[:n_links],
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "pt", "cuda", "pt_cuda"])
def test_offered_load_halo_routes_tiles(backend, monkeypatch):
    """`offered_load(halo=B)` takes the tiled scatter (K6 on the kernel
    backends) for 0 < B < n_links and the whole buffer at B = 0 and
    B = n_links, and every route gives the unsharded loads."""
    calls = []
    tiles = fleet_cuda.segment_sum_tiles
    monkeypatch.setattr(fleet_cuda, "segment_sum_tiles",
                        lambda *a, **kw: calls.append(1) or tiles(*a, **kw))
    rng = np.random.default_rng(5)
    n_links, routes, rates, split = _random_case(rng)
    one = torch.ones(n_links)
    net = TL.with_layout(TL.FluidNet(
        cap=one, qcap=one, ecn_lo=one, ecn_hi=one, drain=one, vcap=one,
        use_phantom=torch.zeros(n_links, dtype=torch.bool),
        routes=torch.as_tensor(routes), dt=torch.tensor(1.0)),
        path_table=True)
    r, sp = torch.as_tensor(rates), torch.as_tensor(split)
    want = TL.offered_load(net, r, sp, backend=backend)
    for halo in (0, 1, n_links - 1, n_links):
        got = TL.offered_load(net, r, sp, backend=backend, halo=halo)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert len(calls) == (2 if backend.endswith("cuda") else 0)
    with pytest.raises(ValueError, match="halo"):
        TL.offered_load(net, r, sp, backend=backend, halo=n_links + 1)


def test_k6_refuses_degenerate_cut_and_writes_the_given_row():
    vals = torch.tensor([1.0, 2.0, 3.0, 0.0])
    gather = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    ptr = torch.tensor([0, 1, 3, 3, 4], dtype=torch.int32)   # 3 segments
    for nb in (0, 3, -1):
        with pytest.raises(ValueError, match="n_boundary"):
            fleet_cuda.segment_sum_tiles(vals, gather, ptr, nb)
    with pytest.raises(ValueError, match="bnd_out"):
        fleet_cuda.segment_sum_tiles(vals, gather, ptr, 1,
                                     bnd_out=torch.zeros(3))
    rows = torch.full((2, 3), 7.0)
    priv, bnd = fleet_cuda.segment_sum_tiles(vals, gather, ptr, 2,
                                             bnd_out=rows[1])
    _eq(priv, torch.tensor([1.0]), "private tile")
    _eq(rows, torch.tensor([[7.0, 7.0, 7.0], [5.0, 0.0, 0.0]]), "row 1")
    assert bnd.data_ptr() == rows[1].data_ptr()


# ------------------------------------------------------------ the exchange

@pytest.mark.parametrize("S", [2, 3])
def test_psum_and_nbr_exchange_bitwise_equal(S):
    """Tiles where each boundary link has two ring-adjacent touchers and
    exact +0.0 elsewhere: the neighbor exchange gives every toucher the
    psum's bits; private links are untouched."""
    rng = np.random.default_rng(S)
    per_group = 3
    B = S * per_group if S > 2 else per_group
    groups = [list(range(g * per_group, (g + 1) * per_group))
              for g in range(S if S > 2 else 1)] + \
        ([[]] if S == 2 else [])
    tiles = np.zeros((S, B + 1), np.float32)
    for g, links in enumerate(groups):
        for j in links:
            for s in (g, (g + 1) % S):
                tiles[s, j] = rng.uniform(0.1, 10.0)
    width = max(len(gr) for gr in groups)
    nbr = np.full((S, 2, width), B, np.int64)
    for p in range(S):
        r, l = groups[p], groups[(p - 1) % S]
        nbr[p, 0, :len(r)] = r
        nbr[p, 1, :len(l)] = l
    t = torch.as_tensor(tiles)
    psum = TL.halo_exchange(t)
    got = TL.halo_exchange(t, nbr=torch.as_tensor(nbr))
    assert torch.equal(t, torch.as_tensor(tiles))     # inputs untouched
    for g, links in enumerate(groups):
        for s in (g, (g + 1) % S):
            _eq(got[s, links], psum[s, links], f"S={S} group {g} shard {s}")
    _eq(psum[0, :B], tiles.sum(axis=0)[:B], "psum")


# ----------------------------------------- the sharded steady state

def _ref_steady(name, run, backend="auto"):
    fs = _ref_fs(name)
    return RF.steady_state(fs.net, fs.params, is_inter=fs.is_inter,
                           lb=fs.lb, backend=backend, **run)


@functools.lru_cache(maxsize=None)
def _ref_run(name, n_warm, n_meas, backend="auto"):
    s, g = _ref_steady(name, dict(n_warm=n_warm, n_meas=n_meas), backend)
    return np.asarray(s.q_phantom), np.asarray(s.q_phys), np.asarray(g)


STEADY_CASES = {
    # name: (scenario, shards, shard_scenario flags, epochs, rate bar)
    "single_path": ("dumbbell_sp", 4, {}, (1000, 300), "scale"),
    "full_exchange": ("dumbbell_sp", 4, dict(locality=False), (1000, 300),
                      "scale"),
    "multipath_lb": ("dumbbell_mp", 4, {}, (1000, 300), 1e-4),
    "fat_tree_lb": ("fat_tree", 2, dict(tier=True), (1500, 500), "noise"),
    "multi_dc_nbr": ("multi_dc", 3, dict(tier=True, dc=True,
                                         exchange="nbr"), (600, 200),
                     "noise"),
}


def _port_sharded(name, S, flags, n_warm, n_meas, **kw):
    fs = _port_fs(name)
    sf = TSH.shard_scenario(fs.net, fs.params, n_shards=S,
                            **_shard_kw(fs, name, flags))
    return sf, TSH.steady_state_prepared(sf, n_warm=n_warm, n_meas=n_meas,
                                         **kw)


@pytest.mark.parametrize("case", sorted(STEADY_CASES))
def test_sharded_steady_state_matches_reference_single_device(case):
    """Rates within the reference's own sharded-vs-single bars
    (tests/test_fleet_scale.py:523-529): single path and the full-buffer
    exchange 1e-5 x scale, multipath with LB 1e-4; on the fat tree and
    the 3-DC ring (chaotic LB on 9-hop paths) max(1e-4 x scale, 4x the
    reference's own backend-swap divergence).  Queues, reassembled from
    their owners, within 1e-4 x the queue scale, or there within the same
    multiple of the reference's own queue divergence."""
    name, S, flags, (n_warm, n_meas), bar = STEADY_CASES[case]
    q_r, qp_r, g_r = _ref_run(name, n_warm, n_meas)
    sf, (st, g) = _port_sharded(name, S, flags, n_warm, n_meas)
    assert sf.plan.n_boundary > 0
    if flags.get("exchange") == "nbr":
        assert sf.nbr is not None
    g = g.numpy()
    scale = max(1.0, float(np.max(np.abs(g_r))))
    err = float(np.max(np.abs(g - g_r)))
    swap = _ref_run(name, n_warm, n_meas, "reference") \
        if bar == "noise" else (q_r, qp_r, g_r)
    if bar == "scale":
        assert err < 1e-5 * scale, (case, err)
    elif bar == "noise":
        noise = float(np.max(np.abs(swap[2] - g_r)))
        assert err < max(1e-4 * scale, 4.0 * noise), (case, err, noise)
    else:
        assert err < bar, (case, err)
    for got, want, other in ((st.q_phantom, q_r, swap[0]),
                             (st.q_phys, qp_r, swap[1])):
        q_err = float(np.max(np.abs(got.numpy() - want)))
        q_noise = float(np.max(np.abs(other - want)))
        assert q_err <= max(1e-4 * max(1.0, float(np.max(want))),
                            4.0 * q_noise), (case, q_err, q_noise)
    assert np.all(np.isfinite(g))
    np.testing.assert_allclose(st.split.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_multi_dc_nbr_and_psum_bitwise_equal():
    """3-DC ring at S=3: the neighbor exchange and the psum give bitwise
    the same rates and final state, on the plain and on the kernel
    backends' CPU path."""
    for backend in ("auto", "cuda"):
        runs = [_port_sharded("multi_dc", 3, dict(tier=True, dc=True,
                                                  exchange=ex), 150, 50,
                              backend=backend)
                for ex in ("nbr", "psum")]
        (sf_n, (st_n, g_n)), (sf_p, (st_p, g_p)) = runs
        assert sf_n.nbr is not None and sf_p.nbr is None
        _eq(g_n, g_p, f"{backend} rates")
        for f, v in st_n._asdict().items():
            if v is not None:
                _eq(v, getattr(st_p, f), f"{backend} state.{f}")


# --------------------------------------------- dist: gloo, two ranks

_DIST_KW = dict(k=4, n_wan=4, n_flows=40, n_paths=4, seed=2)
_DIST_EPOCHS = dict(n_warm=150, n_meas=50)

_RANK = r"""
import datetime, json, sys
import numpy as np, torch
import torch.distributed as dist
rank, init, out, kw, run = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            json.loads(sys.argv[4]), json.loads(sys.argv[5]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
import repro_torch.scenarios as TS
from repro_torch.fleetsim import shard as SH
fs = TS.to_fleetsim(TS.fat_tree_spec(**kw), device="cpu")
res = {}
for ex in ("psum", "nbr"):
    st, g = SH.steady_state_sharded(
        fs.net, fs.params, is_inter=fs.is_inter, lb=fs.lb,
        group=dist.group.WORLD, link_tier=fs.link_tier, exchange=ex,
        seed=fs.seed, **run)
    res[ex + "/rates"] = g.numpy()
    for f, v in st._asdict().items():
        if v is not None:
            res[ex + "/" + f] = v.numpy()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
print("ok")
"""


def test_dist_gloo_two_ranks_bitwise_equal_stacked(tmp_path):
    """One shard per rank over gloo (all_reduce / batch_isend_irecv,
    all_reduce of the owned queues, all_gather of the rates) gives
    bitwise the stacked runner's results, under both exchanges."""
    out = tmp_path / "dist.npz"
    init = f"file://{tmp_path / 'rendezvous'}"
    args = [json.dumps(_DIST_KW), json.dumps(_DIST_EPOCHS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init, str(out), *args],
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
    fs = TS.to_fleetsim(TS.fat_tree_spec(**_DIST_KW), device="cpu")
    for ex in ("psum", "nbr"):
        st, g = TSH.steady_state_sharded(
            fs.net, fs.params, is_inter=fs.is_inter, lb=fs.lb, n_shards=2,
            link_tier=fs.link_tier, exchange=ex, seed=fs.seed,
            **_DIST_EPOCHS)
        _eq(got[ex + "/rates"], g, f"{ex} rates")
        for f, v in st._asdict().items():
            if v is not None:
                _eq(got[ex + "/" + f], v, f"{ex} state.{f}")
