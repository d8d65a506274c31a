"""The port's sweep service (`repro_torch.fleetsim.service`, its CLI
`repro_torch.fleetsim.sweep_server`) and spec fingerprints against the
JAX reference's (`repro.fleetsim.service`, `repro.scenarios.spec`).

Held here: the fingerprints string for string; content addresses that
bind builder defaults as the reference's do and carry the package token
the reference's lack; bundles whose arrays equal the reference's bundle
arrays name for name (the reference's extra layout fields aside); round
trips bitwise; corrupt, truncated, version-skewed and foreign bundles
rebuilt; the LRU size cap; the ladder planner; batched queries equal to
each query alone and within the dumbbell bar of the reference service;
the grid-layout memo (keyed by the cells' routes: a warm batch of
addressed queries, and what-ifs that keep the routes, build none);
the CLI's per-line isolation."""
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import links as RL  # noqa: E402
from repro.fleetsim import service as RSV  # noqa: E402
from repro.scenarios import spec as RSP  # noqa: E402

import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.fleetsim import service as SV  # noqa: E402
from repro_torch.fleetsim import sweep_server, sweeps  # noqa: E402
from repro_torch.scenarios import spec as TSP  # noqa: E402

MS = 1e6
RUN = dict(n_warm=60, n_meas=20)
DB = dict(n_intra=4, n_inter=4, multipath=True, n_wan=2)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny(**kw):
    kw = {**DB, **kw}
    return TS.to_fleetsim(TS.dumbbell_scenario(
        kw.pop("n_intra"), kw.pop("n_inter"), **kw), device="cpu")


def _tree_equal(a, b, what=""):
    """Two NamedTuples of tensors (nested, None members) bitwise equal,
    dtypes included."""
    assert type(a) is type(b), what
    for f, v in a._asdict().items():
        w = getattr(b, f)
        if v is None or w is None:
            assert v is None and w is None, f"{what}.{f}"
        elif hasattr(v, "_fields"):
            _tree_equal(v, w, f"{what}.{f}")
        else:
            assert v.dtype == w.dtype and torch.equal(v, w), f"{what}.{f}"


# ------------------------------------------------------------ fingerprints

def _specs(M):
    """Specs with RelSpec, ChurnSpec and FaultSpec fields, one per
    builder, from the reference's (`M is RS`) or the port's builders."""
    rel = M.RelSpec(ladder=((8, 1), (8, 2)), debounce=1e5)
    churn = M.ChurnSpec(7e5, 2e6)
    db = M.dumbbell_scenario(
        3, 4, multipath=True, n_wan=2, inter_rel=rel, intra_churn=churn,
        faults=(M.FaultSpec("wan0", "down", t_start=1 * MS, t_end=3 * MS),
                M.FaultSpec("wan1", "burst", loss_rate=0.02, burst=0.3)))
    ft = M.fat_tree_spec(k=4, n_wan=4, n_flows=60, n_paths=4, seed=3)
    ft = ft._replace(faults=(M.FaultSpec(ft.links[-1].name, "flap",
                                         period=2e5),))
    mdc = M.multi_dc_spec(k=4, n_dc=3, mesh="ring", n_flows=60, seed=2)
    return {"dumbbell": db, "fat_tree": ft, "multi_dc": mdc,
            "kwargs": {"kind": "dumbbell", "kwargs": dict(
                n_intra=2, n_inter=3, inter_rel=rel, intra_churn=churn,
                faults=(M.FaultSpec("down0", "brownout", cap_frac=0.4),),
                drain_frac=0.85)}}


@pytest.mark.parametrize("name", ["dumbbell", "fat_tree", "multi_dc",
                                  "kwargs"])
def test_fingerprint_equals_reference(name):
    ref, port = _specs(RS)[name], _specs(TS)[name]
    for extra in ((), (3,), (3, "repro_torch")):
        assert TSP.fingerprint(port, *extra) == RSP.fingerprint(ref, *extra)
    if name != "kwargs":
        assert TS.spec_fingerprint(port, 3) == RS.spec_fingerprint(ref, 3)
    assert TSP._canonical(port) == RSP._canonical(ref)
    with pytest.raises(TypeError, match="unfingerprintable"):
        TSP.fingerprint({"routes": np.zeros(2)})


def test_scenario_key_binds_defaults_and_carries_the_package():
    base = SV.scenario_key("dumbbell", n_intra=4, n_inter=4)
    assert SV.scenario_key("dumbbell", n_intra=4, n_inter=4,
                           multipath=False) == base
    assert SV.scenario_key("dumbbell", n_intra=4, n_inter=4, seed=3) != base
    assert SV.scenario_key("dumbbell", n_intra=4, n_inter=4,
                           inter_rel=TS.RelSpec(ec=(4, 1))) != base
    keys = {SV.scenario_key("multi_dc", k=4, n_flows=60, **kw)
            for kw in ({}, dict(n_dc=3, mesh="ring", oversub=1.0))}
    assert len(keys) == 1
    with pytest.raises(ValueError, match="unknown scenario kind"):
        SV.scenario_key("torus", k=3)
    with pytest.raises(TypeError):
        SV.scenario_key("dumbbell", n_intra=4, n_inter=4, qcap_typo=1)
    # the reference binds the same kwargs: without the package token the
    # addresses agree, with it they never collide
    for kind, kw in (("dumbbell", DB), ("fat_tree", dict(k=4, n_flows=60)),
                     ("multi_dc", dict(k=4, n_flows=60, n_dc=4))):
        ref = RSV.scenario_key(kind, **kw)
        assert SV.scenario_key(kind, **kw) != ref
        bound = inspect.signature(SV._builder(kind)).bind(**kw)
        bound.apply_defaults()
        assert TSP.fingerprint({"kind": kind, "kwargs": dict(
            bound.arguments)}, SV.CACHE_VERSION) == ref


# ------------------------------------------------------------ bundles

BUILDS = {
    "dumbbell_dyn": ("dumbbell", dict(
        DB, intra_churn=TS.ChurnSpec(7e5, 7e5),
        inter_rel=TS.RelSpec(ladder=((8, 1), (8, 2))),
        faults=(TS.FaultSpec("wan0", "down", t_start=1 * MS, t_end=3 * MS),
                TS.FaultSpec("wan1", "burst", loss_rate=0.02, burst=0.3)))),
    "fat_tree_pt": ("fat_tree", dict(k=4, n_wan=4, n_flows=240, n_paths=4)),
    "multi_dc": ("multi_dc", dict(k=4, n_dc=3, mesh="ring", n_flows=60,
                                  n_paths=4)),
}


def _ref_kwargs(kw):
    """The port's spec NamedTuples as the reference's (same fields)."""
    def conv(v):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return getattr(RS, type(v).__name__)(*map(conv, v))
        if isinstance(v, tuple):
            return tuple(map(conv, v))
        return v
    return {k: conv(v) for k, v in kw.items()}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_bundle_arrays_equal_reference_bundle(name, tmp_path, monkeypatch):
    """The port's bundle and the reference's for one build request: every
    port array equals the reference's array of that name, dtype
    included; the reference only adds its layout's `hop_mask`,
    `sort_link` and `csr_gather`."""
    monkeypatch.setattr(TL, "PT_MIN_COMPRESS", 0.0)
    monkeypatch.setattr(RL, "PT_MIN_COMPRESS", 0.0)
    kind, kw = BUILDS[name]
    fs, src = SV.cached_scenario(kind, cache_dir=tmp_path / "p",
                                 device="cpu", **kw)
    assert src == "build"
    RSV.cached_scenario(kind, cache_dir=tmp_path / "r", **_ref_kwargs(kw))
    zp = np.load(SV.bundle_path(SV.scenario_key(kind, **kw), tmp_path / "p"))
    zr = np.load(RSV.bundle_path(RSV.scenario_key(kind, **_ref_kwargs(kw)),
                                 tmp_path / "r"))
    with zp, zr:
        assert set(zr.files) - set(zp.files) == \
            {"lay_hop_mask", "lay_sort_link", "lay_csr_gather"}
        assert set(zp.files) <= set(zr.files)
        for k in zp.files:
            if k == "__meta__":
                continue
            assert zp[k].dtype == zr[k].dtype, k
            np.testing.assert_array_equal(zp[k], zr[k], err_msg=k)
        meta = json.loads(str(zp["__meta__"][()]))
        assert meta["package"] == "repro_torch"
        if name == "fat_tree_pt":
            assert "lay_pt_seg_idx" in zp.files
        if name == "multi_dc":
            assert "link_dc" in zp.files
        if name == "dumbbell_dyn":
            assert {"fault_link", "rel_ladder_k", "churn_churned"} <= \
                set(zp.files)
    assert fs.net.layout is not None


@pytest.mark.parametrize("case", ["flat", "path_table", "fault_ladder",
                                  "none_subfields"])
def test_bundle_round_trip_bitwise(case, tmp_path, monkeypatch):
    if case == "path_table":
        monkeypatch.setattr(TL, "PT_MIN_COMPRESS", 0.0)
    fs = {
        "flat": lambda: _tiny(),
        "path_table": lambda: TS.to_fleetsim(TS.fat_tree_spec(
            k=4, n_wan=4, n_flows=120, n_paths=4), device="cpu"),
        "fault_ladder": lambda: _tiny(
            n_intra=0, inter_rel=TS.RelSpec(ladder=((4, 1), (4, 2))),
            faults=(TS.FaultSpec("wan0", "down", t_start=1 * MS,
                                 t_end=3 * MS),
                    TS.FaultSpec("wan1", "burst", t_start=0.0))),
        "none_subfields": lambda: _tiny(inter_rel=TS.RelSpec(ec=(4, 2))),
    }[case]()
    got = SV.load_bundle(SV.save_bundle(tmp_path / "b.npz", fs, key="b"),
                         device="cpu")
    assert got is not None
    for f in ("net", "params", "lb", "churn", "rel", "fault"):
        a, b = getattr(fs, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _tree_equal(a, b, f)
    assert torch.equal(fs.is_inter, got.is_inter) and fs.seed == got.seed
    for f in ("link_tier", "link_dc"):
        a, b = getattr(fs, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    if case == "flat":
        assert got.net.layout.path_table is None and got.link_tier is None
    if case == "path_table":
        assert got.net.layout.path_table is not None
    if case == "fault_ladder":
        assert got.fault is not None and got.rel.ladder_k is not None
    if case == "none_subfields":
        assert got.fault is None and got.rel.ladder_k is None and \
            got.rel.adapt_on is None


def test_untrusted_bundles_load_as_none_and_rebuild(tmp_path, monkeypatch):
    """Truncated, corrupt, version-skewed and the reference's own bundles
    load as None; `cached_scenario` rebuilds and heals in place."""
    fs, src = SV.cached_scenario("dumbbell", cache_dir=tmp_path,
                                 device="cpu", **DB)
    assert src == "build"
    assert SV.cached_scenario("dumbbell", cache_dir=tmp_path, device="cpu",
                              **DB)[1] == "disk"
    path = SV.bundle_path(SV.scenario_key("dumbbell", **DB), tmp_path)
    good = path.read_bytes()
    for bad in (good[:100], b"not a zip at all", good[:-40]):
        path.write_bytes(bad)
        assert SV.load_bundle(path, device="cpu") is None
    fs2, src = SV.cached_scenario("dumbbell", cache_dir=tmp_path,
                                  device="cpu", **DB)
    assert src == "build"
    _tree_equal(fs.params, fs2.params, "params")
    assert SV.load_bundle(path, device="cpu") is not None
    monkeypatch.setattr(SV, "CACHE_VERSION", SV.CACHE_VERSION + 1)
    assert SV.load_bundle(path, device="cpu") is None
    monkeypatch.undo()
    ref = RSV.save_bundle(tmp_path / "ref.npz", RS.to_fleetsim(
        RS.dumbbell_scenario(4, 4, multipath=True, n_wan=2)), key="r")
    assert SV.load_bundle(ref, device="cpu") is None     # another package
    assert SV.load_bundle(tmp_path / "missing.npz", device="cpu") is None


def _spaced_bundles(tmp_path, n):
    fs = _tiny()
    paths = []
    for i in range(n):
        p = SV.save_bundle(tmp_path / f"b{i}.npz", fs, key=f"b{i}")
        os.utime(p, (1000.0 + i, 1000.0 + i))
        paths.append(p)
    return paths


def test_prune_cache_lru_and_env_cap(tmp_path, monkeypatch):
    monkeypatch.delenv("FLEETSIM_CACHE_BYTES", raising=False)
    assert SV.cache_size_cap() == 0
    for raw, want in (("12345", 12345), ("lots", 0), ("-5", 0)):
        monkeypatch.setenv("FLEETSIM_CACHE_BYTES", raw)
        assert SV.cache_size_cap() == want
    monkeypatch.delenv("FLEETSIM_CACHE_BYTES")
    paths = _spaced_bundles(tmp_path, 4)
    assert SV.prune_cache(tmp_path) == 0            # unlimited: no-op
    size = paths[0].stat().st_size
    assert SV.load_bundle(paths[0], device="cpu") is not None  # a read
    before = SV._EVICTIONS[0]
    assert SV.prune_cache(tmp_path, max_bytes=int(2.5 * size)) == 2
    assert paths[0].exists() and paths[3].exists()
    assert not paths[1].exists() and not paths[2].exists()
    st = SV.cache_stats(tmp_path)
    assert st["bundles"] == 2 and st["evictions"] == before + 2
    # the env cap prunes on every save
    monkeypatch.setenv("FLEETSIM_CACHE_BYTES", str(int(2.5 * size)))
    os.utime(paths[3], (999.0, 999.0))
    SV.save_bundle(tmp_path / "new.npz", _tiny(), key="new")
    assert not paths[3].exists() and (tmp_path / "new.npz").exists()
    assert SV.SweepService(cache_dir=tmp_path, device="cpu").stats()[
        "bundle_cache"]["bundles"] == 2


# ------------------------------------------------------------ the planner

def test_cut_ladder():
    assert list(SV._cut_ladder(1, (1, 2, 4))) == [(1, 1)]
    assert list(SV._cut_ladder(3, (1, 2, 4))) == [(2, 2), (1, 1)]
    assert list(SV._cut_ladder(7, (2, 4))) == [(4, 4), (2, 2), (1, 2)]
    assert list(SV._cut_ladder(11, (1, 2, 4, 8, 16))) == \
        [(8, 8), (2, 2), (1, 1)]
    with pytest.raises(ValueError):
        list(SV._cut_ladder(3, ()))


def _whatifs(fs, factors, seed=None):
    return [SV.SweepQuery((fs.net._replace(drain=fs.net.drain * f),
                           fs.params, fs.is_inter, fs.lb),
                          seed=i if seed is None else seed, **RUN)
            for i, f in enumerate(factors)]


def test_stream_pads_orders_and_matches_each_query_alone(tmp_path):
    fs = _tiny()
    queries = _whatifs(fs, (0.8, 0.9, 1.0), seed=7)
    svc = SV.SweepService(cache_dir=tmp_path, ladder=(2, 4), device="cpu")
    got = list(svc.stream(queries))
    assert [qid for qid, _, _ in got] == [0, 1, 2]
    st = svc.stats()["scenario_cache"]
    assert (st["padded_cells"], st["batches"], st["queries"]) == (1, 2, 3)
    for qid, final, rates in got:
        alone_f, alone_r = sweeps.run_grid([queries[qid].scenario],
                                           seeds=[7], **RUN)
        assert torch.equal(rates, alone_r[0]), qid
        assert torch.equal(final.cwnd, alone_f.cwnd[0]), qid


def test_submit_matches_reference_service(tmp_path):
    """Four drain what-ifs with per-query seeds: each rate within 1e-5 x
    scale of the reference service's, and equal to a repeat."""
    fs = _tiny()
    ref = RS.to_fleetsim(RS.dumbbell_scenario(4, 4, multipath=True,
                                              n_wan=2))
    factors = (0.8, 0.9, 1.0, 1.1)
    out = SV.SweepService(cache_dir=tmp_path / "p", ladder=(1, 2, 4),
                          device="cpu").submit(_whatifs(fs, factors))
    want = RSV.SweepService(cache_dir=tmp_path / "r", ladder=(1, 2, 4)) \
        .submit([RSV.SweepQuery((ref.net._replace(drain=ref.net.drain * f),
                                 ref.params, ref.is_inter, ref.lb),
                                seed=i, **RUN)
                 for i, f in enumerate(factors)])
    for (_, r), (_, w) in zip(out, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(r.numpy() - w).max()) < 1e-5 * scale
    summ = SV.summarize_rates(out[0][1])
    assert summ["n_flows"] == 8 and summ["mean_rate"] > 0.0
    assert summ == {k: (v if k == "n_flows" else pytest.approx(v, abs=2e-4))
                    for k, v in RSV.summarize_rates(want[0][1]).items()}


def test_warm_batches_reuse_the_grid_layout(tmp_path):
    """Addressed queries: the first batch builds its layout, a repeat in
    the process reuses it (0 builds), bitwise the same rates; what-if
    tuples that keep an earlier batch's routes (the same tensor, or a
    copy of it) reuse its layout, bitwise the rates of a service that
    builds it afresh, and other routes build; a fresh service loads the
    bundle from disk."""
    svc = SV.SweepService(cache_dir=tmp_path, ladder=(1, 2, 4),
                          device="cpu")
    fs = svc.scenario("dumbbell", **DB)
    assert svc.scenario("dumbbell", **DB) is fs
    ft = svc.scenario("fat_tree", k=4, n_wan=4, n_flows=60, n_paths=4)
    queries = [SV.SweepQuery(fs, seed=i, **RUN) for i in range(3)] + \
        [SV.SweepQuery(ft, **RUN)]
    first = svc.submit(queries)
    lay = svc.stats()["grid_layouts"]
    assert lay == {"built": 3, "reused": 0}        # rungs 2 + 1, and 1
    again = svc.submit(queries)
    assert svc.stats()["grid_layouts"] == {"built": 3, "reused": 3}
    for (_, a), (_, b) in zip(first, again):
        assert torch.equal(a, b)
    hit = svc.submit(_whatifs(fs, (0.9, 1.1)))
    svc.submit(_whatifs(fs, (0.8, 1.2)))
    assert svc.stats()["grid_layouts"] == {"built": 3, "reused": 5}
    cold = SV.SweepService(cache_dir=tmp_path, ladder=(1, 2, 4),
                           device="cpu").submit(_whatifs(fs, (0.9, 1.1)))
    for (_, a), (_, b) in zip(hit, cold):
        assert torch.equal(a, b)
    copy = fs._replace(net=fs.net._replace(routes=fs.net.routes.clone()))
    svc.submit(_whatifs(copy, (0.9, 1.1)))
    assert svc.stats()["grid_layouts"] == {"built": 3, "reused": 6}
    routes = fs.net.routes.clone()
    routes[[0, -1]] = routes[[-1, 0]]            # two flows swap routes
    assert not torch.equal(routes, fs.net.routes)
    other = fs._replace(net=TL.with_layout(fs.net._replace(routes=routes)))
    svc.submit(_whatifs(other, (0.9, 1.1)))
    assert svc.stats()["grid_layouts"] == {"built": 4, "reused": 6}
    st = svc.stats()["scenario_cache"]
    assert (st["builds"], st["memo_hits"], st["disk_hits"]) == (2, 1, 0)
    fresh = SV.SweepService(cache_dir=tmp_path, device="cpu")
    fresh.scenario("dumbbell", **DB)
    assert fresh.stats()["scenario_cache"]["disk_hits"] == 1
    assert svc.stats()["device"] == "cpu"


# ------------------------------------------------------------ the CLI

QUERIES = """\
# capacity what-ifs (line numbers count comments and blanks too)
{"kind": "dumbbell", "n_intra": 2, "n_inter": 2, "n_warm": 40, "n_meas": 10}
{"kind": "dumbbell", "n_intra": 2,

{"kind": "torus", "k": 3}
{"kind": "dumbbell", "n_intra": 2, "n_inter": 2, "qcap_misspelled": 1}
{"kind": "dumbbell", "n_intra": 2, "n_inter": 2, "seed": 1, "n_warm": 40, "n_meas": 10}
"""


def test_cli_poisoned_lines_emit_errors_and_batch_drains(tmp_path):
    qfile = tmp_path / "queries.jsonl"
    qfile.write_text(QUERIES)
    out = tmp_path / "out.jsonl"
    assert sweep_server.main([
        "--queries", str(qfile), "--out", str(out), "--cache-dir",
        str(tmp_path / "cache"), "--n-warm", "40", "--n-meas", "10",
        "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    errors = [r for r in recs if "error" in r]
    results = [r for r in recs if "id" in r]
    stats = [r for r in recs if "stats" in r]
    assert sorted(e["line"] for e in errors) == [3, 5, 6]
    assert any("torus" in e["error"] for e in errors)
    assert sorted(r["line"] for r in results) == [2, 7]
    assert sorted(r["id"] for r in results) == [0, 1]
    for r in results:
        assert r["n_flows"] == 4 and r["mean_rate"] > 0.0
    assert len(stats) == 1 and recs[-1] is stats[0]
    assert stats[0]["stats"]["grid_layouts"]["built"] == 1
    assert stats[0]["stats"]["device"] == "cpu"
