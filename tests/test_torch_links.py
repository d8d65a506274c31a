"""The port's flow<->link kernel modules and `link_epoch` against the JAX
reference, on random route tensors made from a numpy seed (-1 padding on
the hop and path axes, multipath splits, flow counts that no Pallas block
divides).

On the CPU the kernel wrappers of `repro_torch.kernels.fleet_cuda` run
their kernels' plain versions, so these tests hold the wrappers'
composition (CSR operands, packing, the PathTable stages) and the plain
arithmetic against `repro.kernels.fleet_pallas` in interpret mode and the
`repro.kernels.ref` oracles, at 1e-6 normalized.  The CUDA kernels
themselves are held against the same plain versions by chip_smoke.py on
the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fleetsim import links as RL  # noqa: E402
from repro.kernels import fleet_pallas  # noqa: E402
from repro.kernels import ref as RK  # noqa: E402

from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402

TOL = 1e-6
# the reference runs jitted: one compile per shape instead of one per
# eager op keeps this file's wall clock small
_REF_EPOCH = jax.jit(RL.link_epoch,
                     static_argnames=("backend", "block", "with_loss"))
_REF_LOAD = jax.jit(RK.fleet_offered_load_ref, static_argnums=3)
_REF_GATHERS = jax.jit(RK.fleet_link_gathers_ref)
_REF_PT_LOAD = jax.jit(RK.fleet_pt_offered_load_ref, static_argnums=5)
_REF_PT_GATHERS = jax.jit(RK.fleet_pt_gathers_ref)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_case(seed, n_links=None, n_flows=None, n_paths=None,
                 max_hops=None):
    """numpy routes / link constants / rates / split from one seed."""
    rng = np.random.default_rng(seed)
    n_links = n_links or int(rng.integers(2, 9))
    n_flows = n_flows or int(rng.integers(2, 14))
    n_paths = n_paths or int(rng.integers(1, 5))
    max_hops = max_hops or int(rng.integers(1, 5))
    routes = rng.integers(-1, n_links, size=(n_flows, n_paths, max_hops))
    routes[:, 0, 0] = rng.integers(0, n_links, size=n_flows)
    routes = routes.astype(np.int32)
    mask = (routes >= 0).any(axis=2)
    w = rng.uniform(0, 1, (n_flows, n_paths)) * mask
    split = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    return dict(
        routes=routes, n_links=n_links,
        cap=rng.uniform(1.0, 20.0, n_links).astype(np.float32),
        qcap=rng.uniform(10.0, 1000.0, n_links).astype(np.float32),
        use_phantom=rng.integers(0, 2, n_links).astype(bool),
        rates=rng.uniform(0.0, 10.0, n_flows).astype(np.float32),
        split=split,
        scale=rng.uniform(0.05, 1.0, n_links).astype(np.float32),
        clean=rng.uniform(0.0, 1.0, n_links).astype(np.float32),
        delay=rng.uniform(0.0, 50.0, n_links).astype(np.float32),
        q_phys=rng.uniform(0.0, 800.0, n_links).astype(np.float32),
        q_phantom=rng.uniform(0.0, 800.0, n_links).astype(np.float32),
        p_loss=rng.uniform(0.0, 0.05, n_links).astype(np.float32))


CASES = [dict(seed=s) for s in range(2)] + [
    dict(seed=100, n_links=5, n_flows=7, n_paths=2, max_hops=3),
    dict(seed=101, n_links=6, n_flows=37, n_paths=1, max_hops=4),
    dict(seed=102, n_links=9, n_flows=33, n_paths=4, max_hops=5),
]
IDS = [f"case{i}" for i in range(len(CASES))]


def _t(a):
    return torch.as_tensor(np.array(a))


def _net_fields(c):
    q = c["qcap"]
    return dict(ecn_lo=(0.25 * q).astype(np.float32),
                ecn_hi=(0.75 * q).astype(np.float32),
                drain=(0.9 * c["cap"]).astype(np.float32), vcap=q,
                **{k: c[k] for k in ("cap", "qcap", "use_phantom")})


def _port_net(c, p_loss=False, path_table=True):
    """The port's FluidNet with its layout, from one case."""
    net = TL.FluidNet(**{k: _t(v) for k, v in _net_fields(c).items()},
                      routes=_t(c["routes"]),
                      dt=torch.tensor(1.0, dtype=torch.float32),
                      p_loss=_t(c["p_loss"]) if p_loss else None)
    return TL.with_layout(net, path_table=path_table)


def _ref_net(c, p_loss=False, path_table=True):
    """The reference's FluidNet with its layout, from the same case."""
    net = RL.FluidNet(**{k: jnp.asarray(v)
                         for k, v in _net_fields(c).items()},
                      routes=jnp.asarray(c["routes"]), dt=jnp.float32(1.0),
                      p_loss=jnp.asarray(c["p_loss"]) if p_loss else None)
    return RL.with_layout(net, path_table=path_table)


def _close(got, want, tol=TOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_oracles_match_jax_oracles(case):
    c = _random_case(**case)
    r, L = c["routes"], c["n_links"]
    _close(TK.fleet_offered_load_ref(_t(r), _t(c["rates"]), _t(c["split"]),
                                     L)[:L],
           _REF_LOAD(jnp.asarray(r), jnp.asarray(c["rates"]),
                     jnp.asarray(c["split"]), L)[:L])
    vals = [c[k] for k in ("scale", "clean", "delay")]
    for g, w in zip(TK.fleet_link_gathers_ref(_t(r), *map(_t, vals)),
                    _REF_GATHERS(jnp.asarray(r), *map(jnp.asarray, vals))):
        _close(g, w)
    pt = RL.compute_path_table(r, L)
    pt_args = [np.asarray(x) for x in (pt.pre_id, pt.suf_id, pt.seg_idx)]
    _close(TK.fleet_pt_offered_load_ref(*map(_t, pt_args), _t(c["rates"]),
                                        _t(c["split"]), L)[:L],
           _REF_PT_LOAD(*map(jnp.asarray, pt_args), jnp.asarray(c["rates"]),
                        jnp.asarray(c["split"]), L)[:L])
    for g, w in zip(TK.fleet_pt_gathers_ref(*map(_t, pt_args + vals)),
                    _REF_PT_GATHERS(*map(jnp.asarray, pt_args + vals))):
        _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_link_scatter_matches_pallas(case):
    """K1's flat contract (CSR built from pad_idx, and the layout's own
    CSR) == fleet_pallas.link_scatter on the real links."""
    c = _random_case(**case)
    L = c["n_links"]
    pad_idx = np.where(c["routes"] >= 0, c["routes"], L).astype(np.int32)
    sub = c["rates"][:, None] * c["split"]
    want = fleet_pallas.link_scatter(jnp.asarray(pad_idx), jnp.asarray(sub),
                                     L, block=4)
    got = fleet_cuda.link_scatter(_t(pad_idx), _t(sub), L)
    _close(got[:L], np.asarray(want)[:L], what="csr from pad_idx")
    assert float(got[L]) == 0.0
    lay = TL.compute_layout(_t(c["routes"]), L, path_table=False)
    got = fleet_cuda.link_scatter(_t(pad_idx), _t(sub), L,
                                  csr=(lay.sort_sub, lay.link_ptr))
    _close(got[:L], np.asarray(want)[:L], what="layout csr")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_link_gathers_matches_pallas(case):
    c = _random_case(**case)
    L = c["n_links"]
    pad_idx = np.where(c["routes"] >= 0, c["routes"], L).astype(np.int32)
    vals = [c[k] for k in ("scale", "clean", "delay")]
    want = fleet_pallas.link_gathers(jnp.asarray(pad_idx),
                                     *map(jnp.asarray, vals), block=4)
    got = fleet_cuda.link_gathers(_t(pad_idx), *map(_t, vals))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_path_table_kernels_match_pallas(case):
    """Stage 1 (path_rates), stages 1 + 2 (path_table_scatter) and the
    per-segment gathers composed per subflow (path_table_gathers) on a
    forced PathTable == the fleet_pallas path_table_* wrappers."""
    c = _random_case(**case)
    L = c["n_links"]
    ref_pt = RL.compute_path_table(c["routes"], L)
    pt = TL.compute_path_table(_t(c["routes"]), L)
    sub = c["rates"][:, None] * c["split"]
    u = pt.n_segments
    want_seg = fleet_pallas.path_rates(ref_pt.pre_id, ref_pt.suf_id,
                                       jnp.asarray(sub), u, block=4)
    got_seg = fleet_cuda.path_rates(pt, _t(sub))
    # the all-padding segment's stage-1 entries are dropped from the CSR
    # (its rate only ever lands in the scratch slot): compare the others
    live = ~(pt.seg_idx == L).all(dim=1).numpy()
    _close(got_seg[:u].numpy()[live], np.asarray(want_seg)[:u][live],
           what="path_rates")
    assert float(got_seg[u]) == 0.0
    want = fleet_pallas.path_table_scatter(
        ref_pt.pre_id, ref_pt.suf_id, ref_pt.seg_idx, jnp.asarray(sub), L,
        block=4)
    _close(fleet_cuda.path_table_scatter(pt, _t(sub))[:L],
           np.asarray(want)[:L], what="path_table_scatter")
    vals = [c[k] for k in ("scale", "clean", "delay")]
    want = fleet_pallas.path_table_gathers(
        ref_pt.pre_id, ref_pt.suf_id, ref_pt.seg_idx,
        *map(jnp.asarray, vals), block=4)
    got = fleet_cuda.path_table_gathers(pt, *map(_t, vals))
    for g, w in zip(got, want):
        _close(g, w, what="path_table_gathers")


@pytest.mark.parametrize("backend", ["reference", "pt", "cuda", "pt_cuda"])
def test_offered_load_backends_match_reference_oracle(backend):
    for case in CASES:
        c = _random_case(**case)
        net = _port_net(c)
        want = _REF_LOAD(
            jnp.asarray(c["routes"]), jnp.asarray(c["rates"]),
            jnp.asarray(c["split"]), c["n_links"])[:c["n_links"]]
        got = TL.offered_load(net, _t(c["rates"]), _t(c["split"]),
                              backend=backend)
        _close(got, want, what=f"{backend} {case}")


BACKEND_PAIRS = [("reference", "reference"), ("pt", "pt"),
                 ("cuda", "pallas"), ("pt_cuda", "pt_pallas")]


@pytest.mark.parametrize("with_loss", [False, True], ids=["", "with_loss"])
@pytest.mark.parametrize("p_loss", [False, True], ids=["clean", "p_loss"])
@pytest.mark.parametrize("port_backend,ref_backend", BACKEND_PAIRS,
                         ids=[p for p, _ in BACKEND_PAIRS])
def test_link_epoch_matches_reference(port_backend, ref_backend, p_loss,
                                      with_loss):
    """Every LinkEpoch field of one epoch (load, both queues, marks and
    the three per-subflow gathers, with the p_loss thinning; with
    `with_loss` the overflow drop probability from the pre-step queues
    and its per-subflow composition) matches
    repro.fleetsim.links.link_epoch."""
    for case in CASES[-2:]:
        c = _random_case(**case)
        ref = _ref_net(c, p_loss=p_loss)
        port = _port_net(c, p_loss=p_loss)
        want = _REF_EPOCH(ref, jnp.asarray(c["rates"]),
                          jnp.asarray(c["split"]), jnp.asarray(c["q_phys"]),
                          jnp.asarray(c["q_phantom"]),
                          backend=ref_backend, block=4, with_loss=with_loss)
        got = TL.link_epoch(port, _t(c["rates"]), _t(c["split"]),
                            _t(c["q_phys"]), _t(c["q_phantom"]),
                            backend=port_backend, with_loss=with_loss)
        for f in TL.LinkEpoch._fields:
            g, w = getattr(got, f), getattr(want, f)
            if w is None:
                assert g is None, f
                continue
            _close(g, w, what=f"{port_backend} {f} {case}")
        if with_loss:
            assert float(want.p_drop.max()) > 0.0, case   # overflow seen


def test_auto_backend_resolution_on_cpu():
    c = _random_case(seed=3)
    flat = _port_net(c, path_table=False)
    pt = _port_net(c, path_table=True)
    assert TL._resolve_backend(flat, "auto") == "reference"
    assert TL._resolve_backend(pt, "auto") == "pt"
    with pytest.raises(ValueError, match="PathTable"):
        TL._resolve_backend(flat, "pt_cuda")
    with pytest.raises(ValueError, match="unknown"):
        TL._resolve_backend(flat, "pallas")
    # with_loss runs on whatever "auto" resolves to: the flat and the
    # PathTable composition of the loss signal agree with the reference
    ref = _ref_net(c, p_loss=True, path_table=False)
    want = _REF_EPOCH(ref, jnp.asarray(c["rates"]), jnp.asarray(c["split"]),
                      jnp.asarray(c["q_phys"]), jnp.asarray(c["q_phantom"]),
                      backend="reference", block=4, with_loss=True)
    for net in (flat, pt):
        net = net._replace(p_loss=_t(c["p_loss"]))
        got = TL.link_epoch(net, _t(c["rates"]), _t(c["split"]),
                            _t(c["q_phys"]), _t(c["q_phantom"]),
                            with_loss=True)
        _close(got.p_drop, want.p_drop, what="p_drop")
        _close(got.sub_loss, want.sub_loss, what="sub_loss")


def test_segment_sum_plain_version_semantics():
    """K1's plain version: per-segment sums of the gathered entries, the
    trailing scratch slot 0.0 whatever its entries hold, empty segments
    0.0."""
    rng = np.random.default_rng(21)
    vals = rng.uniform(0, 1, 50).astype(np.float32)
    keys = np.sort(rng.integers(0, 7, 200))          # 6 real + scratch
    keys[rng.integers(0, 200, 5)] = 3                # not sorted any more
    keys = np.sort(keys)
    keys[keys == 2] = 1                              # segment 2 empty
    gather = rng.integers(0, 50, 200).astype(np.int32)
    ptr = np.searchsorted(keys, np.arange(8)).astype(np.int32)
    got = fleet_cuda.segment_sum(_t(vals), _t(gather), _t(ptr)).numpy()
    want = np.zeros(7, np.float64)
    np.add.at(want, keys, vals[gather].astype(np.float64))
    want[6] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[2] == 0.0 and got[6] == 0.0


def test_row_gathers_plain_version_semantics():
    """K2's plain version over hop rows: min of scale, 1 - product of
    clean and sum of delay over each row's hops, the scratch slot L
    reading the identity (1, 1, 0)."""
    rng = np.random.default_rng(22)
    scale, clean, delay = (_t(rng.uniform(0.1, 1, 6).astype(np.float32))
                           for _ in range(3))
    idx = rng.integers(0, 7, (11, 1, 4)).astype(np.int32)
    idx[0] = 6                                       # all scratch: identity
    mn, frac, tot = (o[:, 0] for o in
                     fleet_cuda.link_gathers(_t(idx), scale, clean, delay))
    ext = [np.append(v.numpy(), f) for v, f in
           ((scale, 1.0), (clean, 1.0), (delay, 0.0))]
    v = [e[idx[:, 0]] for e in ext]
    np.testing.assert_array_equal(mn.numpy(), v[0].min(axis=1))
    np.testing.assert_allclose(frac.numpy(), 1 - v[1].prod(axis=1),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tot.numpy(), v[2].sum(axis=1),
                               rtol=1e-6, atol=1e-6)
    assert mn[0] == 1.0 and frac[0] == 0.0 and tot[0] == 0.0


def test_wrappers_reject_bad_operands():
    vals = torch.zeros(4)
    ptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(TypeError):
        fleet_cuda.segment_sum(vals, torch.zeros(2, dtype=torch.int64), ptr)
    with pytest.raises(ValueError, match="contiguous"):
        fleet_cuda.segment_sum(
            vals, torch.zeros(4, dtype=torch.int32)[::2], ptr)
    with pytest.raises(ValueError, match="lengths differ"):
        fleet_cuda.link_gathers(torch.zeros((2, 1, 2), dtype=torch.int32),
                                torch.zeros(3), torch.zeros(3),
                                torch.zeros(4))
    with pytest.raises(ValueError, match="devices"):
        fleet_cuda.segment_sum(vals, torch.zeros(2, dtype=torch.int32),
                               ptr.to("meta"))


@pytest.mark.parametrize("n_links,max_hops", [(9, 4), (40, 9),
                                              (3_000, 9), (20_000, 9)])
def test_path_table_unique_rows_match_reference(n_links, max_hops):
    """The PathTable's row dedup (`links._unique_rows`: a lexsort of each
    row read as int64 numbers of at most 62 bits) gives
    `np.unique(axis=0)`'s rows and inverse, and the whole table the
    reference's, bitwise, on both sides of the 62-bit edge (a 5-hop
    segment over 20,000 links needs two numbers)."""
    rng = np.random.default_rng(n_links + max_hops)
    routes = rng.integers(-1, n_links, size=(600, 3, max_hops))
    routes[:, 0, 0] = rng.integers(0, n_links, size=600)
    routes[1::4] = routes[2::4]                 # shared segments
    routes = routes.astype(np.int32)
    rows = routes.reshape(-1, max_hops)[:, :(max_hops + 1) // 2]
    seg, inv = TL._unique_rows(rows, n_links)
    want, want_inv = np.unique(rows, axis=0, return_inverse=True)
    np.testing.assert_array_equal(seg, want)
    np.testing.assert_array_equal(inv, want_inv.reshape(-1))
    ref = RL.compute_path_table(routes, n_links)
    got = TL.compute_path_table(routes, n_links, device="cpu")
    for f in RL.PathTable._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
