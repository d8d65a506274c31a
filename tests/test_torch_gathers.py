"""K2, the fleet link -> flow gathers (TPU rows 2 and 5), against the JAX
reference on the CPU.

`fleet_cuda.link_gathers` (flat, over the (n, p, h) hop table) and
`fleet_cuda.path_table_gathers` (the PathTable function in full: the
per-segment reductions and the per-subflow prefix/suffix composition)
take the three per-link vectors (scale, clean, delay) themselves.  Given
CPU tensors they run their plain versions, `ref.link_gathers_ref` and
`ref.pt_gathers_ref`.  These tests hold those against
`repro.kernels.fleet_pallas` in interpret mode and the `repro.kernels.ref`
oracles at 1e-6 normalized (the reference's own bar between its
backends; the order of the float32 products and sums differs), on a k=4
fat tree, a 3-DC ring, the random route tensors of test_torch_links and
one table built to hit the edges: paths short enough to sit whole in the
prefix (their suffix the all-padding segment), masked paths, hop ids at
the scratch slot.  A numpy float32 replay pins the kernels' order bitwise;
tests/test_torch_kernels_gpu.py holds the kernels against the plain
versions on the card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fleetsim import links as RL  # noqa: E402
from repro.kernels import fleet_pallas  # noqa: E402
from repro.kernels import ref as RK  # noqa: E402

import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402
from repro_torch.kernels import fleet_cuda  # noqa: E402
from repro_torch.kernels import ref as TK  # noqa: E402
from test_torch_links import CASES, _random_case, _t  # noqa: E402

TOL = 1e-6
_REF_GATHERS = jax.jit(RK.fleet_link_gathers_ref)
_REF_PT_GATHERS = jax.jit(RK.fleet_pt_gathers_ref)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _edge_routes():
    """(routes, n_links): h = 6, so hseg = 3.  Paths of 1-3 hops sit whole
    in the prefix (suffix: the all-padding segment), longer ones split
    ceil(m/2) + rest; whole paths masked; -1 holes inside a path."""
    r = np.full((5, 3, 6), -1, np.int32)
    r[0, 0] = [0, 1, 2, 3, 4, 5]
    r[0, 1, :1] = [2]
    r[1, 0, :3] = [1, 2, 3]
    r[1, 1, :4] = [4, 5, 0, 1]
    r[1, 2, :5] = [6, 0, 6, 2, 3]
    r[2, 0] = [5, -1, 4, -1, 3, 2]
    r[2, 1] = [6, 6, 6, 6, 6, 6]
    r[3, 0, :2] = [3, 3]
    r[4, 0, :1] = [6]
    r[4, 2] = [0, 1, 2, 3, 4, 5]                     # path 1 masked
    return r, 7


def _scenario_routes(name):
    if name == "fat_tree_k4":
        spec = TS.fat_tree_spec(k=4, n_wan=4, n_flows=60, n_paths=4, seed=2)
    else:
        spec = TS.multi_dc_spec(k=4, n_dc=3, mesh="ring", n_flows=60,
                                n_paths=4, seed=1)
    net = TS.to_fleetsim(spec, device="cpu").net
    return net.routes.numpy(), net.n_links


CASE_NAMES = (["fat_tree_k4", "multi_dc_ring", "edges"]
              + [f"case{i}" for i in range(len(CASES))])


def _case(name):
    """(routes (n, p, h) int32 with -1 padding, n_links, scale, clean,
    delay) from a numpy seed."""
    if name.startswith("case"):
        c = _random_case(**CASES[int(name[4:])])
        routes, n_links = c["routes"], c["n_links"]
    elif name == "edges":
        routes, n_links = _edge_routes()
    else:
        routes, n_links = _scenario_routes(name)
    rng = np.random.default_rng(len(name) * 7 + n_links)
    vals = (rng.uniform(0.05, 1.0, n_links).astype(np.float32),
            rng.uniform(0.0, 1.0, n_links).astype(np.float32),
            rng.uniform(0.0, 50.0, n_links).astype(np.float32))
    return routes.astype(np.int32), n_links, vals


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL,
                               err_msg=what)


def _pad_idx(routes, n_links):
    return np.where(routes >= 0, routes, n_links).astype(np.int32)


def _replay(idx, vals):
    """numpy float32, hop 0 first: the kernels' (min, prod, sum) per row
    of idx (R, h), hop id L the identity (1, 1, 0)."""
    ext = [np.append(v, np.float32(f)).astype(np.float32)
           for v, f in zip(vals, (1.0, 1.0, 0.0))]
    g = [e[idx] for e in ext]
    mn, prod, tot = g[0][:, 0], g[1][:, 0], g[2][:, 0]
    for j in range(1, idx.shape[1]):
        mn = np.fmin(mn, g[0][:, j])
        prod = np.float32(prod * g[1][:, j])
        tot = np.float32(tot + g[2][:, j])
    return mn, prod, tot


@pytest.mark.parametrize("name", CASE_NAMES)
def test_path_table_gathers_matches_pallas_and_oracles(name):
    """The whole row-5 function on the port's PathTable ==
    fleet_pallas.path_table_gathers on the reference's table, the
    PathTable oracle, and the flat oracle on the unfactored routes."""
    routes, n_links, vals = _case(name)
    pt = TL.compute_path_table(_t(routes), n_links)
    ref_pt = RL.compute_path_table(routes, n_links)
    for a, b in ((pt.pre_id, ref_pt.pre_id), (pt.suf_id, ref_pt.suf_id),
                 (pt.seg_idx, ref_pt.seg_idx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fleet_cuda.path_table_gathers(pt, *map(_t, vals))
    jv = [jnp.asarray(v) for v in vals]
    want = fleet_pallas.path_table_gathers(ref_pt.pre_id, ref_pt.suf_id,
                                           ref_pt.seg_idx, *jv, block=4,
                                           interpret=True)
    oracle = _REF_PT_GATHERS(ref_pt.pre_id, ref_pt.suf_id, ref_pt.seg_idx,
                             *jv)
    flat = _REF_GATHERS(jnp.asarray(routes), *jv)
    for i, what in enumerate(("sub_scale", "sub_frac", "sub_delay")):
        assert got[i].dtype == torch.float32
        _close(got[i], want[i], f"{name} {what} vs fleet_pallas")
        _close(got[i], oracle[i], f"{name} {what} vs pt oracle")
        _close(got[i], flat[i], f"{name} {what} vs flat oracle")
        # the min is a selection: exact against every version
        if i == 0:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(flat[0]))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_link_gathers_matches_pallas_and_oracle(name):
    """Flat K2 on the three per-link vectors == fleet_pallas.link_gathers
    and the flat oracle."""
    routes, n_links, vals = _case(name)
    pad_idx = _pad_idx(routes, n_links)
    got = fleet_cuda.link_gathers(_t(pad_idx), *map(_t, vals))
    jv = [jnp.asarray(v) for v in vals]
    want = fleet_pallas.link_gathers(jnp.asarray(pad_idx), *jv, block=4,
                                     interpret=True)
    oracle = _REF_GATHERS(jnp.asarray(routes), *jv)
    for i, what in enumerate(("sub_scale", "sub_frac", "sub_delay")):
        _close(got[i], want[i], f"{name} {what} vs fleet_pallas")
        _close(got[i], oracle[i], f"{name} {what} vs oracle")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(oracle[0]))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_versions_replay_kernel_order(name):
    """The plain versions are the kernels' arithmetic, bitwise: hop 0
    first, one rounding per step, and per subflow min(pre, suf),
    1 - prod_pre * prod_suf, sum_pre + sum_suf."""
    routes, n_links, vals = _case(name)
    pad_idx = _pad_idx(routes, n_links)
    n, p, h = pad_idx.shape
    mn, prod, tot = _replay(pad_idx.reshape(n * p, h), vals)
    got = TK.link_gathers_ref(*map(_t, (pad_idx,) + vals))
    for g, w in zip(got, (mn, np.float32(1.0) - prod, tot)):
        np.testing.assert_array_equal(g.numpy(), w.reshape(n, p))
    pt = TL.compute_path_table(_t(routes), n_links)
    mn, prod, tot = _replay(pt.seg_idx.numpy(), vals)
    pre, suf = pt.pre_id.numpy(), pt.suf_id.numpy()
    want = (np.fmin(mn[pre], mn[suf]),
            np.float32(1.0) - np.float32(prod[pre] * prod[suf]),
            np.float32(tot[pre] + tot[suf]))
    got = TK.pt_gathers_ref(pt.pre_id, pt.suf_id, pt.seg_idx,
                            *map(_t, vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_edges_read_the_identity():
    """Masked paths (both halves the all-padding segment) read (1, 0, 0);
    a path short enough for the prefix alone equals its flat reduction
    bitwise, its suffix contributing the identity exactly."""
    routes, n_links, vals = _case("edges")
    pt = TL.compute_path_table(_t(routes), n_links)
    sub = fleet_cuda.path_table_gathers(pt, *map(_t, vals))
    flat = fleet_cuda.link_gathers(_t(_pad_idx(routes, n_links)),
                                   *map(_t, vals))
    masked = ~(routes >= 0).any(axis=2)
    assert masked.sum() >= 3
    for g, ident in zip(sub, (1.0, 0.0, 0.0)):
        assert bool((g[torch.from_numpy(masked)] == ident).all())
    pad = (pt.seg_idx == n_links).all(dim=1).nonzero().reshape(-1)
    assert pad.numel() == 1
    short = ((routes >= 0).sum(axis=2) <= pt.seg_idx.shape[1]) & ~masked
    assert bool((pt.suf_id.numpy()[short] == int(pad)).all())
    s = torch.from_numpy(short)
    for g, f in zip(sub, flat):
        assert torch.equal(g[s], f[s])


def test_gather_wrappers_reject_bad_operands():
    pt = TL.compute_path_table(_t(_edge_routes()[0]), 7)
    vals = [torch.rand(7) for _ in range(3)]
    with pytest.raises(ValueError, match="lengths differ"):
        fleet_cuda.path_table_gathers(pt, vals[0], vals[1], torch.rand(6))
    with pytest.raises(TypeError):
        fleet_cuda.path_table_gathers(pt._replace(pre_id=pt.pre_id.long()),
                                      *vals)
    with pytest.raises(ValueError, match="differ"):
        fleet_cuda.path_table_gathers(pt._replace(suf_id=pt.suf_id[:2]),
                                      *vals)
    with pytest.raises(ValueError, match="at least one hop"):
        fleet_cuda.link_gathers(torch.zeros((2, 2, 0), dtype=torch.int32),
                                *vals)
    with pytest.raises(TypeError):
        fleet_cuda.link_gathers(torch.zeros((2, 2, 3), dtype=torch.int32),
                                vals[0].double(), vals[1], vals[2])
