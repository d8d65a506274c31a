"""The port's scenario layer and fluid compiler against the JAX reference:
specs equal field for field, and `to_fleetsim` arrays equal array for array
(int arrays exactly, float arrays as float32), including every RouteLayout
and PathTable field.  Also the port's device rule (no silent CPU fallback)
and its independence from JAX and the reference package."""
import ast
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as RS  # noqa: E402
from repro.fleetsim import links as RL  # noqa: E402

import repro_torch.scenarios as TS  # noqa: E402
from repro_torch.fleetsim import links as TL  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _assert_same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32), err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)


# reference RouteLayout fields that serve backends the port does not have
_LAYOUT_NOT_PORTED = {"hop_mask", "sort_link", "csr_gather"}


def _assert_tuple_same(ref, port, what, not_ported=frozenset()):
    assert [f for f in ref._fields if f not in not_ported] == \
        list(port._fields), what
    for f in port._fields:
        rv, pv = getattr(ref, f), getattr(port, f)
        if rv is None or pv is None:
            assert rv is None and pv is None, (what, f)
        elif hasattr(rv, "_fields"):
            _assert_tuple_same(rv, pv, f"{what}.{f}")
        else:
            _assert_same(rv, pv, f"{what}.{f}")


SPECS = {
    "dumbbell": lambda M: M.dumbbell_scenario(5, 7, n_bottleneck=2),
    "dumbbell_mp": lambda M: M.dumbbell_scenario(3, 6, n_bottleneck=3,
                                                 multipath=True, n_wan=4),
    "dumbbell_red_loss": lambda M: M.dumbbell_scenario(
        4, 4, phantom=False, wan_p_loss=0.01),
    "fat_tree_perm": lambda M: M.fat_tree_spec(k=4, n_wan=4, n_flows=97,
                                               n_paths=4, seed=3),
    "fat_tree_incast": lambda M: M.fat_tree_spec(
        k=4, n_wan=2, n_flows=40, n_paths=8, workload="incast", seed=11),
    "fat_tree_k6": lambda M: M.fat_tree_spec(k=6, n_wan=3, n_flows=150,
                                             n_paths=6, seed=2),
}


@functools.lru_cache(maxsize=None)
def _ref_fs(name):
    """The reference's compiled scenario, built once per module."""
    return RS.to_fleetsim(SPECS[name](RS))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_matches_reference(name):
    ref, port = SPECS[name](RS), SPECS[name](TS)
    # NamedTuples compare as tuples: links, groups, path-sets, LbSpecs
    assert tuple(ref) == tuple(port)
    assert ref.n_flows == port.n_flows


@pytest.mark.parametrize("name", sorted(SPECS))
def test_to_fleetsim_arrays_equal_reference(name):
    ref = _ref_fs(name)
    port = TS.to_fleetsim(SPECS[name](TS), device="cpu")
    net_r, net_p = ref.net, port.net
    for f in TL.FluidNet._fields:
        if f == "layout":
            continue
        rv, pv = getattr(net_r, f), getattr(net_p, f)
        if rv is None:
            assert pv is None, f
        else:
            _assert_same(rv, pv, f"net.{f}")
    _assert_tuple_same(net_r.layout, net_p.layout, "layout",
                       _LAYOUT_NOT_PORTED)
    _assert_tuple_same(ref.params, port.params, "params")
    if ref.lb is None:
        assert port.lb is None
    else:
        _assert_tuple_same(ref.lb, port.lb, "lb")
    _assert_same(ref.is_inter, port.is_inter, "is_inter")
    if ref.link_tier is None:
        assert port.link_tier is None
    else:
        _assert_same(ref.link_tier, port.link_tier, "link_tier")
    assert ref.seed == port.seed


@pytest.mark.parametrize("name", ["dumbbell_mp", "fat_tree_perm",
                                  "fat_tree_k6"])
def test_forced_path_table_equal_reference(name):
    """Every PathTable field equals the reference's when the table is
    forced (at these sizes the auto policy attaches none)."""
    ref = _ref_fs(name).net
    port = TS.to_fleetsim(SPECS[name](TS), device="cpu").net
    pt_r = RL.compute_path_table(ref.routes, ref.n_links)
    pt_p = TL.compute_path_table(port.routes, port.n_links)
    _assert_tuple_same(pt_r, pt_p, "path_table")
    lay_r = RL.compute_layout(ref.routes, ref.n_links, path_table=True)
    lay_p = TL.compute_layout(port.routes, port.n_links, path_table=True)
    _assert_tuple_same(lay_r, lay_p, "layout", _LAYOUT_NOT_PORTED)


def test_auto_policy_matches_reference_on_compressing_routes():
    """A deep-multipath fat tree clears PT_MIN_COMPRESS in both packages
    alike (k=6, 600 flows, 6 paths)."""
    spec_kw = dict(k=6, n_wan=3, n_flows=600, n_paths=6, seed=4)
    ref = RS.to_fleetsim(RS.fat_tree_spec(**spec_kw)).net.layout
    port = TS.to_fleetsim(TS.fat_tree_spec(**spec_kw), device="cpu")
    port = port.net.layout
    assert (ref.path_table is None) == (port.path_table is None)
    _assert_tuple_same(ref, port, "layout", _LAYOUT_NOT_PORTED)


def test_make_params_baseline_cadence_matches_reference():
    """make_params knobs (own-RTT cadence, EWMA gain) on the fat tree's
    per-flow BDP/RTT mix."""
    from repro.fleetsim import make_params as ref_make_params
    from repro_torch.fleetsim import make_params as port_make_params
    spec = SPECS["fat_tree_perm"](TS)
    p = _ref_fs("fat_tree_perm").params
    kw = dict(cc_period_rtts=1.0, ewma_g=0.0625, alpha_frac=0.002)
    args = (spec.intra_bdp, spec.intra_rtt)
    ref = ref_make_params(p.bdp, p.rtt, *args, **kw)
    port = port_make_params(np.array(p.bdp), np.array(p.rtt), *args,
                            device="cpu", **kw)
    _assert_tuple_same(ref, port, "params")


def test_unported_axes_raise():
    rel = TS.dumbbell_scenario(2, 2, inter_rel=TS.RelSpec())
    with pytest.raises(NotImplementedError):
        TS.to_fleetsim(rel, device="cpu")
    fault = TS.dumbbell_scenario(2, 2, faults=(TS.FaultSpec("wan"),))
    with pytest.raises(NotImplementedError):
        TS.to_fleetsim(fault, device="cpu")


def test_entry_points_never_fall_back_to_cpu():
    """Without device="cpu", entry points run on cuda — and raise where
    there is none instead of sliding to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.fleetsim import make_params
    from repro_torch.fleetsim.carry import scenario_from_arrays
    spec = TS.dumbbell_scenario(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.to_fleetsim(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_params(np.ones(2, np.float32), np.ones(2, np.float32), 1.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.compute_layout(np.zeros((2, 1, 2), np.int32), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        scenario_from_arrays({"net_cap": np.ones(2, np.float32)})


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
