"""The frozen byte formulas give the bytes of PERF.md's kernel table at
its shapes: the fat tree at 100k flows (rows 1 to 5) and the 8-cell
fault grid (rows 1 and 2 `@fault_grid`), and the readers turn a trace
into the numbers the per-layer metrics report."""
from __future__ import annotations

import pytest
import torch

from bench.harness import config, traffic, work
from bench.reference.compile import routes_of
from bench.tests.conftest import cell


def _shapes(spec, n_cells=1):
    from repro_torch.fleetsim.links import compute_layout
    r = torch.as_tensor(routes_of(spec))
    nl = len(spec.links)
    if n_cells > 1:
        off = (torch.arange(n_cells) * nl).reshape(-1, 1, 1, 1)
        r = torch.where(r >= 0, r[None] + off, r[None]).reshape(
            (-1,) + tuple(r.shape[1:]))
        nl *= n_cells
    lay = compute_layout(r, nl, device="cpu")

    class Net:
        routes, cap, layout = r, torch.zeros(nl), lay
    return work.layout_shapes(Net)


@pytest.fixture(scope="module")
def fat_tree_100k():
    c = cell("fat_tree_k8.permutation_1m")
    spec = traffic.topology("fat_tree")(
        c.config, dict(c.traffic, n_flows=100_000), 1)
    return _shapes(spec)


def test_fat_tree_100k_rows(fat_tree_100k):
    s = fat_tree_100k
    flat_k1 = work.segsum_bytes(s["S"] + 1, s["flat_live"], s["L"])
    pt = s["pt"]
    stage1 = work.segsum_bytes(s["S"] + 1, pt["stage1_live"], pt["U"])
    stage2 = work.segsum_bytes(pt["U"] + 1, pt["stage2_live"], s["L"])
    assert round(flat_k1 / 1e6, 1) == 23.7          # row 1
    assert round(stage1 / 1e6, 2) == 8.80           # row 3
    assert round(stage2 / 1e6, 2) == 1.27           # row 4
    assert round(work.link_gathers_bytes(s) / 1e6, 1) == 17.2   # row 5
    flat = dict(s, pt=None)
    assert round(work.link_gathers_bytes(flat) / 1e6, 1) == 38.4  # row 2
    assert work.link_scatter_bytes(s) == stage1 + stage2


def test_fault_grid_8_cells_rows():
    c = config.load_cell("lossy_dumbbell_100k.fault_sweep128")
    spec = traffic.topology("dumbbell")(c.config, {}, 0)
    s = _shapes(spec, n_cells=8)
    assert s["pt"] is None
    assert round(work.link_scatter_bytes(s) / 1e6, 2) == 9.60
    assert round(work.link_gathers_bytes(s) / 1e6, 1) == 16.0


def test_readers_from_a_trace():
    shapes = dict(n=10, p=1, h=2, S=10, L=3, flat_live=20, pt=None)
    kernels = [("void segsum_tile_kernel<1>(...)", 0.0, 2.0),
               ("link_gathers_kernel(...)", 2.0, 3.0),
               ("elementwise", 5.0, 9.0),
               ("void segsum_tile_kernel<1>(...)", 10.0, 12.0),
               ("link_gathers_kernel(...)", 12.0, 13.0)]
    tr = dict(kernels=kernels, epochs=2, window_s=20e-6,
              busy_s=11e-6, launches={"link_scatter/flat": 2,
                                      "link_gathers/flat": 2})
    ctx = dict(build_s=3.0, trace=tr, layout=shapes)
    read = {m: config.metric_reader(m) for m in (
        "kernels_per_epoch", "device_busy_ms_per_epoch", "device_idle_share",
        "link_scatter_roofline", "link_gathers_roofline", "build_s")}
    assert read["kernels_per_epoch"](ctx) == 2.5
    assert read["device_busy_ms_per_epoch"](ctx) == pytest.approx(5.5e-3)
    assert read["device_idle_share"](ctx) == pytest.approx(45.0)
    need = 2 * work.link_scatter_bytes(shapes) / work.HBM_BYTES_PER_S
    assert read["link_scatter_roofline"](ctx) == pytest.approx(
        100 * need / 4e-6)
    assert read["build_s"](ctx) == 3.0
    # the form the layout needs did not run once an epoch: no reading
    tr["launches"] = {"link_scatter/flat": 1, "link_gathers/flat": 2}
    assert read["link_scatter_roofline"](ctx) is None
    assert read["link_gathers_roofline"](ctx) is not None


def test_busy_union_and_breakdown():
    from bench.harness.trace import breakdown, busy_union
    assert busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    b = breakdown([("k1", 0, 2e6), ("k2", 3e6, 4e6), ("k1", 4e6, 5e6)])
    assert b["device_ops"] == [["k1", 3.0], ["k2", 1.0]]
    assert b["idle_gaps"] == [["launch of k2", 1.0]]
