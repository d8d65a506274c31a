"""The generator: reproducible from the seed, and the same scenarios the
program's own builders make (its fat-tree pairs and path sets, its fault
sweep's cells)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench.harness import config, traffic
from bench.tests.conftest import TINY, tiny


def _gen(cell, seed):
    c = tiny(cell)
    return traffic.generate(c.config, c.traffic, seed)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_same_seed_same_traffic(cell):
    a, b = _gen(cell, 2 ** 31 + 17), _gen(cell, 2 ** 31 + 17)
    assert a == b
    assert a.seeds == tuple(2 ** 31 + 17 + i for i in range(a.n_cells))


def test_other_seed_other_flows():
    a = _gen("fat_tree_k8.permutation_1m", 1)
    b = _gen("fat_tree_k8.permutation_1m", 2)
    assert a.base.links == b.base.links
    assert a.base.groups != b.base.groups
    assert a.base.n_flows == b.base.n_flows == 600


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 3])
def test_fat_tree_equals_the_programs_builder(seed):
    from repro_torch.scenarios import fat_tree_spec
    c = tiny("fat_tree_k8.permutation_1m")
    mine = traffic.topology("fat_tree")(c.config, c.traffic, seed)
    theirs = fat_tree_spec(k=4, n_wan=4, n_flows=600, n_paths=8, seed=seed)
    assert tuple(mine.links) == tuple(tuple(l) for l in theirs.links)
    for g, h in zip(mine.groups, theirs.groups, strict=True):
        assert (g.name, g.n, g.inter, tuple(g.lb)) == \
            (h.name, h.n, h.inter, tuple(h.lb))
        assert g.path_sets == h.path_sets
    assert tuple(mine[3:15]) == tuple(theirs[3:15])


def test_fault_grid_equals_the_programs_sweep_cells():
    from repro_torch.fleetsim.sweeps import _fault_cells
    c = config.load_cell("lossy_dumbbell_100k.fault_sweep128")
    cfg = dict(c.config, n_inter=30)
    gen = traffic.generate(cfg, c.traffic, 7)
    dt = gen.base.dt
    f = c.traffic["fault"]
    ax = {a["name"]: a["values"] for a in c.traffic["axes"]}
    cells, period = _fault_cells(
        [e * dt for e in ax["fail_epoch"]], ax["fault_kind"],
        [tuple(tuple(r) for r in p) for p in ax["ec_policy"]], n_inter=30,
        qcap=float(cfg["qcap_bytes"]), fault_rtts=f["window_rtts"],
        brownout_frac=f["brownout_frac"],
        flap_period_rtts=f["flap_period_rtts"], flap_duty=f["flap_duty"],
        burst_loss=f["burst_loss"], burst_corr=f["burst_corr"],
        mean_burst_len=f["mean_burst_len"], seed=7, device="cpu")
    assert len(cells) == gen.n_cells == 128
    from bench.harness.program import build
    prog = build(gen, torch.device("cpu"))
    from repro_torch.fleetsim import stack_scenarios
    g = stack_scenarios(cells)
    for a, b in ((prog.rel, g.rel), (prog.fault, g.fault),
                 (prog.params, g.params)):
        for x, y in zip(a, b, strict=True):
            assert (x is None and y is None) or torch.equal(x, y)
    assert torch.equal(prog.net.routes, g.net.routes)
    assert torch.equal(prog.net.cap, g.net.cap)
    assert all(m.rel["nack_period"] == period for m in gen.cells)


def test_traffic_files_are_data():
    for p in sorted((config.BENCH / "traffic").iterdir()):
        assert p.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv")
        assert json.loads(p.read_text())["kind"] in ("single", "grid")


def test_grid_axes_product_order():
    gen = _gen("lossy_dumbbell_100k.fault_sweep128", 3)
    kinds = [m.cap_events[0][3] if m.cap_events[0][2] else None
             for m in gen.cells]
    # fail epoch slowest, then kind, then policy: the first 2 cells are
    # "down" (capacity 0), the next 2 "brownout" (0.4)
    assert kinds[:4] == [0.0, 0.0, 0.4, 0.4]
    assert np.asarray([m.cap_events[0][1] for m in gen.cells])[[0, 8]] \
        .tolist() == [3, 9]
