"""The span recorder of the port (`repro_torch.trace`), on a tiny lossy
dumbbell: 300 inter-DC flows with EC + NACK recovery and a
Gilbert-Elliott burst on the WAN, RED queues.

  * off, the recorder keeps nothing and hands out one shared no-op object;
  * on, one epoch is one `fleetsim.epoch` span over its phases
    (`fleetsim.faults` around the chains' threefry draw, `fleetsim.links`,
    `fleetsim.reliability`, `fleetsim.cc`), all with the epoch's id;
  * the step's outputs are bitwise the same with the recorder on and off;
  * the set-up spans open in the order the set-up runs, the grid's tiled
    layout (`fleetsim.tile_layout`) inside `fleetsim.stack_scenarios`;
  * on a k=4 fat-tree grid with UnoLB, `fleetsim.lb` inside each epoch's
    `fleetsim.cc`, the step bitwise the same with the recorder on and
    off, and `counters()` carrying the grid layouts tiled and compiled;
  * on the card (`gpu`): the spans lie on the profiler's clock (each
    kernel's launch inside its epoch's span), and the recorder adds no
    host sync.
"""
from __future__ import annotations

import warnings

import pytest
import torch

from repro_torch import trace as T
from repro_torch.fleetsim import (init_state, make_step, stack_scenarios,
                                  uniform_split)
from repro_torch.fleetsim import prng
from repro_torch.scenarios import spec as S
from repro_torch.scenarios import to_fleetsim

PHASES = ("fleetsim.faults", "fleetsim.links", "fleetsim.reliability",
          "fleetsim.cc")


def _spec(seed=3):
    return S.dumbbell_scenario(
        0, 300, qcap=64 * 1024, phantom=False, red_lo_frac=0.85,
        red_hi_frac=0.98, inter_rel=S.RelSpec(ec=(8, 2)), seed=seed,
        faults=(S.FaultSpec("wan", "burst", loss_rate=2e-2, burst=0.3),))


def _program(device="cpu"):
    fs = to_fleetsim(_spec(), device=device)
    state = init_state(fs.params, fs.net.n_links, n_paths=fs.net.n_paths,
                       split0=uniform_split(fs.net), seed=fs.seed,
                       rel=fs.rel, fault=fs.fault)
    step = make_step(fs.net, fs.params, "uno", fs.is_inter, lb=fs.lb,
                     churn=fs.churn, rel=fs.rel, fault=fs.fault)
    return step, state


@pytest.fixture(autouse=True)
def _recorder_off():
    T.disable()
    T.drain()
    yield
    T.disable()
    T.drain()


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]


def _children(records, i):
    return [r for r in records if r.parent == i]


def test_off_records_nothing_and_shares_one_object():
    step, state = _program()
    assert T.span("fleetsim.epoch") is T.span("fleetsim.links")
    step(state)
    assert T.drain() == []


def test_one_epoch_is_one_span_tree():
    step, state = _program()
    step(state)                         # the first epoch's lazy set-up
    T.enable()
    calls = prng.CALLS["threefry2x32"]
    step(state)
    T.disable()
    recs = T.drain()
    epochs = [i for i, r in enumerate(recs) if r.name == "fleetsim.epoch"]
    assert len(epochs) == 1 and recs[epochs[0]].parent == -1
    top = epochs[0]
    assert {r.id for r in recs} == {recs[top].id}
    kids = _children(recs, top)
    assert {r.name for r in kids} == set(PHASES)
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    draws = [r for r in recs if r.name == "prng.threefry2x32"]
    assert draws and len(draws) == prng.CALLS["threefry2x32"] - calls
    assert all(recs[r.parent].name == "fleetsim.faults" for r in draws)
    # send (rtx) and receive (`rel_step`: the NACK machine and the EC
    # split in one call) both recover
    assert sum(r.name == "fleetsim.reliability" for r in kids) == 2
    assert sum(r.name == "fleetsim.cc" for r in kids) == 1


def test_epoch_ids_advance_per_epoch():
    step, state = _program()
    T.enable()
    for _ in range(3):
        state, _ = step(state)
    T.disable()
    recs = T.drain()
    ids = [r.id for r in recs if r.name == "fleetsim.epoch"]
    assert ids == [ids[0], ids[0] + 1, ids[0] + 2]
    for i, r in enumerate(recs):
        if r.parent >= 0:
            assert r.id == recs[r.parent].id


def test_outputs_bitwise_equal_on_and_off():
    step, state0 = _program()
    runs = []
    for on in (False, True, False):
        (T.enable if on else T.disable)()
        state, outs = state0, []
        for _ in range(4):
            state, goodput = step(state)
            outs += [goodput] + _leaves(state)
        runs.append(outs)
    T.disable()
    assert len(T.drain()) > 0
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_setup_spans_in_order():
    T.enable()
    fs = to_fleetsim(_spec(), device="cpu")
    cells = [(fs.net, fs.params, fs.is_inter, fs.lb, fs.churn, fs.rel,
              fs.fault)] * 2
    g = stack_scenarios(cells)
    init_state(g.params, g.net.n_links, n_paths=g.net.n_paths,
               split0=uniform_split(g.net), seed=[1, 2], rel=g.rel,
               fault=g.fault)
    T.disable()
    recs = T.drain()
    top = [r.name for r in recs if r.parent == -1]
    assert top == ["compile.to_fleetsim", "fleetsim.stack_scenarios",
                   "fleetsim.init_state"]
    assert {r.id for r in recs} == {recs[0].id}
    compile_kids = [r.name for r in _children(recs, 0)]
    assert compile_kids == ["compile.arrays", "compile.layout",
                            "compile.rel", "compile.faults"]
    named = {r.name: i for i, r in enumerate(recs)}
    assert recs[recs[named["fleetsim.make_rel_params"]].parent].name == \
        "compile.rel"
    assert recs[recs[named["fleetsim.make_schedule"]].parent].name == \
        "compile.faults"
    starts = [r.start_ns for r in recs]
    assert starts == sorted(starts)


def test_counters_read_the_existing_counters():
    step, state = _program()
    before = T.counters().get("prng.threefry2x32", 0)
    calls = prng.CALLS["threefry2x32"]
    step(state)
    after = T.counters()
    assert after["prng.threefry2x32"] - before == \
        prng.CALLS["threefry2x32"] - calls > 0
    assert all(k.split(".", 1)[0] in ("fleet_cuda", "unorc_cuda", "prng",
                                      "sweeps")
               for k in after)


def _lb_grid():
    """Two cells of one k=4 fat tree with UnoLB on its inter-DC flows,
    stacked (the layout tiled) and stepped once to warm up."""
    from repro_torch.scenarios import fat_tree_spec
    fs = to_fleetsim(fat_tree_spec(k=4, n_wan=4, n_flows=200, seed=2),
                     device="cpu")
    cells = [(fs.net, fs.params, fs.is_inter, fs.lb, fs.churn, fs.rel,
              fs.fault)] * 2
    T.enable()
    g = stack_scenarios(cells)
    T.disable()
    setup = T.drain()
    state = init_state(g.params, g.net.n_links, n_paths=g.net.n_paths,
                       split0=uniform_split(g.net), seed=[1, 2])
    step = make_step(g.net, g.params, "uno", g.is_inter, lb=g.lb)
    step(state)
    return setup, step, state


def test_lb_and_tile_layout_spans():
    """`fleetsim.tile_layout` opens inside `fleetsim.stack_scenarios`, and
    `fleetsim.lb` (the path-mark filter and the split update) inside each
    epoch's `fleetsim.cc`."""
    setup, step, state = _lb_grid()
    names = [r.name for r in setup]
    assert names == ["fleetsim.stack_scenarios", "fleetsim.tile_layout"]
    assert setup[1].parent == 0
    T.enable()
    for _ in range(2):
        state, _ = step(state)
    T.disable()
    recs = T.drain()
    lbs = [r for r in recs if r.name == "fleetsim.lb"]
    assert len(lbs) == 2
    assert all(recs[r.parent].name == "fleetsim.cc" for r in lbs)
    assert all(recs[recs[r.parent].parent].name == "fleetsim.epoch"
               for r in lbs)


def test_lb_grid_outputs_bitwise_equal_on_and_off():
    _, step, state0 = _lb_grid()
    runs = []
    for on in (False, True):
        (T.enable if on else T.disable)()
        state, outs = state0, []
        for _ in range(3):
            state, goodput = step(state)
            outs += [goodput] + _leaves(state)
        runs.append(outs)
    T.disable()
    assert any(r.name == "fleetsim.lb" for r in T.drain())
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_counters_carry_the_grid_layouts():
    from repro_torch.fleetsim import sweeps
    before = T.counters()
    assert before["sweeps.tiled"] == sweeps.LAYOUTS["tiled"]
    assert before["sweeps.compiled"] == sweeps.LAYOUTS["compiled"]
    _lb_grid()
    after = T.counters()
    assert after["sweeps.tiled"] == before["sweeps.tiled"] + 1
    assert after["sweeps.compiled"] == before["sweeps.compiled"]


def test_traced_keeps_the_function():
    assert make_step.__name__ == "make_step"
    assert "state -> (state', goodput)" in make_step.__doc__
    assert to_fleetsim.__wrapped__.__name__ == "to_fleetsim"


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_on_the_profiler_clock(cuda):
    """Each kernel's runtime launch record (tied to the kernel by its
    correlation id) falls inside the `fleetsim.epoch` span that issued
    it; failing launch records, no kernel starts before its epoch's span
    (stream order)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bench.harness.spans import LAUNCH_NAMES
    step, state = _program(cuda)
    state, _ = step(state)
    torch.cuda.synchronize()
    T.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state)
        torch.cuda.synchronize()
    T.disable()
    recs = T.drain()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    epochs = [((r.start_ns - t0) / 1e3, (r.end_ns - t0) / 1e3)
              for r in recs if r.name == "fleetsim.epoch"]
    assert len(epochs) == 3
    events = prof.events()
    kernels = sorted((e.time_range.start, e.id) for e in events
                     if e.device_type == DeviceType.CUDA)
    launches = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name in LAUNCH_NAMES}
    assert kernels
    tied = [launches[c] for _, c in kernels if c in launches]
    if tied:
        inside = sum(any(s <= t <= e for s, e in epochs) for t in tied)
        assert inside == len(tied)
    else:
        assert kernels[0][0] >= epochs[0][0]


@pytest.mark.gpu
def test_recorder_adds_no_host_sync(cuda):
    step, state = _program(cuda)
    state, _ = step(state)
    torch.cuda.synchronize()
    counts = []
    for on in (False, True):
        (T.enable if on else T.disable)()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts.append(len(got))
    T.disable()
    assert counts[0] == counts[1]
