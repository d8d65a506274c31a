"""The device trace cut by the program's spans (`bench.harness.spans`):
from synthetic kernels, launch records and spans, each rule of the cut;
on the CPU's profiler, the spans on its clock; and a tiny traced run of a
cell with the program's recorder on, which changes nothing the run
reports."""
from __future__ import annotations

import pytest
import torch

from bench import run
from bench.harness import spans as SP
from bench.tests.conftest import tiny
from repro_torch import trace as T
from repro_torch.trace import Span

E, F, R, L, C = ("fleetsim.epoch", "fleetsim.faults", "prng.threefry2x32",
                 "fleetsim.links", "fleetsim.cc")


def _records(t0=0):
    """One epoch (µs 100-900): faults 110-300 with a threefry 150-250,
    links 300-500, cc 520-880; then a second epoch 1000-1500 with links
    only; ns on the Unix clock from `t0`."""
    us = 1000
    return [Span(E, t0 + 100 * us, t0 + 900 * us, -1, 0),
            Span(F, t0 + 110 * us, t0 + 300 * us, 0, 0),
            Span(R, t0 + 150 * us, t0 + 250 * us, 1, 0),
            Span(L, t0 + 300 * us, t0 + 500 * us, 0, 0),
            Span(C, t0 + 520 * us, t0 + 880 * us, 0, 0),
            Span(E, t0 + 1000 * us, t0 + 1500 * us, -1, 1),
            Span(L, t0 + 1010 * us, t0 + 1400 * us, 5, 1)]


def _cut(kernels, launches, epochs=2, calls=None):
    return SP.cut(kernels, launches, SP.map_spans(_records(7), 7), epochs,
                  calls)


def test_paths_on_the_profiler_axis():
    sp = SP.map_spans(_records(5_000), 5_000)
    assert sp[2].path == "fleetsim.epoch/fleetsim.faults/prng.threefry2x32"
    assert (sp[2].start, sp[2].end) == (150.0, 250.0)
    assert sp[6].path == "fleetsim.epoch/fleetsim.links" and sp[6].parent == 5


@pytest.mark.parametrize("t, want", [
    (200.0, E + "/" + F + "/" + R), (280.0, E + "/" + F),
    (505.0, E), (600.0, E + "/" + C), (950.0, SP.OUTSIDE),
    (50.0, SP.OUTSIDE), (1450.0, E), (1200.0, E + "/" + L)])
def test_innermost_span_open_at_a_time(t, want):
    find = SP.Finder(SP.map_spans(_records(), 0))
    assert find.path(t) == want


def test_kernel_goes_to_the_span_that_launched_it():
    # (name, start, end, correlation id): each kernel runs long after its
    # launch, so its own start says nothing of its span
    kernels = [("k_draw", 2000, 2010, 1), ("k_mod", 2010, 2030, 2),
               ("k_load", 2030, 2080, 3), ("k_rate", 2080, 2090, 4),
               ("k_cc", 2090, 2190, 5), ("k_load2", 2190, 2290, 6)]
    launches = {1: 200.0, 2: 280.0, 3: 400.0, 4: 510.0, 5: 700.0,
                6: 1100.0}
    tr = _cut(kernels, launches, calls={"prng.threefry2x32": 4})
    dev = tr["device_by_path"]
    assert dev[E + "/" + F + "/" + R] == pytest.approx(10e-6)
    assert dev[E + "/" + F] == pytest.approx(20e-6)
    assert dev[E + "/" + L] == pytest.approx(150e-6)
    assert dev[E] == pytest.approx(10e-6)
    assert SP.phase_ms_per_epoch(tr, F) == pytest.approx(0.015)
    assert SP.phase_ms_per_epoch(tr, L) == pytest.approx(0.075)
    assert SP.phase_ms_per_epoch(tr, C) == pytest.approx(0.05)
    assert SP.phase_ms_per_epoch(tr, "fleetsim.reliability") == 0.0
    assert SP.epoch_own_ms_per_epoch(tr) == pytest.approx(0.005)
    assert SP.under_epoch_share(tr) == pytest.approx(100.0)
    assert SP.threefry_calls_per_epoch(tr) == 2.0
    assert SP.host_ms_per_epoch(tr) == pytest.approx((0.8 + 0.5) / 2)
    assert tr["untied"] == 0 and tr["launches_outside"] == 0
    assert tr["kernels_by_path"] == {E + "/" + F + "/" + R: 1,
                                     E + "/" + F: 1, E + "/" + L: 2,
                                     E: 1, E + "/" + C: 1}
    assert tr["host_by_path"][E] == pytest.approx(1.3e-3)
    assert tr["host_by_path"][E + "/" + L] == pytest.approx(0.59e-3)
    top = SP.breakdown(tr)["device_by_span"]
    assert top[0][0] == E + "/" + L and len(top) == 5


def test_kernel_without_launch_record_follows_the_one_before():
    kernels = [("a", 2000, 2010, 1), ("b", 2010, 2020, 99)]
    tr = _cut(kernels, {1: 200.0})
    assert tr["untied"] == 1
    assert tr["device_by_path"] == {E + "/" + F + "/" + R:
                                    pytest.approx(20e-6)}


def test_launch_outside_every_span_is_counted():
    tr = _cut([("a", 2000, 2010, 1)], {1: 950.0})
    assert tr["launches_outside"] == 1
    assert tr["device_by_path"] == {SP.OUTSIDE: pytest.approx(10e-6)}
    assert SP.under_epoch_share(tr) == 0.0


def test_gap_that_began_outside_every_span():
    # busy 100-240, idle 240-400 (began inside the threefry span: the
    # host was drawing), busy 400-920, idle 920-1100 (began between the
    # epochs: outside the program), busy 1100-1200, idle 1200-1300 (in
    # the second epoch's links)
    kernels = [("a", 100, 240, 1), ("b", 400, 920, 2), ("c", 1100, 1200, 3),
               ("d", 1300, 1310, 4)]
    tr = _cut(kernels, {1: 120.0, 2: 160.0, 3: 950.0, 4: 1150.0})
    idle = tr["idle_by_path"]
    assert idle[E + "/" + F + "/" + R] == pytest.approx(160e-6)
    assert idle[SP.OUTSIDE] == pytest.approx(180e-6)
    assert idle[E + "/" + L] == pytest.approx(100e-6)
    assert SP.idle_outside_program_share(tr) == pytest.approx(
        100.0 * 180 / 440)
    assert SP.breakdown(tr)["idle_by_span"][0][0] == SP.OUTSIDE


def test_readers_silent_without_spans():
    kernels = [("a", 100, 240, 1), ("b", 400, 920, 2)]
    tr = SP.cut(kernels, {1: 120.0}, [], 2, {"prng.threefry2x32": 4})
    for read in (SP.host_ms_per_epoch, SP.idle_outside_program_share,
                 SP.threefry_calls_per_epoch, SP.under_epoch_share,
                 SP.epoch_own_ms_per_epoch):
        assert read(tr) is None and read(None) is None
    assert SP.phase_ms_per_epoch(tr, L) is None
    assert SP.phase_ms_per_epoch(None, L) is None
    assert SP.compile_s([]) is None and SP.first_epoch_s(None) is None


def test_setup_readers():
    s = 10 ** 9
    recs = [Span("compile.to_fleetsim", 0, 2 * s, -1, -1),
            Span("compile.arrays", 0, s, 0, -1),
            Span("fleetsim.make_rel_params", 2 * s, 3 * s, -1, -1),
            Span("fleetsim.init_state", 3 * s, 4 * s, -1, -1),
            Span("fleetsim.make_step", 4 * s, 5 * s, -1, -1),
            Span(E, 6 * s, 9 * s, -1, 0),
            Span("kernels.load", 6 * s, 8 * s, 5, 0),
            Span(E, 9 * s, 10 * s, -1, 1)]
    assert SP.compile_s(recs) == pytest.approx(5.0)
    assert SP.first_epoch_s(recs) == pytest.approx(3.0)


def test_spans_on_the_cpu_profiler_clock():
    """On the CPU the profiler's host operators stand in for kernels:
    each one falls inside the span that ran it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    T.drain()
    T.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with T.span(E):
                    with T.span(L):
                        x = torch.ones(4096).mul(2.0)
                    with T.span(C):
                        x.add(1.0)
    finally:
        T.disable()
    spans = SP.map_spans(T.drain(),
                         prof.profiler.kineto_results.trace_start_ns())
    find = SP.Finder(spans)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CPU
           and e.name in ("aten::mul", "aten::add")]
    assert len(ops) == 6
    for e in ops:
        want = L if e.name == "aten::mul" else C
        assert find.path(e.time_range.start) == E + "/" + want
        assert find.path(e.time_range.end) == E + "/" + want


@pytest.mark.parametrize("cell", ["lossy_dumbbell_100k.fault_sweep128",
                                  "lossy_dumbbell_100k.recovery_sweep64"])
def test_traced_run_with_the_recorder_on(cell):
    """A tiny traced run with the program's recorder on from its start
    reports what it reports with the recorder off, correct both times;
    the recorder holds the set-up and every epoch's spans."""
    results = []
    for on in (False, True):
        T.drain()
        if on:
            T.enable()
        try:
            res = run.run_cell(tiny(cell), 2 ** 31 + 5, 0.5, True,
                               torch.device("cpu"))
        finally:
            T.disable()
        res.pop("_lines")
        results.append((res, T.drain()))
    (off, none), (on, recs) = results
    assert none == []
    assert off["correct"] is True and on["correct"] is True
    assert set(on["metrics"]) == set(off["metrics"])
    assert on["checks"] == off["checks"]
    assert SP.compile_s(recs) > 0 and SP.first_epoch_s(recs) > 0
    epochs = [r for r in recs if r.name == E]
    assert len(epochs) >= on["run"]["window_epochs"]
    names = {r.name for r in recs}
    assert {"compile.to_fleetsim", "fleetsim.stack_scenarios",
            "fleetsim.init_state", "fleetsim.make_step", L, C,
            "fleetsim.reliability"} <= names
    assert (F in names) == (cell.endswith("fault_sweep128"))


@pytest.mark.parametrize("cell", ["lossy_dumbbell_100k.fault_sweep128",
                                  "lossy_dumbbell_100k.recovery_sweep64"])
def test_traced_run_cut_by_the_spans(cell):
    """`traced_run` on the CPU: the run's own result, correct, with the
    set-up readers filled, the device readers silent (no kernels), the
    harness's `Tracer` put back and the recorder left off and empty."""
    from bench.harness import trace as HT
    real = HT.Tracer
    res = SP.traced_run(tiny(cell), 2 ** 31 + 9, 0.5, torch.device("cpu"))
    assert HT.Tracer is real and T.span(E) is T.span(L) and T.drain() == []
    assert res["correct"] is True and res["run"]["window_epochs"] > 0
    sp = res["spans"]
    assert sp["compile_s"] > 0 and sp["first_epoch_s"] > 0
    for k in ("faults", "links", "reliability", "cc", "churn"):
        assert sp[k + "_device_ms_per_epoch"] is None
    assert sp["host_ms_per_epoch"] > 0
    assert sp["idle_outside_program_share"] is None
    assert sp["untied"] == 0 and sp["launches_outside"] == 0
    assert "fleetsim.epoch/fleetsim.links" in sp["per_epoch_by_span"]
