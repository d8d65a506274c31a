"""A device trace cut by the program's spans.

The program (`repro_torch.trace`) records, while its recorder is on, a
span around each phase of its epoch step and of its set-up: name, start
and end on the Unix clock in ns, the index of the enclosing span's
record, and the epoch's id.  `torch.profiler` stamps its events on the
same clock, in µs from `kineto_results.trace_start_ns()`; `map_spans`
puts the spans on that axis, each under its path from the outermost span
(`fleetsim.epoch/fleetsim.faults/prng.threefry2x32`).

The rules:

  * a kernel belongs to the innermost span open when the host launched
    it: the CUDA runtime's launch record that shares the kernel's
    correlation id gives the launch time; a kernel without one takes the
    launch time of the kernel before it in stream order that has one (the
    host launches one stream's kernels in order), and `untied` counts
    them;
  * an idle gap between kernels belongs to the innermost span open on
    the host when the gap began (the end of the kernel before it); where
    no span was open, to `OUTSIDE`: the harness's loop, its synchronize,
    or a host stall.

`cut` takes a profile's kernels and launch records (`profile_events`),
the mapped spans of the traced stretch and its epochs, and returns what
the readers below read:

  * `phase_ms_per_epoch(tr, phase)`: device ms an epoch of the kernels
    launched inside `phase` (`fleetsim.faults` with its threefry draws,
    `fleetsim.links`, `fleetsim.reliability`, `fleetsim.cc`,
    `fleetsim.churn`);
  * `host_ms_per_epoch(tr)`: the mean `fleetsim.epoch` span, host ms;
  * `idle_outside_program_share(tr)`: % of the idle time between kernels
    whose gap began outside every span;
  * `threefry_calls_per_epoch(tr)`: the program's threefry2x32 count
    across the stretch, per epoch;
  * `compile_s(records)` and `first_epoch_s(records)`, from the set-up's
    records: the top-level set-up spans, summed, and the process's first
    `fleetsim.epoch` span (the kernel library's load inside it).

Each returns None where there is nothing to read: no spans (a program
without the recorder), no kernels, no epochs.

`traced_run` is `bench/run.py`'s `--trace 1` run with the recorder on and
the traced stretch cut by the spans (`tools/span_trace.py`).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple, Optional

from bench.harness.trace import idle_gaps

EPOCH = "fleetsim.epoch"
OUTSIDE = "outside the program"
PHASES = ("fleetsim.faults", "fleetsim.links", "fleetsim.reliability",
          "fleetsim.cc", "fleetsim.churn")
SETUP = ("compile.", "fleetsim.make_", "fleetsim.stack_scenarios",
         "fleetsim.init_state")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


class Mapped(NamedTuple):
    path: str
    start: float               # µs on the profiler's axis
    end: float
    parent: int                # index in the mapped list, or -1


def map_spans(records, trace_start_ns: int) -> list:
    """The records (`repro_torch.trace.Span`s, in the order they opened)
    on the profiler's µs axis, each with its path."""
    out = []
    for r in records:
        path = r.name if r.parent < 0 else out[r.parent].path + "/" + r.name
        out.append(Mapped(path, (r.start_ns - trace_start_ns) * 1e-3,
                          (r.end_ns - trace_start_ns) * 1e-3, r.parent))
    return out


class Finder:
    """The innermost mapped span open at a time: the latest-opened span
    that started at or before it, or its first ancestor still open."""

    def __init__(self, spans: list):
        self.spans = spans
        self.starts = [s.start for s in spans]

    def __call__(self, t: float) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end < t:
            i = self.spans[i].parent
        return i if i >= 0 else None

    def path(self, t: float) -> str:
        i = self(t)
        return OUTSIDE if i is None else self.spans[i].path


def profile_events(prof):
    """(kernels, launches, trace_start_ns) of a finished `torch.profiler`
    profile: kernels as (name, start µs, end µs, correlation id) in stream
    order, launches as {correlation id: µs} of the runtime's launch
    records."""
    from torch.autograd import DeviceType
    kernels, launches = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.name, e.time_range.start, e.time_range.end,
                            e.id))
        elif e.name in LAUNCH_NAMES:
            launches[e.id] = e.time_range.start
    kernels.sort(key=lambda k: k[1])
    return kernels, launches, prof.profiler.kineto_results.trace_start_ns()


def launch_times(kernels, launches):
    """Each kernel's launch time (module docstring) and how many kernels
    had no launch record of their own."""
    out, last, untied = [], None, 0
    for _, start, _, corr in kernels:
        t = launches.get(corr)
        if t is None:
            untied += 1
            t = start if last is None else last
        out.append(t)
        last = t
    return out, untied


def cut(kernels, launches, spans, epochs: int, calls: dict = None) -> dict:
    """The trace cut by the mapped spans: `device_by_path`,
    `idle_by_path` and `host_by_path` (seconds per span path: kernels,
    idle gaps, the spans' own host time), `kernels_by_path`,
    `epoch_spans` (host seconds of each `fleetsim.epoch` span), `untied`,
    `launches_outside` (tied launches that fall outside every span),
    `epochs` and `calls` (the program's counters across the stretch)."""
    find = Finder(spans)
    times, untied = launch_times(kernels, launches)
    device, count = defaultdict(float), defaultdict(int)
    outside = 0
    for (_, s, e, corr), t in zip(kernels, times):
        path = find.path(t)
        device[path] += (e - s) * 1e-6
        count[path] += 1
        outside += corr in launches and path == OUTSIDE
    idle = defaultdict(float)
    for s, e in idle_gaps([(s, e) for _, s, e, _ in kernels]):
        idle[find.path(s)] += (e - s) * 1e-6
    host = defaultdict(float)
    for s in spans:
        host[s.path] += (s.end - s.start) * 1e-6
    return dict(device_by_path=dict(device), idle_by_path=dict(idle),
                host_by_path=dict(host), kernels_by_path=dict(count),
                epoch_spans=[(s.end - s.start) * 1e-6 for s in spans
                             if s.path == EPOCH],
                untied=untied, launches_outside=outside, epochs=epochs,
                calls=dict(calls or {}), n_spans=len(spans))


def breakdown(tr: dict, top: int = 10) -> dict:
    """`device_by_span` and `idle_by_span`: the `top` span paths by
    device and by idle seconds."""
    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"device_by_span": ranked(tr["device_by_path"]),
            "idle_by_span": ranked(tr["idle_by_path"])}


def _has_spans(tr) -> bool:
    return bool(tr and tr.get("n_spans") and tr.get("epochs"))


def phase_ms_per_epoch(tr, phase: str) -> Optional[float]:
    if not _has_spans(tr) or not tr["device_by_path"]:
        return None
    return 1e3 * sum(v for k, v in tr["device_by_path"].items()
                     if phase in k.split("/")) / tr["epochs"]


def epoch_own_ms_per_epoch(tr) -> Optional[float]:
    """Device ms an epoch of the kernels launched in `fleetsim.epoch`
    outside every phase span."""
    if not _has_spans(tr) or not tr["device_by_path"]:
        return None
    return 1e3 * tr["device_by_path"].get(EPOCH, 0.0) / tr["epochs"]


def under_epoch_share(tr) -> Optional[float]:
    """% of the traced kernels' device time launched inside a
    `fleetsim.epoch` span."""
    if not _has_spans(tr) or not tr["device_by_path"]:
        return None
    total = sum(tr["device_by_path"].values())
    inside = sum(v for k, v in tr["device_by_path"].items()
                 if EPOCH in k.split("/"))
    return 100.0 * inside / total if total else None


def host_ms_per_epoch(tr) -> Optional[float]:
    if not _has_spans(tr) or not tr["epoch_spans"]:
        return None
    return 1e3 * sum(tr["epoch_spans"]) / len(tr["epoch_spans"])


def idle_outside_program_share(tr) -> Optional[float]:
    if not _has_spans(tr):
        return None
    total = sum(tr["idle_by_path"].values())
    if not total:
        return None
    return 100.0 * tr["idle_by_path"].get(OUTSIDE, 0.0) / total


def threefry_calls_per_epoch(tr) -> Optional[float]:
    if not _has_spans(tr) or "prng.threefry2x32" not in tr["calls"]:
        return None
    return tr["calls"]["prng.threefry2x32"] / tr["epochs"]


def compile_s(records) -> Optional[float]:
    """Seconds of the top-level set-up spans before the first epoch."""
    top = []
    for r in records or ():
        if r.name == EPOCH:
            break
        if r.parent < 0 and r.name.startswith(SETUP):
            top.append(r)
    if not top:
        return None
    return sum(r.end_ns - r.start_ns for r in top) * 1e-9


def first_epoch_s(records) -> Optional[float]:
    """Seconds of the first `fleetsim.epoch` span among `records`."""
    for r in records or ():
        if r.name == EPOCH:
            return (r.end_ns - r.start_ns) * 1e-9
    return None


def traced_run(cell, seed: int, seconds: float, device) -> dict:
    """`run.run_cell(cell, seed, seconds, trace=True, device)` with the
    program's recorder on from its start to the end of the window.  The
    result gains `breakdown.device_by_span` and `.idle_by_span`, and
    `spans`: the readers above over the traced stretch and the set-up,
    the kernels without a launch record (`untied`), the tied launches
    outside every span, and each span path's kernels and device, host
    and idle ms an epoch."""
    from bench import run
    from bench.harness import trace as HT
    from repro_torch import trace as T
    got = {}

    class SpanTracer(HT.Tracer):
        def __enter__(self):
            if "setup" not in got:
                got["setup"] = T.drain()
            self.c0 = T.counters()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            self.records, self.c1 = T.drain(), T.counters()
            return out

        def collect(self, epochs):
            tr = super().collect(epochs)
            kernels, launches, t0 = profile_events(self.prof)
            calls = {k: v - self.c0.get(k, 0) for k, v in self.c1.items()}
            got["cut"] = cut(kernels, launches, map_spans(self.records, t0),
                             epochs, calls)
            tr["breakdown"].update(breakdown(got["cut"]))
            return tr

    real = HT.Tracer
    HT.Tracer = SpanTracer
    T.drain()
    T.enable()
    try:
        res = run.run_cell(cell, seed, seconds, True, device)
    finally:
        T.disable()
        T.drain()
        HT.Tracer = real
    tr, setup = got.get("cut"), got.get("setup", [])
    out = {p.split(".")[1] + "_device_ms_per_epoch":
           phase_ms_per_epoch(tr, p) for p in PHASES}
    out.update(
        host_ms_per_epoch=host_ms_per_epoch(tr),
        idle_outside_program_share=idle_outside_program_share(tr),
        threefry_calls_per_epoch=threefry_calls_per_epoch(tr),
        compile_s=compile_s(setup), first_epoch_s=first_epoch_s(setup),
        epoch_own_ms_per_epoch=epoch_own_ms_per_epoch(tr),
        under_epoch_share=under_epoch_share(tr))
    if tr:
        n = tr["epochs"] or 1
        by = ("device_by_path", "host_by_path", "idle_by_path")
        paths = sorted(set(tr["kernels_by_path"]).union(*(tr[b] for b in by)))
        out.update(untied=tr["untied"],
                   launches_outside=tr["launches_outside"],
                   per_epoch_by_span={
                       k: [tr["kernels_by_path"].get(k, 0) / n]
                       + [1e3 * tr[b].get(k, 0.0) / n for b in by]
                       for k in paths})
    res["spans"] = out
    return res
