"""The device trace of one stretch of the window, from `torch.profiler`.

`Tracer` is entered on a synchronized device and left after one; it
records the device's kernels (name, start, end) and nothing of the host's
operators (recording every operator slows the eager host loop by half
again and more, which would inflate the idle share it is there to
measure), the host clock across the stretch, and the port's fleet-kernel
launch counts across it.  `collect` turns that into what the readers of
`bench/metrics` read: the kernels, the epochs traced, the host-clock
length of the stretch (`window_s`), the union of the kernels' intervals
(`busy_s`), the launch counts, and the `breakdown` of the result line:
the device operations that took most time, and the idle gaps between
kernels summed by the kernel that waited for the host to launch it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict


def busy_union(intervals) -> float:
    """Total length (same unit) of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals):
    """(start, end) of each gap between the merged busy intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def breakdown(kernels, top: int = 10) -> dict:
    """`device_ops`: seconds per kernel name; `idle_gaps`: idle seconds
    per kernel that the device waited for ("launch of <kernel>": the host
    was still dispatching the operators before it); each the `top`
    largest."""
    by_kernel = defaultdict(float)
    for name, s, e in kernels:
        by_kernel[name[:120]] += (e - s) * 1e-6
    ks = sorted(kernels, key=lambda t: t[1])
    starts = [s for _, s, _ in ks]
    by_host = defaultdict(float)
    for s, e in idle_gaps([(s, e) for _, s, e in kernels]):
        nxt = ks[bisect.bisect_left(starts, e)][0]
        by_host["launch of " + nxt[:110]] += (e - s) * 1e-6
    return {
        "device_ops": [[k, v] for k, v in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:top]]}


class Tracer:
    """Context manager over a stretch of epochs (module docstring)."""

    def __init__(self, sync, launches, cuda: bool = True):
        self.sync, self.launches, self.cuda = sync, launches, cuda

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self.l0 = self.launches()
        # a CPU run (the tests) has no device to trace: its host operators
        # stand in, and no reader finds a kernel among them
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self.l1 = self.launches()
        return False

    def collect(self, epochs: int) -> dict:
        from torch.autograd import DeviceType
        kernels = [(e.name, e.time_range.start, e.time_range.end)
                   for e in self.prof.events()
                   if e.device_type == DeviceType.CUDA]
        launches = {k: v - self.l0.get(k, 0) for k, v in self.l1.items()
                    if v - self.l0.get(k, 0)}
        return dict(kernels=kernels, epochs=epochs, window_s=self.wall,
                    busy_s=busy_union((s, e) for _, s, e in kernels) * 1e-6,
                    launches=launches, breakdown=breakdown(kernels))
