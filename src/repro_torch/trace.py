"""Spans of the port's host work, and its counters read in one place.

A span marks a stretch of host time in which the port issues one phase
of its work: the phases of the fluid simulator's epoch step
(`fleetsim.epoch` around the whole step; inside it `fleetsim.faults`,
`prng.threefry2x32`, `fleetsim.links`, `fleetsim.reliability`,
`fleetsim.cc` with `fleetsim.lb` inside it, `fleetsim.churn`) and of its
set-up (`compile.to_fleetsim` with `compile.arrays`, `compile.layout`,
`compile.rel`, `compile.faults`; `fleetsim.make_rel_params`,
`fleetsim.make_schedule`, `fleetsim.stack_scenarios` with
`fleetsim.tile_layout` inside it, `fleetsim.init_state`,
`fleetsim.make_step`; `kernels.load`).  A device kernel belongs to the
innermost span open when the host launched it, so a device trace can be
cut by phase.

The recorder is off until `enable()`; then

    with span("fleetsim.links"):
        ...

keeps one record (`Span`): the name, the start and end on the Unix clock
in ns (`time.time_ns`, the clock `torch.profiler` stamps its events
with), the index of the enclosing span's record (-1 at the top), and an
id: the epoch's number, counted from 0 and advanced by each
`fleetsim.epoch` span, so that the spans of one epoch share it and the
set-up spans before the first epoch have -1.  `drain()` takes the records out;
call it with no span open.  Off, `span` returns one shared no-op object
and records nothing.  One thread records at a time.

A span does no device work and never synchronizes, so the step stays free
of host syncs and capturable as a CUDA graph; under capture its spans
record the capture once, and a replay records nothing.  A span's time is
the host's: the kernels it launched may run long after it closed.

`counters()` reads the port's existing counters in one dict: the fleet
and UnoRC kernel launches (`kernels.fleet_cuda.LAUNCHES`,
`kernels.unorc_cuda.LAUNCHES`), the threefry2x32 evaluations
(`fleetsim.prng.CALLS`) and the grid layouts tiled or compiled
(`fleetsim.sweeps.LAYOUTS`), which stay where they are.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

EPOCH = "fleetsim.epoch"

_on = False
_records: list = []        # [name, start_ns, end_ns, parent, id]
_open: list = []           # indices into _records of the open spans
_epoch = -1


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int            # index of the enclosing span's record, or -1
    id: int                # the epoch (spans before the first epoch: -1)


class _Recording:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _epoch
        if self.name == EPOCH:
            _epoch += 1
        self.record = [self.name, 0, 0, _open[-1] if _open else -1, _epoch]
        _open.append(len(_records))
        _records.append(self.record)
        self.record[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.record[2] = time.time_ns()
        if _open:
            _open.pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records `name` while the recorder is on;
    the shared no-op object while it is off."""
    return _Recording(name) if _on else _OFF


def traced(name: str):
    """Decorate a function so that each call is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> list:
    """The records so far, as `Span`s in the order their spans opened,
    and an empty recorder (the epoch count goes on)."""
    out = [Span(*r) for r in _records]
    _records.clear()
    _open.clear()
    return out


def counters() -> dict:
    """The port's counters so far, keyed `<module>.<key>`:
    `fleet_cuda.<kernel>/<use>`, `unorc_cuda.<kernel>[/<use>]`,
    `prng.threefry2x32`, `sweeps.tiled`, `sweeps.compiled`."""
    from repro_torch.fleetsim import prng, sweeps
    from repro_torch.kernels import fleet_cuda, unorc_cuda
    out = {}
    for mod, counts in (("fleet_cuda", fleet_cuda.LAUNCHES),
                        ("unorc_cuda", unorc_cuda.LAUNCHES),
                        ("prng", prng.CALLS),
                        ("sweeps", sweeps.LAYOUTS)):
        out.update((f"{mod}.{k}", v) for k, v in counts.items())
    return out
