"""The warm-up and the measured window.

The window calls the program's `step` in chunks of `chunk` epochs, each
chunk ending on a device synchronize, until `seconds` have elapsed; its
rate is all the epochs over all the time up to the last synchronize.
Epochs for the check are kept as it runs (`Sampler`), each as (state
before, state after, goodput): the epochs the cell file names by number
(`check_at`, counted from the run's first epoch, so that every run checks
the same moments of the traffic, such as a fault's first epoch), a
reservoir of `k` epochs uniform over the window's epochs and drawn from
the seed, and the window's last epoch.  Keeping an epoch holds references
to tensors the step has already made, so nothing is copied in the
window; the warm-up holds all its states, so the allocator's cache is
grown for them before the window.
"""
from __future__ import annotations

import random
import time
from typing import Callable, NamedTuple, Optional


class Kept(NamedTuple):
    epoch: int
    before: object
    after: object
    goodput: object


class Sampler:
    def __init__(self, k: int, seed: int, at=()):
        self.k = k
        self.rng = random.Random(seed ^ 0x5EC0DE)
        self.at = frozenset(int(e) for e in at)
        self.fixed: dict = {}
        self.kept: list = []
        self.seen = 0
        self.last: Optional[Kept] = None

    def offer(self, epoch, before, after, goodput):
        item = Kept(epoch, before, after, goodput)
        if epoch in self.at:
            self.fixed[epoch] = item
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item
        self.last = item

    def checked(self) -> list:
        """The named, the drawn and the last epochs, in epoch order."""
        items = {k.epoch: k for k in self.kept}
        items.update(self.fixed)
        if self.last is not None:
            items[self.last.epoch] = self.last
        return [items[e] for e in sorted(items)]

    def missed(self) -> list:
        """The named epochs that were never offered."""
        return sorted(self.at - set(self.fixed))


class Window(NamedTuple):
    epochs: int
    seconds: float
    state: object              # the state after the window's last epoch
    trace: Optional[dict]      # the traced stretch (`trace.collect`)


def warm_up(step: Callable, state, n: int, sync: Callable):
    """`n` epochs from the fresh state; returns (state, first) with
    `first` the run's first epoch as a `Kept`.  Every warm-up state is
    held until the end, so the allocator's cache is grown for as many
    states as the window's check holds (the cell's `warm_epochs` is sized
    for that) and the window allocates no new device memory."""
    first, held = None, []
    for _ in range(n):
        new, goodput = step(state)
        if first is None:
            first = Kept(0, state, new, goodput)
        held.append((state, goodput))
        state = new
    sync()
    del held
    return state, first


def run(step: Callable, state, *, seconds: float, chunk: int,
        sampler: Sampler, sync: Callable, epoch0: int = 0,
        tracer=None, trace_epochs: int = 0) -> Window:
    """The measured window (module docstring).  With `tracer`, one extra
    chunk of `trace_epochs` epochs runs under it once a third of the
    window has passed."""
    clock = time.perf_counter
    epoch, traced = epoch0, None
    sync()
    t0 = clock()
    while True:
        if tracer is not None and traced is None and \
                clock() - t0 >= seconds / 3:
            n_before = epoch
            with tracer() as tr:
                for _ in range(trace_epochs):
                    new, goodput = step(state)
                    sampler.offer(epoch, state, new, goodput)
                    state, epoch = new, epoch + 1
                sync()
            traced = tr.collect(epoch - n_before)
        for _ in range(chunk):
            new, goodput = step(state)
            sampler.offer(epoch, state, new, goodput)
            state, epoch = new, epoch + 1
        sync()
        if clock() - t0 >= seconds:
            break
    return Window(epoch - epoch0, clock() - t0, state, traced)
