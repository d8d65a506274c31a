"""Event-driven packet-level network simulator core (htsim analogue): the
port's copy of ``repro.netsim.engine``, in plain Python on the host.

Units: time ns (float), sizes bytes, rates bytes/ns.  One heap event per hop
(arrival at the link's far end); FIFO queue occupancy is maintained lazily
from known service-completion times, so no dequeue events are needed.

ECN marking is RED (min/max thresholds, linear probability), applied either to
the physical queue occupancy or — when a phantom queue is attached (Uno) — to
the phantom occupancy (a counter incremented per enqueue, drained at a
constant fraction of line rate; HULL re-purposed for inter-DC BDP, §4.1.3).

Python floats, one `random.Random` per `Simulator`, and the reference's
order of arithmetic, of heap pushes (the `_seq` tie-break) and of random
draws: a run is bitwise the reference's (the same event order, traces and
counters).  No tensors: a per-packet event heap gains nothing from them.
"""
from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Callable, Optional


class Simulator:
    def __init__(self, seed: int = 0):
        self.now = 0.0
        self._heap: list = []
        self._seq = 0
        self.rng = random.Random(seed)
        self.dropped = 0
        self.delivered = 0
        self.events = 0         # events run, over all calls of `run`

    def at(self, t: float, fn: Callable, *args):
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn, args))

    def after(self, dt: float, fn: Callable, *args):
        self.at(self.now + dt, fn, *args)

    def run(self, until: Optional[float] = None, max_events: int = 500_000_000):
        n = 0
        try:
            while self._heap and n < max_events:
                t, _, fn, args = heapq.heappop(self._heap)
                if until is not None and t > until:
                    self.now = until
                    return
                self.now = t
                fn(*args)
                n += 1
        finally:
            self.events += n


class PhantomQueue:
    """Virtual queue: += size per enqueue, drains at `drain_rate` (< line rate)."""

    __slots__ = ("occ", "drain_rate", "last", "cap")

    def __init__(self, drain_rate: float, cap: float):
        self.occ = 0.0
        self.drain_rate = drain_rate
        self.last = 0.0
        self.cap = cap

    def update(self, now: float):
        self.occ = max(0.0, self.occ - (now - self.last) * self.drain_rate)
        self.last = now

    def push(self, now: float, size: int):
        self.update(now)
        self.occ = min(self.occ + size, self.cap)


class Link:
    """Directed link: egress FIFO (qcap bytes) + serializer (rate) + pdelay."""

    __slots__ = ("name", "rate", "pdelay", "qcap", "busy_until", "_inflight",
                 "_occ", "dst", "phantom", "ecn_min", "ecn_max", "p_ecn_min",
                 "p_ecn_max", "sim", "drops", "marks", "forwarded", "failed",
                 "loss_fn", "qocc_trace")

    def __init__(self, sim: Simulator, name: str, rate: float, pdelay: float,
                 qcap: int, dst=None):
        self.sim = sim
        self.name = name
        self.rate = rate
        self.pdelay = pdelay
        self.qcap = qcap
        self.busy_until = 0.0
        self._inflight: deque = deque()       # (depart_time, size)
        self._occ = 0.0                       # bytes still queued/serializing
        self.dst = dst                        # fn(pkt, now) at far end
        self.phantom: Optional[PhantomQueue] = None
        # RED thresholds on the physical queue (fractions of qcap)
        self.ecn_min = 0.25 * qcap
        self.ecn_max = 0.75 * qcap
        # RED thresholds on the phantom queue (set with attach_phantom)
        self.p_ecn_min = 0.0
        self.p_ecn_max = 0.0
        self.drops = 0
        self.marks = 0
        self.forwarded = 0
        self.failed = False
        self.loss_fn = None                   # fn(pkt, now) -> bool (random loss)
        self.qocc_trace = None                # optional [(t, occ)] recorder

    def attach_phantom(self, drain_frac: float, virtual_cap: float,
                       min_frac: float = 0.10, max_frac: float = 0.50):
        self.phantom = PhantomQueue(drain_frac * self.rate, virtual_cap)
        self.p_ecn_min = min_frac * virtual_cap
        self.p_ecn_max = max_frac * virtual_cap

    def qocc(self, now: float) -> float:
        q = self._inflight
        while q and q[0][0] <= now:
            self._occ -= q.popleft()[1]
        return self._occ

    def _red_mark(self, occ: float, lo: float, hi: float) -> bool:
        if occ <= lo:
            return False
        if occ >= hi:
            return True
        return self.sim.rng.random() < (occ - lo) / (hi - lo)

    def enqueue(self, pkt, now: float):
        if self.failed or (self.loss_fn is not None and self.loss_fn(pkt, now)):
            self.drops += 1
            self.sim.dropped += 1
            if pkt.flow is not None:
                pkt.flow.on_drop(pkt, now)
            return
        occ = self.qocc(now)
        if occ + pkt.size > self.qcap:
            self.drops += 1
            self.sim.dropped += 1
            if pkt.flow is not None:
                pkt.flow.on_drop(pkt, now)
            return
        # ECN: phantom queue if present (Uno), else physical RED
        if self.phantom is not None:
            self.phantom.push(now, pkt.size)
            if self._red_mark(self.phantom.occ, self.p_ecn_min, self.p_ecn_max):
                pkt.ecn = True
                self.marks += 1
        else:
            if self._red_mark(occ, self.ecn_min, self.ecn_max):
                pkt.ecn = True
                self.marks += 1
        depart = max(now, self.busy_until) + pkt.size / self.rate
        self.busy_until = depart
        self._inflight.append((depart, pkt.size))
        self._occ += pkt.size
        if self.qocc_trace is not None:
            self.qocc_trace.append((now, occ + pkt.size))
        self.forwarded += 1
        self.sim.at(depart + self.pdelay, self.dst, pkt)
