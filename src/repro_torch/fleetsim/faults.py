"""Scheduled fault injection for the fluid fleet simulator.

The port of ``repro.fleetsim.faults``.  A scenario's `FaultSpec`s
compile into one `FaultSchedule` of epoch-indexed events, and each epoch
derives from the carried epoch counter and burst chains

  * `cap_scale`, an (n_links,) capacity multiplier: hard downs pin a
    link's capacity to 0, brownouts to a fraction, flaps toggle on a
    period/duty square wave;
  * `p_extra`, an (n_links,) extra loss probability from seeded
    Gilbert-Elliott chains (`FaultCarry.ge_bad`), one tick per epoch, the
    loss the expectation over the epoch's bytes.

`apply_modulation` folds both into the epoch's FluidNet (cap and drain
scaled, `p_extra` composed into `p_loss`), which every backend reads
unchanged; `degrade_split` drains the epoch's send split from dead
paths.  Several events on one link combine by min (capacity) and max
(loss).  Under sharding the link ids are relabeled like the routes and
the carry is replicated: it advances once per epoch whatever the shard
count.  The epoch counter is a device tensor; nothing here reads a
device value on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim import prng
from repro_torch.trace import traced

# t1 sentinel for events that never clear (fits int32, compares cleanly)
OPEN_END = 2 ** 31 - 1
_FAULT_SALT = 0xFA          # the chain key is the seed's key folded with it


class FaultSchedule(NamedTuple):
    """Epoch-indexed fault events: capacity events (E,), active on epochs
    [t0, t1) (flaps in the fault half of their period), multiplying the
    link's capacity by `cap_frac`; and Gilbert-Elliott events (G,), a
    two-state chain per event inside [ge_t0, ge_t1) emitting `ge_p_bad`
    / `ge_p_good` by state.  Either family may be empty."""
    link: torch.Tensor       # (E,) int32 target link id
    t0: torch.Tensor         # (E,) int32 first active epoch
    t1: torch.Tensor         # (E,) int32 first epoch past the event
    cap_frac: torch.Tensor   # (E,) float32 capacity multiplier while faulted
    period: torch.Tensor     # (E,) int32 flap period in epochs (0 = steady)
    duty: torch.Tensor       # (E,) float32 fraction of a period faulted
    ge_link: torch.Tensor    # (G,) int32 target link id
    ge_t0: torch.Tensor      # (G,) int32
    ge_t1: torch.Tensor      # (G,) int32
    ge_p_good: torch.Tensor  # (G,) float32 loss prob in the good state
    ge_p_bad: torch.Tensor   # (G,) float32 loss prob in the bad state
    ge_p_gb: torch.Tensor    # (G,) float32 per-epoch P(good -> bad)
    ge_p_bg: torch.Tensor    # (G,) float32 per-epoch P(bad -> good)

    @property
    def n_cap_events(self) -> int:
        return self.link.shape[-1]

    @property
    def n_ge_events(self) -> int:
        return self.ge_link.shape[-1]


class FaultCarry(NamedTuple):
    """Fault state carried from epoch to epoch; replicated, never
    flow-indexed.  A grid of B cells (`fleetsim.sweeps`) carries one
    chain key per cell, (B, 2), over its concatenated (B·G,) chains."""
    epoch: torch.Tensor    # 0-d int32: epochs since simulation start
    ge_bad: torch.Tensor   # (G,) bool: burst chains in the BAD state
    key: torch.Tensor      # (2,) int64 PRNG key of the chain transitions


@traced("fleetsim.make_schedule")
def make_schedule(cap_events: Sequence[Tuple] = (),
                  ge_events: Sequence[Tuple] = (),
                  device=None) -> FaultSchedule:
    """A FaultSchedule on `device` (default cuda) from host-side rows:
    `cap_events` (link, t0, t1, cap_frac, period, duty), `ge_events`
    (link, t0, t1, p_good, p_bad, p_gb, p_bg), epoch-valued times,
    t1 None -> OPEN_END."""
    dev = resolve_device(device)

    def col(rows, j, dtype, none=None):
        vals = [none if r[j] is None else r[j] for r in rows]
        return torch.tensor(vals, dtype=dtype, device=dev).reshape(len(rows))

    cap_events = [tuple(r) for r in cap_events]
    ge_events = [tuple(r) for r in ge_events]
    i32, f32 = torch.int32, torch.float32
    return FaultSchedule(
        link=col(cap_events, 0, i32), t0=col(cap_events, 1, i32),
        t1=col(cap_events, 2, i32, none=OPEN_END),
        cap_frac=col(cap_events, 3, f32), period=col(cap_events, 4, i32),
        duty=col(cap_events, 5, f32),
        ge_link=col(ge_events, 0, i32), ge_t0=col(ge_events, 1, i32),
        ge_t1=col(ge_events, 2, i32, none=OPEN_END),
        ge_p_good=col(ge_events, 3, f32), ge_p_bad=col(ge_events, 4, f32),
        ge_p_gb=col(ge_events, 5, f32), ge_p_bg=col(ge_events, 6, f32))


def init_fault_carry(fault: FaultSchedule, seed=0) -> FaultCarry:
    """Epoch 0, every chain good, the chain key the seed's key folded
    away from the churn key (which is the seed's own).  A sequence of
    seeds, one per cell of a grid whose schedules are concatenated, gives
    the (cells, 2) chain keys."""
    dev = fault.link.device
    return FaultCarry(
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        ge_bad=torch.zeros(fault.n_ge_events, dtype=torch.bool, device=dev),
        key=prng.fold_in(prng.PRNGKey(seed, dev), _FAULT_SALT))


def fault_modulation(fault: FaultSchedule, carry: FaultCarry, n_links: int):
    """One epoch of fault evaluation: (cap_scale, p_extra, carry'), the
    (n_links,) capacity multiplier (None without capacity events) and
    extra loss probability (None without GE events)."""
    ep = carry.epoch
    dev = ep.device
    cap_scale = None
    if fault.n_cap_events:
        active = (ep >= fault.t0) & (ep < fault.t1)
        phase = torch.remainder(ep - fault.t0, torch.clamp(fault.period,
                                                           min=1))
        flap_on = phase.to(torch.float32) < \
            fault.duty * fault.period.to(torch.float32)
        in_fault = torch.where(fault.period > 0, flap_on, True)
        eff = torch.where(active & in_fault, fault.cap_frac, 1.0)
        cap_scale = torch.ones(n_links, dtype=torch.float32, device=dev) \
            .scatter_reduce_(0, fault.link.long(), eff, "amin")
    p_extra = None
    ge_bad, key = carry.ge_bad, carry.key
    if fault.n_ge_events:
        key, u = prng.split_uniform(carry.key, fault.n_ge_events)
        win = (ep >= fault.ge_t0) & (ep < fault.ge_t1)
        # outside its window a chain is pinned to good
        ge_bad = torch.where(ge_bad, u >= fault.ge_p_bg,
                             u < fault.ge_p_gb) & win
        p_ev = torch.where(win, torch.where(ge_bad, fault.ge_p_bad,
                                            fault.ge_p_good), 0.0)
        p_extra = torch.zeros(n_links, dtype=torch.float32, device=dev) \
            .scatter_reduce_(0, fault.ge_link.long(), p_ev, "amax")
    return cap_scale, p_extra, FaultCarry(epoch=ep + 1, ge_bad=ge_bad,
                                          key=key)


def apply_modulation(net: L.FluidNet, cap_scale, p_extra) -> L.FluidNet:
    """The epoch's FluidNet: capacity and phantom drain scaled, the extra
    loss composed into `p_loss` as an independent drop stage."""
    if cap_scale is not None:
        net = net._replace(cap=net.cap * cap_scale,
                           drain=net.drain * cap_scale)
    if p_extra is not None:
        base = 0.0 if net.p_loss is None else net.p_loss
        net = net._replace(p_loss=1.0 - (1.0 - base) * (1.0 - p_extra))
    return net


def _alive_paths(net: L.FluidNet, cap_scale: torch.Tensor) -> torch.Tensor:
    """(n, p) bool: no hop of the path has capacity multiplier 0."""
    up = torch.cat([cap_scale > 0.0,
                    torch.ones(1, dtype=torch.bool, device=cap_scale.device)])
    return torch.all(L.take(up, L._pad_idx(net)), dim=2)


def degrade_split(net: L.FluidNet, split: torch.Tensor, cap_scale,
                  pmask: torch.Tensor) -> torch.Tensor:
    """The epoch's send split with dead paths drained: a path is dead when
    any hop's capacity multiplier is 0; its weight moves to the flow's
    surviving paths.  Flows with no surviving path keep the stored split
    (goodput 0, parked at the cwnd floor until a repair)."""
    ok = pmask & _alive_paths(net, cap_scale)
    any_alive = torch.any(ok, dim=1)
    w = torch.where(ok, split, 0.0)
    return torch.where(any_alive[:, None], L.normalize_split(w, ok), split)
