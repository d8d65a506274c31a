"""Cross-validation of the fluid model against the packet simulator: the
port of ``repro.fleetsim.validate``.

ONE scenario spec compiles to both simulators and their steady-state
per-flow goodput is compared positionally (the spec fixes the flow
order).  The packet half runs the port's packet simulator
(`repro_torch.netsim`, plain Python on the host: a run is bitwise the
reference's); the fluid half runs the port's fleet model on `device`
(cuda unless the caller passes "cpu"):

  * spec builders, one per comparison, with the reference's `compare_*`
    arguments and defaults (`steady_state_spec`, `multipath_spec`,
    `recovery_spec`, `fault_spec`, `adaptive_ec_spec` and
    `adaptive_ec_packet_spec`, `fat_tree_steady_spec`,
    `multi_dc_steady_spec`);
  * the packet halves (from `scenarios.compile_netsim`, which imports no
    torch): `netsim_scenario_rates` (the per-flow mean goodput of the ACK
    trace over [t0, horizon)) and `netsim_recovery_rates` (the same plus
    the window's retransmit fraction, sum(n_retx) / sum(n_sent) after t0:
    the recovery and adaptive-EC runs);
  * the fluid halves: `fluid_scenario_rates` (a warm-up, then the mean
    goodput of the measurement window), `fluid_recovery` (the same with
    the reliability counters of the window), `fluid_fault_recovery` (the
    warm-up runs to the packet window's start `t0`, the measurement
    spans it) and `fluid_adaptive_ec` (the ladder's settled rung, the
    per-flow majority at the window's end);
  * the result dicts with the reference's keys and formulas
    (`scenario_result`, `recovery_result`, `fault_result`,
    `adaptive_ec_result`);
  * `compare_*`, each spec + packet half + fluid half -> the reference's
    dict.  The packet numbers may be given (`netsim=`, `retx_netsim=`,
    `compare_adaptive_ec`'s `replay=`), e.g. from a packet run in another
    process; by default the comparison runs its packet half itself.
    `compare_adaptive_ec` is two-stage as in the reference: the fluid
    ladder settles first, then the packet run replays the settled rung's
    fixed geometry.

    res = compare_steady_state(1, 1)                # on the card
    res = compare_steady_state(1, 1, device="cpu")  # on the CPU

The fluid run is eager, one epoch a step: at the reference's depth
(220,000 epochs) it takes minutes on a CPU, where the reference's jitted
scan takes seconds.  The packet half takes seconds.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleetsim import cc as fleet_cc
from repro_torch.scenarios import (FaultSpec, LbSpec, RelSpec, Scenario,
                                   dumbbell_scenario, fat_tree_spec,
                                   multi_dc_spec, netsim_recovery_rates,
                                   netsim_scenario_rates, to_fleetsim)
from repro_torch.scenarios.spec import MIB, MS, RATE_100G, US


# ------------------------------------------------------------ spec builders

def steady_state_spec(n_intra: int, n_inter: int, *,
                      rate: float = RATE_100G, intra_rtt: float = 14 * US,
                      inter_rtt: float = 2 * MS, seed: int = 1) -> Scenario:
    """`compare_steady_state`'s spray-routing dumbbell: the WAN as
    separate border links, inter flows on RPS over 8 subflows."""
    return dumbbell_scenario(n_intra, n_inter, rate=rate,
                             intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                             multipath=True, seed=seed,
                             inter_lb=LbSpec(kind="rps", n_subflows=8))


def multipath_spec(n_intra: int, n_inter: int, *, rate: float = RATE_100G,
                   intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
                   n_wan: int = 8, n_bottleneck: int = 1,
                   seed: int = 1) -> Scenario:
    """`compare_multipath_steady_state`'s dumbbell with adaptive LB."""
    return dumbbell_scenario(n_intra, n_inter, rate=rate,
                             intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                             multipath=True, n_wan=n_wan,
                             n_bottleneck=n_bottleneck, seed=seed)


def recovery_spec(n_inter: int = 6, *, ec: tuple = (8, 2),
                  p_loss: float = 0.02, qcap: float = 512 * MIB,
                  rate: float = RATE_100G, intra_rtt: float = 14 * US,
                  inter_rtt: float = 2 * MS,
                  nack_period: Optional[float] = None,
                  seed: int = 1) -> Scenario:
    """`compare_recovery_steady_state`'s dumbbell: configured loss
    `p_loss` on the WAN, EC `ec`, the NACK period 2 x inter_rtt by
    default."""
    if nack_period is None:
        nack_period = 2.0 * inter_rtt
    return dumbbell_scenario(0, n_inter, rate=rate, intra_rtt=intra_rtt,
                             inter_rtt=inter_rtt, qcap=qcap,
                             wan_p_loss=p_loss,
                             inter_rel=RelSpec(ec=ec,
                                               nack_period=nack_period),
                             seed=seed)


def fault_spec(n_inter: int = 8, *, n_wan: int = 4,
               fail_link: str = "wan0", t_fail: float = 4 * MS,
               rate: float = RATE_100G, intra_rtt: float = 14 * US,
               inter_rtt: float = 2 * MS, seed: int = 1) -> Scenario:
    """`compare_fault_recovery`'s multipath dumbbell (UnoLB over n_wan
    subflows) with `fail_link` down from `t_fail` on."""
    return dumbbell_scenario(
        0, n_inter, rate=rate, intra_rtt=intra_rtt, inter_rtt=inter_rtt,
        multipath=True, n_wan=n_wan,
        inter_lb=LbSpec(kind="unolb", n_subflows=n_wan),
        faults=(FaultSpec(link=fail_link, kind="down", t_start=t_fail),),
        seed=seed)


def adaptive_ec_spec(p_loss: float = 0.02, *,
                     ladder: tuple = ((8, 1), (8, 2), (8, 4)),
                     ladder_up: Optional[tuple] = None,
                     ladder_down: Optional[tuple] = None,
                     n_inter: int = 6, qcap: float = 512 * MIB,
                     rate: float = RATE_100G, intra_rtt: float = 14 * US,
                     inter_rtt: float = 2 * MS,
                     nack_period: Optional[float] = None,
                     seed: int = 1) -> Scenario:
    """`compare_adaptive_ec`'s fluid dumbbell: the EC ladder on, starting
    at its first rung."""
    if nack_period is None:
        nack_period = 2.0 * inter_rtt
    return dumbbell_scenario(
        0, n_inter, rate=rate, intra_rtt=intra_rtt, inter_rtt=inter_rtt,
        qcap=qcap, wan_p_loss=p_loss,
        inter_rel=RelSpec(ec=tuple(ladder[0]), nack_period=nack_period,
                          ladder=tuple(tuple(kr) for kr in ladder),
                          ladder_up=ladder_up, ladder_down=ladder_down),
        seed=seed)


def adaptive_ec_packet_spec(p_loss: float, geometry: tuple, *,
                            n_inter: int = 6, qcap: float = 512 * MIB,
                            rate: float = RATE_100G,
                            intra_rtt: float = 14 * US,
                            inter_rtt: float = 2 * MS,
                            nack_period: Optional[float] = None,
                            seed: int = 1) -> Scenario:
    """The packet side of `compare_adaptive_ec`: the same dumbbell with
    the settled rung's (k, r) as its static EC geometry."""
    if nack_period is None:
        nack_period = 2.0 * inter_rtt
    return dumbbell_scenario(
        0, n_inter, rate=rate, intra_rtt=intra_rtt, inter_rtt=inter_rtt,
        qcap=qcap, wan_p_loss=p_loss,
        inter_rel=RelSpec(ec=tuple(geometry), nack_period=nack_period),
        seed=seed)


def fat_tree_steady_spec(k: int = 4, *, n_intra_pod: int = 0,
                         n_cross_pod: int = 6, n_inter: int = 0,
                         n_wan: int = 4, n_paths: int = 4,
                         workload: str = "incast",
                         seed: int = 1) -> Scenario:
    """`compare_fat_tree_steady_state`'s spec: the single-class cross-pod
    incast on the two-DC k-ary fat tree by default."""
    return fat_tree_spec(k=k, n_wan=n_wan, n_intra_pod=n_intra_pod,
                         n_cross_pod=n_cross_pod, n_inter=n_inter,
                         workload=workload, n_paths=n_paths, seed=seed)


def multi_dc_steady_spec(k: int = 4, n_dc: int = 3, *, mesh: str = "ring",
                         oversub: float = 1.0, n_intra_pod: int = 0,
                         n_cross_pod: int = 6, n_inter: int = 0,
                         n_wan: int = 4, n_paths: int = 4,
                         workload: str = "incast",
                         seed: int = 1) -> Scenario:
    """`compare_multi_dc_steady_state`'s spec: the same incast on DC 0 of
    an N-DC fat tree behind a WAN mesh."""
    return multi_dc_spec(k=k, n_dc=n_dc, mesh=mesh, oversub=oversub,
                         n_wan=n_wan, n_intra_pod=n_intra_pod,
                         n_cross_pod=n_cross_pod, n_inter=n_inter,
                         workload=workload, n_paths=n_paths, seed=seed)


# ------------------------------------------------------------ fluid halves

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def fluid_scenario_rates(spec: Scenario, *, n_warm: int = 200_000,
                         n_meas: int = 20_000, scheme: str = "uno",
                         device: DeviceLike = None,
                         backend: str = "auto") -> np.ndarray:
    """Fluid steady-state per-flow goodput (bytes/ns), spec flow order:
    `steady_state` after `n_warm` epochs, averaged over `n_meas`."""
    fs = to_fleetsim(spec, device=resolve_device(device))
    _, rates = fleet_cc.steady_state(fs.net, fs.params, n_warm=n_warm,
                                     n_meas=n_meas, scheme=scheme,
                                     is_inter=fs.is_inter, lb=fs.lb,
                                     churn=fs.churn, seed=fs.seed,
                                     backend=backend)
    return _np(rates)


def _warm_then_record(fs, n_warm: int, n_meas: int, backend: str,
                      fault: bool = False):
    """`simulate` for n_warm epochs from the seeded state, then n_meas
    more recorded: (warm state, final state, per-flow mean goodput)."""
    kw = dict(scheme="uno", is_inter=fs.is_inter, lb=fs.lb,
              churn=fs.churn, rel=fs.rel, backend=backend)
    if fault:
        kw["fault"] = fs.fault
    warm, _ = fleet_cc.simulate(fs.net, fs.params, n_epochs=n_warm,
                                seed=fs.seed, **kw)
    final, traj = fleet_cc.simulate(fs.net, fs.params, n_epochs=n_meas,
                                    state0=warm, record=True, **kw)
    return warm, final, _np(traj).mean(axis=0)


def _rel_fracs(warm, final) -> dict:
    """The window's reliability counters as fractions of its wire bytes:
    retransmitted, parity-recovered and lost bytes, and the NACK count."""

    def diff(field):
        d = _np(getattr(final.rel, field)) - _np(getattr(warm.rel, field))
        return float(np.sum(d))

    wire = max(diff("wire_bytes"), 1.0)
    return {"retx_fluid": diff("rtx_bytes") / wire,
            "rec_fluid": diff("rec_bytes") / wire,
            "nack_fluid": float(np.sum(_np(final.rel.nacks)
                                       - _np(warm.rel.nacks))),
            "loss_fluid": diff("lost_bytes") / wire}


def fluid_recovery(spec: Scenario, *, n_warm: int = 200_000,
                   n_meas: int = 20_000, device: DeviceLike = None,
                   backend: str = "auto") -> dict:
    """`compare_recovery_steady_state`'s fluid half: {"fluid" (per-flow
    mean goodput of the window), "retx_fluid", "rec_fluid", "nack_fluid",
    "loss_fluid"}, the counters diffed between the window's ends."""
    fs = to_fleetsim(spec, device=resolve_device(device))
    warm, final, fm = _warm_then_record(fs, n_warm, n_meas, backend)
    return {"fluid": fm, **_rel_fracs(warm, final)}


def fault_window(spec: Scenario, t0: float, horizon: float,
                 n_meas: Optional[int] = None, dt: Optional[float] = None):
    """(n_warm, n_meas) of `compare_fault_recovery`: the warm-up runs to
    the packet window's start t0, the measurement spans [t0, horizon),
    both in whole epochs of the spec's period (`dt`: the compiled net's,
    if not given)."""
    if dt is None:
        dt = float(to_fleetsim(spec, device="cpu").net.dt)
    n_warm = max(int(round(t0 / dt)), 1)
    if n_meas is None:
        n_meas = max(int(round((horizon - t0) / dt)), 1)
    return n_warm, n_meas


def fluid_fault_recovery(spec: Scenario, *, t0: float = 45 * MS,
                         horizon: float = 70 * MS,
                         n_meas: Optional[int] = None,
                         device: DeviceLike = None,
                         backend: str = "auto") -> dict:
    """`compare_fault_recovery`'s fluid half: {"fluid", "agg_fluid",
    "n_warm", "n_meas"} over the post-failure window."""
    fs = to_fleetsim(spec, device=resolve_device(device))
    n_warm, n_meas = fault_window(spec, t0, horizon, n_meas,
                                  dt=float(fs.net.dt))
    _, _, fm = _warm_then_record(fs, n_warm, n_meas, backend, fault=True)
    return {"fluid": fm, "agg_fluid": float(fm.sum()), "n_warm": n_warm,
            "n_meas": n_meas}


def fluid_adaptive_ec(spec: Scenario, *, n_warm: int = 200_000,
                      n_meas: int = 20_000, device: DeviceLike = None,
                      backend: str = "auto") -> dict:
    """`compare_adaptive_ec`'s fluid half: {"fluid", "rung_fluid" (the
    per-flow majority rung at the window's end), "rung_geometry",
    "retx_fluid", "rec_fluid", "loss_fluid"}."""
    ladder = next(g.rel.ladder for g in spec.groups
                  if g.rel is not None and g.rel.ladder)
    fs = to_fleetsim(spec, device=resolve_device(device))
    warm, final, fm = _warm_then_record(fs, n_warm, n_meas, backend)
    rungs = _np(final.rel.rung)
    rung = int(np.bincount(rungs, minlength=len(ladder)).argmax())
    fr = _rel_fracs(warm, final)
    return {"fluid": fm, "rung_fluid": rung,
            "rung_geometry": tuple(ladder[rung]),
            "retx_fluid": fr["retx_fluid"], "rec_fluid": fr["rec_fluid"],
            "loss_fluid": fr["loss_fluid"]}


# ------------------------------------------------------------ result dicts

def scenario_result(spec: Scenario, netsim, fluid) -> dict:
    """The reference's `compare_scenario` dict from the two rate vectors:
    {"netsim", "fluid", "rel_err", "max_rel_err", "util_netsim",
    "util_fluid"}."""
    ns, fm = np.asarray(netsim), np.asarray(fluid)
    rel = np.abs(fm - ns) / np.maximum(ns, 1e-9)
    return {
        "netsim": ns, "fluid": fm, "rel_err": rel,
        "max_rel_err": float(rel.max()),
        "util_netsim": float(ns.sum() / spec.rate),
        "util_fluid": float(fm.sum() / spec.rate),
    }


def recovery_result(spec: Scenario, netsim, retx_netsim: float,
                    fluid: dict) -> dict:
    """`compare_recovery_steady_state`'s dict: `scenario_result` plus
    "retx_netsim" and `fluid_recovery`'s four counters."""
    return {**scenario_result(spec, netsim, fluid["fluid"]),
            "retx_netsim": float(retx_netsim),
            **{k: fluid[k] for k in ("retx_fluid", "rec_fluid",
                                     "nack_fluid", "loss_fluid")}}


def fault_result(spec: Scenario, netsim, fluid) -> dict:
    """`compare_fault_recovery`'s dict: the aggregates and utilizations
    (per-flow positions after a failure are not comparable)."""
    ns, fm = np.asarray(netsim), np.asarray(fluid)
    agg_ns, agg_fl = float(ns.sum()), float(fm.sum())
    return {
        "netsim": ns, "fluid": fm,
        "agg_netsim": agg_ns, "agg_fluid": agg_fl,
        "agg_rel_err": abs(agg_fl - agg_ns) / max(agg_ns, 1e-9),
        "util_netsim": agg_ns / spec.rate,
        "util_fluid": agg_fl / spec.rate,
    }


def adaptive_ec_result(spec: Scenario, netsim, retx_netsim: float,
                       fluid: dict) -> dict:
    """`compare_adaptive_ec`'s dict: `scenario_result` plus the settled
    rung, its geometry and the recovery fractions."""
    return {**scenario_result(spec, netsim, fluid["fluid"]),
            "rung_fluid": fluid["rung_fluid"],
            "rung_geometry": fluid["rung_geometry"],
            "retx_netsim": float(retx_netsim),
            **{k: fluid[k] for k in ("retx_fluid", "rec_fluid",
                                     "loss_fluid")}}


# ------------------------------------------------------------ comparisons

def compare_scenario(spec: Scenario, netsim=None, *,
                     horizon: float = 45 * MS, t0: float = 15 * MS,
                     size: int = 512 * MIB, n_warm: int = 200_000,
                     n_meas: int = 20_000, lb=None,
                     device: DeviceLike = None) -> dict:
    """Run both compilations of one spec; report per-flow agreement.
    `netsim`: the packet rates, if already run (`netsim_scenario_rates`
    with these arguments otherwise)."""
    if netsim is None:
        netsim = netsim_scenario_rates(spec, horizon=horizon, t0=t0,
                                       size=size, lb=lb)
    fm = fluid_scenario_rates(spec, n_warm=n_warm, n_meas=n_meas,
                              device=device)
    return scenario_result(spec, netsim, fm)


def compare_steady_state(n_intra: int, n_inter: int, *, netsim=None,
                         rate: float = RATE_100G,
                         intra_rtt: float = 14 * US,
                         inter_rtt: float = 2 * MS,
                         horizon: float = 45 * MS, t0: float = 15 * MS,
                         n_warm: int = 200_000, n_meas: int = 20_000,
                         seed: int = 1, device: DeviceLike = None) -> dict:
    """The spray-routing dumbbell acceptance (`steady_state_spec`)."""
    spec = steady_state_spec(n_intra, n_inter, rate=rate,
                             intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                             seed=seed)
    return compare_scenario(spec, netsim, horizon=horizon, t0=t0,
                            n_warm=n_warm, n_meas=n_meas, device=device)


def compare_multipath_steady_state(n_intra: int, n_inter: int, *,
                                   netsim=None, rate: float = RATE_100G,
                                   intra_rtt: float = 14 * US,
                                   inter_rtt: float = 2 * MS,
                                   n_wan: int = 8, n_bottleneck: int = 1,
                                   horizon: float = 45 * MS,
                                   t0: float = 15 * MS,
                                   n_warm: int = 200_000,
                                   n_meas: int = 20_000, seed: int = 1,
                                   device: DeviceLike = None) -> dict:
    """The multipath acceptance (`multipath_spec`): UnoLB in the packet
    run, the adaptive split in the fluid one."""
    spec = multipath_spec(n_intra, n_inter, rate=rate, intra_rtt=intra_rtt,
                          inter_rtt=inter_rtt, n_wan=n_wan,
                          n_bottleneck=n_bottleneck, seed=seed)
    return compare_scenario(spec, netsim, horizon=horizon, t0=t0,
                            n_warm=n_warm, n_meas=n_meas, device=device)


def compare_recovery_steady_state(n_inter: int = 6, *, netsim=None,
                                  retx_netsim: Optional[float] = None,
                                  ec: tuple = (8, 2),
                                  p_loss: float = 0.02,
                                  qcap: float = 512 * MIB,
                                  rate: float = RATE_100G,
                                  intra_rtt: float = 14 * US,
                                  inter_rtt: float = 2 * MS,
                                  nack_period: Optional[float] = None,
                                  horizon: float = 60 * MS,
                                  t0: float = 20 * MS,
                                  size: int = 512 * MIB,
                                  n_warm: int = 200_000,
                                  n_meas: int = 20_000, seed: int = 1,
                                  device: DeviceLike = None) -> dict:
    """The loss-recovery acceptance (`recovery_spec`): EC framing and NACK
    block recovery in the packet run against the fluid reliability
    machine.  `netsim` and `retx_netsim` (sum(n_retx) / sum(n_sent) over
    the packet window), if given together, stand for the packet run."""
    if (netsim is None) != (retx_netsim is None):
        raise ValueError("give netsim and retx_netsim together, or neither")
    spec = recovery_spec(n_inter, ec=ec, p_loss=p_loss, qcap=qcap,
                         rate=rate, intra_rtt=intra_rtt,
                         inter_rtt=inter_rtt, nack_period=nack_period,
                         seed=seed)
    if netsim is None:
        netsim, retx_netsim = netsim_recovery_rates(spec, horizon=horizon,
                                                    t0=t0, size=size)
    fluid = fluid_recovery(spec, n_warm=n_warm, n_meas=n_meas,
                           device=device)
    return recovery_result(spec, netsim, retx_netsim, fluid)


def compare_fault_recovery(n_inter: int = 8, *, netsim=None,
                           n_wan: int = 4, fail_link: str = "wan0",
                           t_fail: float = 4 * MS,
                           rate: float = RATE_100G,
                           intra_rtt: float = 14 * US,
                           inter_rtt: float = 2 * MS,
                           horizon: float = 70 * MS, t0: float = 45 * MS,
                           n_meas: Optional[int] = None, seed: int = 1,
                           device: DeviceLike = None) -> dict:
    """The fault acceptance (`fault_spec`): the packet rates over [t0,
    horizon); the fluid window is the same span in epochs."""
    if not t_fail < t0:
        raise ValueError("t_fail must precede the measurement window t0")
    spec = fault_spec(n_inter, n_wan=n_wan, fail_link=fail_link,
                      t_fail=t_fail, rate=rate, intra_rtt=intra_rtt,
                      inter_rtt=inter_rtt, seed=seed)
    if netsim is None:
        netsim = netsim_scenario_rates(spec, horizon=horizon, t0=t0)
    fluid = fluid_fault_recovery(spec, t0=t0, horizon=horizon,
                                 n_meas=n_meas, device=device)
    return fault_result(spec, netsim, fluid["fluid"])


def compare_adaptive_ec(p_loss: float = 0.02, *,
                        replay: Optional[Callable[[Scenario], tuple]] = None,
                        ladder: tuple = ((8, 1), (8, 2), (8, 4)),
                        ladder_up: Optional[tuple] = None,
                        ladder_down: Optional[tuple] = None,
                        n_inter: int = 6, qcap: float = 512 * MIB,
                        rate: float = RATE_100G,
                        intra_rtt: float = 14 * US,
                        inter_rtt: float = 2 * MS,
                        nack_period: Optional[float] = None,
                        horizon: float = 60 * MS, t0: float = 20 * MS,
                        size: int = 512 * MIB,
                        n_warm: int = 200_000, n_meas: int = 20_000,
                        seed: int = 1, device: DeviceLike = None) -> dict:
    """The adaptive-EC acceptance, two-stage: the fluid ladder settles on
    a rung (`adaptive_ec_spec`), then the packet run replays
    `adaptive_ec_packet_spec` at that rung's fixed geometry.  `replay`
    (spec -> (per-flow rates, retransmit fraction)) stands for that run;
    by default it is `netsim_recovery_rates` over [t0, horizon)."""
    spec = adaptive_ec_spec(p_loss, ladder=ladder, ladder_up=ladder_up,
                            ladder_down=ladder_down, n_inter=n_inter,
                            qcap=qcap, rate=rate, intra_rtt=intra_rtt,
                            inter_rtt=inter_rtt, nack_period=nack_period,
                            seed=seed)
    fluid = fluid_adaptive_ec(spec, n_warm=n_warm, n_meas=n_meas,
                              device=device)
    if replay is None:
        def replay(s):
            return netsim_recovery_rates(s, horizon=horizon, t0=t0,
                                         size=size)
    netsim, retx_netsim = replay(adaptive_ec_packet_spec(
        p_loss, fluid["rung_geometry"], n_inter=n_inter, qcap=qcap,
        rate=rate, intra_rtt=intra_rtt, inter_rtt=inter_rtt,
        nack_period=nack_period, seed=seed))
    return adaptive_ec_result(spec, netsim, retx_netsim, fluid)


def compare_fat_tree_steady_state(k: int = 4, *, netsim=None,
                                  n_intra_pod: int = 0, n_cross_pod: int = 6,
                                  n_inter: int = 0, n_wan: int = 4,
                                  n_paths: int = 4,
                                  workload: str = "incast",
                                  horizon: float = 45 * MS,
                                  t0: float = 15 * MS,
                                  n_warm: int = 200_000,
                                  n_meas: int = 20_000, seed: int = 1,
                                  device: DeviceLike = None) -> dict:
    """The fat-tree acceptance (`fat_tree_steady_spec`)."""
    spec = fat_tree_steady_spec(k, n_intra_pod=n_intra_pod,
                                n_cross_pod=n_cross_pod, n_inter=n_inter,
                                n_wan=n_wan, n_paths=n_paths,
                                workload=workload, seed=seed)
    return compare_scenario(spec, netsim, horizon=horizon, t0=t0,
                            n_warm=n_warm, n_meas=n_meas, device=device)


def compare_multi_dc_steady_state(k: int = 4, n_dc: int = 3, *,
                                  netsim=None, mesh: str = "ring",
                                  oversub: float = 1.0,
                                  n_intra_pod: int = 0, n_cross_pod: int = 6,
                                  n_inter: int = 0, n_wan: int = 4,
                                  n_paths: int = 4,
                                  workload: str = "incast",
                                  horizon: float = 45 * MS,
                                  t0: float = 15 * MS,
                                  n_warm: int = 200_000,
                                  n_meas: int = 20_000, seed: int = 1,
                                  device: DeviceLike = None) -> dict:
    """The N-datacenter acceptance (`multi_dc_steady_spec`)."""
    spec = multi_dc_steady_spec(k, n_dc, mesh=mesh, oversub=oversub,
                                n_intra_pod=n_intra_pod,
                                n_cross_pod=n_cross_pod, n_inter=n_inter,
                                n_wan=n_wan, n_paths=n_paths,
                                workload=workload, seed=seed)
    return compare_scenario(spec, netsim, horizon=horizon, t0=t0,
                            n_warm=n_warm, n_meas=n_meas, device=device)
