"""Vectorized congestion-control state machines on a fixed epoch clock.

The port of ``repro.fleetsim.cc``.  One `step` = one epoch, for all flows
at once: send rates (split across paths) -> `links.link_epoch` (offered
load, queue step, mark probabilities, the three link -> flow gathers) ->
feedback-lagged observations -> window accumulators -> the scheme's window
reaction (Alg 1 for UnoCC with fast increase, Quick-Adapt and gentle MD;
the DCTCP / Gemini baselines) -> the `lb` axis split update.

Three optional axes ride on the step, each absent from it when None:

  * churn (`ChurnParams`): open-loop on/off masks with geometric per-epoch
    transitions drawn from the threefry key in the state (`prng`); an OFF
    flow sends nothing and its controller state is frozen, an OFF->ON
    flow restarts fresh (`_merge_flow_state`);
  * reliability (`reliability.RelParams`): the overflow loss signal
    (`links.link_physics(with_loss=True)`), the EC recovery split, the
    NACK machine and its retransmit backlog on the wire, a loss-driven
    window cut, and goodput from the dynamic EC split (`rel.ec_eff`
    supersedes `lb.ec_eff`);
  * faults (`faults.FaultSchedule`): each epoch's capacity and burst-loss
    modulation of the net, and the send split drained from dead paths
    (the stored split is kept, so a repair resumes the old weights).

The epoch is cut at the only point where flows meet across a sharded flow
axis, the offered load.  `make_step_halves` returns three parts: `draw`,
what the epoch draws once for every shard (the fault modulation, which
advances the fault carry, and the churn uniforms); a send half (the
epoch's net and split, rates and this shard's partial load,
`links.scatter_partial`); and a receive half (queue step, marks, gathers,
the CC, reliability, LB and churn updates, from the exchanged loads and
what the send half computed).  `make_step` composes them with no
exchange; the sharded runners of `repro_torch.fleetsim.shard` put the
halo exchange between the halves and share one `draw` per epoch.
`steady_state_core` is the warm-up + measurement loop both share.

Each phase runs inside a span of `repro_torch.trace` (`fleetsim.epoch`
around `make_step`'s step; `fleetsim.faults`, `fleetsim.links`,
`fleetsim.reliability`, `fleetsim.cc` with `fleetsim.lb` inside it around
the LB phase, `fleetsim.churn` in the halves), which records nothing
unless the recorder is on.

`lax.scan` becomes a Python loop over epochs.  The step branches only on
Python-level configuration (scheme, which axes are present, single-path)
and makes no host synchronisation (no `.item()`, no tensor in Python
control flow), so it stays capturable as a CUDA graph.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.unocc import gentle_md_scale, md_ecn_gain, md_factor
from repro_torch.fleetsim import faults as F
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim import prng
from repro_torch.fleetsim import reliability as R
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams, init_state)
from repro_torch.kernels import fleet_cuda
from repro_torch.trace import span, traced

SCHEMES = ("uno", "gemini", "dctcp")
_FRAC_EPS = 1e-6
# state the churn merge does not select per flow: the link queues, the
# PRNG key, the replicated fault carry and the active mask (set each epoch)
_NON_FLOW_FIELDS = ("q_phys", "q_phantom", "key", "active", "fault")


class EpochDraws(NamedTuple):
    """What one epoch draws once for every shard."""
    cap_scale: Optional[torch.Tensor]   # (n_links,) capacity multiplier
    p_extra: Optional[torch.Tensor]     # (n_links,) burst loss probability
    fault: Optional[F.FaultCarry]       # the fault carry after this epoch
    key: Optional[torch.Tensor]         # the churn key after this epoch
    u: Optional[torch.Tensor]           # (churn_n,) churn uniforms


class Sent(NamedTuple):
    """What the send half hands the receive half."""
    wire: torch.Tensor                  # rate + retransmit rate
    rate: torch.Tensor                  # the CC send rate
    rtx: Optional[torch.Tensor]         # retransmit rate (with rel)
    split: torch.Tensor                 # this epoch's send split
    net: L.FluidNet                     # this epoch's (modulated) net
    draws: EpochDraws


def _merge_flow_state(cond: torch.Tensor, a: FleetState,
                      b: FleetState) -> FleetState:
    """Per-flow fields from `a` where `cond` ((n_flows,) bool) else `b`;
    the fields of `_NON_FLOW_FIELDS` pass through from `a`.  Iterating
    FleetState._fields (and the nested RelState's) keeps the churn
    freeze / restart exhaustive."""
    out = {}
    for f in FleetState._fields:
        av = getattr(a, f)
        if f in _NON_FLOW_FIELDS or av is None:
            out[f] = av
        elif hasattr(av, "_fields"):    # nested per-flow carry (RelState)
            out[f] = type(av)(*(torch.where(cond, x, y)
                                for x, y in zip(av, getattr(b, f))))
        else:
            c = cond if av.dim() == 1 else cond[:, None]
            out[f] = torch.where(c, av, getattr(b, f))
    return FleetState(**out)


def update_split(split: torch.Tensor, path_frac: torch.Tensor,
                 bad_count: torch.Tensor, mask: torch.Tensor, lb: LbParams):
    """One epoch of the UnoLB-style weight adaptation; returns
    (split', bad_count')."""
    bad = mask & (path_frac > lb.repath_thresh[:, None])
    bad_count = torch.where(bad, bad_count + 1, 0).to(torch.int32)
    repath = bad_count >= lb.repath_patience[:, None]
    w = split * torch.exp(-lb.eta[:, None] * path_frac)
    w = torch.where(repath, 0.0, w)
    bad_count = torch.where(repath, 0, bad_count).to(torch.int32)
    return L.normalize_split(w, mask, lb.w_floor), bad_count


def lb_update_plain(lb: LbParams, fb: torch.Tensor, mask: torch.Tensor,
                    split: torch.Tensor, path_frac: torch.Tensor,
                    sub_frac: torch.Tensor, bad_count: torch.Tensor):
    """One epoch of the LB phase in torch operations: the per-path mark
    filter (gain `fb`, (n_flows,)) toward this epoch's `sub_frac`, then
    `update_split` of the send split `split`.  Returns (path_frac',
    split', bad_count')."""
    path_frac = path_frac + fb[:, None] * (sub_frac - path_frac)
    split, bad_count = update_split(split, path_frac, bad_count, mask, lb)
    return path_frac, split, bad_count


def make_lb_step(lb: LbParams, fb: torch.Tensor, mask: torch.Tensor, *,
                 plain: bool = False):
    """`lb_update_plain` with (lb, fb, mask) bound: a function of (split,
    path_frac, sub_frac, bad_count).  Unless `plain`, the hand-written
    kernel runs it, one launch an epoch (`fleet_cuda.LbUpdate`, which
    checks and packs the bound operands once, here)."""
    if plain:
        return functools.partial(lb_update_plain, lb, fb, mask)
    return fleet_cuda.LbUpdate(lb, fb, mask)


@traced("fleetsim.make_step")
def make_step(net: L.FluidNet, params: FleetParams, scheme: str = "uno",
              is_inter: Optional[torch.Tensor] = None,
              lb: Optional[LbParams] = None,
              churn: Optional[ChurnParams] = None,
              rel: Optional[R.RelParams] = None,
              fault: Optional[F.FaultSchedule] = None, *,
              backend: str = "auto"):
    """Build the per-epoch transition: state -> (state', goodput).

    `lb=None` freezes the split at its initial value (static spraying)
    and reports raw goodput; `churn`, `rel` and `fault` switch on their
    axes (module docstring).  `backend` picks the link-aggregation path
    (links.LOAD_BACKENDS); it is resolved once, here.  The reliability
    and LB phases follow it: the kernel backends run their kernels, the
    plain ones (`reference`, `pt`) their plain versions
    (`reliability.rel_step`, `lb_update_plain`).
    """
    draw, send, recv = make_step_halves(net, params, scheme, is_inter,
                                        lb=lb, churn=churn, rel=rel,
                                        fault=fault, backend=backend)

    def step(state: FleetState):
        with span("fleetsim.epoch"):
            sent, private, tile = send(state, draw(state))
            with span("fleetsim.links"):
                load = L.assemble_load(private, tile, net.n_links)
            return recv(state, sent, load)

    return step


def make_step_halves(net: L.FluidNet, params: FleetParams,
                     scheme: str = "uno",
                     is_inter: Optional[torch.Tensor] = None,
                     lb: Optional[LbParams] = None,
                     churn: Optional[ChurnParams] = None,
                     rel: Optional[R.RelParams] = None,
                     fault: Optional[F.FaultSchedule] = None, *,
                     backend: str = "auto", halo: Optional[int] = None,
                     churn_map: Optional[torch.Tensor] = None,
                     churn_n: Optional[int] = None):
    """The epoch cut at the halo exchange, as `(draw, send, recv)`.

    `draw(state) -> EpochDraws`: the epoch's fault modulation (advancing
    the fault carry) and churn uniforms, drawn once for all shards.
    `send(state, draws, out=None) -> (sent, private, tile)`: the epoch's
    net and send split, the send rates and this shard's partial offered
    load (`links.scatter_partial` with `halo`; `out` receives the tile).
    `recv(state, sent, load) -> (state', goodput)`: everything after the
    exchange, from the (n_links,) loads.  `churn_map` / `churn_n` make
    churn exact under flow sharding: `draw` makes the GLOBAL (churn_n,)
    uniform vector and each row reads the entry of its original flow id
    (`churn_map`, int32).  Other arguments as `make_step`.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown fleetsim scheme {scheme!r}")
    if churn_map is not None and churn_n is None:
        raise ValueError("churn_map needs churn_n (the global flow count)")
    if is_inter is None:
        is_inter = torch.zeros_like(params.bdp, dtype=torch.bool)
    pmask = L.path_mask(net)
    single = net.n_paths == 1
    backend = L._resolve_backend(net, backend)
    plain = backend in ("reference", "pt")   # these run the plain versions
    if rel is not None:
        rel_step = R.make_rel_step(rel, plain=plain)
    fb = torch.clamp(net.dt / params.rtt, max=1.0)
    if lb is not None:
        lb_step = make_lb_step(lb, fb, pmask, plain=plain)
    n_draw = params.bdp.shape[0] if churn_map is None else churn_n
    fresh = p_off = p_on = None
    if churn is not None:
        # the OFF->ON restart target: a fresh flow as init_state starts it
        fresh = init_state(params, net.n_links, n_paths=net.n_paths,
                           split0=L.uniform_split(net), rel=rel)
        p_off = torch.clamp(net.dt / torch.clamp(churn.mean_on, min=1.0),
                            0.0, 1.0)
        p_on = torch.clamp(net.dt / torch.clamp(churn.mean_off, min=1.0),
                           0.0, 1.0)

    def draw(state: FleetState) -> EpochDraws:
        cap_scale = p_extra = carry = key = u = None
        if fault is not None:
            with span("fleetsim.faults"):
                cap_scale, p_extra, carry = F.fault_modulation(
                    fault, state.fault, net.n_links)
        if churn is not None:
            with span("fleetsim.churn"):
                key, u = prng.split_uniform(state.key, n_draw)
        return EpochDraws(cap_scale, p_extra, carry, key, u)

    def send(state: FleetState, draws: EpochDraws,
             out: Optional[torch.Tensor] = None):
        net_e, split = net, state.split
        if fault is not None:
            with span("fleetsim.faults"):
                net_e = F.apply_modulation(net, draws.cap_scale,
                                           draws.p_extra)
                if draws.cap_scale is not None and not single:
                    split = F.degrade_split(net, split, draws.cap_scale,
                                            pmask)
        rate = state.active.to(torch.float32) * state.cwnd / params.rtt
        rtx, wire = None, rate
        if rel is not None:   # the retransmit backlog is real wire traffic
            with span("fleetsim.reliability"):
                rtx = R.rtx_rate(rel, state.rel, rate, params.rtt)
                wire = rate + rtx
        with span("fleetsim.links"):
            private, tile = L.scatter_partial(net, wire, split,
                                              backend=backend, halo=halo,
                                              out=out)
        return Sent(wire, rate, rtx, split, net_e, draws), private, tile

    def recv(state: FleetState, sent: Sent, load: torch.Tensor):
        p = params
        split, wire, rtx = sent.split, sent.wire, sent.rtx
        # ---- network: queues, marks, delays -----------------------------
        with span("fleetsim.links"):
            le = L.link_physics(sent.net, load, state.q_phys,
                                state.q_phantom, backend=backend,
                                with_loss=rel is not None)
            sub_frac = le.sub_frac
            if single:   # split-weighted sums: one product per flow
                s1 = split[:, 0]
                sc = s1 * le.sub_scale[:, 0]
                inst_frac = s1 * sub_frac[:, 0]
                inst_delay = s1 * le.sub_delay[:, 0]
            else:
                sc = torch.sum(split * le.sub_scale, dim=1)
                inst_frac = torch.sum(split * sub_frac, dim=1)
                inst_delay = torch.sum(split * le.sub_delay, dim=1)
            goodput = wire * sc
        rel_new, nack_fire, rel_goodput = state.rel, None, None
        if rel is not None:
            # the CC acks the goodput before the EC split, `wire * sc`
            with span("fleetsim.reliability"):
                rel_new, nack_fire, rel_goodput = rel_step(
                    state.rel, sent.rate, rtx, split, le.sub_loss, sc,
                    net.dt, p.rtt)
        with span("fleetsim.cc"):
            # feedback lag: first-order filter with time constant = flow RTT
            frac = state.obs_frac + fb * (inst_frac - state.obs_frac)
            delay = state.obs_delay + fb * (inst_delay - state.obs_delay)
            acked = goodput * net.dt

            # ---- window accumulators ----------------------------------------
            win_acked = state.win_acked + acked
            win_marked = state.win_marked + frac * acked
            win_dmin = torch.minimum(state.win_delay_min, delay) \
                if scheme == "uno" else state.win_delay_min
            win_dmax = torch.maximum(state.win_delay_max, delay) \
                if scheme == "gemini" else state.win_delay_max
            fire = state.cc_countdown <= 1
            can_md = state.skip <= 0
            wfrac = win_marked / torch.clamp(win_acked, min=1.0)
            marked = wfrac > _FRAC_EPS

            # ---- additive increase (continuous, on unmarked bytes) ----------
            ai_gain = p.mtu if scheme == "dctcp" else p.alpha
            inc = ai_gain * acked * (1.0 - frac) / \
                torch.clamp(state.cwnd, min=1.0)
            if scheme == "uno":
                # fast increase keys off the INSTANTANEOUS mark fraction
                m_fi = inst_frac > _FRAC_EPS
                fi_on = state.fi_active & ~m_fi
                inc = torch.where(
                    fi_on, torch.maximum(inc, acked * (1.0 - frac)), inc)
            cwnd = state.cwnd + inc

            # ---- window reaction --------------------------------------------
            ecn_ewma = torch.where(
                fire, (1.0 - p.ewma_g) * state.ecn_ewma + p.ewma_g * wfrac,
                state.ecn_ewma)
            md_scale = state.md_scale
            if scheme == "uno":                          # Alg 1 OnEpoch
                gentle = torch.where(
                    win_dmin < p.delay_thresh,
                    gentle_md_scale(state.md_scale, p.gentle_scale,
                                    p.gentle_floor, maximum=torch.maximum),
                    1.0)
                md_scale = torch.where(fire & marked & can_md, gentle,
                                       torch.where(fire & ~marked, 1.0,
                                                   state.md_scale))
                factor = md_factor(ecn_ewma, md_scale, p.k_md, p.bdp,
                                   p.md_cap, minimum=torch.minimum)
                cwnd = torch.where(fire & marked & can_md,
                                   torch.maximum(cwnd * factor, p.min_cwnd),
                                   cwnd)
            elif scheme == "gemini":                     # per-own-RTT reaction
                md = torch.where(marked,
                                 ecn_ewma * md_ecn_gain(p.k_md, p.bdp), 0.0)
                wan_md = torch.where(
                    is_inter & (win_dmax > p.delay_thresh),
                    0.5 * torch.clamp(win_dmax / p.rtt, max=1.0), 0.0)
                md = torch.minimum(torch.maximum(md, wan_md), p.md_cap)
                cwnd = torch.where(
                    fire & (md > 0.0),
                    torch.maximum(cwnd * (1.0 - md), p.min_cwnd), cwnd)
            else:                                    # dctcp: cwnd *= 1 - E/2
                cwnd = torch.where(
                    fire & marked,
                    torch.maximum(cwnd * (1.0 - 0.5 * ecn_ewma), p.min_cwnd),
                    cwnd)

            win_acked = torch.where(fire, 0.0, win_acked)
            win_marked = torch.where(fire, 0.0, win_marked)
            if scheme == "uno":
                win_dmin = torch.where(fire, math.inf, win_dmin)
            if scheme == "gemini":
                win_dmax = torch.where(fire, 0.0, win_dmax)
            cc_countdown = torch.where(fire, p.cc_period,
                                       state.cc_countdown - 1)

            # ---- fast-increase bookkeeping (UnoCC only) ---------------------
            fi_clean = state.fi_clean
            fi_active = state.fi_active
            fi_ceiling = state.fi_ceiling
            if scheme == "uno":
                fi_active = fi_on
                fi_clean = torch.where(
                    fire, torch.where(m_fi, 0, state.fi_clean + 1),
                    state.fi_clean).to(torch.int32)
                engage = (fi_clean >= 3) & (cwnd < 0.7 * fi_ceiling)
                fi_active = torch.where(fire, ~m_fi & (fi_active | engage),
                                        fi_active)
                fi_ceiling = torch.where(
                    fire & m_fi, torch.maximum(cwnd, 4.0 * p.min_cwnd),
                    state.fi_ceiling)

            # ---- Quick-Adapt (UnoCC only; Alg 1 OnQA) -----------------------
            qa_acked = state.qa_acked + acked
            qa_prev = state.qa_prev_acked
            qa_deficits = state.qa_deficits
            skip = torch.clamp(state.skip - 1, min=0)
            qa_countdown = state.qa_countdown - 1
            if scheme == "uno":
                tick = state.qa_countdown <= 1
                deficit = (tick & (state.cwnd >= 4.0 * p.mtu)
                           & (qa_acked < p.beta * state.cwnd))
                trigger = deficit & (state.qa_deficits >= 1) & can_md
                cwnd = torch.where(
                    trigger, torch.maximum(torch.maximum(qa_acked, qa_prev),
                                           p.min_cwnd),
                    cwnd)
                qa_deficits = torch.where(
                    tick, torch.where(deficit & ~trigger,
                                      state.qa_deficits + 1, 0),
                    state.qa_deficits).to(torch.int32)
                skip = torch.where(trigger, 2 * p.qa_period, skip)
                qa_prev = torch.where(tick, qa_acked, qa_prev)
                qa_acked = torch.where(tick, 0.0, qa_acked)
                qa_countdown = torch.where(tick, p.qa_period, qa_countdown)

            # ---- reliability: NACK-driven multiplicative decrease -----------
            # (at most one cut per flow RTT; the post-QA skip suppresses it)
            if rel is not None:
                cwnd = torch.where(
                    nack_fire & can_md,
                    torch.maximum(cwnd * rel.loss_md, p.min_cwnd), cwnd)
            cwnd = torch.minimum(torch.maximum(cwnd, p.min_cwnd), p.max_cwnd)

            # ---- lb axis: adaptive subflow weights --------------------------
            # with lb the per-path marks are filtered and the STORED split
            # adapts from this epoch's (degraded) send split; without it
            # both stay put
            split_new, path_frac, bad_count = \
                state.split, state.path_frac, state.bad_count
            if lb is not None:
                with span("fleetsim.lb"):
                    path_frac, split_new, bad_count = lb_step(
                        split, path_frac, sub_frac, bad_count)
                if rel is None:
                    goodput = goodput * lb.ec_eff   # parity carries no payload
        if rel is not None:
            goodput = rel_goodput   # the dynamic EC split at the old rung

        new = FleetState(
            cwnd=cwnd, ecn_ewma=ecn_ewma, md_scale=md_scale,
            q_phys=le.q_phys, q_phantom=le.q_phantom,
            obs_frac=frac, obs_delay=delay,
            win_acked=win_acked, win_marked=win_marked,
            win_delay_min=win_dmin, win_delay_max=win_dmax,
            cc_countdown=cc_countdown,
            qa_acked=qa_acked, qa_prev_acked=qa_prev,
            qa_deficits=qa_deficits, qa_countdown=qa_countdown, skip=skip,
            fi_clean=fi_clean, fi_active=fi_active, fi_ceiling=fi_ceiling,
            split=split_new, path_frac=path_frac, bad_count=bad_count,
            active=state.active, key=state.key, rel=rel_new,
            fault=state.fault if fault is None else sent.draws.fault)

        # ---- churn: freeze OFF flows, restart fresh on OFF->ON ----------
        if churn is not None:
            with span("fleetsim.churn"):
                act = state.active
                u = sent.draws.u if churn_map is None else \
                    torch.index_select(sent.draws.u, 0, churn_map)
                turn_off = act & churn.churned & (u < p_off)
                turn_on = ~act & churn.churned & (u < p_on)
                new = _merge_flow_state(act, new, state)       # OFF: frozen
                new = _merge_flow_state(~turn_on, new, fresh)  # OFF->ON
                new = new._replace(active=(act & ~turn_off) | turn_on,
                                   key=sent.draws.key)
        return new, goodput

    return draw, send, recv


def _default_state(net: L.FluidNet, params: FleetParams, seed: int = 0,
                   rel=None, fault=None) -> FleetState:
    return init_state(params, net.n_links, n_paths=net.n_paths,
                      split0=L.uniform_split(net), seed=seed, rel=rel,
                      fault=fault)


def simulate(net: L.FluidNet, params: FleetParams, *, n_epochs: int,
             scheme: str = "uno", state0: Optional[FleetState] = None,
             is_inter: Optional[torch.Tensor] = None,
             lb: Optional[LbParams] = None,
             churn: Optional[ChurnParams] = None,
             rel: Optional[R.RelParams] = None,
             fault: Optional[F.FaultSchedule] = None, seed: int = 0,
             record: bool = False, backend: str = "auto"):
    """Run `n_epochs` epochs; returns (final_state, goodput_trajectory),
    the trajectory (n_epochs, n_flows) bytes/ns when `record`, else None.
    `seed` seeds the churn key and the fault chains of a fresh state."""
    step = make_step(net, params, scheme, is_inter, lb=lb, churn=churn,
                     rel=rel, fault=fault, backend=backend)
    state = _default_state(net, params, seed, rel, fault) \
        if state0 is None else state0
    traj = [] if record else None
    for _ in range(n_epochs):
        state, goodput = step(state)
        if record:
            traj.append(goodput)
    return state, (torch.stack(traj) if record else None)


def steady_state(net: L.FluidNet, params: FleetParams, *, n_warm: int,
                 n_meas: int, scheme: str = "uno",
                 state0: Optional[FleetState] = None,
                 is_inter: Optional[torch.Tensor] = None,
                 lb: Optional[LbParams] = None,
                 churn: Optional[ChurnParams] = None,
                 rel: Optional[R.RelParams] = None,
                 fault: Optional[F.FaultSchedule] = None, seed: int = 0,
                 backend: str = "auto"):
    """Warm up for `n_warm` epochs, then return (final_state, mean goodput
    over `n_meas` epochs), accumulating a running sum instead of a
    trajectory.  `seed` as `simulate`."""
    step = make_step(net, params, scheme, is_inter, lb=lb, churn=churn,
                     rel=rel, fault=fault, backend=backend)
    state = _default_state(net, params, seed, rel, fault) \
        if state0 is None else state0
    return steady_state_core(step, state, n_warm=n_warm, n_meas=n_meas,
                             acc=torch.zeros_like(params.bdp))


def steady_state_core(step, state, *, n_warm: int, n_meas: int,
                      acc: torch.Tensor):
    """Run `step` (state -> (state', goodput)) for `n_warm` epochs, then
    return (final_state, mean goodput over `n_meas` epochs), summing into
    the zero accumulator `acc` instead of keeping a trajectory.  The
    single-device `steady_state` and the sharded runners share it."""
    if n_meas < 1:
        raise ValueError(f"n_meas must be >= 1, got {n_meas}")
    for _ in range(n_warm):
        state, _ = step(state)
    for _ in range(n_meas):
        state, goodput = step(state)
        acc = acc + goodput
    return state, acc / n_meas
