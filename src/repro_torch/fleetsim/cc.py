"""Vectorized congestion-control state machines on a fixed epoch clock.

The port of ``repro.fleetsim.cc``.  One `step` = one epoch, for all flows
at once: send rates (split across paths) -> `links.link_epoch` (offered
load, queue step, mark probabilities, the three link -> flow gathers) ->
feedback-lagged observations -> window accumulators -> the scheme's window
reaction (Alg 1 for UnoCC with fast increase, Quick-Adapt and gentle MD;
the DCTCP / Gemini baselines) -> the `lb` axis split update.

`lax.scan` becomes a Python loop over epochs.  The step branches only on
Python-level configuration (scheme, `lb is None`, single-path) and makes
no host synchronisation (no `.item()`, no tensor in Python control flow),
so it stays capturable as a CUDA graph.  Churn, the reliability axis and
fault injection raise until their slices are ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.unocc import gentle_md_scale, md_ecn_gain, md_factor
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim.state import (FleetParams, FleetState, LbParams,
                                        init_state)

SCHEMES = ("uno", "gemini", "dctcp")
_FRAC_EPS = 1e-6


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


def make_step(net: L.FluidNet, params: FleetParams, scheme: str = "uno",
              is_inter: Optional[torch.Tensor] = None,
              lb: Optional[LbParams] = None, churn=None, rel=None,
              fault=None, *, backend: str = "auto"):
    """Build the per-epoch transition: state -> (state', goodput).

    `lb=None` freezes the split at its initial value (static spraying)
    and reports raw goodput.  `backend` picks the link-aggregation path
    (links.LOAD_BACKENDS); it is resolved once, here.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown fleetsim scheme {scheme!r}")
    L.not_yet(churn=churn, rel=rel, fault=fault)
    if is_inter is None:
        is_inter = torch.zeros_like(params.bdp, dtype=torch.bool)
    pmask = L.path_mask(net)
    single = net.n_paths == 1
    backend = L._resolve_backend(net, backend)
    fb = torch.clamp(net.dt / params.rtt, max=1.0)

    def step(state: FleetState):
        p = params
        actf = state.active.to(torch.float32)
        split = state.split
        # ---- network: loads, queues, marks, delays ----------------------
        rate = actf * state.cwnd / p.rtt
        wire = rate
        le = L.link_epoch(net, wire, split, state.q_phys, state.q_phantom,
                          backend=backend)
        sub_frac = le.sub_frac
        if single:   # split-weighted sums collapse to one product per flow
            s1 = split[:, 0]
            sc = s1 * le.sub_scale[:, 0]
            inst_frac = s1 * sub_frac[:, 0]
            inst_delay = s1 * le.sub_delay[:, 0]
        else:
            sc = torch.sum(split * le.sub_scale, dim=1)
            inst_frac = torch.sum(split * sub_frac, dim=1)
            inst_delay = torch.sum(split * le.sub_delay, dim=1)
        goodput = wire * sc
        # feedback lag: first-order filter with time constant = flow RTT
        frac = state.obs_frac + fb * (inst_frac - state.obs_frac)
        delay = state.obs_delay + fb * (inst_delay - state.obs_delay)
        path_frac = state.path_frac if lb is None else \
            state.path_frac + fb[:, None] * (sub_frac - state.path_frac)
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
            inc = torch.where(fi_on,
                              torch.maximum(inc, acked * (1.0 - frac)), inc)
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
            factor = md_factor(ecn_ewma, md_scale, p.k_md, p.bdp, p.md_cap,
                               minimum=torch.minimum)
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
            cwnd = torch.where(fire & (md > 0.0),
                               torch.maximum(cwnd * (1.0 - md), p.min_cwnd),
                               cwnd)
        else:                                        # dctcp: cwnd *= 1 - E/2
            cwnd = torch.where(fire & marked,
                               torch.maximum(cwnd * (1.0 - 0.5 * ecn_ewma),
                                             p.min_cwnd),
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
                trigger,
                torch.maximum(torch.maximum(qa_acked, qa_prev), p.min_cwnd),
                cwnd)
            qa_deficits = torch.where(
                tick, torch.where(deficit & ~trigger,
                                  state.qa_deficits + 1, 0),
                state.qa_deficits).to(torch.int32)
            skip = torch.where(trigger, 2 * p.qa_period, skip)
            qa_prev = torch.where(tick, qa_acked, qa_prev)
            qa_acked = torch.where(tick, 0.0, qa_acked)
            qa_countdown = torch.where(tick, p.qa_period, qa_countdown)
        cwnd = torch.minimum(torch.maximum(cwnd, p.min_cwnd), p.max_cwnd)

        # ---- lb axis: adaptive subflow weights --------------------------
        split_new, bad_count = state.split, state.bad_count
        if lb is not None:
            split_new, bad_count = update_split(split, path_frac, bad_count,
                                                pmask, lb)
            goodput = goodput * lb.ec_eff   # parity bytes carry no payload

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
            active=state.active, key=state.key, rel=state.rel,
            fault=state.fault)
        return new, goodput

    return step


def _default_state(net: L.FluidNet, params: FleetParams) -> FleetState:
    return init_state(params, net.n_links, n_paths=net.n_paths,
                      split0=L.uniform_split(net))


def simulate(net: L.FluidNet, params: FleetParams, *, n_epochs: int,
             scheme: str = "uno", state0: Optional[FleetState] = None,
             is_inter: Optional[torch.Tensor] = None,
             lb: Optional[LbParams] = None, churn=None, rel=None,
             fault=None, record: bool = False, backend: str = "auto"):
    """Run `n_epochs` epochs; returns (final_state, goodput_trajectory),
    the trajectory (n_epochs, n_flows) bytes/ns when `record`, else None."""
    step = make_step(net, params, scheme, is_inter, lb=lb, churn=churn,
                     rel=rel, fault=fault, backend=backend)
    state = _default_state(net, params) if state0 is None else state0
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
                 lb: Optional[LbParams] = None, churn=None, rel=None,
                 fault=None, backend: str = "auto"):
    """Warm up for `n_warm` epochs, then return (final_state, mean goodput
    over `n_meas` epochs), accumulating a running sum instead of a
    trajectory."""
    step = make_step(net, params, scheme, is_inter, lb=lb, churn=churn,
                     rel=rel, fault=fault, backend=backend)
    state = _default_state(net, params) if state0 is None else state0
    for _ in range(n_warm):
        state, _ = step(state)
    acc = torch.zeros_like(params.bdp)
    for _ in range(n_meas):
        state, goodput = step(state)
        acc = acc + goodput
    return state, acc / n_meas
