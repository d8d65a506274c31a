"""The plain reference's epoch: one step of the fluid fleet model over the
route tensor, in plain torch, written out from the model's equations.

  * offered load: every flow adds rate * split[p] to each hop of its p-th
    path (one `index_add_` into an (L + 1,) buffer);
  * links: forward-Euler physical and phantom queues, the RED mark
    probability on the marking queue, the overflow drop probability from
    the pre-step queue, and per subflow the min of cap/load, 1 - prod(1 -
    p) and the sum of q/cap over its hops (gathers over the routes);
  * faults: each epoch's capacity multiplier (downs, brownouts, flaps)
    and Gilbert-Elliott burst loss from threefry uniforms, dead paths
    drained from the send split;
  * reliability: the binomial EC recovery split, the NACK machine and its
    retransmit backlog, the EC ladder's rung moves;
  * congestion control: the feedback-lagged observations, the window
    accumulators, UnoCC's fast increase, gentle MD and Quick-Adapt (or
    the DCTCP / Gemini reaction), the NACK cut, the LB split update, and
    churn's freeze / restart.

`step(sc, state)` takes the compiled scenario (`compile.compile_generated`)
and a state dict under the simulator's field names (nested dicts for the
reliability and fault carries) and returns (state', goodput).  The float
type of the state and scenario is the arithmetic's: the control passes
them in bfloat16.  Nothing here reads a device value on the host.
"""
from __future__ import annotations

import math

import torch

from bench.reference import prng

_EPS = 1e-9
_FRAC_EPS = 1e-6
_NON_FLOW = ("q_phys", "q_phantom", "key", "active", "fault")


def _r3(routes):
    return routes if routes.dim() == 3 else routes[:, None, :]


def _pad(routes, n_links):
    return torch.where(routes >= 0, routes, n_links).long()


def _ext(v, fill):
    return torch.cat([v, v.new_full((1,), fill)])


def normalize_split(w, mask, w_floor=None):
    m = mask.to(w.dtype)
    w = torch.clamp(w, min=0.0) * m
    if w_floor is not None:
        n_valid = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
        w = torch.maximum(w, (w_floor[:, None] / n_valid) * m)
    s = torch.sum(w, dim=1, keepdim=True)
    uni = m / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    return torch.where(s > _EPS, w / torch.clamp(s, min=_EPS), uni)


def offered_load(routes, n_links, rates, split, acc):
    """(n_links,) load: every hop of every subflow summed in `acc`, then
    rounded once to the rates' type."""
    r = _r3(routes)
    per_hop = ((rates[:, None] * split)[:, :, None]
               * (r >= 0).to(rates.dtype))
    buf = torch.zeros(n_links + 1, dtype=acc, device=rates.device)
    buf.index_add_(0, _pad(r, n_links).reshape(-1),
                   per_hop.reshape(-1).to(acc))
    return buf[:n_links].to(rates.dtype)


def _loss_frac(routes, n_links, p_drop):
    keep = _ext(1.0 - p_drop, 1.0)
    return 1.0 - torch.prod(keep[_pad(_r3(routes), n_links)], dim=2)


def link_physics(net, load, q_phys, q_phantom, with_loss):
    cap, dt, nl = net["cap"], net["dt"], net["cap"].shape[0]
    p_drop = None
    if with_loss:
        over = q_phys + (load - cap) * dt - net["qcap"]
        p_drop = torch.clamp(torch.clamp(over, min=0.0)
                             / torch.clamp(load * dt, min=_EPS), 0.0, 1.0)
    q_phys = torch.minimum(torch.clamp(q_phys + (load - cap) * dt, min=0.0),
                           net["qcap"])
    q_phantom = torch.minimum(
        torch.clamp(q_phantom + (load - net["drain"]) * dt, min=0.0),
        net["vcap"])
    q = torch.where(net["use_phantom"], q_phantom, q_phys)
    p_link = torch.clamp((q - net["ecn_lo"]) / torch.clamp(
        net["ecn_hi"] - net["ecn_lo"], min=_EPS), 0.0, 1.0)
    scale = torch.clamp(cap / torch.clamp(load, min=_EPS), max=1.0)
    delay = q_phys / torch.clamp(cap, min=_EPS)
    pad = _pad(_r3(net["routes"]), nl)
    sub_scale = torch.amin(_ext(scale, 1.0)[pad], dim=2)
    sub_frac = 1.0 - torch.prod(_ext(1.0 - p_link, 1.0)[pad], dim=2)
    sub_delay = torch.sum(_ext(delay, 0.0)[pad], dim=2)
    if net["p_loss"] is not None:
        sub_scale = sub_scale * (1.0 - _loss_frac(net["routes"], nl,
                                                  net["p_loss"]))
    sub_loss = None
    if with_loss:
        if net["p_loss"] is not None:
            p_drop = 1.0 - (1.0 - p_drop) * (1.0 - net["p_loss"])
        sub_loss = _loss_frac(net["routes"], nl, p_drop)
    return dict(q_phys=q_phys, q_phantom=q_phantom, sub_scale=sub_scale,
                sub_frac=sub_frac, sub_delay=sub_delay, sub_loss=sub_loss)


# ------------------------------------------------------------ faults

def fault_modulation(f, carry, n_links, ft):
    ep = carry["epoch"]
    dev = ep.device
    cap_scale = p_extra = None
    if f["link"].shape[0]:
        active = (ep >= f["t0"]) & (ep < f["t1"])
        phase = torch.remainder(ep - f["t0"], torch.clamp(f["period"], min=1))
        flap_on = phase.to(ft) < f["duty"] * f["period"].to(ft)
        in_fault = torch.where(f["period"] > 0, flap_on, True)
        eff = torch.where(active & in_fault, f["cap_frac"], 1.0)
        cap_scale = torch.ones(n_links, dtype=ft, device=dev) \
            .scatter_reduce_(0, f["link"].long(), eff, "amin")
    ge_bad, key = carry["ge_bad"], carry["key"]
    if f["ge_link"].shape[0]:
        key, u = prng.split_uniform(carry["key"], f["ge_link"].shape[0])
        u = u.to(ft)
        win = (ep >= f["ge_t0"]) & (ep < f["ge_t1"])
        ge_bad = torch.where(ge_bad, u >= f["ge_p_bg"],
                             u < f["ge_p_gb"]) & win
        p_ev = torch.where(win, torch.where(ge_bad, f["ge_p_bad"],
                                            f["ge_p_good"]), 0.0)
        p_extra = torch.zeros(n_links, dtype=ft, device=dev) \
            .scatter_reduce_(0, f["ge_link"].long(), p_ev, "amax")
    return cap_scale, p_extra, dict(epoch=ep + 1, ge_bad=ge_bad, key=key)


def _degrade_split(net, split, cap_scale, pmask):
    up = torch.cat([cap_scale > 0.0,
                    torch.ones(1, dtype=torch.bool, device=cap_scale.device)])
    alive = torch.all(up[_pad(_r3(net["routes"]), cap_scale.shape[0])], dim=2)
    ok = pmask & alive
    w = torch.where(ok, split, 0.0)
    return torch.where(torch.any(ok, dim=1)[:, None],
                       normalize_split(w, ok), split)


# ------------------------------------------------------------ reliability

def _rung(rel, table, rung):
    if rel["ladder_k"].dim() == 1:
        return table[rung.long()]
    idx = rung.reshape(rel["ladder_k"].shape[0], -1).long()
    if table.dim() == 3:
        idx = idx[..., None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx).reshape((-1,) + table.shape[2:])


def _geometry(rel, st):
    k, r, coef = rel["ec_k"], rel["ec_r"], rel["coef"]
    if rel["ladder_k"] is not None:
        on = rel["adapt_on"]
        k = torch.where(on, _rung(rel, rel["ladder_k"], st["rung"]), k)
        r = torch.where(on, _rung(rel, rel["ladder_r"], st["rung"]), r)
        coef = torch.where(on[:, None],
                           _rung(rel, rel["ladder_coef"], st["rung"]), coef)
    return k, r, coef


def _eff(rel, st):
    if rel["ladder_eff"] is None:
        return rel["ec_eff"]
    return torch.where(rel["adapt_on"],
                       _rung(rel, rel["ladder_eff"], st["rung"]),
                       rel["ec_eff"])


def _recovery_split(rel, q, st):
    k, r, coef = _geometry(rel, st)
    q = torch.clamp(q, 0.0, 1.0)[:, None]
    n = (k + r)[:, None]
    i = torch.arange(coef.shape[-1], dtype=q.dtype, device=q.device)[None, :]
    p_i = coef * torch.pow(q, i) * torch.pow(1.0 - q,
                                             torch.clamp(n - i, min=0.0))
    rec = torch.sum(i * p_i, dim=1)
    q1, n1 = q[:, 0], n[:, 0]
    nack = torch.clamp(n1 * q1 - rec, min=0.0)
    scale = torch.where(rel["enabled"], k / torch.clamp(n1 * n1, min=1.0),
                        0.0)
    return rec * scale, nack * scale


def _rel_epoch(rel, st, rate, rtx, wire, loss_frac, dt, rtt):
    g = torch.clamp(dt / rtt, max=1.0)
    q = torch.clamp(loss_frac, 0.0, 1.0)
    rec_frac, nack_frac = _recovery_split(rel, q, st)
    recovered = rate * rec_frac
    pending = st["pending"] + (rate * nack_frac * dt + rtx * q * dt)
    tick = st["ack_cd"] <= 1
    fire = tick & (st["hold"] <= 0) & (pending >= rel["nack_quantum"]) \
        & rel["enabled"]
    backlog = torch.clamp(st["backlog"] - rtx * dt, min=0.0) + \
        torch.where(fire, pending, 0.0)
    pending = torch.where(fire, 0.0, pending)
    hold = torch.where(fire, rel["nack_hold"],
                       torch.clamp(st["hold"] - 1, min=0))
    ack_cd = torch.where(tick, rel["nack_period"], st["ack_cd"] - 1)
    cut = fire & (st["md_cd"] <= 0.0)
    md_cd = torch.where(cut, rtt, torch.clamp(st["md_cd"] - dt, min=0.0))
    rung, loss_ewma, adapt_cd = st["rung"], st["loss_ewma"], st["adapt_cd"]
    if rel["ladder_k"] is not None:
        n_rungs = rel["ladder_k"].shape[-1]
        loss_ewma = st["loss_ewma"] + torch.clamp(dt / rtt, max=1.0) * (
            q - st["loss_ewma"])
        cd = torch.clamp(st["adapt_cd"] - dt, min=0.0)
        can = rel["adapt_on"] & rel["enabled"] & (cd <= 0.0)
        up = can & (loss_ewma > _rung(rel, rel["ladder_up"], st["rung"])) \
            & (st["rung"] < n_rungs - 1)
        dn = can & (loss_ewma < _rung(rel, rel["ladder_down"], st["rung"])) \
            & (st["rung"] > 0)
        rung = st["rung"] + up.to(torch.int32) - dn.to(torch.int32)
        adapt_cd = torch.where(up | dn, rtt, cd)
    lat_nack = 1.5 * rtt + 0.5 * (rel["nack_period"] + rel["nack_hold"]) * dt
    vol = recovered + rtx
    inst_lat = (recovered * rtt + rtx * lat_nack) / torch.clamp(vol, min=_EPS)
    lat_ewma = torch.where(vol > 0.0,
                           st["lat_ewma"] + g * (inst_lat - st["lat_ewma"]),
                           st["lat_ewma"])
    new = dict(
        pending=pending, backlog=backlog, ack_cd=ack_cd, hold=hold,
        md_cd=md_cd, rtx_ewma=st["rtx_ewma"] + g * (rtx - st["rtx_ewma"]),
        lat_ewma=lat_ewma, nacks=st["nacks"] + fire.to(rate.dtype),
        rec_bytes=st["rec_bytes"] + recovered * dt,
        rtx_bytes=st["rtx_bytes"] + rtx * dt,
        wire_bytes=st["wire_bytes"] + wire * dt,
        lost_bytes=st["lost_bytes"] + wire * q * dt,
        rung=rung, loss_ewma=loss_ewma, adapt_cd=adapt_cd)
    return new, cut, recovered


# ------------------------------------------------------------ the epoch

def _merge(cond, a, b):
    out = {}
    for f, av in a.items():
        if f in _NON_FLOW or av is None:
            out[f] = av
        elif isinstance(av, dict):
            out[f] = {k: torch.where(cond, v, b[f][k]) for k, v in av.items()}
        else:
            c = cond if av.dim() == 1 else cond[:, None]
            out[f] = torch.where(c, av, b[f])
    return out


def step(sc: dict, st: dict, scheme: str = "uno", fresh: dict = None,
         acc=torch.float64):
    """One epoch: (state', goodput).  `fresh` is the OFF -> ON restart
    state (a fresh run's), needed only with churn; `acc` is the type the
    offered load is summed in."""
    net, p, lb, rel, fault = (sc["net"], sc["params"], sc["lb"], sc["rel"],
                              sc["fault"])
    churn, is_inter = sc["churn"], sc["is_inter"]
    ft = st["cwnd"].dtype
    nl = net["cap"].shape[0]
    dt = net["dt"]
    pmask = torch.any(_r3(net["routes"]) >= 0, dim=2)
    single = pmask.shape[1] == 1
    fb = torch.clamp(dt / p["rtt"], max=1.0)

    # ---- draws: fault modulation, churn uniforms
    net_e, split = net, st["split"]
    fcarry = st["fault"]
    if fault is not None:
        cap_scale, p_extra, fcarry = fault_modulation(fault, st["fault"], nl,
                                                      ft)
        if cap_scale is not None:
            net_e = dict(net_e, cap=net["cap"] * cap_scale,
                         drain=net["drain"] * cap_scale)
            if not single:
                split = _degrade_split(net, split, cap_scale, pmask)
        if p_extra is not None:
            base = 0.0 if net["p_loss"] is None else net["p_loss"]
            net_e = dict(net_e, p_loss=1.0 - (1.0 - base) * (1.0 - p_extra))
    key, u = st["key"], None
    if churn is not None:
        key, u = prng.split_uniform(st["key"], p["bdp"].shape[0])
        u = u.to(ft)

    # ---- send
    rate = st["active"].to(ft) * st["cwnd"] / p["rtt"]
    rtx, wire = None, rate
    if rel is not None:
        rtx = torch.minimum(st["rel"]["backlog"] / torch.clamp(p["rtt"],
                                                               min=1.0),
                            rel["rtx_cap"] * rate)
        wire = rate + rtx
    load = offered_load(net["routes"], nl, wire, split, acc)

    # ---- links
    le = link_physics(net_e, load, st["q_phys"], st["q_phantom"],
                      rel is not None)
    sub_frac = le["sub_frac"]
    if single:
        s1 = split[:, 0]
        sc_ = s1 * le["sub_scale"][:, 0]
        inst_frac = s1 * sub_frac[:, 0]
        inst_delay = s1 * le["sub_delay"][:, 0]
    else:
        sc_ = torch.sum(split * le["sub_scale"], dim=1)
        inst_frac = torch.sum(split * sub_frac, dim=1)
        inst_delay = torch.sum(split * le["sub_delay"], dim=1)
    goodput = wire * sc_
    rel_new, nack_fire, recovered = st["rel"], None, None
    if rel is not None:
        lf = s1 * le["sub_loss"][:, 0] if single else \
            torch.sum(split * le["sub_loss"], dim=1)
        rel_new, nack_fire, recovered = _rel_epoch(
            rel, st["rel"], rate, rtx, wire, lf, dt, p["rtt"])
    frac = st["obs_frac"] + fb * (inst_frac - st["obs_frac"])
    delay = st["obs_delay"] + fb * (inst_delay - st["obs_delay"])
    path_frac = st["path_frac"] if lb is None else \
        st["path_frac"] + fb[:, None] * (sub_frac - st["path_frac"])
    acked = goodput * dt

    # ---- window accumulators
    win_acked = st["win_acked"] + acked
    win_marked = st["win_marked"] + frac * acked
    win_dmin = torch.minimum(st["win_delay_min"], delay) \
        if scheme == "uno" else st["win_delay_min"]
    win_dmax = torch.maximum(st["win_delay_max"], delay) \
        if scheme == "gemini" else st["win_delay_max"]
    fire = st["cc_countdown"] <= 1
    can_md = st["skip"] <= 0
    wfrac = win_marked / torch.clamp(win_acked, min=1.0)
    marked = wfrac > _FRAC_EPS

    # ---- additive increase
    ai = p["mtu"] if scheme == "dctcp" else p["alpha"]
    inc = ai * acked * (1.0 - frac) / torch.clamp(st["cwnd"], min=1.0)
    if scheme == "uno":
        m_fi = inst_frac > _FRAC_EPS
        fi_on = st["fi_active"] & ~m_fi
        inc = torch.where(fi_on, torch.maximum(inc, acked * (1.0 - frac)),
                          inc)
    cwnd = st["cwnd"] + inc

    # ---- window reaction
    ecn_ewma = torch.where(fire, (1.0 - p["ewma_g"]) * st["ecn_ewma"]
                           + p["ewma_g"] * wfrac, st["ecn_ewma"])
    md_scale = st["md_scale"]
    gain = 4.0 * p["k_md"] / (p["k_md"] + p["bdp"])
    if scheme == "uno":
        gentle = torch.where(
            win_dmin < p["delay_thresh"],
            torch.maximum(st["md_scale"] * p["gentle_scale"],
                          p["gentle_floor"]), 1.0)
        md_scale = torch.where(fire & marked & can_md, gentle,
                               torch.where(fire & ~marked, 1.0,
                                           st["md_scale"]))
        factor = 1.0 - torch.minimum(ecn_ewma * gain * md_scale, p["md_cap"])
        cwnd = torch.where(fire & marked & can_md,
                           torch.maximum(cwnd * factor, p["min_cwnd"]), cwnd)
    elif scheme == "gemini":
        md = torch.where(marked, ecn_ewma * gain, 0.0)
        wan_md = torch.where(is_inter & (win_dmax > p["delay_thresh"]),
                             0.5 * torch.clamp(win_dmax / p["rtt"], max=1.0),
                             0.0)
        md = torch.minimum(torch.maximum(md, wan_md), p["md_cap"])
        cwnd = torch.where(fire & (md > 0.0),
                           torch.maximum(cwnd * (1.0 - md), p["min_cwnd"]),
                           cwnd)
    else:
        cwnd = torch.where(fire & marked,
                           torch.maximum(cwnd * (1.0 - 0.5 * ecn_ewma),
                                         p["min_cwnd"]), cwnd)
    win_acked = torch.where(fire, 0.0, win_acked)
    win_marked = torch.where(fire, 0.0, win_marked)
    if scheme == "uno":
        win_dmin = torch.where(fire, math.inf, win_dmin)
    if scheme == "gemini":
        win_dmax = torch.where(fire, 0.0, win_dmax)
    cc_countdown = torch.where(fire, p["cc_period"], st["cc_countdown"] - 1)

    # ---- fast increase bookkeeping
    fi_clean, fi_active, fi_ceiling = (st["fi_clean"], st["fi_active"],
                                       st["fi_ceiling"])
    if scheme == "uno":
        fi_active = fi_on
        fi_clean = torch.where(fire, torch.where(m_fi, 0, st["fi_clean"] + 1),
                               st["fi_clean"]).to(torch.int32)
        engage = (fi_clean >= 3) & (cwnd < 0.7 * fi_ceiling)
        fi_active = torch.where(fire, ~m_fi & (fi_active | engage),
                                fi_active)
        fi_ceiling = torch.where(fire & m_fi,
                                 torch.maximum(cwnd, 4.0 * p["min_cwnd"]),
                                 st["fi_ceiling"])

    # ---- Quick-Adapt
    qa_acked = st["qa_acked"] + acked
    qa_prev, qa_deficits = st["qa_prev_acked"], st["qa_deficits"]
    skip = torch.clamp(st["skip"] - 1, min=0)
    qa_countdown = st["qa_countdown"] - 1
    if scheme == "uno":
        tick = st["qa_countdown"] <= 1
        deficit = (tick & (st["cwnd"] >= 4.0 * p["mtu"])
                   & (qa_acked < p["beta"] * st["cwnd"]))
        trigger = deficit & (st["qa_deficits"] >= 1) & can_md
        cwnd = torch.where(trigger, torch.maximum(
            torch.maximum(qa_acked, qa_prev), p["min_cwnd"]), cwnd)
        qa_deficits = torch.where(
            tick, torch.where(deficit & ~trigger, st["qa_deficits"] + 1, 0),
            st["qa_deficits"]).to(torch.int32)
        skip = torch.where(trigger, 2 * p["qa_period"], skip)
        qa_prev = torch.where(tick, qa_acked, qa_prev)
        qa_acked = torch.where(tick, 0.0, qa_acked)
        qa_countdown = torch.where(tick, p["qa_period"], qa_countdown)

    # ---- NACK cut, clamps
    if rel is not None:
        cwnd = torch.where(nack_fire & can_md,
                           torch.maximum(cwnd * rel["loss_md"],
                                         p["min_cwnd"]), cwnd)
    cwnd = torch.minimum(torch.maximum(cwnd, p["min_cwnd"]), p["max_cwnd"])

    # ---- LB split update, goodput accounting
    split_new, bad_count = st["split"], st["bad_count"]
    if lb is not None:
        bad = pmask & (path_frac > lb["repath_thresh"][:, None])
        bad_count = torch.where(bad, bad_count + 1, 0).to(torch.int32)
        repath = bad_count >= lb["repath_patience"][:, None]
        w = split * torch.exp(-lb["eta"][:, None] * path_frac)
        w = torch.where(repath, 0.0, w)
        bad_count = torch.where(repath, 0, bad_count).to(torch.int32)
        split_new = normalize_split(w, pmask, lb["w_floor"])
        if rel is None:
            goodput = goodput * lb["ec_eff"]
    if rel is not None:
        eff = _eff(rel, st["rel"])
        goodput = goodput * eff + rtx * sc_ * (1.0 - eff) + recovered

    new = dict(
        cwnd=cwnd, ecn_ewma=ecn_ewma, md_scale=md_scale,
        q_phys=le["q_phys"], q_phantom=le["q_phantom"], obs_frac=frac,
        obs_delay=delay, win_acked=win_acked, win_marked=win_marked,
        win_delay_min=win_dmin, win_delay_max=win_dmax,
        cc_countdown=cc_countdown, qa_acked=qa_acked, qa_prev_acked=qa_prev,
        qa_deficits=qa_deficits, qa_countdown=qa_countdown, skip=skip,
        fi_clean=fi_clean, fi_active=fi_active, fi_ceiling=fi_ceiling,
        split=split_new, path_frac=path_frac, bad_count=bad_count,
        active=st["active"], key=st["key"], rel=rel_new, fault=fcarry)

    if churn is not None:
        act = st["active"]
        p_off = torch.clamp(dt / torch.clamp(churn["mean_on"], min=1.0),
                            0.0, 1.0)
        p_on = torch.clamp(dt / torch.clamp(churn["mean_off"], min=1.0),
                           0.0, 1.0)
        turn_off = act & churn["churned"] & (u < p_off)
        turn_on = ~act & churn["churned"] & (u < p_on)
        new = _merge(act, new, st)
        new = _merge(~turn_on, new, fresh)
        new["active"] = (act & ~turn_off) | turn_on
        new["key"] = key
    return new, goodput
