"""The plain reference's compiler: a generated scenario (a spec, or a grid
of cells over one spec) to the tensors one fluid epoch reads.

Each structure is a dict of tensors under the names the simulator's
state and parameters use (`net`, `params`, `is_inter`, `lb`, `churn`,
`rel`, `fault`), worked out here from the spec alone: the route tensor
(flow -> path -> link hop, -1 padded), the per-link constants, the
per-flow constants of UnoCC, the load-balancing, churn and reliability
knobs and the epoch-indexed fault schedule.  A grid stacks its cells as
one net: cell b's links offset by b * L, its per-flow and per-link rows
concatenated, its fault events' links offset alike, each cell's EC
ladder its own table when the cells' ladders differ.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.reference import prng

MAX_R = 16
OPEN_END = 2 ** 31 - 1
_FAULT_SALT = 0xFA
_ADAPTIVE = ("unolb", "plb")
_NEVER = 2.0
_LADDER = ("ladder_k", "ladder_r", "ladder_eff", "ladder_coef", "ladder_up",
           "ladder_down")
REL_FIELDS = ("enabled", "ec_k", "ec_r", "ec_eff", "nack_period",
              "nack_hold", "loss_md", "rtx_cap", "nack_quantum", "coef",
              "adapt_on") + _LADDER
# UnoCC defaults (the fractions of the paper's parameter table)
UNO = dict(alpha_frac=0.001, beta=0.5, k_frac=1.0 / 7.0, ewma_g=0.2,
           delay_thresh_frac=0.25, gentle_scale=0.3, gentle_floor=0.09,
           md_cap=0.5, max_cwnd_bdps=1.5, mtu=4096.0)


# ------------------------------------------------------------ routes

def routes_of(spec) -> np.ndarray:
    """(n_flows, n_paths, max_hops) int32 hop link ids, -1 padded, built
    once per distinct path-set object and gathered per flow."""
    idx = spec.link_index()
    uniq, ids = {}, []
    for g in spec.groups:
        sets = g.path_sets
        for i in range(g.n):
            ps = sets[i if len(sets) > 1 else 0]
            j = uniq.get(id(ps))
            if j is None:
                j = uniq[id(ps)] = (len(uniq), ps)
            ids.append(j[0])
    sets = [ps for _, ps in sorted(uniq.values(), key=lambda t: t[0])]
    p = max(len(ps) for ps in sets)
    h = max(len(path) for ps in sets for path in ps)
    table = np.full((len(sets), p, h), -1, np.int32)
    for u, ps in enumerate(sets):
        for q, path in enumerate(ps):
            table[u, q, :len(path)] = [idx[name] for name in path]
    return table[np.asarray(ids, np.int64)]


# ------------------------------------------------------------ one spec

def _per_flow(spec, fn):
    out = []
    for g in spec.groups:
        out.extend([fn(g)] * g.n)
    return out


def make_params(bdp, rtt, intra_bdp, intra_rtt, epoch_frac):
    dev = bdp.device
    f32 = dict(dtype=torch.float32, device=dev)
    u = UNO
    alpha = u["alpha_frac"] * bdp
    k_md = u["k_frac"] * torch.tensor(intra_bdp, **f32)
    epoch = epoch_frac * torch.tensor(intra_rtt, **f32)
    ones = torch.ones_like(bdp)
    return dict(
        bdp=bdp, rtt=rtt, mtu=u["mtu"] * ones, alpha=alpha, k_md=k_md * ones,
        beta=u["beta"] * ones, ewma_g=u["ewma_g"] * ones,
        gentle_scale=u["gentle_scale"] * ones,
        gentle_floor=u["gentle_floor"] * ones, md_cap=u["md_cap"] * ones,
        delay_thresh=u["delay_thresh_frac"] * intra_rtt * ones,
        min_cwnd=u["mtu"] * ones, max_cwnd=u["max_cwnd_bdps"] * bdp,
        cc_period=torch.ones_like(bdp, dtype=torch.int32),
        qa_period=torch.clamp(torch.round(rtt / epoch), min=1.0)
        .to(torch.int32))


def _coef_row(k, r, dev):
    return torch.tensor([float(math.comb(k + r, i)) if i <= r else 0.0
                         for i in range(MAX_R + 1)], dtype=torch.float32,
                        device=dev)


def make_rel(n, dev, *, ec=(8, 2), nack_period=1, nack_hold=0, loss_md=0.5,
             rtx_cap=1.0, nack_quantum=4096.0, enabled=None, ladder=None,
             ladder_up=None, ladder_down=None):
    f32 = dict(dtype=torch.float32, device=dev)
    k, r = int(ec[0]), int(ec[1])
    rungs = None if ladder is None else [(int(a), int(b)) for a, b in ladder]
    if rungs:
        k, r = rungs[0]
    ones = torch.ones(n, **f32)
    enabled = torch.ones(n, dtype=torch.bool, device=dev) if enabled is None \
        else torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    lad = dict.fromkeys(("adapt_on",) + _LADDER)
    if rungs:
        ks = torch.tensor([a for a, _ in rungs], **f32)
        rs = torch.tensor([b for _, b in rungs], **f32)
        ns = ks + rs
        up = 0.5 * (rs + 1.0) / ns if ladder_up is None \
            else torch.tensor(ladder_up, **f32)
        down = torch.cat([torch.zeros(1, **f32), 0.5 * up[:-1]]) \
            if ladder_down is None else torch.tensor(ladder_down, **f32)
        lad = dict(adapt_on=enabled, ladder_k=ks, ladder_r=rs,
                   ladder_eff=ks / ns,
                   ladder_coef=torch.stack([_coef_row(a, b, dev)
                                            for a, b in rungs]),
                   ladder_up=up, ladder_down=down)
    return dict(
        enabled=enabled, ec_k=torch.where(enabled, float(k), 1.0),
        ec_r=torch.where(enabled, float(r), 0.0),
        ec_eff=torch.where(enabled, k / (k + r), 1.0),
        nack_period=torch.full((n,), max(int(nack_period), 1),
                               dtype=torch.int32, device=dev),
        nack_hold=torch.full((n,), max(int(nack_hold), 0), dtype=torch.int32,
                             device=dev),
        loss_md=loss_md * ones, rtx_cap=rtx_cap * ones,
        nack_quantum=nack_quantum * ones,
        coef=enabled.to(torch.float32)[:, None]
        * _coef_row(k, r, dev)[None, :], **lad)


def _cat_rel(rows):
    """Per-group rows along the flow axis; one shared ladder."""
    out = {}
    for f in REL_FIELDS:
        vals = [r[f] for r in rows]
        if f in _LADDER:
            present = [v for v in vals if v is not None]
            out[f] = present[0] if present else None
        elif f == "adapt_on":
            out[f] = None if all(v is None for v in vals) else torch.cat(
                [v if v is not None else torch.zeros_like(r["enabled"])
                 for v, r in zip(vals, rows)])
        else:
            out[f] = torch.cat(vals)
    return out


def _rel_of(spec, dt, dev):
    if not any(g.rel is not None and g.inter for g in spec.groups):
        return None
    rows = []
    for g in spec.groups:
        if g.n == 0:
            continue
        r = g.rel if g.inter else None
        if r is not None:
            rtt = g.rtt if g.rtt is not None else (
                spec.inter_rtt if g.inter else spec.intra_rtt)
            per = r.nack_period if r.nack_period is not None \
                else max(0.25 * rtt, 100_000.0)
            rows.append(make_rel(
                g.n, dev, ec=r.ec, nack_period=max(int(round(per / dt)), 1),
                nack_hold=int(round(r.debounce / dt)), loss_md=r.loss_md,
                rtx_cap=r.rtx_cap, ladder=r.ladder, ladder_up=r.ladder_up,
                ladder_down=r.ladder_down))
        else:
            row = make_rel(g.n, dev, enabled=np.zeros(g.n, bool))
            k_r = g.lb.ec if g.inter else None
            if k_r is not None:
                row["ec_eff"] = torch.full((g.n,), k_r[0] / (k_r[0] + k_r[1]),
                                           dtype=torch.float32, device=dev)
            rows.append(row)
    return _cat_rel(rows)


def make_fault(cap_events, ge_events, dev):
    def col(rows, j, dtype, none=None):
        vals = [none if r[j] is None else r[j] for r in rows]
        return torch.tensor(vals, dtype=dtype, device=dev).reshape(len(rows))
    cap_events, ge_events = list(cap_events), list(ge_events)
    i32, f32 = torch.int32, torch.float32
    return dict(
        link=col(cap_events, 0, i32), t0=col(cap_events, 1, i32),
        t1=col(cap_events, 2, i32, OPEN_END),
        cap_frac=col(cap_events, 3, f32), period=col(cap_events, 4, i32),
        duty=col(cap_events, 5, f32),
        ge_link=col(ge_events, 0, i32), ge_t0=col(ge_events, 1, i32),
        ge_t1=col(ge_events, 2, i32, OPEN_END),
        ge_p_good=col(ge_events, 3, f32), ge_p_bad=col(ge_events, 4, f32),
        ge_p_gb=col(ge_events, 5, f32), ge_p_bg=col(ge_events, 6, f32))


def _fault_of(spec, dt, dev):
    if not spec.faults:
        return None
    idx = spec.link_index()

    def ep(t):
        return max(int(round(t / dt)), 0)
    cap, ge = [], []
    for f in spec.faults:
        li, e0 = idx[f.link], ep(f.t_start)
        e1 = None if f.t_end is None else max(ep(f.t_end), e0)
        if f.kind == "down":
            cap.append((li, e0, e1, 0.0, 0, 0.0))
        elif f.kind == "brownout":
            cap.append((li, e0, e1, f.cap_frac, 0, 0.0))
        elif f.kind == "flap":
            cap.append((li, e0, e1, f.cap_frac,
                        max(int(round(f.period / dt)), 1), f.duty))
        else:
            p_bg = 1.0 / max(f.mean_burst_len, 1.0)
            p_gb = f.loss_rate / max(f.burst * f.mean_burst_len, 1e-12)
            ge.append((li, e0, e1, 0.0, f.burst, min(p_gb, 1.0), p_bg))
    return make_fault(cap, ge, dev)


def compile_spec(spec, dev) -> dict:
    """One spec's tensors on `dev`."""
    f32 = dict(dtype=torch.float32, device=dev)
    n_links = len(spec.links)
    cap = torch.tensor([l.rate for l in spec.links], **f32)
    qcap = torch.tensor([l.qcap for l in spec.links], **f32)
    vcap_d = torch.tensor(
        [l.vcap_scale * spec.cap_bdps
         * (spec.inter_bdp if l.wan else spec.intra_bdp)
         for l in spec.links], **f32)
    if spec.phantom:
        net = dict(ecn_lo=spec.min_frac * vcap_d, ecn_hi=spec.max_frac * vcap_d,
                   drain=spec.drain_frac * cap, vcap=vcap_d,
                   use_phantom=torch.ones(n_links, dtype=torch.bool,
                                          device=dev))
    else:
        net = dict(ecn_lo=spec.red_lo_frac * qcap,
                   ecn_hi=spec.red_hi_frac * qcap, drain=cap, vcap=qcap,
                   use_phantom=torch.zeros(n_links, dtype=torch.bool,
                                           device=dev))
    net.update(cap=cap, qcap=qcap,
               routes=torch.as_tensor(routes_of(spec), device=dev),
               dt=torch.tensor(spec.epoch_period_frac * spec.intra_rtt, **f32),
               p_loss=torch.tensor([l.p_loss for l in spec.links], **f32)
               if any(l.p_loss > 0.0 for l in spec.links) else None)
    rtt = torch.tensor(_per_flow(spec, lambda g: g.rtt if g.rtt is not None
                                 else (spec.inter_rtt if g.inter
                                       else spec.intra_rtt)), **f32)
    params = make_params(spec.rate * rtt, rtt, spec.intra_bdp,
                         spec.intra_rtt, spec.epoch_period_frac)
    is_inter = torch.tensor(_per_flow(spec, lambda g: g.inter),
                            dtype=torch.bool, device=dev)

    def adaptive(g):
        return g.lb.kind in _ADAPTIVE and g.lb.eta > 0
    lb = None
    if any(adaptive(g) or (g.lb.ec is not None and g.inter)
           for g in spec.groups):
        def eff(g):
            k_r = g.lb.ec if g.inter else None
            return 1.0 if k_r is None else k_r[0] / (k_r[0] + k_r[1])
        lb = dict(
            eta=torch.tensor(_per_flow(spec, lambda g: g.lb.eta if adaptive(g)
                                       else 0.0), **f32),
            repath_thresh=torch.tensor(_per_flow(
                spec, lambda g: g.lb.repath_thresh if adaptive(g)
                else _NEVER), **f32),
            repath_patience=torch.tensor(_per_flow(
                spec, lambda g: g.lb.repath_patience if adaptive(g)
                else 2 ** 30), dtype=torch.int32, device=dev),
            w_floor=torch.tensor(_per_flow(spec, lambda g: g.lb.w_floor
                                           if adaptive(g) else 0.0), **f32),
            ec_eff=torch.tensor(_per_flow(spec, eff), **f32))
    churn = None
    if any(g.churn is not None for g in spec.groups):
        churn = dict(
            churned=torch.tensor(_per_flow(spec, lambda g: g.churn is not None),
                                 dtype=torch.bool, device=dev),
            mean_on=torch.tensor(_per_flow(spec, lambda g: g.churn.mean_on
                                           if g.churn else 1.0), **f32),
            mean_off=torch.tensor(_per_flow(spec, lambda g: g.churn.mean_off
                                            if g.churn else 1.0), **f32))
    dt = float(net["dt"])
    return dict(net=net, params=params, is_inter=is_inter, lb=lb,
                churn=churn, rel=_rel_of(spec, dt, dev),
                fault=_fault_of(spec, dt, dev))


# ------------------------------------------------------------ grids

def _cell(base: dict, mod, spec, dev) -> dict:
    """One grid cell: the base scenario with `mod` applied."""
    sc = dict(base)
    if mod.cap_scale:
        idx = spec.link_index()
        scale = torch.ones_like(base["net"]["cap"])
        for name, f in mod.cap_scale:
            scale[idx[name]] = f
        sc["net"] = dict(base["net"], cap=base["net"]["cap"] * scale,
                         drain=base["net"]["drain"] * scale)
    if mod.rel is not None:
        sc["rel"] = make_rel(spec.n_flows, dev, **mod.rel)
    if mod.cap_events is not None or mod.ge_events is not None:
        sc["fault"] = make_fault(mod.cap_events or (), mod.ge_events or (),
                                 dev)
    return sc


def _stack(cells: list) -> dict:
    c0 = cells[0]
    b, nl = len(cells), c0["net"]["cap"].shape[0]
    r = torch.stack([c["net"]["routes"] for c in cells])
    off = (torch.arange(b, dtype=r.dtype, device=r.device) * nl).reshape(
        (b,) + (1,) * (r.dim() - 1))
    net = {f: torch.cat([c["net"][f] for c in cells])
           for f in ("cap", "qcap", "ecn_lo", "ecn_hi", "drain", "vcap",
                     "use_phantom")}
    net.update(routes=torch.where(r >= 0, r + off, r).reshape(
        (-1,) + tuple(r.shape[2:])).to(torch.int32), dt=c0["net"]["dt"],
        p_loss=None if c0["net"]["p_loss"] is None else
        torch.cat([c["net"]["p_loss"] for c in cells]))

    def cat(key):
        if c0[key] is None:
            return None
        return {f: torch.cat([c[key][f] for c in cells]) for f in c0[key]}
    rel = None
    if c0["rel"] is not None:
        rels = [c["rel"] for c in cells]
        rel = {f: None if f in _LADDER or rels[0][f] is None
               else torch.cat([x[f] for x in rels]) for f in REL_FIELDS}
        if rels[0]["ladder_k"] is not None:
            same = all(torch.equal(x[f], rels[0][f])
                       for x in rels for f in _LADDER)
            for f in _LADDER:
                rel[f] = rels[0][f] if same else \
                    torch.stack([x[f] for x in rels])
    fault = None
    if c0["fault"] is not None:
        fault = cat("fault")
        e = c0["fault"]["link"].shape[0]
        g = c0["fault"]["ge_link"].shape[0]
        dev = fault["link"].device
        fault["link"] = (fault["link"] + torch.arange(
            b, device=dev).repeat_interleave(e) * nl).to(torch.int32)
        fault["ge_link"] = (fault["ge_link"] + torch.arange(
            b, device=dev).repeat_interleave(g) * nl).to(torch.int32)
    return dict(net=net, params=cat("params"),
                is_inter=torch.cat([c["is_inter"] for c in cells]),
                lb=cat("lb"), churn=cat("churn"), rel=rel, fault=fault)


def compile_generated(gen, dev) -> dict:
    """The generated scenario (`bench.harness.traffic.Generated`) as the
    tensors one epoch of the whole net reads, with `seeds`."""
    base = compile_spec(gen.base, dev)
    sc = _stack([_cell(base, m, gen.base, dev) for m in gen.cells]) \
        if gen.grid else base
    sc["seeds"] = list(gen.seeds) if gen.grid else gen.seeds[0]
    return sc


# ------------------------------------------------------------ state

def path_mask(routes):
    r = routes if routes.dim() == 3 else routes[:, None, :]
    return torch.any(r >= 0, dim=2)


def uniform_split(routes):
    m = path_mask(routes).to(torch.float32)
    return m / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)


def init_state(sc: dict) -> dict:
    """A fresh run: line-rate start (cwnd = BDP), empty queues, uniform
    split, the churn key of the seed(s), the reliability machine idle and
    the fault carry at epoch 0."""
    p = sc["params"]
    dev = p["bdp"].device
    n = p["bdp"].shape[0]
    n_links = sc["net"]["cap"].shape[0]
    f0 = torch.zeros(n, dtype=torch.float32, device=dev)
    i0 = torch.zeros(n, dtype=torch.int32, device=dev)
    lk0 = torch.zeros(n_links, dtype=torch.float32, device=dev)
    split0 = uniform_split(sc["net"]["routes"])
    seeds = sc["seeds"]
    st = dict(
        cwnd=p["bdp"].clone(), ecn_ewma=f0, md_scale=torch.ones_like(f0),
        q_phys=lk0, q_phantom=lk0.clone(), obs_frac=f0, obs_delay=f0,
        win_acked=f0, win_marked=f0,
        win_delay_min=torch.full_like(f0, math.inf), win_delay_max=f0,
        cc_countdown=p["cc_period"].clone(), qa_acked=f0, qa_prev_acked=f0,
        qa_deficits=i0, qa_countdown=p["qa_period"].clone(), skip=i0,
        fi_clean=i0, fi_active=torch.zeros(n, dtype=torch.bool, device=dev),
        fi_ceiling=p["max_cwnd"].clone(), split=split0,
        path_frac=torch.zeros_like(split0),
        bad_count=torch.zeros(split0.shape, dtype=torch.int32, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        key=prng.key_of(seeds, dev), rel=None, fault=None)
    rel = sc["rel"]
    if rel is not None:
        z = torch.zeros_like(rel["loss_md"])
        st["rel"] = dict(
            pending=z, backlog=z, ack_cd=rel["nack_period"],
            hold=torch.zeros_like(rel["nack_hold"]), md_cd=z, rtx_ewma=z,
            lat_ewma=z, nacks=z, rec_bytes=z, rtx_bytes=z, wire_bytes=z,
            lost_bytes=z, rung=torch.zeros_like(rel["nack_period"]),
            loss_ewma=z, adapt_cd=z)
    fault = sc["fault"]
    if fault is not None:
        st["fault"] = dict(
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            ge_bad=torch.zeros(fault["ge_link"].shape[0], dtype=torch.bool,
                               device=dev),
            key=prng.fold_in(prng.key_of(seeds, dev), _FAULT_SALT))
    return st
