"""Locality-sharded flow axis: private/boundary link split + halo exchange.

The port of ``repro.fleetsim.shard``.  The fleet step is parallel in the
flow dimension except for one reduction, the per-link offered load.  A
compile-time `ShardPlan` (`repro_torch.scenarios.plan_shards`) permutes the
flows into per-shard rows so each shard's flows touch a contiguous range of
links it owns privately, relabels the link ids so every boundary link (one
touched by flows of 2+ shards) sits at the TAIL of the id space, and each
shard gets its own RouteLayout (and PathTable) over its rows.  Per epoch
each shard reduces its private links locally and only the boundary tile is
exchanged (`links.halo_exchange`): a psum, or — when the plan proves every
boundary link is shared by one ring-adjacent shard pair (`neighbor_halo`)
— a neighbor exchange with bitwise the psum's result.  On the kernel
backends the boundary tile leaves K6 (`fleet_cuda.segment_sum_tiles`)
directly in its row of the exchange buffer.

The epoch is cut at the exchange (`cc.make_step_halves`), and the shards
step in lock-step under one of two exchange implementations behind the
same interface:

  * stacked (no process group): all S shards in this process, on one
    device; the psum is a sum over the shard dim of an (S, B + 1) buffer,
    the neighbor exchange two rolls of the stacked send buffers.
  * dist (`group=`): one shard per rank of a `torch.distributed` process
    group; the psum is an `all_reduce` of the boundary tile, the neighbor
    exchange `batch_isend_irecv` with the ring neighbors, and the final
    link state and rates come back through an `all_reduce` of the owned
    queues and `all_gather`s.

Each shard keeps its own copy of the (n_links,) link state; outside the
shard's reach it goes stale, but no local flow reads it.  The final link
state is reassembled from each link's owning shard (`own`).  Flow counts
that do not divide the shard count are padded per shard with inert flows
(all hops -1: zero split, zero load, zero goodput).  A shard count, or a
process group, takes the place of the reference's device mesh.

The dynamics axes shard as the reference's do: the reliability params are
permuted with the flows (padding rows disabled), the fault schedule's link
ids are relabeled like the routes, and churn reads one GLOBAL (n_real,)
uniform vector per epoch by each row's original flow id (`churn_map`),
so a sharded run flips exactly the flows a single-device run flips.  The
churn key and the fault carry are replicated: the stacked runner draws
them once per epoch for all its shards (`cc.make_step_halves`' `draw`),
and every rank of a process group advances its own identical copy.

Not ported: three knobs that exist only for JAX's compiled scan —
`unroll` (epochs fused per scan step), the executable cache
(`_compiled`, `cache_stats`, `set_executable_cache_size`) and buffer
donation (`_unalias`): an eager Python loop has no trace to fuse, cache
or donate into.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.fleetsim import cc as C
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim.faults import FaultSchedule
from repro_torch.fleetsim.reliability import LADDER_SHARED, RelParams
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams, init_state)

# FleetState fields indexed by link, and those replicated on every shard
# (the rest are per-flow, the nested RelState included, or None)
_LINK_FIELDS = ("q_phys", "q_phantom")
_REPLICATED = ("key", "fault")


def _contiguous_plan(n_real: int, n_links: int, n_shards: int):
    """Contiguous flow blocks, no link relabeling, every link boundary
    (full-buffer exchange): the ``locality=False`` layout as a ShardPlan."""
    from repro_torch.scenarios.compile_fleetsim import ShardPlan
    rows = -(-n_real // n_shards)
    ids = np.arange(n_shards * rows, dtype=np.int32)
    gather = np.where(ids < n_real, ids, n_real).reshape(n_shards, rows)
    eye = np.arange(n_links, dtype=np.int32)
    return ShardPlan(n_shards=n_shards, n_real=n_real, n_links=n_links,
                     n_boundary=n_links, gather=gather, new2old=eye,
                     old2new=eye,
                     owner_ptr=np.zeros(n_shards + 1, np.int32))


class ShardedFleet(NamedTuple):
    """A scenario compiled against one ShardPlan: flow axis permuted into
    per-shard rows, link ids relabeled boundary-last, one RouteLayout per
    shard.  Build once with `shard_scenario`, reuse across runs."""
    plan: object                  # ShardPlan (host-side numpy)
    n_shards: int
    group: object                 # torch.distributed group, None: stacked
    net: L.FluidNet               # permuted links + routes, layout=None
    layouts: list                 # per-shard RouteLayouts
    params: FleetParams           # flow axis permuted + padded
    is_inter: torch.Tensor
    lb: Optional[LbParams]
    own: torch.Tensor             # (S, n_links) bool link-ownership masks
    nbr: Optional[torch.Tensor] = None  # (S, 2, P) int32 neighbor-exchange
    # link ids (neighbor_halo); None -> boundary psum
    churn: Optional[ChurnParams] = None   # flow axis permuted, padding off
    churn_map: Optional[torch.Tensor] = None  # (S, rows) int32 original
    # flow id of each row: the entry of the global churn draw it reads
    rel: Optional[RelParams] = None       # flow axis permuted, padding off
    fault: Optional[FaultSchedule] = None  # link ids relabeled (old2new)

    @property
    def rows(self) -> int:
        return self.plan.rows

    def shard_net(self, s: int) -> L.FluidNet:
        """Shard s's view: the shared link arrays, its rows of the routes
        and its own layout."""
        r = self.rows
        return self.net._replace(routes=self.net.routes[s * r:(s + 1) * r],
                                 layout=self.layouts[s])


def neighbor_halo(plan) -> Optional[np.ndarray]:
    """(S, 2, P) neighbor halo-exchange index table, or None when illegal.

    Legal iff every boundary link is touched by exactly one RING-ADJACENT
    shard pair {p, (p+1) % S} (`ShardPlan.boundary_pairs`) — trivially
    true on any 2-shard plan.  Pair group p (shared by shards p and p+1)
    is one global link list; shard p's row 0 is group p (its RIGHT group),
    row 1 group p-1 (LEFT), both padded to the widest group with `n_links`
    (the scratch slot).  Links with 3+ touchers or a non-adjacent toucher
    pair make this return None; the psum is the fallback there.
    """
    bp = getattr(plan, "boundary_pairs", None)
    S = plan.n_shards
    if bp is None or S < 2 or plan.n_boundary == 0:
        return None
    a = bp[:, 0].astype(np.int64)
    b = bp[:, 1].astype(np.int64)
    if np.any(a < 0):
        return None                       # 3+ touchers somewhere
    g = np.where((b - a) % S == 1, a,
                 np.where((a - b) % S == 1, b, -1))
    if np.any(g < 0):
        return None                       # non-adjacent pair
    base = plan.n_links - plan.n_boundary
    groups = [base + np.flatnonzero(g == gg) for gg in range(S)]
    width = max(gr.shape[0] for gr in groups)
    nbr = np.full((S, 2, width), plan.n_links, np.int32)
    for p in range(S):
        r, l = groups[p], groups[(p - 1) % S]
        nbr[p, 0, :r.shape[0]] = r
        nbr[p, 1, :l.shape[0]] = l
    return nbr


def _take_links(net: L.FluidNet, new2old: torch.Tensor) -> L.FluidNet:
    """Permute every (n_links,) field of the net into the relabeled order."""
    return net._replace(
        cap=net.cap[new2old], qcap=net.qcap[new2old],
        ecn_lo=net.ecn_lo[new2old], ecn_hi=net.ecn_hi[new2old],
        drain=net.drain[new2old], vcap=net.vcap[new2old],
        use_phantom=net.use_phantom[new2old],
        p_loss=None if net.p_loss is None else net.p_loss[new2old])


def _take_rows(tup, idx):
    """`tup` (None passes) with its flow axis indexed by `idx`, a tensor
    or a slice; absent fields and the rung-indexed ladder tables of a
    RelParams pass through."""
    if tup is None:
        return None
    return type(tup)(*(v if v is None or f in LADDER_SHARED else v[idx]
                       for f, v in tup._asdict().items()))


def _take_rel(rel: RelParams, idx: torch.Tensor,
              real: torch.Tensor) -> RelParams:
    """RelParams with the flow axis gathered by `idx` and the rows not
    `real` disabled."""
    out = _take_rows(rel, idx)
    out = out._replace(enabled=out.enabled & real)
    if out.adapt_on is not None:
        out = out._replace(adapt_on=out.adapt_on & real)
    return out


def shard_scenario(net: L.FluidNet, params: FleetParams, *,
                   is_inter: Optional[torch.Tensor] = None,
                   lb: Optional[LbParams] = None, churn=None, rel=None,
                   fault=None, n_shards: Optional[int] = None, group=None,
                   locality: bool = True, plan=None, link_tier=None,
                   link_dc=None, sender_private: Optional[bool] = None,
                   exchange: str = "auto", seed: int = 0,
                   path_table="auto") -> ShardedFleet:
    """Compile (net, params, ...) against a locality ShardPlan over
    `n_shards` shards, or over the ranks of a `torch.distributed` `group`.

    `locality=False` gives the contiguous-block plan (full link buffer
    exchanged every epoch); an explicit `plan` overrides both.
    `churn` / `rel` / `fault` (FleetScenario fields) shard as the module
    docstring says.  `link_tier` / `link_dc` feed the planner's tier
    score and DC-major order, `sender_private` its first-hop rehoming
    (default: on exactly when `link_dc` is given), `seed` its draws.

    `exchange`: "auto" uses the neighbor exchange whenever the plan
    proves it legal (`neighbor_halo`), else the psum; "psum" forces the
    psum; "nbr" demands the neighbor exchange and raises when the plan
    cannot support it.  Under the neighbor exchange each boundary link's
    final queue state is taken from its FIRST toucher shard.

    `path_table`: "auto" attaches per-shard PathTables only when EVERY
    shard clears `links.PT_MIN_COMPRESS`, True forces them, False keeps
    the flat layouts; shards are padded to the widest shard's (U, E1), as
    the reference's stacked tables are.
    """
    from repro_torch.scenarios.compile_fleetsim import plan_shards
    if exchange not in ("auto", "psum", "nbr"):
        raise ValueError(f"unknown boundary exchange {exchange!r}")
    if group is not None:
        import torch.distributed as dist
        size = dist.get_world_size(group)
        if n_shards is not None and n_shards != size:
            raise ValueError(f"n_shards={n_shards} but the group has "
                             f"{size} ranks")
        n_shards = size
    if n_shards is None:
        raise ValueError("give n_shards or a process group")
    dev = net.device
    nl = net.n_links
    n_real = params.bdp.shape[0]
    routes3 = L._routes3(net).cpu().numpy()
    if sender_private is None:
        sender_private = link_dc is not None
    if plan is None:
        plan = (plan_shards(routes3, nl, n_shards, link_tier=link_tier,
                            seed=seed, link_dc=link_dc,
                            sender_private=sender_private) if locality
                else _contiguous_plan(n_real, nl, n_shards))
    if plan.n_shards != n_shards or plan.n_real != n_real:
        raise ValueError(
            f"plan is for {plan.n_shards} shards x {plan.n_real} flows, "
            f"the call gives {n_shards} x {n_real}")

    gflat = plan.flat_gather
    real = gflat < n_real
    gc_np = np.where(real, gflat, 0)
    gc = torch.as_tensor(gc_np.astype(np.int64), device=dev)
    real_t = torch.as_tensor(real, device=dev)

    # routes: relabel link ids, permute flows, force inert padding rows
    relabeled = np.where(routes3 >= 0,
                         plan.old2new[np.clip(routes3, 0, None)], -1)
    routes_p = np.where(real[:, None, None], relabeled[gc_np],
                        -1).astype(np.int32)
    new2old = torch.as_tensor(plan.new2old.astype(np.int64), device=dev)
    net_p = _take_links(net, new2old)._replace(
        routes=torch.as_tensor(routes_p, device=dev), layout=None)
    rows = plan.rows
    shard_routes = [routes_p[s * rows:(s + 1) * rows]
                    for s in range(n_shards)]
    lays = [L.compute_layout(r, nl, path_table=False, device=dev)
            for r in shard_routes]
    if path_table:
        min_c = L.PT_MIN_COMPRESS if path_table == "auto" else None
        pts = [L.compute_path_table(r, nl, min_compress=min_c, device=dev)
               for r in shard_routes]
        if all(pt is not None for pt in pts):
            u_max = max(pt.n_segments for pt in pts)
            e1_max = max(pt.seg_gather.numel() for pt in pts)
            pts = [pt if pt.n_segments == u_max and
                   pt.seg_gather.numel() == e1_max else
                   L.compute_path_table(r, nl, pad_segments_to=u_max,
                                        pad_entries_to=e1_max, device=dev)
                   for r, pt in zip(shard_routes, pts)]
            lays = [lay._replace(path_table=pt)
                    for lay, pt in zip(lays, pts)]

    params_p = _take_rows(params, gc)
    if is_inter is None:
        is_inter = torch.zeros(n_real, dtype=torch.bool, device=dev)
    ii_p = is_inter[gc] & real_t
    lb_p = _take_rows(lb, gc)
    rel_p = None if rel is None else _take_rel(rel, gc, real_t)
    fault_p = None
    if fault is not None:
        # schedule link ids live in the original id space: relabel them
        o2n = torch.as_tensor(plan.old2new, device=dev)
        fault_p = fault._replace(
            link=torch.index_select(o2n, 0, fault.link),
            ge_link=torch.index_select(o2n, 0, fault.ge_link))
    churn_p = cmap = None
    if churn is not None:
        churn_p = ChurnParams(churned=churn.churned[gc] & real_t,
                              mean_on=churn.mean_on[gc],
                              mean_off=churn.mean_off[gc])
        cmap = gc.to(torch.int32).reshape(n_shards, rows)

    nbr = None
    if exchange != "psum":
        nbr = neighbor_halo(plan)
        if nbr is None and exchange == "nbr":
            raise ValueError(
                "exchange='nbr' but the plan's boundary links are not all "
                "ring-adjacent shard pairs (neighbor_halo); hub-spoke "
                "relays and straddled multi-shard hubs need the psum")

    # link ownership: shard s owns its private range plus (shard 0) any
    # untouched link; the boundary tail goes wholesale to shard 0 under
    # the psum (every shard holds the sum) and link by link to its FIRST
    # toucher under the neighbor exchange (only the touchers hold it)
    iota = np.arange(nl)
    own = (iota >= plan.owner_ptr[:-1, None]) & \
        (iota < plan.owner_ptr[1:, None])
    base = nl - plan.n_boundary
    if nbr is None:
        own[0] |= iota >= base
    else:
        own[plan.boundary_pairs[:, 0], base + np.arange(plan.n_boundary)] = \
            True
    return ShardedFleet(
        plan=plan, n_shards=n_shards, group=group, net=net_p, layouts=lays,
        params=params_p, is_inter=ii_p, lb=lb_p,
        own=torch.as_tensor(own, device=dev),
        nbr=None if nbr is None else torch.as_tensor(nbr, device=dev),
        churn=churn_p, churn_map=cmap, rel=rel_p, fault=fault_p)


def _map_fields(state: FleetState, flow, link) -> FleetState:
    """Apply `flow` to every per-flow tensor (the nested RelState's too)
    and `link` to the link fields; replicated and absent fields pass
    through."""
    out = {}
    for f, v in state._asdict().items():
        if v is None or f in _REPLICATED:
            out[f] = v
        elif f in _LINK_FIELDS:
            out[f] = link(v)
        elif hasattr(v, "_fields"):
            out[f] = type(v)(*(flow(x) for x in v))
        else:
            out[f] = flow(v)
    return FleetState(**out)


def _permute_state(state: FleetState, flow_idx: torch.Tensor,
                   link_idx: torch.Tensor) -> FleetState:
    """Reindex a FleetState: per-flow fields by `flow_idx`, link fields by
    `link_idx`."""
    return _map_fields(state, lambda v: v[flow_idx], lambda v: v[link_idx])


class ShardedStep:
    """The lock-step epoch of the shards this process steps: every shard
    of a stacked run, or this rank's shard under a process group.

    `split(state)` cuts a full (permuted, padded) FleetState into the
    per-shard states `step` advances; `step(states) -> (states, goodput)`
    runs every local shard's send half, the halo exchange and every
    receive half; `join(states, rates)` reassembles the full state and
    rates (link state from each link's owner).
    """

    def __init__(self, sf: ShardedFleet, *, scheme: str = "uno",
                 backend: str = "auto"):
        self.sf = sf
        self.group = sf.group
        if sf.group is None:
            self.local = list(range(sf.n_shards))
        else:
            import torch.distributed as dist
            self.local = [dist.get_rank(sf.group)]
        nl, halo, rows = sf.net.n_links, sf.plan.n_boundary, sf.rows
        self.n_links = nl
        dev = sf.net.device
        self.halves, self.backends = [], []
        for s in self.local:
            sl = slice(s * rows, (s + 1) * rows)
            net_s = sf.shard_net(s)
            self.backends.append(L._resolve_backend(net_s, backend))
            self.halves.append(C.make_step_halves(
                net_s, _take_rows(sf.params, sl), scheme, sf.is_inter[sl],
                lb=_take_rows(sf.lb, sl), churn=_take_rows(sf.churn, sl),
                rel=_take_rows(sf.rel, sl), fault=sf.fault,
                backend=self.backends[-1], halo=halo,
                churn_map=None if sf.churn_map is None else sf.churn_map[s],
                churn_n=sf.plan.n_real))
        # the replicated draws (churn uniforms, fault carry): once an epoch
        self.draw = self.halves[0][0]
        # the exchange buffer: one (halo + 1,) boundary tile per local
        # shard, the scratch slot last (the whole buffer at halo == nl)
        self.tiles = None
        if halo:
            self.tiles = torch.empty((len(self.local), halo + 1),
                                     dtype=torch.float32, device=dev)
        self.nbr = None
        if sf.nbr is not None:
            local = (sf.nbr.long() - (nl - halo))[self.local]
            self.nbr = local if sf.group is None else local[0]

    def split(self, state: FleetState) -> list:
        rows = self.sf.rows
        return [_map_fields(state, lambda v, s=s: v[s * rows:(s + 1) * rows],
                            lambda v: v) for s in self.local]

    def zeros(self) -> torch.Tensor:
        return torch.zeros(len(self.local) * self.sf.rows,
                           dtype=torch.float32, device=self.sf.net.device)

    def _exchange(self) -> torch.Tensor:
        if self.group is None:
            return L.halo_exchange(self.tiles, nbr=self.nbr)
        return L.halo_exchange(self.tiles[0], nbr=self.nbr,
                               group=self.group)[None]

    def step(self, states: list):
        draws = self.draw(states[0])
        sent = [send(st, draws,
                     out=None if self.tiles is None else self.tiles[i])
                for i, ((_, send, _), st) in enumerate(zip(self.halves,
                                                           states))]
        tiles = None if self.tiles is None else self._exchange()
        new, goodput = [], []
        for i, ((_, _, recv), st, (sent_i, private, _)) in enumerate(
                zip(self.halves, states, sent)):
            load = L.assemble_load(private,
                                   None if tiles is None else tiles[i],
                                   self.n_links)
            st, g = recv(st, sent_i, load)
            new.append(st)
            goodput.append(g)
        return new, goodput[0] if len(goodput) == 1 else torch.cat(goodput)

    def join(self, states: list, rates: torch.Tensor):
        own = self.sf.own[self.local]
        out = {}
        for f in FleetState._fields:
            vals = [getattr(st, f) for st in states]
            if vals[0] is None or f in _REPLICATED:
                out[f] = vals[0]
            elif hasattr(vals[0], "_fields"):
                out[f] = type(vals[0])(*(self._gather(torch.cat(col))
                                         for col in zip(*vals)))
            elif f in _LINK_FIELDS:
                owned = torch.where(own, torch.stack(vals), 0.0).sum(dim=0)
                if self.group is not None:
                    import torch.distributed as dist
                    dist.all_reduce(owned, group=self.group)
                out[f] = owned
            else:
                out[f] = self._gather(torch.cat(vals))
        return FleetState(**out), self._gather(rates)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Rows of every rank, in rank order (stacked: `x` itself)."""
        if self.group is None:
            return x
        import torch.distributed as dist
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, y.contiguous(), group=self.group)
        return torch.cat(parts).to(x.dtype)


def permute_in(sf: ShardedFleet, state0: Optional[FleetState] = None, *,
               seed: int = 0) -> FleetState:
    """A full FleetState in the plan's permuted, padded order: the fresh
    `init_state` when `state0` is None, else `state0` (unpadded, original
    flow and link order) permuted in, with zero split on padding rows."""
    plan, net = sf.plan, sf.net
    dev = net.device
    if state0 is None:
        return init_state(sf.params, net.n_links, n_paths=net.n_paths,
                          split0=L.uniform_split(net), seed=seed,
                          rel=sf.rel, fault=sf.fault)
    if state0.cwnd.shape[0] != plan.n_real:
        raise ValueError("state0 flow count does not match the plan")
    for f in ("rel", "fault"):
        if (getattr(state0, f) is None) != (getattr(sf, f) is None):
            raise ValueError(f"state0's {f} carry does not match the "
                             f"scenario's")
    gflat = plan.flat_gather
    real = gflat < plan.n_real
    gc = torch.as_tensor(np.where(real, gflat, 0).astype(np.int64),
                         device=dev)
    state0 = _permute_state(state0, gc, torch.as_tensor(
        plan.new2old.astype(np.int64), device=dev))
    # inert padding carries zero split weight, not a real flow's copy
    return state0._replace(split=torch.where(
        torch.as_tensor(real, device=dev)[:, None], state0.split, 0.0))


def steady_state_prepared(sf: ShardedFleet, *, n_warm: int, n_meas: int,
                          scheme: str = "uno", backend: str = "auto",
                          state0: Optional[FleetState] = None,
                          seed: int = 0):
    """`cc.steady_state` over an already-compiled ShardedFleet.

    Returns (final_state, mean goodput) in the ORIGINAL flow and link
    order with padding stripped (on every rank under a process group).
    `state0`, when given, must match the unpadded flow count and original
    ordering — it is permuted in.
    """
    plan = sf.plan
    state0 = permute_in(sf, state0, seed=seed)
    runner = ShardedStep(sf, scheme=scheme, backend=backend)
    states, rates = C.steady_state_core(
        runner.step, runner.split(state0), n_warm=n_warm, n_meas=n_meas,
        acc=runner.zeros())
    final, rates = runner.join(states, rates)
    dev = sf.net.device
    inv = torch.as_tensor(plan.inverse_flow, device=dev)
    return (_permute_state(final, inv, torch.as_tensor(
        plan.old2new.astype(np.int64), device=dev)), rates[inv])


def steady_state_sharded(net: L.FluidNet, params: FleetParams, *,
                         n_warm: int, n_meas: int, scheme: str = "uno",
                         is_inter: Optional[torch.Tensor] = None,
                         lb: Optional[LbParams] = None, churn=None,
                         rel=None, fault=None,
                         state0: Optional[FleetState] = None,
                         n_shards: Optional[int] = None, group=None,
                         backend: str = "auto", locality: bool = True,
                         plan=None, link_tier=None, link_dc=None,
                         sender_private: Optional[bool] = None,
                         exchange: str = "auto", path_table="auto",
                         seed: int = 0):
    """`cc.steady_state` with the flow axis sharded over `n_shards` shards
    stepped in lock-step on net's device, or over the ranks of `group` —
    `shard_scenario` + `steady_state_prepared` in one call."""
    sf = shard_scenario(net, params, is_inter=is_inter, lb=lb, churn=churn,
                        rel=rel, fault=fault, n_shards=n_shards,
                        group=group, locality=locality, plan=plan,
                        link_tier=link_tier, link_dc=link_dc,
                        sender_private=sender_private, exchange=exchange,
                        seed=seed, path_table=path_table)
    return steady_state_prepared(sf, n_warm=n_warm, n_meas=n_meas,
                                 scheme=scheme, backend=backend,
                                 state0=state0, seed=seed)
