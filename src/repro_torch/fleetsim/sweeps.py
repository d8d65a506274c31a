"""Scenario sweeps: whole fluid simulations across parameter grids, every
cell of a grid stepped as one batched epoch.

The port of ``repro.fleetsim.sweeps``.  A "scenario" is (FluidNet,
FleetParams, is_inter[, LbParams[, ChurnParams[, RelParams[,
FaultSchedule]]]]), or a `scenarios.FleetScenario`.  The reference vmaps
one simulation over scenarios stacked on a leading axis; the port has no
vmap over its kernels, so a grid of B same-shape cells (n_flows F,
n_links L) runs as ONE fluid net of B·F flows and B·L links
(`stack_scenarios`):

  * cell b's link ids are offset by b·L, so the routes are block-diagonal
    and no flow of one cell loads a link of another;
  * the per-flow and per-link arrays are concatenated, and the layout is
    compiled once over the block-diagonal routes (`links.compute_layout`);
    a PathTable is kept only when every cell carries one of one shape,
    else the cells' tables are stripped with the reference's warning;
  * what a cell holds per cell and not per flow: the churn key (the state
    carries (B, 2) keys, and the epoch's churn draw is ONE threefry2x32
    call over (B, F) counters, `prng`), the fault schedule (concatenated,
    its link ids offset like the routes, with (B, 2) chain keys,
    `faults`), the EC ladder (per-cell tables when the cells' ladders
    differ, `reliability.RelParams`) and the epoch period `dt`, which
    stays one 0-d value per net: `run_grid` steps each group of cells of
    equal `dt` as one batched net, in submission order, and puts the
    results back in cell order.

Each epoch runs `cc.make_step` once for the whole grid, so a grid epoch
launches the same kernels, and makes the same threefry2x32 calls, as one
cell's.  Outputs follow the reference's contract: every leaf of the final
`FleetState` carries a leading cell axis ((B, F, ...), (B, L), the keys
(B, 2), `fault.epoch` (B,)), and the rates are (B, F).

`run_grid(n_shards=S)` (or `group=`, one shard per rank of a
`torch.distributed` group) also shards the flow axis of the grid, as the
reference's `run_grid(mesh=...)` does: cell 0 is planned once
(`scenarios.plan_shards`, with `link_tier`), the plan is lifted to the
block-diagonal grid (`shard.lift_plan`: each shard's rows cell-major, the
B cells' boundary links one common tail) and the grid runs through
`shard.shard_scenario` + `shard.steady_state_prepared` as one scenario
would.  The shared plan needs identical routes in every cell; a grid
whose routes differ warns and runs unsharded, as the reference's does.

`run_grid_streamed` evaluates the grid in fixed-size chunks and yields
completed cells in submission order.  The five concrete sweeps (fairness,
load mix, churn, recovery, faults) build their cells on `device`
(default cuda) and return the reference's keys as tensors.

Not ported: `unroll` (a `lax.scan` knob with no eager counterpart) and
`grid_traces` (it counts jit traces; the sweep service counts the grid
layouts it builds and reuses instead, `service.SweepService.stats`).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim.cc import make_step, steady_state_core
from repro_torch.fleetsim.faults import FaultCarry, FaultSchedule
from repro_torch.fleetsim.reliability import LADDER_SHARED, RelParams
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams, init_state, make_params)

US = L.US
_SUM_CHUNK = 1024
_AXES = ("lb", "churn", "rel", "fault")


def fleet_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Compensated float32 sum along `dim`, accurate at 10^6+ flows:
    per-chunk sums of `_SUM_CHUNK` values joined by a Neumaier-compensated
    carry across chunks."""
    x = torch.movedim(torch.as_tensor(x).to(torch.float32), dim, -1)
    n = x.shape[-1]
    pad = (-n) % _SUM_CHUNK
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    chunks = torch.movedim(x.reshape(x.shape[:-1] + (-1, _SUM_CHUNK)), -2, 0)
    s = x.new_zeros(x.shape[:-1])
    comp = x.new_zeros(x.shape[:-1])
    for c in chunks:
        y = torch.sum(c, dim=-1)
        t = s + y
        comp = comp + torch.where(torch.abs(s) >= torch.abs(y),
                                  (s - t) + y, (y - t) + s)
        s = t
    return s + comp


def jain(rates: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Jain fairness index along `dim` (1.0 = perfectly fair)."""
    s = fleet_sum(rates, dim=dim)
    s2 = fleet_sum(rates * rates, dim=dim)
    n = rates.shape[dim]
    return s * s / torch.clamp(n * s2, min=1e-12)


# ------------------------------------------------------------ stacking

class Grid(NamedTuple):
    """B same-shape cells as one fluid net: block-diagonal routes over
    B·L links, every per-flow array (B·F,), every per-link array (B·L,).
    Cell b owns flows [b·F, (b+1)·F) and links [b·L, (b+1)·L)."""
    net: L.FluidNet
    params: FleetParams
    is_inter: torch.Tensor
    lb: Optional[LbParams]
    churn: Optional[ChurnParams]
    rel: Optional[RelParams]
    fault: Optional[FaultSchedule]
    n_cells: int
    cell_flows: int          # F
    cell_links: int          # L

    @property
    def flow_offsets(self) -> list:
        return [b * self.cell_flows for b in range(self.n_cells)]

    @property
    def link_offsets(self) -> list:
        return [b * self.cell_links for b in range(self.n_cells)]


def _norm_scenario(sc):
    """Scenario -> (net, params, is_inter, lb, churn, rel, fault).

    Accepts a FleetScenario (any NamedTuple with these field names) or a
    bare (net, params, is_inter[, lb[, churn[, rel[, fault]]]]) tuple;
    absent trailing axes pad with None."""
    if hasattr(sc, "net") and hasattr(sc, "params"):
        return (sc.net, sc.params, sc.is_inter, getattr(sc, "lb", None),
                getattr(sc, "churn", None), getattr(sc, "rel", None),
                getattr(sc, "fault", None))
    sc = tuple(sc)
    if not 3 <= len(sc) <= 7:
        raise ValueError(f"scenario tuple of length {len(sc)}")
    return sc + (None,) * (7 - len(sc))


def _check_axes(cells) -> None:
    for i, tag in enumerate(_AXES, start=3):
        xs = [c[i] for c in cells]
        if any(x is None for x in xs) != all(x is None for x in xs):
            raise ValueError(f"{tag} must be set on all scenarios or none")


def _strip_unstackable_path_tables(nets):
    """Drop per-cell PathTables that cannot serve one grid: cells whose
    routes dedupe to different segment counts (load_mix_sweep rebuilds
    routes per cell), or a mix of flat and compressed layouts.  Every cell
    keeps its flat layout, so the grid runs the flat backend — correct,
    just uncompressed."""
    pts = [None if n.layout is None else n.layout.path_table for n in nets]
    if all(pt is None for pt in pts):
        return nets
    sigs = {None if pt is None else tuple(tuple(v.shape) for v in pt)
            for pt in pts}
    if len(sigs) == 1:
        return nets
    warnings.warn("stack_scenarios: per-cell PathTables have mismatched "
                  "shapes; stripping them (cells fall back to the flat "
                  "CSR backend)")
    return tuple(
        n if n.layout is None or n.layout.path_table is None
        else n._replace(layout=n.layout._replace(path_table=None))
        for n in nets)


def _cat(tups, cls):
    """Field-wise concatenation of NamedTuples of per-row tensors."""
    return cls(*(torch.cat(vs) for vs in zip(*tups)))


def _stack_nets(nets, layout=None) -> L.FluidNet:
    net0 = nets[0]
    n_cells, nl = len(nets), net0.n_links
    for n in nets[1:]:
        if tuple(n.routes.shape) != tuple(net0.routes.shape) or \
                n.n_links != nl:
            raise ValueError(
                "stack_scenarios: cells differ in shape (routes "
                f"{tuple(n.routes.shape)} vs {tuple(net0.routes.shape)}, "
                f"links {n.n_links} vs {nl})")
        if (n.p_loss is None) != (net0.p_loss is None):
            raise ValueError("p_loss must be set on all scenarios or none")
    if len({float(n.dt) for n in nets}) > 1:
        raise ValueError("stack_scenarios: cells differ in dt (run_grid "
                         "steps each dt as its own batch)")
    r = torch.stack([n.routes for n in nets])
    off = (torch.arange(n_cells, dtype=r.dtype, device=r.device) * nl) \
        .reshape((n_cells,) + (1,) * (r.dim() - 1))
    routes = torch.where(r >= 0, r + off, r).reshape(
        (-1,) + tuple(r.shape[2:])).to(torch.int32)
    per_link = {f: torch.cat([getattr(n, f) for n in nets])
                for f in ("cap", "qcap", "ecn_lo", "ecn_hi", "drain",
                          "vcap", "use_phantom")}
    if layout is None:
        keep_pt = all(n.layout is not None and
                      n.layout.path_table is not None for n in nets)
        layout = L.compute_layout(routes, n_cells * nl, path_table=keep_pt,
                                  device=net0.device)
    p_loss = None if net0.p_loss is None else \
        torch.cat([n.p_loss for n in nets])
    return L.FluidNet(**per_link, routes=routes, dt=net0.dt, p_loss=p_loss,
                      layout=layout or None)


def _stack_rel(rels) -> RelParams:
    """One RelParams for the grid: per-flow fields concatenated; the
    ladder tables shared when every cell has the same, else stacked to
    per-cell tables (cells, R, ...) that each flow reads by its cell."""
    has = [r.ladder_k is not None for r in rels]
    if any(has) != all(has):
        raise ValueError("an EC ladder must be set on all scenarios' rel "
                         "or none")
    out = {f: (None if f in LADDER_SHARED or vals[0] is None
               else torch.cat(vals))
           for f, vals in zip(RelParams._fields, zip(*rels))}
    if not any(has):
        return RelParams(**out)
    r0 = rels[0]
    if any(r.ladder_k.shape != r0.ladder_k.shape for r in rels):
        raise ValueError("the cells' EC ladders differ in length (pad the "
                         "shorter ones by repeating their last rung, as "
                         "fault_sweep does)")
    same = all(torch.equal(getattr(r, f), getattr(r0, f))
               for r in rels for f in LADDER_SHARED)
    for f in LADDER_SHARED:
        out[f] = getattr(r0, f) if same else \
            torch.stack([getattr(r, f) for r in rels])
    return RelParams(**out)


def _stack_faults(faults, n_links: int) -> FaultSchedule:
    """The cells' schedules concatenated, link ids offset like the routes
    (every cell must have as many events of each family)."""
    f0 = faults[0]
    if any(f.n_cap_events != f0.n_cap_events or
           f.n_ge_events != f0.n_ge_events for f in faults):
        raise ValueError("stack_scenarios: cells differ in fault event "
                         "counts (pad with inert events, as fault_sweep "
                         "does)")
    out = _cat(faults, FaultSchedule)
    e, g = f0.n_cap_events, f0.n_ge_events
    dev = f0.link.device
    cell_e = torch.arange(len(faults), device=dev).repeat_interleave(e)
    cell_g = torch.arange(len(faults), device=dev).repeat_interleave(g)
    return out._replace(
        link=(out.link + cell_e * n_links).to(torch.int32),
        ge_link=(out.ge_link + cell_g * n_links).to(torch.int32))


def stack_scenarios(scenarios: Sequence, *, layout=None) -> Grid:
    """Stack same-shape scenarios into one `Grid` (module docstring).

    The LB / churn / reliability / fault axes must each be present on all
    scenarios or none (a fault grid pads inactive cells with inert
    events, see `fault_sweep`); the cells must share routes' shape, link
    count, `dt` and the presence of `p_loss`, fault event counts and EC
    ladder lengths.  Per-cell PathTables survive only when every cell
    carries one of one shape (`_strip_unstackable_path_tables`).

    `layout`: None compiles the block-diagonal RouteLayout; a RouteLayout
    built earlier for the same cells' routes is attached as given (the
    sweep service's memo); False attaches none (the sharded grid compiles
    one per shard)."""
    cells = [_norm_scenario(s) for s in scenarios]
    if not cells:
        raise ValueError("stack_scenarios: no scenarios")
    _check_axes(cells)
    nets, params, inters, lbs, churns, rels, faults = zip(*cells)
    nets = _strip_unstackable_path_tables(nets)
    n_flows, n_links = nets[0].routes.shape[0], nets[0].n_links
    inters = [torch.zeros(n_flows, dtype=torch.bool, device=nets[0].device)
              if ii is None else ii for ii in inters]
    return Grid(
        net=_stack_nets(nets, layout), params=_cat(params, FleetParams),
        is_inter=torch.cat(inters),
        lb=None if lbs[0] is None else _cat(lbs, LbParams),
        churn=None if churns[0] is None else _cat(churns, ChurnParams),
        rel=None if rels[0] is None else _stack_rel(rels),
        fault=None if faults[0] is None else _stack_faults(faults, n_links),
        n_cells=len(cells), cell_flows=n_flows, cell_links=n_links)


def _grid_seeds(n: int, seed: int, seeds) -> np.ndarray:
    """Cell i's seed: `seed + i`, or `seeds[i]`."""
    if seeds is None:
        return seed + np.arange(n, dtype=np.int64)
    seeds = np.asarray(seeds, np.int64)
    if seeds.shape != (n,):
        raise ValueError(f"seeds shape {seeds.shape} != ({n},)")
    return seeds


# ------------------------------------------------------------ grid runs

def _map(fn, *states):
    """fn over the leaves of FleetStates (nested carries included); None
    passes."""
    s0 = states[0]
    if s0 is None:
        return None
    if hasattr(s0, "_fields"):
        return type(s0)(*(_map(fn, *vs) for vs in zip(*states)))
    return fn(*states)


def _unstack(g: Grid, st: FleetState) -> FleetState:
    """The grid's flat final state with the leading cell axis of the
    reference's contract."""
    b = g.n_cells

    def rows(v):     # per-flow (B·F, ...) and per-link (B·L,) leaves
        return v.reshape((b, -1) + tuple(v.shape[1:]))

    fault = None
    if st.fault is not None:
        fault = FaultCarry(epoch=st.fault.epoch.expand(b).clone(),
                           ge_bad=rows(st.fault.ge_bad), key=st.fault.key)
    return _map(rows, st._replace(key=None, fault=None))._replace(
        key=st.key, fault=fault)


def run_stacked(g: Grid, seeds: np.ndarray, *, scheme: str = "uno",
                n_warm: int, n_meas: int, backend: str = "auto"):
    """One stacked grid of one `dt` on one device: init per cell, the
    steady-state loop over the batched step; (final, rates (B, F))."""
    state0 = init_state(g.params, g.net.n_links, n_paths=g.net.n_paths,
                        split0=L.uniform_split(g.net), seed=seeds,
                        rel=g.rel, fault=g.fault)
    step = make_step(g.net, g.params, scheme, g.is_inter, lb=g.lb,
                     churn=g.churn, rel=g.rel, fault=g.fault,
                     backend=backend)
    final, rates = steady_state_core(step, state0, n_warm=n_warm,
                                     n_meas=n_meas,
                                     acc=torch.zeros_like(g.params.bdp))
    return _unstack(g, final), rates.reshape(g.n_cells, g.cell_flows)


def shard_grid(g: Grid, *, n_shards: Optional[int] = None, group=None,
               link_tier=None):
    """The stacked grid `g` (its cells routed identically, stacked with
    `layout=False`) compiled against cell 0's plan lifted to the grid
    (`shard.lift_plan`): a `shard.ShardedFleet` over `n_shards` shards,
    or over the ranks of `group`, its boundary exchanged by a psum, as
    the reference's grid does.  Cell 0 is planned as the reference plans
    it: `link_tier` feeds the planner, no DC order, seed 0."""
    from repro_torch.fleetsim import shard as SH
    from repro_torch.scenarios.compile_fleetsim import plan_shards
    size = n_shards
    if group is not None:
        import torch.distributed as dist
        size = dist.get_world_size(group)
    if size is None:
        raise ValueError("give n_shards or a process group")
    f, nl = g.cell_flows, g.cell_links
    cell0 = L._routes3(g.net)[:f].cpu().numpy()
    plan = plan_shards(cell0, nl, size, link_tier=link_tier)
    return SH.shard_scenario(
        g.net, g.params, is_inter=g.is_inter, lb=g.lb, churn=g.churn,
        rel=g.rel, fault=g.fault, n_shards=n_shards, group=group,
        plan=SH.lift_plan(plan, g.n_cells, f, nl), exchange="psum")


def _run_sharded(g: Grid, sf, seeds: np.ndarray, *, scheme: str,
                 n_warm: int, n_meas: int, backend: str):
    """`run_stacked` on `sf`, the grid `g` compiled by `shard_grid`."""
    from repro_torch.fleetsim import shard as SH
    final, rates = SH.steady_state_prepared(
        sf, n_warm=n_warm, n_meas=n_meas, scheme=scheme, backend=backend,
        seed=seeds)
    return _unstack(g, final), rates.reshape(g.n_cells, g.cell_flows)


def _same_routes(cells) -> bool:
    r0 = cells[0][0].routes
    return all(c[0].routes.shape == r0.shape and torch.equal(c[0].routes, r0)
               for c in cells[1:])


def run_grid(scenarios: Sequence, *, scheme: str = "uno",
             n_warm: int = 50_000, n_meas: int = 10_000, seed: int = 0,
             seeds=None, backend: str = "auto",
             n_shards: Optional[int] = None, group=None, link_tier=None):
    """Sweep all scenarios as batched epochs, on the scenarios' device.

    Returns (final_states, rates): each leaf carries a leading scenario
    axis; `rates` is (n_scenarios, n_flows) mean steady goodput in
    bytes/ns.  Cell i is seeded with `seed + i` (churn key and fault
    chains), or `seeds[i]`, so a cell's result does not depend on the
    grid it rides in.  Cells of equal `dt` step as one batch (all of
    them, in the concrete sweeps); several `dt` values run one batch each,
    in order of first appearance, and the results come back in cell
    order.

    `n_shards` (or a `torch.distributed` `group`, one shard per rank)
    shards the flow axis of every batch under cell 0's plan
    (`shard_grid`); `link_tier` feeds the planner, by default the first
    FleetScenario cell's.  The shards' boundary is exchanged by a psum,
    as the reference's grid does.  Cells whose routes differ cannot share
    a plan: the grid then warns and runs unsharded.  Explicit `seeds` are
    honoured on both paths."""
    scenarios = list(scenarios)
    cells = [_norm_scenario(s) for s in scenarios]
    if not cells:
        raise ValueError("run_grid: no scenarios")
    _check_axes(cells)
    sd = _grid_seeds(len(cells), seed, seeds)
    sharded = n_shards is not None or group is not None
    if sharded and not _same_routes(cells):
        warnings.warn(
            "run_grid(n_shards=...) needs identical routes across grid "
            "cells to share one ShardPlan; running the grid unsharded",
            RuntimeWarning, stacklevel=2)
        sharded = False
    if sharded and link_tier is None:
        link_tier = next((s.link_tier for s in scenarios
                          if getattr(s, "link_tier", None) is not None),
                         None)
    run = dict(scheme=scheme, n_warm=n_warm, n_meas=n_meas, backend=backend)
    batches: dict = {}
    for i, c in enumerate(cells):
        batches.setdefault(float(c[0].dt), []).append(i)
    outs = []
    for idx in batches.values():
        batch = [cells[i] for i in idx]
        if sharded:
            g = stack_scenarios(batch, layout=False)
            sf = shard_grid(g, n_shards=n_shards, group=group,
                            link_tier=link_tier)
            outs.append(_run_sharded(g, sf, sd[idx], **run))
        else:
            outs.append(run_stacked(stack_scenarios(batch), sd[idx], **run))
    if len(outs) == 1:
        return outs[0]
    order = torch.as_tensor(np.argsort(np.concatenate(
        list(batches.values()))), device=outs[0][1].device)
    final = _map(lambda *vs: torch.cat(vs)[order], *(o[0] for o in outs))
    return final, torch.cat([o[1] for o in outs])[order]


def run_grid_streamed(scenarios: Sequence, *, chunk: int = 8,
                      scheme: str = "uno", n_warm: int = 50_000,
                      n_meas: int = 10_000, seed: int = 0, seeds=None,
                      backend: str = "auto"):
    """Generator variant of `run_grid`: evaluate in chunks of `chunk`
    cells, yielding `(index, final_state_cell, rates_cell)` per completed
    cell in submission order.  Cell i keeps seed `seed + i` (or
    `seeds[i]`) whatever the chunking; the tail chunk is padded by
    repeating its last cell and seed, and the padding is dropped."""
    n = len(scenarios)
    if n == 0:
        return
    chunk = max(1, chunk)
    sd = _grid_seeds(n, seed, seeds)
    for lo in range(0, n, chunk):
        cells = list(scenarios[lo:lo + chunk])
        live = len(cells)
        csd = sd[lo:lo + chunk]
        if live < chunk:
            cells += [cells[-1]] * (chunk - live)
            csd = np.concatenate([csd, np.repeat(csd[-1], chunk - live)])
        final, rates = run_grid(cells, scheme=scheme, n_warm=n_warm,
                                n_meas=n_meas, seeds=csd, backend=backend)
        for i in range(live):
            yield lo + i, _map(lambda v, j=i: v[j], final), rates[i]


# ------------------------------------------------------------ concrete sweeps

def _axis(values, dev) -> torch.Tensor:
    """A sweep axis as jnp.asarray makes it with 64-bit types off:
    integers int32, reals float32."""
    a = np.asarray(values)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=dev)


def fairness_sweep(rtt_ratios: Sequence[float],
                   drain_fracs: Sequence[float], *,
                   n_intra: int = 4, n_inter: int = 4,
                   rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                   scheme: str = "uno", multipath: bool = False,
                   n_wan: int = 8, n_warm: int = 50_000,
                   n_meas: int = 10_000, device=None) -> dict:
    """Inter/intra fairness heatmap over (RTT ratio x phantom drain frac),
    the paper's Fig 11 question at grid scale.  `multipath=True` gives
    inter flows adaptive subflow splits over `n_wan` separate border
    links.  Returns (len(rtt_ratios), len(drain_fracs)) tensors 'jain',
    'class_ratio' (mean inter / mean intra rate), 'util', and 'rates'."""
    from repro_torch.scenarios import dumbbell_scenario, to_fleetsim
    dev = resolve_device(device)
    scen, shape = [], (len(rtt_ratios), len(drain_fracs))
    for ratio in rtt_ratios:
        for drain in drain_fracs:
            scen.append(to_fleetsim(dumbbell_scenario(
                n_intra, n_inter, rate=rate, intra_rtt=intra_rtt,
                inter_rtt=ratio * intra_rtt, drain_frac=drain,
                multipath=multipath, n_wan=n_wan), device=dev))
    _, rates = run_grid(scen, scheme=scheme, n_warm=n_warm, n_meas=n_meas)
    ii = torch.arange(n_intra + n_inter, device=dev) >= n_intra
    mean_inter = torch.mean(rates[:, ii], dim=1) if n_inter else \
        torch.zeros(rates.shape[0], device=dev)
    mean_intra = torch.mean(rates[:, ~ii], dim=1) if n_intra else \
        torch.ones(rates.shape[0], device=dev)
    return {
        "rtt_ratios": _axis(rtt_ratios, dev),
        "drain_fracs": _axis(drain_fracs, dev),
        "rates": rates.reshape(shape + (n_intra + n_inter,)),
        "jain": jain(rates).reshape(shape),
        "class_ratio": (mean_inter / torch.clamp(mean_intra, min=1e-9))
        .reshape(shape),
        "util": (fleet_sum(rates, dim=1) / rate).reshape(shape),
    }


def load_mix_sweep(inter_counts: Sequence[int],
                   loads: Sequence[float], *, n_total: int = 16,
                   rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                   inter_rtt: float = 2 * L.MS, scheme: str = "uno",
                   n_warm: int = 50_000, n_meas: int = 10_000,
                   device=None) -> dict:
    """Heatmap over (flow-count mix x bottleneck load): cell (m, l) runs m
    inter + (n_total - m) intra flows into a bottleneck of capacity
    rate / load.  One base dumbbell (`links.dumbbell`: n_total uplinks,
    the WAN pipe, the bottleneck); per mix m the last m flows repoint hop
    0 at the WAN pipe (layout recompiled), per load the bottleneck's cap
    and drain scale."""
    dev = resolve_device(device)
    scen, shape = [], (len(inter_counts), len(loads))
    base, bdp0, rtt0 = L.dumbbell(n_total, 0, rate=rate,
                                  intra_rtt=intra_rtt, inter_rtt=inter_rtt,
                                  device=dev)
    wan, down = n_total, base.n_links - 1
    hop0 = torch.arange(2, device=dev) == 0
    for m in inter_counts:
        if not 0 <= m <= n_total:
            raise ValueError(f"inter count {m} not in [0, {n_total}]")
        ii = torch.arange(n_total, device=dev) >= (n_total - m)
        routes = torch.where(ii[:, None, None] & hop0, wan,
                             base.routes).to(torch.int32)
        net_m = L.with_layout(base._replace(routes=routes))
        p = make_params(torch.where(ii, rate * inter_rtt, bdp0),
                        torch.where(ii, inter_rtt, rtt0),
                        rate * intra_rtt, intra_rtt)
        for load in loads:
            scale = torch.ones_like(net_m.cap)
            scale[down] = 1.0 / load
            scen.append((net_m._replace(cap=net_m.cap * scale,
                                        drain=net_m.drain * scale), p, ii))
    _, rates = run_grid(scen, scheme=scheme, n_warm=n_warm, n_meas=n_meas)
    return {
        "inter_counts": _axis(inter_counts, dev),
        "loads": _axis(loads, dev),
        "rates": rates.reshape(shape + (n_total,)),
        "jain": jain(rates).reshape(shape),
        "util": (fleet_sum(rates, dim=1) / rate).reshape(shape),
    }


def churn_sweep(duty_fracs: Sequence[float],
                mean_on_rtts: Sequence[float], *, n_flows: int = 16,
                rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                scheme: str = "uno", n_warm: int = 20_000,
                n_meas: int = 30_000, seed: int = 0, device=None) -> dict:
    """Open-loop churn heatmap over (ON duty cycle x ON-period length):
    every flow ON for ~`mean_on_rtts` intra RTTs at a time, ON a fraction
    `duty` of the time; `duty == 1.0` is the backlogged baseline (flows
    never blink off).  Returns 2-D 'util', 'jain', 'expected_on' (mean
    concurrently ON flows) and 'rates'."""
    dev = resolve_device(device)
    shape = (len(duty_fracs), len(mean_on_rtts))
    scen = _churn_cells(duty_fracs, mean_on_rtts, n_flows=n_flows,
                        rate=rate, intra_rtt=intra_rtt, seed=seed,
                        device=dev)
    _, rates = run_grid(scen, scheme=scheme, n_warm=n_warm, n_meas=n_meas,
                        seed=seed)
    return {
        "duty_fracs": _axis(duty_fracs, dev),
        "mean_on_rtts": _axis(mean_on_rtts, dev),
        "rates": rates.reshape(shape + (n_flows,)),
        "jain": jain(rates).reshape(shape),
        "util": (fleet_sum(rates, dim=1) / rate).reshape(shape),
        "expected_on": torch.full(shape, float(n_flows), device=dev)
        * _axis(duty_fracs, dev).to(torch.float32)[:, None],
    }


def _churn_cells(duty_fracs, mean_on_rtts, *, n_flows: int = 16,
                 rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                 seed: int = 0, device=None) -> list:
    """`churn_sweep`'s cells, duty-major."""
    from repro_torch.scenarios import ChurnSpec, dumbbell_scenario, \
        to_fleetsim
    dev = resolve_device(device)
    scen = []
    for duty in duty_fracs:
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty {duty} not in (0, 1]")
        for on_rtts in mean_on_rtts:
            if duty >= 1.0:
                churn = ChurnSpec(mean_on=float("inf"), mean_off=1.0)
            else:
                mean_on = on_rtts * intra_rtt
                churn = ChurnSpec(mean_on=mean_on,
                                  mean_off=mean_on * (1.0 - duty) / duty)
            scen.append(to_fleetsim(dumbbell_scenario(
                n_flows, 0, rate=rate, intra_rtt=intra_rtt,
                intra_churn=churn, seed=seed), device=dev))
    return scen


def _recovery_outputs(final, rates, shape, n_flows: int, rate: float,
                      loads=None) -> dict:
    """The recovery metrics of a grid's final RelState, reshaped."""
    rs = final.rel
    wire = torch.clamp(fleet_sum(rs.wire_bytes, dim=1), min=1.0)
    util = fleet_sum(rates, dim=1)
    if loads is not None:
        util = util * loads
    return {
        "rates": rates.reshape(shape + (n_flows,)),
        "jain": jain(rates).reshape(shape),
        "util": (util / rate).reshape(shape),
        "retx_ratio": (fleet_sum(rs.rtx_bytes, dim=1) / wire).reshape(shape),
        "rec_ratio": (fleet_sum(rs.rec_bytes, dim=1) / wire).reshape(shape),
        "loss_ratio": (fleet_sum(rs.lost_bytes, dim=1) / wire)
        .reshape(shape),
        "nacks": fleet_sum(rs.nacks, dim=1).reshape(shape),
        "nack_lat": torch.mean(rs.lat_ewma, dim=1).reshape(shape),
    }


def _lossy_dumbbell(n_inter, rate, intra_rtt, inter_rtt, qcap, seed, dev):
    """The recovery / fault sweeps' cell: an inter-DC dumbbell with
    physical RED drops (no phantom), a small `qcap` and drop thresholds
    pushed to the tail, so the queue actually overflows."""
    from repro_torch.scenarios import dumbbell_scenario, to_fleetsim
    return to_fleetsim(dumbbell_scenario(
        0, n_inter, rate=rate, intra_rtt=intra_rtt, inter_rtt=inter_rtt,
        qcap=qcap, phantom=False, red_lo_frac=0.85, red_hi_frac=0.98,
        seed=seed), device=dev)


def recovery_sweep(overloads: Sequence[float],
                   ec_configs: Sequence[tuple],
                   debounce_rtts: Sequence[float], *, n_inter: int = 64,
                   rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                   inter_rtt: float = 2 * L.MS, qcap: float = 64 * 1024,
                   scheme: str = "uno", n_warm: int = 20_000,
                   n_meas: int = 10_000, seed: int = 0, device=None,
                   n_shards: Optional[int] = None, group=None,
                   link_tier=None) -> dict:
    """Loss-recovery heatmap over (overload x EC geometry x NACK
    debounce) on the lossy inter-DC dumbbell, its downlink capacity
    scaled to rate / overload.  `ec_configs` are (k, r) pairs,
    `debounce_rtts` the NACK holdoff in inter RTTs; the NACK batch period
    is a quarter RTT.  Returns (len(overloads), len(ec_configs),
    len(debounce_rtts)) tensors 'util' (goodput / scaled bottleneck
    capacity), 'jain', 'retx_ratio', 'rec_ratio', 'loss_ratio', 'nacks',
    'nack_lat', 'rates', the axes, and 'rel_config', the resolved
    reliability knobs.  `n_shards` / `group` / `link_tier` shard the
    grid's flow axis (`run_grid`; every cell routes alike)."""
    from repro_torch.fleetsim.reliability import make_rel_params
    dev = resolve_device(device)
    base = _lossy_dumbbell(n_inter, rate, intra_rtt, inter_rtt, qcap, seed,
                           dev)
    dt = float(base.net.dt)
    down = base.net.n_links - 1
    period = max(int(round(0.25 * inter_rtt / dt)), 1)
    shape = (len(overloads), len(ec_configs), len(debounce_rtts))
    rels = {}
    for ec in ec_configs:
        for deb in debounce_rtts:
            rels[(tuple(ec), float(deb))] = make_rel_params(
                n_inter, ec=tuple(ec), nack_period=period,
                nack_hold=int(round(deb * inter_rtt / dt)), device=dev)
    scen = []
    for load in overloads:
        if load <= 0:
            raise ValueError(f"overload {load} must be positive")
        scale = torch.ones_like(base.net.cap)
        scale[down] = 1.0 / load
        net = base.net._replace(cap=base.net.cap * scale,
                                drain=base.net.drain * scale)
        for ec in ec_configs:
            for deb in debounce_rtts:
                scen.append((net, base.params, base.is_inter, base.lb,
                             base.churn, rels[(tuple(ec), float(deb))]))
    final, rates = run_grid(scen, scheme=scheme, n_warm=n_warm,
                            n_meas=n_meas, seed=seed, n_shards=n_shards,
                            group=group, link_tier=link_tier)
    loads = torch.repeat_interleave(
        _axis([float(x) for x in overloads], dev),
        len(ec_configs) * len(debounce_rtts))
    rel0 = next(iter(rels.values()))
    return {
        "overloads": _axis(overloads, dev),
        "ec_configs": tuple(tuple(ec) for ec in ec_configs),
        "debounce_rtts": _axis(debounce_rtts, dev),
        **_recovery_outputs(final, rates, shape, n_inter, rate, loads),
        "rel_config": {
            "ec_configs": [list(map(int, ec)) for ec in ec_configs],
            "debounce_rtts": [float(d) for d in debounce_rtts],
            "nack_period_epochs": period,
            "nack_quantum": float(rel0.nack_quantum[0]),
            "loss_md": float(rel0.loss_md[0]),
        },
    }


_FAULT_KINDS = ("down", "brownout", "flap", "burst")


def fault_sweep(fail_times: Sequence[float],
                fault_kinds: Sequence[str],
                ec_policies: Sequence[tuple], *, n_inter: int = 64,
                rate: float = L.RATE_100G, intra_rtt: float = 14 * US,
                inter_rtt: float = 2 * L.MS, qcap: float = 64 * 1024,
                fault_rtts: float = 50.0, brownout_frac: float = 0.4,
                flap_period_rtts: float = 2.0, flap_duty: float = 0.5,
                burst_loss: float = 2e-2, burst_corr: float = 0.3,
                mean_burst_len: float = 3.0, scheme: str = "uno",
                n_warm: int = 20_000, n_meas: int = 10_000, seed: int = 0,
                device=None, n_shards: Optional[int] = None, group=None,
                link_tier=None) -> dict:
    """Fault-response grid over (fail time x fault kind x EC policy) on
    the recovery sweep's dumbbell, with ONE scheduled fault on the
    bottleneck downlink per cell: a `fault_rtts`-RTT window from
    `fail_times[i]` (ns) of a kind from `_FAULT_KINDS` — a hard 'down',
    a 'brownout' to `brownout_frac` capacity, a 'flap' (period
    `flap_period_rtts` RTTs, ON fraction `flap_duty`), or a
    Gilbert-Elliott loss 'burst' (`burst_loss` mean loss, `burst_corr`
    in-burst drop probability, `mean_burst_len` ticks).  A kind uses an
    inert event (a zero-length window) on the axis it does not exercise,
    so every cell has one capacity and one burst event.

    `ec_policies` are EC ladders, tuples of (k, r) rungs (one rung =
    static EC); shorter ladders are padded by repeating their last rung.
    Returns (len(fail_times), len(fault_kinds), len(ec_policies))
    tensors: the recovery_sweep metrics plus 'rung_mean' (mean final
    rung), the axes, and 'fault_config', the resolved fault knobs.
    `n_shards` / `group` / `link_tier` shard the grid's flow axis
    (`run_grid`; every cell routes alike)."""
    dev = resolve_device(device)
    scen, period = _fault_cells(
        fail_times, fault_kinds, ec_policies, n_inter=n_inter, rate=rate,
        intra_rtt=intra_rtt, inter_rtt=inter_rtt, qcap=qcap,
        fault_rtts=fault_rtts, brownout_frac=brownout_frac,
        flap_period_rtts=flap_period_rtts, flap_duty=flap_duty,
        burst_loss=burst_loss, burst_corr=burst_corr,
        mean_burst_len=mean_burst_len, seed=seed, device=dev)
    shape = (len(fail_times), len(fault_kinds), len(ec_policies))
    final, rates = run_grid(scen, scheme=scheme, n_warm=n_warm,
                            n_meas=n_meas, seed=seed, n_shards=n_shards,
                            group=group, link_tier=link_tier)
    return {
        "fail_times": _axis(fail_times, dev),
        "fault_kinds": tuple(fault_kinds),
        "ec_policies": tuple(tuple(tuple(map(int, kr)) for kr in pol)
                             for pol in ec_policies),
        **_recovery_outputs(final, rates, shape, n_inter, rate),
        "rung_mean": torch.mean(final.rel.rung.to(torch.float32), dim=1)
        .reshape(shape),
        "fault_config": {
            "fail_times": [float(t) for t in fail_times],
            "fault_kinds": list(fault_kinds),
            "ec_policies": [[list(map(int, kr)) for kr in pol]
                            for pol in ec_policies],
            "fault_rtts": float(fault_rtts),
            "brownout_frac": float(brownout_frac),
            "flap_period_rtts": float(flap_period_rtts),
            "flap_duty": float(flap_duty),
            "burst_loss": float(burst_loss),
            "burst_corr": float(burst_corr),
            "mean_burst_len": float(mean_burst_len),
            "nack_period_epochs": period,
        },
    }


def _fault_cells(fail_times, fault_kinds, ec_policies, *,
                 n_inter: int = 64, rate: float = L.RATE_100G,
                 intra_rtt: float = 14 * US, inter_rtt: float = 2 * L.MS,
                 qcap: float = 64 * 1024, fault_rtts: float = 50.0,
                 brownout_frac: float = 0.4, flap_period_rtts: float = 2.0,
                 flap_duty: float = 0.5, burst_loss: float = 2e-2,
                 burst_corr: float = 0.3, mean_burst_len: float = 3.0,
                 seed: int = 0, device=None):
    """`fault_sweep`'s cells (fail-time-major, then kind, then policy)
    and its NACK batch period in epochs."""
    from repro_torch.fleetsim.faults import make_schedule
    from repro_torch.fleetsim.reliability import make_rel_params
    for kind in fault_kinds:
        if kind not in _FAULT_KINDS:
            raise ValueError(f"fault kind {kind!r} not in {_FAULT_KINDS}")
    dev = resolve_device(device)
    base = _lossy_dumbbell(n_inter, rate, intra_rtt, inter_rtt, qcap, seed,
                           dev)
    dt = float(base.net.dt)
    down = base.net.n_links - 1
    period = max(int(round(0.25 * inter_rtt / dt)), 1)
    flap_ep = max(int(round(flap_period_rtts * inter_rtt / dt)), 1)
    dur_ep = max(int(round(fault_rtts * inter_rtt / dt)), 1)
    p_bg = 1.0 / max(float(mean_burst_len), 1.0)
    p_gb = min(burst_loss / max(burst_corr * mean_burst_len, 1e-12), 1.0)
    n_rungs = max(len(pol) for pol in ec_policies)
    rels = []
    for pol in ec_policies:
        rungs = [tuple(map(int, kr)) for kr in pol]
        rungs += [rungs[-1]] * (n_rungs - len(rungs))
        rels.append(make_rel_params(n_inter, ladder=tuple(rungs),
                                    nack_period=period, device=dev))
    inert_cap = (down, 0, 0, 1.0, 0, 0.0)       # t1 == t0: never active
    inert_ge = (down, 0, 0, 0.0, 0.0, 0.0, 1.0)
    scen = []
    for t in fail_times:
        e0 = max(int(round(float(t) / dt)), 0)
        e1 = e0 + dur_ep
        for kind in fault_kinds:
            cap_ev, ge_ev = inert_cap, inert_ge
            if kind == "down":
                cap_ev = (down, e0, e1, 0.0, 0, 0.0)
            elif kind == "brownout":
                cap_ev = (down, e0, e1, float(brownout_frac), 0, 0.0)
            elif kind == "flap":
                cap_ev = (down, e0, e1, 0.0, flap_ep, float(flap_duty))
            else:                                # burst
                ge_ev = (down, e0, e1, 0.0, float(burst_corr), p_gb, p_bg)
            fault = make_schedule(cap_events=[cap_ev], ge_events=[ge_ev],
                                  device=dev)
            for rel in rels:
                scen.append((base.net, base.params, base.is_inter,
                             base.lb, base.churn, rel, fault))
    return scen, period
