"""The one general generator: a configuration file, a traffic file and a
seed in, the scenario that both the program and the plain reference run
out.

The configuration's `topology` names a module `bench/topologies/<name>.py`
whose `spec(cfg, tr, seed)` builds the base scenario (a new topology is a
new file there).  Two kinds of traffic file (`"kind"`):

  * ``"single"`` — one scenario of the configuration's topology, stepped
    as one net, optionally with churn, reliability and scheduled faults
    from the traffic file (`_dynamics`);
  * ``"grid"`` — a sweep: the configuration's scenario built once, then
    one cell per point of the traffic file's `axes` (their product, the
    first axis slowest), all cells stepped as one batched net.  Cell i is
    seeded `seed + i`.  A cell may differ from the base only in what a
    `CellMod` holds: one link's capacity scale (`overload`), reliability
    knobs (`ec`, `ec_policy`, `nack_debounce_rtts`) and one fault
    (`fail_epoch` x `fault_kind`).  An axis that changes the compiled
    base itself (RTTs, drain, topology) is not one of these: it needs a
    cell compiled on its own, which the harness does not do yet.

The grid's cell arithmetic (fault events, NACK periods, ladder padding)
is a copy of the program's sweep builders (`fleetsim.sweeps`), kept here
because traffic generation is the benchmark's, not the program's: both
sides take the same cells from it.  Plain Python and numpy.
"""
from __future__ import annotations

import importlib
import re
from typing import NamedTuple, Optional, Tuple

import numpy as np

from bench.harness.spec import ChurnSpec, FaultSpec, RelSpec, Scenario

FAULT_KINDS = ("down", "brownout", "flap", "burst")


class CellMod(NamedTuple):
    """What one cell of a grid changes on the base scenario; all None for
    the base itself."""
    cap_scale: Optional[Tuple[Tuple[str, float], ...]] = None  # link, factor
    rel: Optional[dict] = None       # reliability knobs (epochs, rungs)
    cap_events: Optional[tuple] = None   # (link, t0, t1, frac, period, duty)
    ge_events: Optional[tuple] = None    # (link, t0, t1, p_good, p_bad,
    #                                       p_gb, p_bg)


class Generated(NamedTuple):
    base: Scenario
    cells: Tuple[CellMod, ...]       # one per grid cell; (CellMod(),) single
    seeds: Tuple[int, ...]           # one per cell
    scheme: str
    grid: bool

    @property
    def n_cells(self) -> int:
        return len(self.cells)

    @property
    def n_flows(self) -> int:
        """Flows stepped each epoch, over every cell."""
        return self.base.n_flows * len(self.cells)


def _tuples(v):
    """JSON lists as the spec's tuples, nested."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _dynamics(spec: Scenario, tr: dict) -> Scenario:
    """The traffic file's optional dynamics on a single scenario: churn
    per class (`intra_churn` / `inter_churn`: [mean on, mean off] ns),
    reliability on the inter-DC groups (`inter_rel`: RelSpec fields) and
    scheduled faults (`faults`: FaultSpec fields, links by name)."""
    churn = {k: ChurnSpec(*tr[k]) for k in ("intra_churn", "inter_churn")
             if k in tr}
    rel = None
    if "inter_rel" in tr:
        rel = RelSpec(**{k: _tuples(v) for k, v in tr["inter_rel"].items()})
    groups = tuple(g._replace(
        churn=churn.get("inter_churn" if g.inter else "intra_churn",
                        g.churn),
        rel=rel if rel is not None and g.inter else g.rel)
        for g in spec.groups)
    return spec._replace(groups=groups, faults=spec.faults + tuple(
        FaultSpec(**f) for f in tr.get("faults", ())))


_TOPOLOGY = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def topology(name: str):
    """`spec(cfg, tr, seed) -> Scenario` of bench/topologies/<name>.py."""
    if not _TOPOLOGY.match(name):
        raise ValueError(f"topology name {name!r}")
    return importlib.import_module(f"bench.topologies.{name}").spec


# ------------------------------------------------------------ grids

def _grid_cells(base: Scenario, tr: dict) -> Tuple[CellMod, ...]:
    """One CellMod per point of the product of `tr["axes"]`."""
    dt = base.dt
    inter_rtt = base.inter_rtt
    names = [a["name"] for a in tr["axes"]]
    values = [a["values"] for a in tr["axes"]]
    rel_kw = tr.get("rel", {})
    period = max(int(round(rel_kw.get("nack_period_rtts", 0.25)
                           * inter_rtt / dt)), 1)
    flt = tr.get("fault", {})
    link = flt.get("link", base.links[-1].name)
    target = tr.get("overload_link", base.links[-1].name)
    cells = []
    for point in np.ndindex(*[len(v) for v in values]):
        ax = {n: values[i][j] for i, (n, j) in enumerate(zip(names, point))}
        cap = None
        if "overload" in ax:
            cap = ((target, 1.0 / float(ax["overload"])),)
        rel = None
        if "ec_policy" in ax or "ec" in ax or "nack_debounce_rtts" in ax:
            rel = dict(nack_period=period)
            if "ec_policy" in ax:
                n_rungs = max(len(p) for p in values[names.index(
                    "ec_policy")])
                rungs = [tuple(map(int, kr)) for kr in ax["ec_policy"]]
                rel["ladder"] = tuple(rungs + [rungs[-1]]
                                      * (n_rungs - len(rungs)))
            if "ec" in ax:
                rel["ec"] = tuple(map(int, ax["ec"]))
            if "nack_debounce_rtts" in ax:
                rel["nack_hold"] = int(round(
                    float(ax["nack_debounce_rtts"]) * inter_rtt / dt))
        cap_ev = ge_ev = None
        if "fault_kind" in ax:
            kind = ax["fault_kind"]
            if kind not in FAULT_KINDS:
                raise ValueError(f"fault kind {kind!r} not in {FAULT_KINDS}")
            li = base.link_index()[link]
            e0 = int(ax["fail_epoch"])
            e1 = e0 + max(int(round(flt["window_rtts"] * inter_rtt / dt)), 1)
            cap_ev = (li, 0, 0, 1.0, 0, 0.0)          # inert: t1 == t0
            ge_ev = (li, 0, 0, 0.0, 0.0, 0.0, 1.0)
            if kind == "down":
                cap_ev = (li, e0, e1, 0.0, 0, 0.0)
            elif kind == "brownout":
                cap_ev = (li, e0, e1, float(flt["brownout_frac"]), 0, 0.0)
            elif kind == "flap":
                cap_ev = (li, e0, e1, 0.0, max(int(round(
                    flt["flap_period_rtts"] * inter_rtt / dt)), 1),
                    float(flt["flap_duty"]))
            else:
                mbl = float(flt["mean_burst_len"])
                p_bg = 1.0 / max(mbl, 1.0)
                p_gb = min(float(flt["burst_loss"])
                           / max(float(flt["burst_corr"]) * mbl, 1e-12), 1.0)
                ge_ev = (li, e0, e1, 0.0, float(flt["burst_corr"]), p_gb,
                         p_bg)
            cap_ev, ge_ev = (cap_ev,), (ge_ev,)
        cells.append(CellMod(cap_scale=cap, rel=rel, cap_events=cap_ev,
                             ge_events=ge_ev))
    return tuple(cells)


def generate(cfg: dict, tr: dict, seed: int) -> Generated:
    """The scenario of configuration `cfg` under traffic `tr`, from
    `seed`."""
    base = topology(cfg["topology"])(cfg, tr, seed)
    grid = tr["kind"] == "grid"
    if not grid:
        base = _dynamics(base, tr)
    cells = _grid_cells(base, tr) if grid else (CellMod(),)
    return Generated(base=base, cells=cells,
                     seeds=tuple(seed + i for i in range(len(cells))),
                     scheme=cfg.get("scheme", "uno"), grid=grid)
