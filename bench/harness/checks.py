"""The comparison that decides `correct`.

The plain reference (`bench.reference`) compiles the generated scenario
on its own and steps its own epoch; what the program produced is judged
against it in four numbers, each printed with its limit:

  * `compile_mismatches` — elements of the program's compiled net, per-
    flow parameters, LB / churn / reliability knobs and fault schedule
    that differ from the reference's, plus the entries of the program's
    route layout (hop table, by-link CSR, PathTable) that disagree with
    the reference's routes (`bench.reference.layout`).  Exact: limit 0.
  * `init_mismatches` — elements of the program's fresh state that differ
    from the reference's.  Exact: limit 0.
  * `check_at_missed` — epochs the cell file names for the check
    (`check_at`: a fault's first epoch, an epoch inside every fault
    window, the first after a window closes) that the window never
    reached.  Limit 0.
  * `step_off_share` — over the checked epochs (the run's first epoch,
    from the fresh state; the named epochs; epochs of the window drawn
    from the seed; the window's last), the largest share, over the
    state's fields and the goodput, of elements where the program's
    epoch result and the reference's epoch from the same program state
    differ by more than RTOL * |ref| + ATOL * max|ref| of that field
    (integers and flags: exactly).  The simulator's decisions are
    thresholds on float sums, so a field may flip for a few flows whose
    value sits within rounding of a threshold; a share, not a maximum,
    lets those pass and still fails a step that is wrong for a visible
    part of the fleet.  The first epoch of the run is stepped by the
    reference from its OWN fresh state, so the start is held whole.

The reference accumulates the offered load in float64 and rounds once,
so the rounding of the program's own reductions is all the difference a
sound run shows.
"""
from __future__ import annotations

import torch

from bench.reference import layout as RL
from bench.reference import step as RS

RTOL = 1e-4
ATOL = 1e-5
_NET = ("cap", "qcap", "ecn_lo", "ecn_hi", "drain", "vcap", "use_phantom",
        "routes", "dt", "p_loss")


def _leaves(x, prefix=""):
    """(name, tensor) over a nested dict, None skipped."""
    if x is None:
        return
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}{k}." if isinstance(v, dict)
                               else f"{prefix}{k}")
    else:
        yield prefix, x


def exact_mismatches(got, want) -> dict:
    """name -> elements differing (a missing or reshaped leaf counts
    whole) over the leaves of two nested dicts."""
    out = {}
    g = dict(_leaves(got))
    for name, w in _leaves(want):
        v = g.pop(name, None)
        if v is None or tuple(v.shape) != tuple(w.shape) \
                or v.dtype != w.dtype:
            out[name] = int(w.numel())
            continue
        v, w = v.to(w.device), w
        same = (v == w) | (torch.isnan(v) & torch.isnan(w)) \
            if w.is_floating_point() else (v == w)
        n = int((~same).sum())
        if n:
            out[name] = n
    for name, v in g.items():
        out[name] = int(v.numel())
    return out


def compile_mismatches(prog, ref: dict) -> dict:
    """The program's compiled scenario against the reference's."""
    from bench.harness.program import as_dict
    net = {f: getattr(prog.net, f) for f in _NET}
    net["routes"] = net["routes"] if net["routes"].dim() == 3 else \
        net["routes"][:, None, :]
    want_net = dict(ref["net"])
    r = want_net["routes"]
    want_net["routes"] = r if r.dim() == 3 else r[:, None, :]
    out = exact_mismatches(
        dict(net=net, params=as_dict(prog.params), is_inter=prog.is_inter,
             lb=as_dict(prog.lb), churn=as_dict(prog.churn),
             rel=as_dict(prog.rel), fault=as_dict(prog.fault)),
        dict(net=want_net, **{k: ref[k] for k in
                              ("params", "is_inter", "lb", "churn", "rel",
                               "fault")}))
    lay = prog.net.layout
    routes = want_net["routes"].to(lay.pad_idx.device)
    nl = int(ref["net"]["cap"].shape[0])
    n = RL.flat_mismatches(routes, nl, lay.pad_idx, lay.path_mask,
                           lay.sort_sub, lay.link_ptr)
    if n:
        out["layout.flat"] = n
    if lay.path_table is not None:
        n = RL.path_table_mismatches(routes, nl,
                                     as_dict(lay.path_table))
        if n:
            out["layout.path_table"] = n
    return out


def off_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of elements of `got` off `want` (module docstring)."""
    if tuple(got.shape) != tuple(want.shape):
        return 1.0
    if want.numel() == 0:
        return 0.0
    if not want.is_floating_point():
        return float((got != want).float().mean())
    g, w = got.double(), want.double()
    fin = torch.isfinite(w)
    scale = float(w[fin].abs().max()) if bool(fin.any()) else 0.0
    ok = (g == w) | ((g - w).abs() <= RTOL * w.abs() + ATOL * scale)
    return float((~ok).float().mean())


def step_shares(got_state: dict, got_goodput, want_state: dict,
                want_goodput) -> dict:
    """name -> off share over every leaf of an epoch's result."""
    out = {"goodput": off_share(got_goodput, want_goodput)}
    g = dict(_leaves(got_state))
    for name, w in _leaves(want_state):
        v = g.get(name)
        out[name] = 1.0 if v is None else off_share(v, w)
    return out


def to_dtype(x, ft):
    """Every floating leaf of a nested dict cast to `ft`."""
    if isinstance(x, dict):
        return {k: to_dtype(v, ft) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(ft)
    return x


def reference_step(sc: dict, state: dict, scheme: str, fresh=None,
                   dtype=None):
    """The reference's epoch from `state`; `dtype` (bfloat16 for the
    control) casts the scenario and state first and the result back."""
    if dtype is None:
        return RS.step(sc, state, scheme, fresh)
    new, gp = RS.step(to_dtype(sc, dtype), to_dtype(state, dtype), scheme,
                      None if fresh is None else to_dtype(fresh, dtype),
                      acc=torch.float32)
    return to_dtype(new, torch.float32), gp.to(torch.float32)


def failed_cells(state, n_cells: int) -> int:
    """Cells whose state holds a NaN or an infinity (win_delay_min may be
    +inf) or whose split rows do not sum to 1 within 1e-5."""
    from bench.harness.program import as_dict
    bad = torch.zeros(n_cells, dtype=torch.bool, device=state.cwnd.device)
    for name, v in _leaves(as_dict(state)):
        if v.is_floating_point() and v.dim() and v.shape[0] % n_cells == 0:
            ok = ~torch.isnan(v) if name == "win_delay_min" else \
                torch.isfinite(v)
            bad |= ~ok.reshape(n_cells, -1).all(dim=1)
    err = (state.split.sum(dim=1) - 1.0).abs() > 1e-5
    bad |= err.reshape(n_cells, -1).any(dim=1)
    return int(bad.sum())
