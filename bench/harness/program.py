"""The system under test: the port's fluid fleet simulator
(`repro_torch`), driven through its own entry points.

`build(gen, device)` hands the generated scenario to the program: the spec
converted field for field to the port's spec types and compiled by
`scenarios.to_fleetsim`; a grid's cells built on that one compiled base
from the generator's `CellMod`s (`fleetsim.make_rel_params`,
`fleetsim.make_schedule`, and a link's capacity and drain multiplied by
the cell's scale, as `sweeps.recovery_sweep` does) and stacked by
`fleetsim.stack_scenarios`, as `sweeps.run_stacked` runs a sweep; then
`fleetsim.init_state` and `fleetsim.make_step`, whose
`step(state) -> (state', goodput)` the window calls.  The cells' events
and knobs come from the generator (`bench.harness.traffic`), not from the
program's private sweep builders, which cannot read a traffic file; the
reference checks what the program compiled from them element for element
(`checks.compile_mismatches`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def port_spec(spec):
    """The benchmark's spec as the port's spec types (the same fields)."""
    from repro_torch.scenarios import spec as S

    def group(g):
        return S.FlowGroup(
            g.name, g.n, g.path_sets, inter=g.inter, rtt=g.rtt,
            lb=S.LbSpec(*g.lb),
            churn=None if g.churn is None else S.ChurnSpec(*g.churn),
            rel=None if g.rel is None else S.RelSpec(*g.rel))
    return S.Scenario(
        spec.name, tuple(S.LinkSpec(*l) for l in spec.links),
        tuple(group(g) for g in spec.groups),
        *spec[3:15], faults=tuple(S.FaultSpec(*f) for f in spec.faults))


class Program(NamedTuple):
    step: object             # state -> (state', goodput)
    state0: object           # the fresh FleetState
    net: object              # the compiled FluidNet (layout attached)
    params: object
    is_inter: object
    lb: object
    churn: object
    rel: object
    fault: object
    backend: str             # the link backend the step resolved


def build(gen, device) -> Program:
    from repro_torch.fleetsim import (init_state, make_rel_params,
                                      make_schedule, make_step,
                                      stack_scenarios, uniform_split)
    from repro_torch.fleetsim.links import _resolve_backend
    from repro_torch.scenarios import to_fleetsim
    fs = to_fleetsim(port_spec(gen.base), device=device)
    sc = (fs.net, fs.params, fs.is_inter, fs.lb, fs.churn, fs.rel, fs.fault)
    seed = gen.seeds[0]
    if gen.grid:
        cells = []
        for m in gen.cells:
            net, rel, fault = fs.net, fs.rel, fs.fault
            if m.cap_scale:
                idx = gen.base.link_index()
                scale = torch.ones_like(net.cap)
                for name, f in m.cap_scale:
                    scale[idx[name]] = f
                net = net._replace(cap=net.cap * scale,
                                   drain=net.drain * scale)
            if m.rel is not None:
                rel = make_rel_params(gen.base.n_flows, device=device,
                                      **m.rel)
            if m.cap_events is not None or m.ge_events is not None:
                fault = make_schedule(m.cap_events or (), m.ge_events or (),
                                      device=device)
            cells.append((net, fs.params, fs.is_inter, fs.lb, fs.churn, rel,
                          fault))
        g = stack_scenarios(cells)
        sc = (g.net, g.params, g.is_inter, g.lb, g.churn, g.rel, g.fault)
        seed = list(gen.seeds)
    net, params, is_inter, lb, churn, rel, fault = sc
    state0 = init_state(params, net.n_links, n_paths=net.n_paths,
                        split0=uniform_split(net), seed=seed, rel=rel,
                        fault=fault)
    step = make_step(net, params, gen.scheme, is_inter, lb=lb, churn=churn,
                     rel=rel, fault=fault)
    return Program(step, state0, net, params, is_inter, lb, churn, rel,
                   fault, _resolve_backend(net, "auto"))


def as_dict(x):
    """A NamedTuple of tensors (nested ones too) as plain dicts."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    if hasattr(x, "_asdict"):
        return {k: as_dict(v) for k, v in x._asdict().items()}
    return x


def launches() -> dict:
    """The port's fleet-kernel launch counts so far."""
    from repro_torch.kernels import fleet_cuda
    return dict(fleet_cuda.LAUNCHES)
