"""Carry a compiled scenario and a state across from plain numpy arrays.

`scenario_from_arrays` rebuilds the port's `FleetScenario` from a mapping
of numpy arrays named as the reference's scenario bundles name them:
``net_<FluidNet field>``, ``lay_<RouteLayout field>``,
``lay_pt_<PathTable field>``, ``par_<FleetParams field>``,
``lb_<LbParams field>``, ``churn_<ChurnParams field>``,
``rel_<RelParams field>``, ``fault_<FaultSchedule field>``, ``is_inter``,
``link_tier``, ``link_dc`` and the ``__meta__`` JSON (for the seed).  An
open ``.npz`` bundle of the reference's sweep service therefore loads
unchanged, as does a reference `FleetScenario` flattened with
``np.asarray``.  Keys of fields the port does not hold (the reference
layout's ``lay_hop_mask``, ``lay_sort_link``, ``lay_csr_gather``) are
ignored.

`state_from_arrays` does the same for a `FleetState`, taken mid-run:
``<prefix><field>`` per flat field, the churn key as its two uint32 words
(held as int64 by the port), and the nested carries as
``<prefix>rel_<RelState field>`` and ``<prefix>fault_<FaultCarry
field>``.
"""
from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim.faults import FaultCarry, FaultSchedule
from repro_torch.fleetsim.links import FluidNet, PathTable, RouteLayout
from repro_torch.fleetsim.reliability import RelParams, RelState
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams)

_META_KEY = "__meta__"


def _keys(arrays: Mapping) -> list:
    return list(arrays.files if hasattr(arrays, "files") else arrays.keys())


def _tensor(a, dev) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint32:          # PRNG key words: int64 in the port
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=dev)


def _family(arrays, prefix: str, cls, dev, keys):
    if not any(k.startswith(prefix) for k in keys):
        return None
    vals = {}
    for f in cls._fields:
        k = prefix + f
        if k in keys:
            vals[f] = _tensor(arrays[k], dev)
        elif cls._field_defaults.get(f, 0) is None:
            vals[f] = None
        else:
            raise KeyError(k)
    return cls(**vals)


def scenario_from_arrays(arrays: Mapping, device=None):
    """The port's FleetScenario from reference-named numpy arrays, on
    `device` (default cuda)."""
    # imported here: the scenarios package itself imports fleetsim
    from repro_torch.scenarios.compile_fleetsim import FleetScenario
    dev = resolve_device(device)
    keys = _keys(arrays)
    pt = _family(arrays, "lay_pt_", PathTable, dev, keys)
    lay_keys = [k for k in keys if not k.startswith("lay_pt_")]
    layout = _family(arrays, "lay_", RouteLayout, dev, lay_keys)
    if layout is not None:
        layout = layout._replace(path_table=pt)
    net_fields = {f: torch.as_tensor(np.asarray(arrays["net_" + f]),
                                     device=dev)
                  for f in FluidNet._fields
                  if f != "layout" and "net_" + f in keys}
    net = FluidNet(**net_fields, layout=layout)
    seed = 0
    if _META_KEY in keys:
        seed = int(json.loads(str(np.asarray(arrays[_META_KEY])[()]))
                   .get("seed", 0))
    n = net.routes.shape[0]
    is_inter = torch.as_tensor(np.asarray(arrays["is_inter"]), device=dev) \
        if "is_inter" in keys else \
        torch.zeros(n, dtype=torch.bool, device=dev)
    return FleetScenario(
        net=net, params=_family(arrays, "par_", FleetParams, dev, keys),
        is_inter=is_inter, lb=_family(arrays, "lb_", LbParams, dev, keys),
        churn=_family(arrays, "churn_", ChurnParams, dev, keys), seed=seed,
        link_tier=(np.asarray(arrays["link_tier"])
                   if "link_tier" in keys else None),
        link_dc=(np.asarray(arrays["link_dc"])
                 if "link_dc" in keys else None),
        rel=_family(arrays, "rel_", RelParams, dev, keys),
        fault=_family(arrays, "fault_", FaultSchedule, dev, keys))


def state_from_arrays(arrays: Mapping, device=None,
                      prefix: str = "") -> FleetState:
    """A FleetState from numpy arrays named `<prefix><field>` (nested
    carries `<prefix>rel_*` / `<prefix>fault_*`; absent ones are None)."""
    dev = resolve_device(device)
    keys = _keys(arrays)
    vals = {}
    for f in FleetState._fields:
        k = prefix + f
        if f == "rel":
            vals[f] = _family(arrays, k + "_", RelState, dev, keys)
        elif f == "fault":
            vals[f] = _family(arrays, k + "_", FaultCarry, dev, keys)
        elif f == "key" and k not in keys:
            vals[f] = None
        else:
            vals[f] = _tensor(arrays[k], dev)
    return FleetState(**vals)
