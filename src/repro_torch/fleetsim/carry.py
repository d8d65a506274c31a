"""Carry a compiled scenario and a state across from plain numpy arrays.

`scenario_from_arrays` rebuilds the port's `FleetScenario` from a mapping
of numpy arrays named as the reference's scenario bundles name them:
``net_<FluidNet field>``, ``lay_<RouteLayout field>``,
``lay_pt_<PathTable field>``, ``par_<FleetParams field>``,
``lb_<LbParams field>``, ``churn_<ChurnParams field>``, ``is_inter``,
``link_tier``, ``link_dc`` and the ``__meta__`` JSON (for the seed).  An
open ``.npz`` bundle of the reference's sweep service therefore loads
unchanged, as does a reference `FleetScenario` flattened with
``np.asarray``.
`state_from_arrays` does the same for a `FleetState`, one array per field.
Keys of fields the port does not hold (the reference layout's
``lay_hop_mask``, ``lay_sort_link``, ``lay_csr_gather``) are ignored;
families of slices not ported yet (``rel_*``, ``fault_*``) raise.
"""
from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim.links import FluidNet, PathTable, RouteLayout
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams)

_META_KEY = "__meta__"


def _keys(arrays: Mapping) -> list:
    return list(arrays.files if hasattr(arrays, "files") else arrays.keys())


def _family(arrays, prefix: str, cls, dev, keys):
    if not any(k.startswith(prefix) for k in keys):
        return None
    vals = {}
    for f in cls._fields:
        k = prefix + f
        if k in keys:
            vals[f] = torch.as_tensor(np.array(arrays[k]), device=dev)
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
    for prefix in ("rel_", "fault_"):
        if any(k.startswith(prefix) for k in keys):
            raise NotImplementedError(
                f"{prefix.rstrip('_')} arrays belong to a slice not ported")
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
                 if "link_dc" in keys else None))


def state_from_arrays(arrays: Mapping, device=None,
                      prefix: str = "") -> FleetState:
    """A FleetState from numpy arrays named `<prefix><field>`.  The PRNG
    key is dropped (churn is not ported); rel / fault arrays raise."""
    dev = resolve_device(device)
    keys = _keys(arrays)
    vals = {}
    for f in FleetState._fields:
        k = prefix + f
        if f in ("key", "rel", "fault"):
            if f != "key" and any(x.startswith(k) for x in keys):
                raise NotImplementedError(f"{f} carry is not ported yet")
            vals[f] = None
            continue
        vals[f] = torch.as_tensor(np.array(arrays[k]), device=dev)
    return FleetState(**vals)
