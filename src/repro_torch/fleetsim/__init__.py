"""Fluid-model fleet simulator (steady-state slice of the port)."""
from repro_torch.fleetsim.carry import scenario_from_arrays, state_from_arrays
from repro_torch.fleetsim.cc import (SCHEMES, make_step, simulate,
                                     steady_state, update_split)
from repro_torch.fleetsim.links import (LOAD_BACKENDS, FluidNet, PathTable,
                                        RouteLayout, compute_layout,
                                        compute_path_table, link_epoch,
                                        normalize_split, offered_load,
                                        uniform_split, with_layout)
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams, init_state, make_lb_params,
                                        make_params)
from repro_torch.fleetsim.sweeps import fleet_sum, jain

__all__ = [
    "scenario_from_arrays", "state_from_arrays",
    "SCHEMES", "make_step", "simulate", "steady_state", "update_split",
    "LOAD_BACKENDS", "FluidNet", "PathTable", "RouteLayout",
    "compute_layout", "compute_path_table", "link_epoch", "normalize_split",
    "offered_load", "uniform_split", "with_layout",
    "ChurnParams", "FleetParams", "FleetState", "LbParams", "init_state",
    "make_lb_params", "make_params",
    "fleet_sum", "jain",
]
