"""Fluid-model fleet simulator: the steady state on one device, the
dynamics axes (churn on the threefry PRNG of `prng`, the reliability
machine of `reliability`, the fault schedule of `faults`), the
locality-sharded flow axis (`shard`), scenario sweeps, every cell of a
grid stepped as one batched epoch and its flow axis optionally sharded
(`sweeps`), and the persistent sweep service (`service`, its CLI
`sweep_server`)."""
from repro_torch.fleetsim.carry import scenario_from_arrays, state_from_arrays
from repro_torch.fleetsim.cc import (SCHEMES, make_step, make_step_halves,
                                     simulate, steady_state,
                                     steady_state_core, update_split)
from repro_torch.fleetsim.faults import (FaultCarry, FaultSchedule,
                                         apply_modulation, degrade_split,
                                         fault_modulation, init_fault_carry,
                                         make_schedule)
from repro_torch.fleetsim.links import (LOAD_BACKENDS, FluidNet, PathTable,
                                        RouteLayout, compute_layout,
                                        compute_path_table, drop_prob,
                                        dumbbell,
                                        halo_exchange, layout_from_arrays,
                                        layout_to_arrays, link_epoch,
                                        normalize_split, offered_load,
                                        scatter_partial, tile_layout,
                                        uniform_split, with_layout)
from repro_torch.fleetsim.reliability import (RelParams, RelState,
                                              init_rel_state,
                                              make_rel_params,
                                              recovery_split)
from repro_torch.fleetsim.service import (SweepQuery, SweepService,
                                          cached_scenario, load_bundle,
                                          publish_scenario, save_bundle,
                                          scenario_key)
from repro_torch.fleetsim.shard import (ShardedFleet, ShardedStep,
                                        lift_plan, neighbor_halo,
                                        shard_scenario,
                                        steady_state_prepared,
                                        steady_state_sharded)
from repro_torch.fleetsim.state import (ChurnParams, FleetParams, FleetState,
                                        LbParams, init_state,
                                        make_churn_params, make_lb_params,
                                        make_params)
from repro_torch.fleetsim.sweeps import (Grid, churn_sweep, fairness_sweep,
                                         fault_sweep, fleet_sum, jain,
                                         load_mix_sweep, recovery_sweep,
                                         run_grid, run_grid_streamed,
                                         run_stacked, shard_grid,
                                         stack_scenarios)

__all__ = [
    "scenario_from_arrays", "state_from_arrays",
    "SCHEMES", "make_step", "make_step_halves", "simulate", "steady_state",
    "steady_state_core", "update_split",
    "FaultCarry", "FaultSchedule", "apply_modulation", "degrade_split",
    "fault_modulation", "init_fault_carry", "make_schedule",
    "LOAD_BACKENDS", "FluidNet", "PathTable", "RouteLayout",
    "compute_layout", "compute_path_table", "drop_prob", "dumbbell",
    "halo_exchange", "layout_from_arrays", "layout_to_arrays",
    "link_epoch", "normalize_split", "offered_load", "scatter_partial",
    "tile_layout", "uniform_split", "with_layout",
    "RelParams", "RelState", "init_rel_state", "make_rel_params",
    "recovery_split",
    "SweepQuery", "SweepService", "cached_scenario", "load_bundle",
    "publish_scenario", "save_bundle", "scenario_key",
    "ShardedFleet", "ShardedStep", "lift_plan", "neighbor_halo",
    "shard_scenario",
    "steady_state_prepared", "steady_state_sharded",
    "ChurnParams", "FleetParams", "FleetState", "LbParams", "init_state",
    "make_churn_params", "make_lb_params", "make_params",
    "Grid", "churn_sweep", "fairness_sweep", "fault_sweep", "fleet_sum",
    "jain", "load_mix_sweep", "recovery_sweep", "run_grid",
    "run_grid_streamed", "run_stacked", "shard_grid", "stack_scenarios",
]
