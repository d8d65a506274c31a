"""Declarative scenarios and their two compilers: `to_fleetsim` (the fluid
model: dumbbell, two-DC fat tree, N-DC fat tree; churn, reliability and
faults) with the locality shard planner, and `to_netsim` /
`spawn_backlogged` (the packet simulator, `repro_torch.netsim`).  The
fat-tree path sets come from `netsim.topology`'s sampler.

The fluid compiler's names are imported on first use, so that the specs
and the packet side of this package import no torch (a packet run in a
process of its own starts in a fraction of a second)."""
from repro_torch.scenarios.compile_netsim import (ScenarioNet,
                                                  netsim_recovery_rates,
                                                  netsim_scenario_rates,
                                                  spawn_backlogged,
                                                  to_netsim)
from repro_torch.scenarios.fat_tree import (TIER_AGG, TIER_CORE, TIER_EDGE,
                                            TIER_WAN, fat_tree_spec,
                                            link_tier_from_name, link_tiers)
from repro_torch.scenarios.multi_dc import (MESHES, MULTI_DC_WORKLOADS,
                                            link_dcs, multi_dc_spec)
from repro_torch.scenarios.spec import (FAULT_KINDS, ChurnSpec, FaultSpec,
                                        FlowGroup, LbSpec, LinkSpec, Path,
                                        PathSet, RelSpec, Scenario,
                                        dumbbell_scenario, fingerprint,
                                        spec_fingerprint)
from repro_torch.netsim.topology import (MultiDCFatTree, TwoDCFatTree,
                                        wan_mesh_pairs)

__all__ = [
    "FleetScenario", "ShardPlan", "compile_faults", "fleet_arrays",
    "plan_shards", "to_fleetsim",
    "ScenarioNet", "netsim_recovery_rates", "netsim_scenario_rates",
    "spawn_backlogged", "to_netsim",
    "TIER_AGG", "TIER_CORE", "TIER_EDGE", "TIER_WAN", "fat_tree_spec",
    "link_tier_from_name", "link_tiers",
    "MESHES", "MULTI_DC_WORKLOADS", "link_dcs", "multi_dc_spec",
    "FAULT_KINDS", "ChurnSpec", "FaultSpec", "FlowGroup", "LbSpec",
    "LinkSpec", "Path", "PathSet", "RelSpec", "Scenario",
    "dumbbell_scenario", "fingerprint", "spec_fingerprint",
    "MultiDCFatTree", "TwoDCFatTree", "wan_mesh_pairs",
]

_FLUID = ("FleetScenario", "ShardPlan", "compile_faults", "fleet_arrays",
          "plan_shards", "to_fleetsim")


def __getattr__(name):
    if name in _FLUID:
        from repro_torch.scenarios import compile_fleetsim
        return getattr(compile_fleetsim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
