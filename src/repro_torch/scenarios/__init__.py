"""Declarative scenarios, the fluid compiler (dumbbell, two-DC fat tree,
N-DC fat tree; churn, reliability and faults) and the locality shard
planner."""
from repro_torch.scenarios.compile_fleetsim import (FleetScenario, ShardPlan,
                                                    compile_faults,
                                                    fleet_arrays, plan_shards,
                                                    to_fleetsim)
from repro_torch.scenarios.fat_tree import (TIER_AGG, TIER_CORE, TIER_EDGE,
                                            TIER_WAN, fat_tree_spec,
                                            link_tier_from_name, link_tiers)
from repro_torch.scenarios.multi_dc import (MESHES, MULTI_DC_WORKLOADS,
                                            link_dcs, multi_dc_spec)
from repro_torch.scenarios.spec import (FAULT_KINDS, ChurnSpec, FaultSpec,
                                        FlowGroup, LbSpec, LinkSpec, Path,
                                        PathSet, RelSpec, Scenario,
                                        dumbbell_scenario)
from repro_torch.scenarios.topology import (MultiDCFatTree, TwoDCFatTree,
                                            wan_mesh_pairs)

__all__ = [
    "FleetScenario", "ShardPlan", "compile_faults", "fleet_arrays",
    "plan_shards", "to_fleetsim",
    "TIER_AGG", "TIER_CORE", "TIER_EDGE", "TIER_WAN", "fat_tree_spec",
    "link_tier_from_name", "link_tiers",
    "MESHES", "MULTI_DC_WORKLOADS", "link_dcs", "multi_dc_spec",
    "FAULT_KINDS", "ChurnSpec", "FaultSpec", "FlowGroup", "LbSpec",
    "LinkSpec", "Path", "PathSet", "RelSpec", "Scenario",
    "dumbbell_scenario",
    "MultiDCFatTree", "TwoDCFatTree", "wan_mesh_pairs",
]
