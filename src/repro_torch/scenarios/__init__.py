"""Declarative scenarios and the fluid compiler (dumbbell and two-DC fat
tree)."""
from repro_torch.scenarios.compile_fleetsim import (FleetScenario,
                                                    fleet_arrays, to_fleetsim)
from repro_torch.scenarios.fat_tree import (TIER_AGG, TIER_CORE, TIER_EDGE,
                                            TIER_WAN, fat_tree_spec,
                                            link_tier_from_name, link_tiers)
from repro_torch.scenarios.spec import (FAULT_KINDS, ChurnSpec, FaultSpec,
                                        FlowGroup, LbSpec, LinkSpec, Path,
                                        PathSet, RelSpec, Scenario,
                                        dumbbell_scenario)
from repro_torch.scenarios.topology import (MultiDCFatTree, TwoDCFatTree,
                                            wan_mesh_pairs)

__all__ = [
    "FleetScenario", "fleet_arrays", "to_fleetsim",
    "TIER_AGG", "TIER_CORE", "TIER_EDGE", "TIER_WAN", "fat_tree_spec",
    "link_tier_from_name", "link_tiers",
    "FAULT_KINDS", "ChurnSpec", "FaultSpec", "FlowGroup", "LbSpec",
    "LinkSpec", "Path", "PathSet", "RelSpec", "Scenario",
    "dumbbell_scenario",
    "MultiDCFatTree", "TwoDCFatTree", "wan_mesh_pairs",
]
