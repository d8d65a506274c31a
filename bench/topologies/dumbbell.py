"""Topology `dumbbell`: intra- and inter-DC flows through WAN links into
a bottleneck downlink (`bench.harness.spec.dumbbell_scenario`), every
size from the configuration file."""
from __future__ import annotations

from bench.harness.spec import MS, US, Scenario, dumbbell_scenario, lb_spec


def spec(cfg: dict, tr: dict, seed: int) -> Scenario:
    """The configuration's dumbbell; the traffic file adds nothing."""
    return dumbbell_scenario(
        int(cfg["n_intra"]), int(cfg["n_inter"]),
        rate=cfg["rate_gbps"] * 0.125, intra_rtt=cfg["intra_rtt_us"] * US,
        inter_rtt=cfg["inter_rtt_ms"] * MS, qcap=float(cfg["qcap_bytes"]),
        n_wan=int(cfg["n_wan"]), n_bottleneck=int(cfg["n_bottleneck"]),
        phantom=bool(cfg["phantom"]), drain_frac=cfg["drain_frac"],
        cap_bdps=cfg["cap_bdps"], min_frac=cfg["min_frac"],
        max_frac=cfg["max_frac"], red_lo_frac=cfg["red_lo_frac"],
        red_hi_frac=cfg["red_hi_frac"],
        epoch_period_frac=cfg["epoch_period_frac"],
        multipath=bool(cfg["multipath"]),
        inter_lb=lb_spec(cfg["inter_lb"], None) if "inter_lb" in cfg else None,
        seed=seed)
