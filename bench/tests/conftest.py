"""Shared fixtures of the benchmark's own tests: tiny overrides of each
cell file (those of the cells that BENCHMARK.json does not list yet too),
so that a whole run fits a CPU test, and the device fixture of the tests
that need the card."""
from __future__ import annotations

import json

import pytest
import torch

from bench.harness import config

TINY = {
    "lossy_dumbbell_100k.fault_sweep128": {
        "config": {"n_inter": 40},
        "traffic": {"axes": [
            {"name": "fail_epoch", "values": [3, 9]},
            {"name": "fault_kind",
             "values": ["down", "brownout", "flap", "burst"]},
            {"name": "ec_policy",
             "values": [[[8, 1]], [[8, 1], [8, 2], [8, 4]]]}]},
        "knobs": {"chunk_epochs": 5, "warm_epochs": 4,
                  "check_at": [5, 10]}},
    "lossy_dumbbell_100k.recovery_sweep64": {
        "config": {"n_inter": 40},
        "traffic": {"axes": [
            {"name": "overload", "values": [1.0, 2.0]},
            {"name": "ec", "values": [[4, 1], [8, 2]]},
            {"name": "nack_debounce_rtts", "values": [0.0, 1.0]}]},
        "knobs": {"chunk_epochs": 5}},
    "fat_tree_k8.permutation_1m": {
        "config": {"k": 4, "n_wan": 4},
        "traffic": {"n_flows": 600},
        "knobs": {"chunk_epochs": 5}},
}




def cell(name: str, overrides: dict = None) -> config.Cell:
    """The cell `name` with its files and `overrides`: through the
    harness where BENCHMARK.json lists it, else from its cell file alone,
    reporting every metric."""
    if any(w["name"] == name for w in config.benchmark()["workloads"]):
        return config.load_cell(name, overrides=overrides)
    ov = overrides or {}

    def files(kind, key):
        with open(config.BENCH / kind / f"{key}.json") as f:
            return json.load(f)
    knobs = dict(files("cells", name), **ov.get("knobs", {}))
    bm = config.benchmark()
    return config.Cell(
        name, dict(name=name, config=knobs["config"],
                   traffic=knobs["traffic"], chips=1),
        dict(files("configs", knobs["config"]), **ov.get("config", {})),
        dict(files("traffic", knobs["traffic"]), **ov.get("traffic", {})),
        knobs, bm["end_to_end"], bm["per_layer"])


def tiny(name: str) -> config.Cell:
    return cell(name, TINY[name])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
