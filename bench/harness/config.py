"""Finding a cell's files by name.

`BENCHMARK.json` at the checkout's root names each cell (`workloads`)
with its configuration and traffic mix.  The harness reads, by those
names alone:

  * `bench/configs/<config>.json` — the deployment (topology, rates,
    queues, controller, precision) and its `reduced` / `assumed` keys;
  * `bench/traffic/<traffic>.json` — the traffic mix's parameters, read
    by the one generator (`bench.harness.traffic`);
  * `bench/topologies/<topology>.py` — the builder of the configuration's
    `topology`, found by the generator;
  * `bench/cells/<cell>.json` — the cell's configuration and traffic
    names, its `why`, its run knobs (epochs a chunk of the window,
    warm-up epochs, epochs the trace covers, epochs drawn for the check,
    epochs the check keeps by number) and the limits of its comparison;
  * `bench/metrics/<metric>.py` — one reader per per-layer metric;
  * `bench/kernel_work/<work>.json` — the kernels that do a unit of work.

A new cell, configuration, traffic mix, topology or metric is new files
and new entries in `BENCHMARK.json`; nothing here changes.  A traffic mix
is data only where the generator already knows its kind and axes
(`bench.harness.traffic`); one that is not needs a change to the
generator.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import NamedTuple

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    entry: dict            # the BENCHMARK.json workload entry
    config: dict
    traffic: dict
    knobs: dict            # bench/cells/<name>.json
    end_to_end: list       # metric entries this cell reports (trace 0)
    per_layer: list        # metric entries this cell reports (trace 1)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT,
              overrides: dict = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; `overrides`
    ({"config": {...}, "traffic": {...}, "knobs": {...}}) replaces keys,
    for tests at small sizes."""
    bm = benchmark(root)
    ov = overrides or {}
    entry = next((w for w in bm["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name!r} is not a workload of BENCHMARK.json")
    knobs = dict(_json(BENCH / "cells" / f"{name}.json"),
                 **ov.get("knobs", {}))
    cfg = dict(_json(BENCH / "configs" / f"{entry['config']}.json"),
               **ov.get("config", {}))
    tr = dict(_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
              **ov.get("traffic", {}))
    return Cell(name, entry, cfg, tr, knobs,
                [m for m in bm["end_to_end"] if _reports(m, name)],
                [m for m in bm["per_layer"] if _reports(m, name)])


def metric_reader(name: str):
    """`read(ctx) -> float | None` of bench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_work(name: str) -> dict:
    return _json(BENCH / "kernel_work" / f"{name}.json")
