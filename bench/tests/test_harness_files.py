"""Every file of the benchmark parses, BENCHMARK.json keeps to the
benchmark's contract, and the harness finds each piece by its name."""
from __future__ import annotations

import json
import re

import pytest

from bench.harness import config, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BM = config.benchmark()
CELLS = [w["name"] for w in BM["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"][:1] == ["python3"] and len(BM["command"]) <= 32
    assert all(_line(w) for w in BM["command"])
    for p in BM["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
    assert all(c.startswith(tuple(BM["paths"])) for c in BM["command"][1:])
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert len({(w["config"], w["traffic"]) for w in BM["workloads"]}) == \
        len(BM["workloads"])
    assert {w["config"] for w in BM["workloads"]} == set(names)
    e2e = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in e2e
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    every = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(every) == len(set(every))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = config.load_cell(cell)
    assert c.knobs["config"] == c.entry["config"]
    assert c.knobs["traffic"] == c.entry["traffic"]
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["kind"] in ("single", "grid")
    assert set(c.knobs["limits"]) == {"compile_mismatches", "init_mismatches",
                                      "check_at_missed", "step_off_share"}
    assert c.knobs["limits"]["check_at_missed"] == 0
    assert all(int(e) >= c.knobs["warm_epochs"]
               for e in c.knobs.get("check_at", ()))
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("conf", BM["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(conf):
    data = json.loads((config.ROOT / conf["file"]).read_text())
    assert callable(traffic.topology(data["topology"]))
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert data["precision"] == "float32"
    assert isinstance(data.get("assumed"), dict)


@pytest.mark.parametrize("metric", BM["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_and_silent_without_trace(metric):
    read = config.metric_reader(metric["name"])
    ctx = {"build_s": 1.5, "trace": None, "layout": None}
    got = read(ctx)
    assert got is None or metric["name"] == "build_s"


def test_topologies_found_by_name():
    names = sorted(p.stem for p in (config.BENCH / "topologies").glob("*.py")
                   if p.stem != "__init__")
    assert names == ["dumbbell", "fat_tree"]
    for n in names:
        assert callable(traffic.topology(n))
    with pytest.raises(ValueError):
        traffic.topology("../run")


@pytest.mark.parametrize("work", ["link_scatter", "link_gathers"])
def test_kernel_work_mapping(work):
    m = config.kernel_work(work)
    assert m["kernels"] and set(m["launches"]) == {"flat", "path_table"}
