"""A whole run of each cell at a tiny size on the CPU (the look for a chip
skipped): `correct` true when the program is sound, false with the timed
path broken underneath in each way the cells can break — a step that
returns its state unchanged, half of the flows left unstepped, an
answer (the busiest link's offered load) altered where it is produced,
the fault layer's capacity multiplier ignored, a named epoch the window
never reached — and the exits that print no result."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench import run
from bench.harness import config, program
from bench.tests.conftest import TINY, cell as cell_of, tiny

FAULTS = "lossy_dumbbell_100k.fault_sweep128"


def _run(cell, seed=2 ** 31 + 9, trace=False, c=None):
    c = c or tiny(cell)
    res = run.run_cell(c, seed, 0.5, trace, torch.device("cpu"))
    return res, res.pop("_lines")


def _break(monkeypatch, how):
    real = program.build

    def build(gen, device):
        prog = real(gen, device)
        step, n = prog.step, gen.n_flows

        def unchanged(state):
            _, goodput = step(state)
            return state, goodput

        def half_batch(state):
            new, goodput = step(state)
            fields = {}
            for f, v in new._asdict().items():
                if isinstance(v, torch.Tensor) and v.dim() and \
                        v.shape[0] == n:
                    w = v.clone()
                    w[n // 2:] = getattr(state, f)[n // 2:]
                    fields[f] = w
            return new._replace(**fields), goodput
        return prog._replace(step={"unchanged": unchanged,
                                   "half_batch": half_batch}[how])
    monkeypatch.setattr(program, "build", build)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    res, lines = _run(cell)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"flow_epochs_per_s", "setup_s"}
    axes = TINY[cell]["traffic"].get("axes", [])
    n = 1
    for a in axes:
        n *= len(a["values"])
    assert res["attempted"] == n
    assert lines[-1].startswith("check step_off_share")


@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_broken_step_is_not_correct(cell, how, monkeypatch):
    _break(monkeypatch, how)
    res, _ = _run(cell)
    assert res["correct"] is False
    assert res["checks"]["step_off_share"]["value"] > \
        res["checks"]["step_off_share"]["limit"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_altered_load_is_not_correct(cell, monkeypatch):
    from repro_torch.fleetsim import links as L
    real = L.assemble_load

    def altered(private, tile, n_links):
        load = real(private, tile, n_links).clone()
        j = int(load.argmax())
        load[j] = load[j] * 2.0
        return load
    monkeypatch.setattr(L, "assemble_load", altered)
    res, _ = _run(cell)
    assert res["correct"] is False


def test_named_epochs_are_checked():
    """The cell file's named epochs are among those checked, on every
    seed, besides the drawn ones and the last."""
    for seed in (1, 2 ** 31 + 77):
        res, lines = _run(FAULTS, seed=seed)
        assert res["correct"] is True
        checked = lines[0].split("epochs checked ")[1].split("]")[0]
        got = {int(e) for e in checked.strip("[").split(",")}
        assert {0, 5, 10} <= got
        assert res["checks"]["check_at_missed"]["value"] == 0


def test_fault_capacity_ignored_is_not_correct(monkeypatch):
    """The fault layer's capacity multiplier dropped where it is produced
    (downs, brownouts and flaps then never bite): caught at the named
    epochs inside the fault windows."""
    from repro_torch.fleetsim import faults as F
    real = F.fault_modulation

    def ignored(fault, carry, n_links):
        cap_scale, p_extra, carry = real(fault, carry, n_links)
        return torch.ones_like(cap_scale), p_extra, carry
    monkeypatch.setattr(F, "fault_modulation", ignored)
    c = cell_of(FAULTS, dict(TINY[FAULTS], knobs=dict(
        TINY[FAULTS]["knobs"], check_epochs=0)))
    res, _ = _run(FAULTS, c=c)
    assert res["correct"] is False


def test_named_epoch_not_reached_is_not_correct():
    c = cell_of(FAULTS, dict(TINY[FAULTS], knobs=dict(
        TINY[FAULTS]["knobs"], check_at=[5, 10 ** 7])))
    res, _ = _run(FAULTS, c=c)
    assert res["checks"]["check_at_missed"]["value"] == 1
    assert res["correct"] is False


def test_traced_run_on_the_cpu_reads_no_device_metric():
    res, _ = _run("fat_tree_k8.permutation_1m", trace=True)
    assert set(res["metrics"]) == {"build_s"}
    assert "busy_s" not in res["device"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", FAULTS, "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=config.ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ has no program
    to run: the run fails before it prints anything."""
    shutil.copy(config.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(config.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, json, torch; sys.path.insert(0, '.')\n"
            "from bench import run\n"
            "from bench.harness.config import load_cell\n"
            "from bench.tests.conftest import TINY\n"
            f"c = load_cell({FAULTS!r}, overrides=TINY[{FAULTS!r}])\n"
            "print(json.dumps(run.run_cell(c, 1, 0.2, False, "
            "torch.device('cpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_result_line_is_json():
    res, _ = _run(FAULTS)
    line = json.dumps(res)
    assert json.loads(line)["device"]["count"] == 1


def test_fat_tree_with_churn_reliability_and_faults():
    """Churn on both classes, the EC ladder on the inter-DC flows, a WAN
    link down and a burst on another, from the traffic file alone (the
    dynamics axes chip_smoke runs on the fat tree): program and reference
    agree, so such a cell is data only."""
    ov = {**TINY["fat_tree_k8.permutation_1m"],
          "traffic": {"n_flows": 600,
                      "intra_churn": [700000.0, 700000.0],
                      "inter_churn": [1.0e7, 1.0e7],
                      "inter_rel": {"ladder": [[8, 1], [8, 2], [8, 4]],
                                    "ladder_up": [0.008, 0.05, 1.0],
                                    "ladder_down": [0.0, 0.004, 0.025]},
                      "faults": [{"link": "B0->B1.0", "kind": "down",
                                  "t_start": 28000.0, "t_end": 840000.0},
                                 {"link": "B0->B1.1", "kind": "burst",
                                  "loss_rate": 0.02, "burst": 0.3}]}}
    c = cell_of("fat_tree_k8.permutation_1m", ov)
    res = run.run_cell(c, 6, 0.5, False, torch.device("cpu"))
    res.pop("_lines")
    assert res["correct"] is True, res["checks"]
