"""The benchmark's two-DC fat-tree derate grid (`fat_tree_k8.wan_derate16`)
at a small size on the CPU, held against the plain reference
(`bench/reference`: plain torch, no JAX) at the cell's own limits.

The configuration is cut to k=4 with 4 WAN links and the grid to 3 of its
16 cells (B0->B1.0 at 16/16, 4/16 and 1/16 of line rate) of 1,000 flows,
built as the benchmark builds it (`bench.harness.traffic.generate`,
`bench.harness.program.build`):

  * the grid's layout is tiled from the base's, PathTable kept, and the
    step resolves to the PathTable backend;
  * the compiled scenario and the fresh state equal the reference's
    (`compile_mismatches`, `init_mismatches` 0), the derated cells' link
    capacity and drain scaled;
  * each of 20 epochs, stepped by the program from its own state, is the
    reference's epoch from that state within `step_off_share`;
  * at a lighter load (128 flows a cell) a step that marks on the
    physical queue instead of the phantom fails `step_off_share`;
  * a whole run of the cell (`bench/run.py`'s `run_cell`, in a process
    that has not loaded JAX) is correct.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from bench import run
from bench.harness import checks as C
from bench.harness import config
from bench.harness import program as P
from bench.harness import traffic as TR
from bench.reference import compile as RC
from repro_torch.fleetsim import make_step, sweeps

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "fat_tree_k8.wan_derate16"
SMALL = {"config": {"k": 4, "n_wan": 4},
         "traffic": {"n_flows": 1000, "axes": [
             {"name": "overload", "values": [1.0, 4.0, 16.0]}]},
         "knobs": {"chunk_epochs": 5, "warm_epochs": 4, "check_at": [6, 12]}}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    return config.load_cell(CELL, overrides=SMALL)


def test_cell_files_are_the_derate_grid():
    full = config.load_cell(CELL)
    axis = full.traffic["axes"]
    assert len(axis) == 1 and axis[0]["name"] == "overload"
    assert [1.0 / v for v in axis[0]["values"]] == \
        [j / 16 for j in range(16, 0, -1)]
    assert full.traffic["n_flows"] == 500_000
    assert full.traffic["overload_link"] == "B0->B1.0"
    assert full.entry["chips"] == 1


def test_small_grid_held_against_the_reference():
    c = _cell()
    lim = c.knobs["limits"]
    gen = TR.generate(c.config, c.traffic, 2 ** 31 + 5)
    tiled = sweeps.LAYOUTS["tiled"]
    prog = P.build(gen, CPU)
    assert sweeps.LAYOUTS["tiled"] == tiled + 1
    assert prog.backend == "pt" and prog.net.layout.path_table is not None
    ref = RC.compile_generated(gen, CPU)
    assert sum(C.compile_mismatches(prog, ref).values()) <= \
        lim["compile_mismatches"]
    # the derated link at 1, 1/4 and 1/16 of its rate in cells 0, 1, 2
    wan = gen.base.link_index()["B0->B1.0"]
    nl = len(gen.base.links)
    cap = ref["net"]["cap"]
    assert [float(cap[b * nl + wan] / cap[wan]) for b in range(3)] == \
        [1.0, 0.25, 0.0625]
    ref0 = RC.init_state(ref)
    assert sum(C.exact_mismatches(P.as_dict(prog.state0), ref0).values()) \
        <= lim["init_mismatches"]
    state, worst = prog.state0, 0.0
    for _ in range(20):
        before = P.as_dict(state)
        state, goodput = prog.step(state)
        want, want_gp = C.reference_step(ref, before, gen.scheme,
                                         fresh=ref0)
        shares = C.step_shares(P.as_dict(state), goodput, want, want_gp)
        worst = max(worst, max(shares.values()))
    assert worst <= lim["step_off_share"]
    assert C.failed_cells(state, gen.n_cells) == 0


def test_physical_marking_fails_the_step_check_at_a_light_load():
    """At 4 flows a host the paths mark below their maximum and the
    phantom and physical queues part, so a step that marks on the
    physical queue is off the reference's by more than `step_off_share`
    allows, while the program's own step stays within it.  (At the
    cell's ~1,950 flows a host every queue saturates and only the
    compiled `use_phantom` flag tells the two apart.)"""
    c = config.load_cell(CELL, overrides={
        "config": SMALL["config"],
        "traffic": dict(SMALL["traffic"], n_flows=128)})
    lim = c.knobs["limits"]["step_off_share"]
    gen = TR.generate(c.config, c.traffic, 2 ** 31 + 77)
    prog = P.build(gen, CPU)
    ref = RC.compile_generated(gen, CPU)
    ref0 = RC.init_state(ref)
    net = prog.net._replace(use_phantom=torch.zeros_like(
        prog.net.use_phantom))
    bad = make_step(net, prog.params, gen.scheme, prog.is_inter,
                    lb=prog.lb, churn=prog.churn, rel=prog.rel,
                    fault=prog.fault)
    state, bad_worst, good_worst, parted = prog.state0, 0.0, 0.0, 0
    for epoch in range(401):
        if epoch in (350, 400):
            before = P.as_dict(state)
            want, want_gp = C.reference_step(ref, before, gen.scheme,
                                             fresh=ref0)
            off = [max(C.step_shares(P.as_dict(new), gp, want,
                                     want_gp).values())
                   for new, gp in (bad(state), prog.step(state))]
            bad_worst = max(bad_worst, off[0])
            good_worst = max(good_worst, off[1])
            parted += int(((state.q_phys > 0) !=
                           (state.q_phantom > 0)).sum())
        state, _ = prog.step(state)
    assert parted > 0
    assert good_worst <= lim
    assert bad_worst > lim


def test_small_grid_whole_run_is_correct():
    """`bench/run.py`'s `run_cell` in a process of its own: the run
    refuses to report from a process that has loaded JAX, which this
    suite's other files do."""
    code = ("import json, sys, torch\n"
            "from bench import run\n"
            "from bench.harness import config\n"
            f"c = config.load_cell({CELL!r}, overrides={SMALL!r})\n"
            "torch.set_num_threads(1)\n"
            "res = run.run_cell(c, 2 ** 31 + 11, 0.5, False, "
            "torch.device('cpu'))\n"
            "print(json.dumps(res))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res.get("_lines")
    assert res["attempted"] == 3 and res["failed"] == 0
    assert res["run"]["layout"]["pt"] is not None
