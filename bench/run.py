"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell is an entry of `workloads` in BENCHMARK.json; its
configuration, traffic mix, knobs and the readers of its metrics are
files under bench/ found by name (`bench.harness.config`).

A run: the scenario is generated from `--seed` (`bench.harness.traffic`)
and handed to the program (`repro_torch`, `bench.harness.program`), which
compiles it and builds its epoch step; a short warm-up steps it from the
fresh state; `setup_s` is the time from the start of this process to
here.  Then the window steps it in chunks, each ending on a synchronize,
for `--seconds` (`bench.harness.window`); with `--trace 1` one stretch of
it runs under the profiler and the per-layer metrics are read from that
(`bench/metrics`).  After the window the peak device memory is read and
the plain reference (`bench.reference`) judges what the program produced
(`bench.harness.checks`).  The last line of standard output is one JSON
object; the compared numbers and their limits are also the last lines of
standard error.

Exits non-zero, printing no result, when there is no CUDA device or
fewer than the cell asks for, or when `jax`, `jaxlib`, `flax` or the JAX
package `repro` was imported.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
# any kernel cache torch keeps lives at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `repro_torch` is not `repro`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None) -> dict:
    """One run of `cell` (a `config.Cell`) on `device`; returns the result
    dict (its keys in the result line's order) with the check lines."""
    import torch
    from bench.harness import checks as C
    from bench.harness import program as P
    from bench.harness import traffic as TR
    from bench.harness import window as W
    from bench.harness import work
    from bench.harness.config import metric_reader
    from bench.harness.trace import Tracer
    from bench.reference import compile as RC

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_start = T_START if t_start is None else t_start
    kn = cell.knobs

    # ---- set-up: generate, compile, warm up
    t_build = time.perf_counter()
    gen = TR.generate(cell.config, cell.traffic, seed)
    prog = P.build(gen, device)
    sync()
    build_s = time.perf_counter() - t_build
    shapes = work.layout_shapes(prog.net)
    state, first = W.warm_up(prog.step, prog.state0, int(kn["warm_epochs"]),
                             sync)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # ---- the window
    sampler = W.Sampler(int(kn["check_epochs"]), seed,
                        at=kn.get("check_at", ()))
    win = W.run(prog.step, state, seconds=seconds,
                chunk=int(kn["chunk_epochs"]), sampler=sampler, sync=sync,
                epoch0=int(kn["warm_epochs"]),
                tracer=(lambda: Tracer(sync, P.launches, cuda)) if trace
                else None,
                trace_epochs=int(kn["trace_epochs"]))
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules()
    if found:
        return {"forbidden": found}
    failed = C.failed_cells(win.state, gen.n_cells)

    # ---- metrics
    traced = win.trace if win.trace and win.trace["kernels"] else None
    if trace:
        ctx = dict(build_s=build_s, trace=win.trace, layout=shapes)
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rate = gen.n_flows * win.epochs / win.seconds
        values = {"flow_epochs_per_s": rate, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # ---- the check: the reference judges what the program produced
    n_epochs, win_s = win.epochs, win.seconds
    del win, state
    ref = RC.compile_generated(gen, device)
    compile_bad = C.compile_mismatches(prog, ref)
    ref_state0 = RC.init_state(ref)
    init_bad = C.exact_mismatches(P.as_dict(prog.state0), ref_state0)
    # the run's first epoch from the reference's own fresh state, then the
    # named, the drawn and the last window epochs from the program's states
    pairs = [(0, ref_state0, first.after, first.goodput)] + \
        [(k.epoch, P.as_dict(k.before), k.after, k.goodput)
         for k in sampler.checked()]
    worst, where = 0.0, "none"
    for epoch, before, after, goodput in pairs:
        want, want_gp = C.reference_step(ref, before, gen.scheme,
                                         fresh=ref_state0)
        shares = C.step_shares(P.as_dict(after), goodput, want, want_gp)
        leaf = max(shares, key=shares.get)
        if shares[leaf] >= worst:
            worst, where = shares[leaf], f"epoch {epoch} {leaf}"
        del want, want_gp
    lim = kn["limits"]
    missed = sampler.missed()
    numbers = {
        "compile_mismatches": (sum(compile_bad.values()),
                               lim["compile_mismatches"]),
        "init_mismatches": (sum(init_bad.values()), lim["init_mismatches"]),
        "check_at_missed": (len(missed), lim["check_at_missed"]),
        "step_off_share": (worst, lim["step_off_share"]),
    }
    correct = all(v <= l for v, l in numbers.values()) and failed == 0
    lines = [f"check {k}: {v} (limit {l})" for k, (v, l) in numbers.items()]
    lines.insert(0, "check details: compile " + json.dumps(compile_bad)
                 + " init " + json.dumps(init_bad) + f" worst step at {where}"
                 + f" epochs checked {[p[0] for p in pairs]}"
                 + f" named epochs not reached {missed}")

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    if traced:
        dev_info["busy_s"] = traced["busy_s"]
        dev_info["window_s"] = traced["window_s"]
    if cuda:
        dev_info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": gen.n_cells,
              "failed": failed, "metrics": metrics, "device": dev_info}
    if traced:
        result["breakdown"] = traced["breakdown"]
    result["run"] = {"seed": seed, "window_epochs": n_epochs,
                     "window_s": win_s, "build_s": build_s,
                     "flows": gen.n_flows, "layout": shapes}
    result["checks"] = {k: {"value": v, "limit": l}
                        for k, (v, l) in numbers.items()}
    result["_lines"] = lines
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from bench.harness.config import load_cell
    cell = load_cell(args.workload)
    import torch
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s): is_available="
              f"{torch.cuda.is_available()}, count="
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    if "forbidden" in res:
        print("forbidden modules loaded: " + ", ".join(res["forbidden"]),
              file=sys.stderr)
        return 3
    lines = res.pop("_lines")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
