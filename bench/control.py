"""Readings that set the limits of a cell's comparison, on the chip.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 --seconds 15 \
        [--faults] [--out chiprun_out/control.json]

For each seed, in one process: the cell's set-up, a window of `--seconds`
at the cell's own size and load (long enough to pass the cell's last
named epoch), then at the run's first epoch and the window epochs that
`bench/run.py` checks (the named ones, the drawn ones and the last):

  * `program` — `step_off_share` of the program's epoch against the
    reference's from the same state (the lower reading);
  * `control` — the same number for the reference itself computed in
    bfloat16 (values in bfloat16, the offered load summed in float32),
    put in the program's place (the upper reading);
  * with `--faults`, the number for faults planted in the program: the
    state returned unchanged (`unchanged`), the second half of the flows
    left unstepped (`half_batch`), and the busiest link's offered load
    doubled where the program produces it (`load_altered`), and in the
    fault layer, the fault's capacity multiplier ignored (`fault_cap_ignored`)
    and its burst loss ignored (`burst_loss_ignored`), each stepped by
    the program from the kept state (no number where the cell has no
    fault schedule).

The benchmark's own runs never run this.  Prints one JSON line a seed and
writes them all to `--out`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _max_share(shares: dict):
    leaf = max(shares, key=shares.get)
    return shares[leaf], leaf


def _half(before: dict, after: dict, n: int) -> dict:
    """`after` with the flows of the second half left as in `before`."""
    out = {}
    for k, v in after.items():
        b = before[k]
        if isinstance(v, dict):
            out[k] = _half(b, v, n)
        elif v is not None and v.dim() and v.shape[0] == n:
            w = v.clone()
            w[n // 2:] = b[n // 2:]
            out[k] = w
        else:
            out[k] = v
    return out


def readings(cell, seed: int, seconds: float, faults: bool, device) -> dict:
    import torch
    from bench.harness import checks as C
    from bench.harness import program as P
    from bench.harness import traffic as TR
    from bench.harness import window as W
    from bench.reference import compile as RC
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kn = cell.knobs
    t0 = time.perf_counter()
    gen = TR.generate(cell.config, cell.traffic, seed)
    prog = P.build(gen, device)
    state, first = W.warm_up(prog.step, prog.state0, int(kn["warm_epochs"]),
                             sync)
    setup = time.perf_counter() - t0
    sampler = W.Sampler(int(kn["check_epochs"]), seed,
                        at=kn.get("check_at", ()))
    win = W.run(prog.step, state, seconds=seconds,
                chunk=int(kn["chunk_epochs"]), sampler=sampler, sync=sync,
                epoch0=int(kn["warm_epochs"]))
    epochs = win.epochs
    del win, state
    t1 = time.perf_counter()
    ref = RC.compile_generated(gen, device)
    r0 = RC.init_state(ref)
    out = dict(seed=seed, setup_s=setup, window_epochs=epochs,
               compile=C.compile_mismatches(prog, ref),
               init=C.exact_mismatches(P.as_dict(prog.state0), r0),
               missed=sampler.missed(), epochs=[])
    pairs = [(0, r0, P.as_dict(prog.state0), first)] + \
        [(k.epoch, P.as_dict(k.before), P.as_dict(k.before), k)
         for k in sampler.checked()]
    n = gen.n_flows
    for epoch, ref_before, prog_before, kept in pairs:
        want, want_gp = C.reference_step(ref, ref_before, gen.scheme,
                                         fresh=r0)
        row = dict(epoch=epoch)
        row["program"] = _max_share(C.step_shares(
            P.as_dict(kept.after), kept.goodput, want, want_gp))
        cb, cg = C.reference_step(ref, ref_before, gen.scheme, fresh=r0,
                                  dtype=torch.bfloat16)
        row["control"] = _max_share(C.step_shares(cb, cg, want, want_gp))
        del cb, cg
        if faults:
            row["unchanged"] = _max_share(C.step_shares(
                prog_before, torch.zeros_like(want_gp), want, want_gp))
            row["half_batch"] = _max_share(C.step_shares(
                _half(prog_before, P.as_dict(kept.after), n),
                kept.goodput, want, want_gp))
            row["load_altered"] = _max_share(C.step_shares(
                *_altered_step(prog, kept.before), want, want_gp))
            if prog.fault is not None:
                for how in ("fault_cap_ignored", "burst_loss_ignored"):
                    row[how] = _max_share(C.step_shares(
                        *_fault_ignored_step(prog, kept.before, how),
                        want, want_gp))
        out["epochs"].append(row)
        del want, want_gp
    out["check_s"] = time.perf_counter() - t1
    for key in ("program", "control", "unchanged", "half_batch",
                "load_altered", "fault_cap_ignored", "burst_loss_ignored"):
        vals = [r[key][0] for r in out["epochs"] if key in r]
        if vals:
            out[key + "_max" if key == "program" else key + "_min"] = \
                max(vals) if key == "program" else min(vals)
    return out


def _altered_step(prog, before):
    """The program's epoch from `before` with the offered load of its
    busiest link doubled where the load is produced."""
    from repro_torch.fleetsim import links as L
    real = L.assemble_load

    def altered(private, tile, n_links):
        load = real(private, tile, n_links).clone()
        j = int(load.argmax())
        load[j] = load[j] * 2.0
        return load
    L.assemble_load = altered
    try:
        after, goodput = prog.step(before)
    finally:
        L.assemble_load = real
    from bench.harness.program import as_dict
    return as_dict(after), goodput


def _fault_ignored_step(prog, before, how):
    """The program's epoch from `before` with the fault layer's capacity
    multiplier (`fault_cap_ignored`) or burst loss (`burst_loss_ignored`)
    dropped where the fault layer produces it."""
    import torch
    from repro_torch.fleetsim import faults as F
    real = F.fault_modulation

    def ignored(fault, carry, n_links):
        cap_scale, p_extra, carry = real(fault, carry, n_links)
        if how == "fault_cap_ignored" and cap_scale is not None:
            cap_scale = torch.ones_like(cap_scale)
        if how == "burst_loss_ignored" and p_extra is not None:
            p_extra = torch.zeros_like(p_extra)
        return cap_scale, p_extra, carry
    F.fault_modulation = ignored
    try:
        after, goodput = prog.step(before)
    finally:
        F.fault_modulation = real
    from bench.harness.program import as_dict
    return as_dict(after), goodput


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from bench.harness.config import load_cell
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for s in args.seeds:
        r = readings(cell, s, args.seconds, args.faults,
                     torch.device("cuda", 0))
        rows.append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(workload=args.workload,
                                        device=torch.cuda.get_device_name(0),
                                        rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
