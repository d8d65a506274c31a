#!/usr/bin/env python3
"""One `--trace 1` run of a benchmark cell with the port's span recorder
(`repro_torch.trace`) on: where the device time and the idle gaps of the
epoch step go, phase by phase.

    python3 tools/span_trace.py --workload <cell> --seed <n> [--seconds 51]

from the root of a checkout, on a machine with a CUDA card.  The window
is the benchmark's by default, long enough to reach a cell's named
epochs, so that `correct` means what it means in `bench/run.py`.  Prints
`bench/run.py`'s result line with the traced stretch cut by the spans
(`bench.harness.spans.traced_run`): `breakdown.device_by_span` and
`.idle_by_span`, and `spans`, the per-phase device ms an epoch, the
epoch's host ms, the idle share that began outside the program, threefry
calls an epoch, `compile_s`, `first_epoch_s`, the clock's checks and
each span path's [kernels, device ms, host ms, idle ms] an epoch.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from bench.harness.config import load_cell
    from bench.harness.spans import traced_run
    res = traced_run(load_cell(args.workload), args.seed, args.seconds,
                     torch.device("cuda", 0))
    for line in res.pop("_lines", ()):
        print(line, file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
