#!/usr/bin/env python3
"""Run the two lifted-grid kernel tests of tests/test_torch_kernels_gpu.py
many times in one process, keeping every failure, to look for a race in
K6 / K1 / the PathTable gathers.

    python3 tools/k6_repeat.py [--runs 200]

The tests are `test_lifted_grid_k6_matches_plain_versions_on_card` (K6
bitwise K1, two runs equal, the boundary tile's last entry 0, within
1e-6 of the float64 sum, bitwise the tiled plain version on integer
values) and `test_lifted_grid_k1_pt_gathers_match_plain_versions_on_card`
(K1 stage 1 and `uno_pt_gathers`).  Shard 0 of the two-cell k=8 fat-tree
grid is built once, as the module fixture does; each run calls both test
functions on it, with the tests' own seeds and bars.  Prints one JSON
line (runs, failures per test, every failure's message and traceback,
the card's name and power limit, seconds) and writes it to
chiprun_out/k6_repeat.json.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ("test_lifted_grid_k6_matches_plain_versions_on_card",
         "test_lifted_grid_k1_pt_gathers_match_plain_versions_on_card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import torch
    if not torch.cuda.is_available():
        print("k6_repeat: no CUDA device", file=sys.stderr)
        return 2
    import test_torch_kernels_gpu as T
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    shard = T.lifted_grid_shard()
    setup_s = time.perf_counter() - t0
    failures = {name: [] for name in TESTS}
    t0 = time.perf_counter()
    for i in range(args.runs):
        for name in TESTS:
            try:
                getattr(T, name)(shard)
            except Exception as e:          # keep every failure
                failures[name].append(dict(
                    run=i, message=repr(e),
                    traceback=traceback.format_exc()[-3000:]))
    torch.cuda.synchronize()
    out = dict(runs=args.runs, nvidia_smi=smi, setup_s=setup_s,
               seconds=time.perf_counter() - t0,
               n_failures={k: len(v) for k, v in failures.items()},
               failures=failures)
    path = ROOT / "chiprun_out" / "k6_repeat.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 1 if any(failures.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
