#!/usr/bin/env python3
"""Time the UnoRC gradient sync and the host cost of one K3-K5 call of
one checkout, so that two checkouts (K3-K5 called through ctypes from
the wrappers, or as ``torch.ops.repro_torch`` custom ops) can be
compared on one card.

    python3 tools/uno_sync_ab.py --tree PATH --label NAME

PATH is the root of a checkout (its ``src/`` is imported; default: this
one).  Run it once per checkout on one card, in turns (parent, change,
change, parent).  It prints one JSON line and writes it to
chiprun_out/uno_sync_ab_<label>.json:

  * `sync`: `make_uno_grad_sync` over smollm-135m's whole
    134,515,008-parameter bf16 gradient at p = 2 and p = 4, 2 warm-up
    and 10 timed syncs, each to a synchronize on the host clock (the
    median and every time, ms);
  * `dispatch`: the host microseconds of one wrapper call that launches
    its kernel on a tiny operand (one block of 256 values, 8 x 16 bytes
    for K3), the mean of 500 calls (fewer than the launch queue holds)
    behind a sleep kernel that keeps the card busy, so that the host's
    enqueue time is what is measured.

Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

UNO_ARCH = "smollm-135m"
PODS = (2, 4)
N_SYNCS, N_CALLS = 10, 500


def _stacked(cfg, n_pods, dev, seed):
    import torch
    from repro_torch.models import params as P
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves, treedef = P.flatten(P.param_defs(cfg))
    return P.unflatten(treedef, [
        (torch.randn((n_pods, *d.shape), device=dev, generator=g) * 1e-3
         ).to(d.dtype) for d in leaves])


def _host_us(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / N_CALLS * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(pathlib.Path(__file__)
                                          .resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.tree) / "src"))
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core import uno_collectives as U
    from repro_torch.kernels import build, unorc_cuda

    dev = torch.device("cuda")
    build.load("unorc")
    cfg = get_config(UNO_ARCH)
    out = {"label": args.label, "tree": args.tree,
           "device": torch.cuda.get_device_name(0), "sync": {},
           "dispatch": {}}
    for p in PODS:
        stacked = _stacked(cfg, p, dev, seed=100 + p)
        sync = U.make_uno_grad_sync(cfg, RunConfig(), p, device=dev)
        for _ in range(2):
            sync(stacked)
        times = []
        for _ in range(N_SYNCS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync(stacked)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["sync"][f"p{p}"] = dict(ms=statistics.median(times),
                                    ms_all=times)
        del stacked
        torch.cuda.empty_cache()
    x = torch.randn(1, 256, device=dev)
    q, s = unorc_cuda.quant_int8(x)
    rows = torch.randint(0, 256, (8, 16), device=dev, dtype=torch.uint8)
    coeffs = ((1, 2, 3, 4, 5, 6, 7, 8), (8, 7, 6, 5, 4, 3, 2, 1))
    for name, fn in (("quant_int8", lambda: unorc_cuda.quant_int8(x)),
                     ("dequant_int8/acc",
                      lambda: unorc_cuda.dequant_int8(q, s, x)),
                     ("gf_matmul/encode",
                      lambda: unorc_cuda.gf_matmul(rows, coeffs))):
        out["dispatch"][name] = dict(host_us_per_call=_host_us(fn))
    line = json.dumps(out)
    print(line, flush=True)
    dest = pathlib.Path("chiprun_out") / f"uno_sync_ab_{args.label}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
