#!/usr/bin/env python3
"""Time the fleet link -> flow gathers (K2: `link_gathers`, and TPU row
5's whole function `path_table_gathers`) and the UnoRC dequant (K5,
`dequant_int8`, plain and fused with an addend) of one checkout at every
use the port's paths give them, so that two checkouts can be compared on
one card.

    python3 tools/gathers_ab.py --tree PATH --label NAME

PATH is the root of a checkout (its ``src/`` is imported; default: this
one).  Run it once per checkout on one card, in turns (parent, change,
change, parent): it prints one JSON line per use and writes them to
chiprun_out/gathers_ab_<label>.json.  Each time is the median device time
of 25 wrapper calls behind a sleep kernel (CUDA events, L2 warm): the
public wrapper as a caller sees it, its own allocations and any torch
work around the kernel included, so a checkout that composes a function
in torch around a kernel is timed with that composition.  Each use also
carries the device kernels and device time per call from a
`torch.profiler` trace of 20 calls.  The shapes are the ones
chip_smoke.py checks: the k=8 fat tree at 100k flows (flat and
PathTable), the multipath n_wan=4 dumbbell (flat), shard 0 of that fat
tree on 2 shards (flat and PathTable), shard 0 of the 3-DC ring on 3
shards (PathTable), and one p = 2 chunk of smollm-135m's gradient for K5
(beside `torch.mul`, which computes K5's plain function).  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

FAT_TREE = dict(k=8, n_wan=8, n_flows=100_000, n_paths=8, seed=1)
DUMBBELL = dict(n_intra=50_000, n_inter=50_000, n_bottleneck=1_562,
                n_wan=4)
MULTI_DC = dict(k=4, n_dc=3, mesh="ring", n_flows=60_000, n_paths=4,
                seed=1)
UNO_ARCH = "smollm-135m"


def time_ms(fn, n: int = 25) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def call_profile(fn, n: int = 20) -> dict:
    """Device kernels and device µs per call, in all and by kernel name,
    from a profiler trace of n calls between two sleep kernels (not
    counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        for _ in range(n):
            fn()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "spin_kernel" not in e.name]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                + e.time_range.elapsed_us() / n)
    return dict(device_kernels_per_call=len(kernels) / n,
                device_us_per_call=sum(by_name.values()),
                device_us_by_kernel=by_name)


def fleet_uses(dev):
    """(name, pad_idx or None, path table or None, n_links) of every K2
    use."""
    from repro_torch.fleetsim import shard as SH
    from repro_torch.scenarios import (dumbbell_scenario, fat_tree_spec,
                                       multi_dc_spec, to_fleetsim)
    fs = to_fleetsim(fat_tree_spec(**FAT_TREE), device=dev)
    lay = fs.net.layout
    kw = dict(DUMBBELL)
    db = to_fleetsim(dumbbell_scenario(kw.pop("n_intra"), kw.pop("n_inter"),
                                       multipath=True, **kw), device=dev).net
    sf = SH.shard_scenario(fs.net, fs.params, n_shards=2, exchange="psum",
                           is_inter=fs.is_inter, lb=fs.lb,
                           link_tier=fs.link_tier, link_dc=fs.link_dc,
                           seed=fs.seed)
    s2 = sf.shard_net(0)
    fs3 = to_fleetsim(multi_dc_spec(**MULTI_DC), device=dev)
    sf3 = SH.shard_scenario(fs3.net, fs3.params, n_shards=3, exchange="nbr",
                            is_inter=fs3.is_inter, lb=fs3.lb,
                            link_tier=fs3.link_tier, link_dc=fs3.link_dc,
                            seed=fs3.seed)
    s3 = sf3.shard_net(0)
    return [
        ("link_gathers/flat", lay.pad_idx, None, fs.net.n_links),
        ("path_table_gathers", None, lay.path_table, fs.net.n_links),
        ("link_gathers/flat@dumbbell_mp", db.layout.pad_idx, None,
         db.n_links),
        ("link_gathers/flat@fat_tree:shard2", s2.layout.pad_idx, None,
         s2.n_links),
        ("path_table_gathers@fat_tree:shard2", None, s2.layout.path_table,
         s2.n_links),
        ("path_table_gathers@multi_dc:shard3", None, s3.layout.path_table,
         s3.n_links),
    ]


def uno_chunk(dev):
    """(q, scales, x) of one p = 2 chunk of the sync's flat vector."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import unorc_cuda
    from repro_torch.models import params as P
    run = RunConfig()
    n_params = P.param_count(P.param_defs(get_config(UNO_ARCH)))
    unit = run.uno_chunks * run.uno_ec_data * 256
    c = -(-n_params // unit) * unit // run.uno_chunks
    g = torch.Generator(device=dev).manual_seed(4321)
    x = torch.randn(2, c, device=dev, generator=g) * 1e-3
    q, s = unorc_cuda.quant_int8(x)
    return q, s, x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gathers_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import fleet_cuda as K
    from repro_torch.kernels import unorc_cuda as U
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def emit(**row):
        rows.append(dict(label=args.label, **row))
        print(json.dumps(rows[-1]), flush=True)

    for name, pad_idx, pt, nl in fleet_uses(dev):
        scale = 0.05 + 0.95 * torch.rand(nl, device=dev, generator=g)
        clean = 1.0 - 0.05 * torch.rand(nl, device=dev, generator=g)
        delay = 1_000.0 * torch.rand(nl, device=dev, generator=g)
        if pt is None:
            def call():
                return K.link_gathers(pad_idx, scale, clean, delay)
            emit(name=name, rows=pad_idx.shape[0] * pad_idx.shape[1],
                 hops=pad_idx.shape[2], n_links=nl, ms=time_ms(call),
                 **call_profile(call))
            continue
        shape = dict(subflows=pt.pre_id.numel(), segments=pt.seg_idx.shape[0],
                     hops=pt.seg_idx.shape[1], n_links=nl)

        def call():
            return K.path_table_gathers(pt, scale, clean, delay)
        emit(name=name, ms=time_ms(call), **call_profile(call), **shape)
    q, s, x = uno_chunk(dev)
    qb, sb = q.view(*q.shape[:-1], -1, 256), s[..., None]
    for name, fn, lib in (
            ("dequant_int8", lambda: U.dequant_int8(q, s),
             lambda: torch.mul(qb, sb)),
            ("dequant_int8/acc", lambda: U.dequant_int8(q, s, x), None)):
        emit(name=name, shape=list(q.shape), ms=time_ms(fn),
             library_ms=time_ms(lib) if lib else None)
    out = pathlib.Path("chiprun_out") / f"gathers_ab_{args.label}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
