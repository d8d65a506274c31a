#!/usr/bin/env python3
"""Time the fleet segmented-sum kernels (K1 `segment_sum`, K6
`segment_sum_tiles`) of one checkout at every use the port's paths give
them, so that two checkouts can be compared on one card.

    python3 tools/segsum_ab.py --tree PATH --label NAME

PATH is the root of a checkout (its ``src/`` is imported; default: this
one).  Run it once per checkout on one card, in turns
(parent, change, change, parent): it prints one JSON line per use and
writes them to chiprun_out/segsum_ab_<label>.json.  Each time is the
median device time of 25 wrapper calls behind a sleep kernel (CUDA
events, L2 warm), the wrapper's own outputs and nothing else, beside one
`index_add_` over the same pre-gathered entries.  The CSRs are the ones
chip_smoke.py checks: the k=8 fat tree at 100k flows (flat, PathTable
stages 1 and 2), the multipath n_wan=4 dumbbell (flat), shard 0 of that
fat tree on 2 shards (K6 flat and stage 2, K1 stage 1), and shard 0 of
the 3-DC ring on 3 shards (K1 stage 1, K6 stage 2).  Needs a CUDA device.
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


def uses(dev):
    """(name, gather, ptr, n_boundary or None) of every K1/K6 use."""
    from repro_torch.fleetsim import shard as SH
    from repro_torch.scenarios import (dumbbell_scenario, fat_tree_spec,
                                       multi_dc_spec, to_fleetsim)
    fs = to_fleetsim(fat_tree_spec(**FAT_TREE), device=dev)
    lay, pt = fs.net.layout, fs.net.layout.path_table
    kw = dict(DUMBBELL)
    db = to_fleetsim(dumbbell_scenario(kw.pop("n_intra"), kw.pop("n_inter"),
                                       multipath=True, **kw),
                     device=dev).net.layout
    sf = SH.shard_scenario(fs.net, fs.params, n_shards=2, exchange="psum",
                           is_inter=fs.is_inter, lb=fs.lb,
                           link_tier=fs.link_tier, link_dc=fs.link_dc,
                           seed=fs.seed)
    s2 = sf.shard_net(0).layout
    fs3 = to_fleetsim(multi_dc_spec(**MULTI_DC), device=dev)
    sf3 = SH.shard_scenario(fs3.net, fs3.params, n_shards=3, exchange="nbr",
                            is_inter=fs3.is_inter, lb=fs3.lb,
                            link_tier=fs3.link_tier, link_dc=fs3.link_dc,
                            seed=fs3.seed)
    p3 = sf3.shard_net(0).layout.path_table
    nb2, nb3 = sf.plan.n_boundary, sf3.plan.n_boundary

    def st(t):
        return t.seg_gather.reshape(-1), t.seg_ptr

    def lc(t):
        return t.lcsr_gather.reshape(-1), t.llink_ptr

    return [
        ("link_scatter/flat", lay.sort_sub, lay.link_ptr, None),
        ("link_scatter/pt_stage1", *st(pt), None),
        ("link_scatter/pt_stage2", *lc(pt), None),
        ("link_scatter/flat@dumbbell_mp", db.sort_sub, db.link_ptr, None),
        ("link_scatter_tiles/flat@fat_tree:shard2", s2.sort_sub, s2.link_ptr,
         nb2),
        ("link_scatter/pt_stage1@fat_tree:shard2", *st(s2.path_table), None),
        ("link_scatter_tiles/pt_stage2@fat_tree:shard2", *lc(s2.path_table),
         nb2),
        ("link_scatter/pt_stage1@multi_dc:shard3", *st(p3), None),
        ("link_scatter_tiles/pt_stage2@multi_dc:shard3", *lc(p3), nb3),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("segsum_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve() / "src"))
    from repro_torch.kernels import fleet_cuda as K
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, gather, ptr, nb in uses(dev):
        k = ptr.shape[0] - 2
        live = int(ptr[k])
        vals = torch.rand(int(gather[:live].max()) + 2, device=dev,
                          generator=g)
        if nb is None:
            def call():
                return K.segment_sum(vals, gather, ptr)
        else:
            def call():
                return K.segment_sum_tiles(vals, gather, ptr, nb)
        keys = torch.repeat_interleave(
            torch.arange(k, device=dev), (ptr[1:k + 1] - ptr[:k]).long(),
            output_size=live)
        gathered = vals[gather[:live].long()]
        lib_out = torch.zeros(k + 1, device=dev)
        rows.append(dict(label=args.label, name=name, entries=live,
                         segments=k, ms=time_ms(call),
                         library_ms=time_ms(lambda: lib_out.index_add_(
                             0, keys, gathered))))
        print(json.dumps(rows[-1]), flush=True)
    out = pathlib.Path("chiprun_out") / f"segsum_ab_{args.label}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
