#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device  — the card's name, count and `nvidia-smi` power limit;
  2. build   — nvcc builds the hand-written kernels from
               src/repro_torch/kernels/csrc for sm_90a;
  3. kernels — every kernel of every path below against its plain
               PyTorch version on the card, at the shapes that path gives
               it (the full-size k=8 fat-tree layout and the multipath
               n_wan=4 dumbbell layout, random rates and link values):
               per-link relative error <= 1e-6 for the scatter (against
               the plain version evaluated in float64), exact min and
               rtol 1e-6 product / sum for the gathers, two runs bitwise
               equal, median CUDA-event time over 25 launches;
  4. main    — the two-DC k=8 fat tree, 100k flows, 8 ECMP paths,
               permutation mix, compiled by the port and run through
               `steady_state(scheme="uno")` on the `pt_cuda` kernels, then
               200 epochs from the shared final state on `pt_cuda`, on
               `cuda` (flat kernels) and on the plain `pt` path;
  5. dumbbells — the 100k-flow dumbbell (1,562 bottlenecks) under uno,
               gemini and dctcp, and its multipath n_wan=4 variant with
               adaptive load balancing, each on the `cuda` kernels and on
               the plain `reference` path.

Every path that phases 4 and 5 drive runs with the launch counts zeroed
just before it and read just after it; each kernel record carries the
count of the path it belongs to (`path`), and a path's kernel that was
never launched in it fails the run.  The comparisons of phase 3 do not
count.  Then a `{"kernels": [...]}` line,
the `nvidia-smi` name/power-limit line, and last the contract line
`{"ok": true, "device": {...}}`.  Any failed check raises and the script
exits non-zero.  Without a CUDA device, or without the port's sources
beside it, it exits non-zero and prints no result.  Full results also go
to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# main path: the paper's two-DC k=8 fat tree at the repo's headline size
FAT_TREE = dict(k=8, n_wan=8, n_flows=100_000, n_paths=8, seed=1)
N_WARM, N_MEAS = 5_000, 1_000
CHECK_EPOCHS = 200          # backend-agreement horizon (chaotic LB beyond)
# dumbbells: the 100k-flow point of the reference's sweep benchmark
DUMBBELL = dict(n_intra=50_000, n_inter=50_000, n_bottleneck=1_562)
DB_WARM, DB_MEAS = 200, 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate
TIMED_LAUNCHES = 25
SCATTER_TOL = 1e-6          # per-link relative, vs the float64 plain sum
GATHER_RTOL = 1e-6          # product and sum; min must be exact
BACKEND_RTOL = 1e-4         # cwnd after CHECK_EPOCHS on two backends

RESULTS: dict = {}
PATHS: dict = {}            # path name -> its launch counts
MAIN_PATH = "fat_tree:steady_state:pt_cuda"
FLAT_PATH = "fat_tree:agree:cuda"
DB_MP_PATH = "dumbbell_mp:uno:cuda"


def emit(phase: str, **fields):
    RESULTS[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing

def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Median device time of `fn()` over n calls, one CUDA-event pair per
    call.  A sleep kernel queued first keeps the card busy while the host
    enqueues the pair, so the host's launch overhead stays out of it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------- phase 3

def _rel_err(got, truth):
    """max over links of |got - truth| / |truth| (links with zero truth
    must be exactly zero)."""
    import torch
    got = got.double()
    nz = truth != 0
    check(bool(torch.all(got[~nz] == 0)), "nonzero load on an unloaded link")
    if not bool(nz.any()):
        return 0.0
    return float(torch.max(torch.abs(got[nz] - truth[nz]) / truth[nz].abs()))


def drive(path: str, fn, plain: bool = False):
    """fn() with every launch count zeroed just before it and read just
    after it into PATHS[path]; a plain path must launch no kernel."""
    import torch
    from repro_torch.kernels import fleet_cuda
    fleet_cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    PATHS[path] = dict(fleet_cuda.LAUNCHES)
    check(not plain or not PATHS[path], f"{path} launched {PATHS[path]}")
    return out


def kernel_phase(net, dev, flat_path, pt_path=None, tag=""):
    """Every kernel that the paths over `net`'s layout launch, against its
    plain version at that layout's shapes; returns the per-kernel records
    (`path`: the run whose launch count a record reports, `counter`: the
    key of that count) and the whole-offered-load errors.  The PathTable
    kernels are checked when `pt_path` is given."""
    import torch
    from repro_torch.fleetsim import links as L
    from repro_torch.kernels import fleet_cuda as K
    from repro_torch.kernels import ref

    lay, pt = net.layout, net.layout.path_table
    routes = L._routes3(net)
    n, p, h = routes.shape
    nl = net.n_links
    g = torch.Generator(device=dev).manual_seed(1234)
    rates = torch.rand(n, device=dev, generator=g) * 12.5
    split = L.normalize_split(torch.rand(n, p, device=dev, generator=g),
                              lay.path_mask)
    sub = rates[:, None] * split
    vals = K.sub_vals_ext(sub)
    scale = 0.05 + 0.95 * torch.rand(nl, device=dev, generator=g)
    clean = 1.0 - 0.05 * torch.rand(nl, device=dev, generator=g)
    delay = 1_000.0 * torch.rand(nl, device=dev, generator=g)
    packed = ref.pack_link_values(scale, clean, delay)
    records = []

    def scatter_record(use, path, replaces, gather, ptr, v_ext, truth):
        name = "link_scatter/" + use + tag
        k = ptr.shape[0] - 2
        live = int(ptr[k])

        def kernel():
            return K.segment_sum(v_ext, gather, ptr, use=use)

        out1, out2 = kernel(), kernel()
        torch.cuda.synchronize()
        plain = ref.csr_segment_sum_ref(v_ext, gather, ptr)
        plain64 = ref.csr_segment_sum_ref(v_ext.double(), gather, ptr)
        rel = _rel_err(out1[:k], plain64[:k])
        rel_truth = _rel_err(out1[:k], truth[:k]) if truth is not None \
            else rel
        check(rel <= SCATTER_TOL and rel_truth <= SCATTER_TOL,
              f"{name}: per-link relative error {rel} / {rel_truth}")
        check(float(out1[k]) == 0.0, f"{name}: scratch slot not 0")
        # library yardstick: one index_add_ over the gathered entries
        keys = torch.repeat_interleave(
            torch.arange(k, device=dev), (ptr[1:k + 1] - ptr[:k]).long(),
            output_size=live)
        gathered = v_ext[gather[:live].long()]
        lib_out = torch.zeros(k + 1, device=dev)
        n_bytes = 4 * (v_ext.numel() + live + ptr.numel() + k + 1)
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fleet_kernels.cu",
            replaces=replaces, launches=0, path=path,
            counter="link_scatter/" + use,
            max_abs_err=float(torch.max(torch.abs(out1 - plain))),
            max_rel_err_f64=rel, bitwise_repeat=bool(torch.equal(out1,
                                                                 out2)),
            ms=time_ms(kernel),
            plain_ms=time_ms(lambda: ref.csr_segment_sum_ref(v_ext, gather,
                                                             ptr)),
            bound_ms=bound_ms(n_bytes), bound_by="bytes",
            library_ms=time_ms(lambda: lib_out.index_add_(0, keys,
                                                          gathered)),
            bytes=n_bytes, entries=live, segments=k))
        check(records[-1]["bitwise_repeat"], f"{name}: runs differ")
        return out1

    # the float64 scatter truth of the whole offered load
    truth_flat = ref.fleet_offered_load_ref(routes, rates.double(),
                                            split.double(), nl)
    scatter_record("flat", flat_path,
                   "src/repro/kernels/fleet_pallas.py:113",
                   lay.sort_sub, lay.link_ptr, vals, truth_flat)
    # the whole cuda offered load against the float64 oracle
    rel = {"cuda": _rel_err(
        K.link_scatter(lay.pad_idx, sub, nl,
                       csr=(lay.sort_sub, lay.link_ptr))[:nl],
        truth_flat[:nl])}
    if pt_path is not None:
        seg = scatter_record("pt_stage1", pt_path,
                             "src/repro/kernels/fleet_pallas.py:244",
                             pt.seg_gather.reshape(-1), pt.seg_ptr, vals,
                             None)
        scatter_record("pt_stage2", pt_path,
                       "src/repro/kernels/fleet_pallas.py:259",
                       pt.lcsr_gather.reshape(-1), pt.llink_ptr, seg, None)
        # the whole pt_cuda offered load against both float64 oracles
        got = K.path_table_scatter(pt, sub)
        truth_pt = ref.fleet_pt_offered_load_ref(
            pt.pre_id, pt.suf_id, pt.seg_idx, rates.double(),
            split.double(), nl)
        rel["pt_cuda"] = max(_rel_err(got[:nl], truth_pt[:nl]),
                             _rel_err(got[:nl], truth_flat[:nl]))
    for b, err in rel.items():
        check(err <= SCATTER_TOL, f"{b} offered load{tag}: {err}")

    def gather_record(use, path, replaces, idx):
        name = "link_gathers/" + use + tag
        def kernel():
            return K.row_gathers(idx, packed, use=use)

        o1, o2 = kernel(), kernel()
        torch.cuda.synchronize()
        plain = ref.row_gathers_ref(idx, packed)
        got = tuple(x.reshape(-1) for x in o1)
        check(torch.equal(got[0], plain[0]), f"{name}: min not exact")
        prod_err = float(torch.max(torch.abs((1 - got[1]) - (1 - plain[1]))
                                   / (1 - plain[1]).abs()))
        sum_err = float(torch.max(torch.abs(got[2] - plain[2])
                                  / plain[2].abs().clamp(min=1e-30)))
        check(prod_err <= GATHER_RTOL and sum_err <= GATHER_RTOL,
              f"{name}: product {prod_err} / sum {sum_err}")
        r, hh = idx.shape
        n_bytes = 4 * r * hh + 16 * packed.shape[0] + 12 * r
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fleet_kernels.cu",
            replaces=replaces, launches=0, path=path,
            counter="link_gathers/" + use,
            max_abs_err=max(float(torch.max(torch.abs(a.reshape(-1) - b)))
                            for a, b in zip(o1, plain)),
            prod_rel_err=prod_err, sum_rel_err=sum_err,
            bitwise_repeat=all(torch.equal(a, b) for a, b in zip(o1, o2)),
            ms=time_ms(kernel),
            plain_ms=time_ms(lambda: ref.row_gathers_ref(idx, packed)),
            bound_ms=bound_ms(n_bytes), bound_by="bytes", library_ms=None,
            bytes=n_bytes, rows=r, hops=hh))
        check(records[-1]["bitwise_repeat"], f"{name}: runs differ")

    gather_record("flat", flat_path,
                  "src/repro/kernels/fleet_pallas.py:205",
                  lay.pad_idx.reshape(n * p, h))
    flat_oracle = ref.fleet_link_gathers_ref(routes, scale, clean, delay)
    composed = [("cuda", K.link_gathers(lay.pad_idx, scale, clean, delay),
                 [flat_oracle])]
    if pt_path is not None:
        gather_record("pt_segments", pt_path,
                      "src/repro/kernels/fleet_pallas.py:278", pt.seg_idx)
        composed.append((
            "pt_cuda", K.path_table_gathers(pt, scale, clean, delay),
            [ref.fleet_pt_gathers_ref(pt.pre_id, pt.suf_id, pt.seg_idx,
                                      scale, clean, delay), flat_oracle]))
    # the per-subflow results of each backend against its oracles
    for b, outs, oracles in composed:
        for want3 in oracles:
            for got, want in zip(outs, want3):
                err = float(torch.max(torch.abs(got - want)))
                check(err <= 1e-6 * max(1.0, float(want.abs().max())),
                      f"{b} gathers{tag} vs oracle: {err}")
    return records, {f"{b}_offered_load_rel_err{tag}": e
                     for b, e in rel.items()}


# ------------------------------------------------------------- phase 4/5

def _check_state(state, goodput, n, what):
    import torch
    check(tuple(goodput.shape) == (n,), f"{what}: goodput shape")
    check(bool(torch.isfinite(goodput).all()), f"{what}: goodput finite")
    for f, v in state._asdict().items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            ok = torch.isfinite(v) if f != "win_delay_min" else ~torch.isnan(v)
            check(bool(ok.all()), f"{what}: state.{f} finite")
    rows = state.split.sum(dim=1)
    err = float(torch.max(torch.abs(rows - 1.0)))
    check(err <= 1e-5, f"{what}: split rows sum to 1 ({err})")
    return err


def _backend_agreement(fs, state, backends, epochs):
    """cwnd and mean goodput after `epochs` from one shared state on each
    backend, relative to the first backend; each backend's run is the
    path `fat_tree:agree:<backend>`."""
    import torch
    from repro_torch.fleetsim import simulate
    out = {}
    for b in backends:
        s, traj = drive(f"fat_tree:agree:{b}", lambda: simulate(
            fs.net, fs.params, n_epochs=epochs, state0=state,
            is_inter=fs.is_inter, lb=fs.lb, backend=b, record=True),
            plain=not b.endswith("cuda"))
        out[b] = (s.cwnd, traj.mean(dim=0))
    cw0, gp0 = out[backends[0]]
    errs = {}
    for b, (cw, gp) in out.items():
        errs[b] = dict(
            cwnd=float(torch.max(torch.abs(cw - cw0) / cw0.abs())),
            goodput=float(torch.max(torch.abs(gp - gp0))
                          / gp0.abs().max().clamp(min=1e-30)))
        check(max(errs[b].values()) <= BACKEND_RTOL,
              f"{b} vs {backends[0]}: {errs[b]}")
    return errs


def profile_step(fs, state, n: int = 20):
    """Device kernels per epoch, device busy time and idle share of the
    eager step, from a torch.profiler trace of n epochs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fleetsim import make_step
    step = make_step(fs.net, fs.params, "uno", fs.is_inter, lb=fs.lb)
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(t for t, _ in by_name.values())
    n_kernels = sum(c for _, c in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(
        epochs=n, wall_ms_per_epoch=wall / n * 1e3,
        device_kernels_per_epoch=n_kernels / n,
        device_busy_ms_per_epoch=(busy_us / n / 1e3) if n_kernels else None,
        device_idle_share=(1.0 - busy_us / 1e6 / wall) if n_kernels
        else None,
        top_kernels_us_per_epoch={k[:60]: t / n for k, (t, _) in top})


def main_path(fs, dev, spec_s, compile_s, card):
    import torch
    from repro_torch.fleetsim import jain, links as L, steady_state
    n = fs.net.routes.shape[0]
    backend = L._resolve_backend(fs.net, "auto")
    check(backend == "pt_cuda", f"auto resolved to {backend}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, goodput = drive(MAIN_PATH, lambda: steady_state(
        fs.net, fs.params, n_warm=N_WARM, n_meas=N_MEAS, scheme="uno",
        is_inter=fs.is_inter, lb=fs.lb))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    epochs = N_WARM + N_MEAS
    per_epoch = {k: v / epochs for k, v in PATHS[MAIN_PATH].items()}
    split_err = _check_state(state, goodput, n, "fat tree")
    errs = _backend_agreement(fs, state, ["pt_cuda", "cuda", "pt"],
                              CHECK_EPOCHS)
    prof = profile_step(fs, state)
    emit("main", scenario="fat_tree_k8_permutation", **FAT_TREE, **card,
         n_links=fs.net.n_links, max_hops=int(fs.net.routes.shape[2]),
         n_segments=fs.net.layout.path_table.n_segments,
         backend=backend, n_warm=N_WARM, n_meas=N_MEAS,
         spec_build_s=spec_s, compile_s=compile_s, run_s=wall,
         ms_per_epoch=wall / epochs * 1e3,
         flow_epochs_per_s=n * epochs / wall,
         jain=float(jain(goodput)),
         goodput_sum_bytes_per_ns=float(goodput.double().sum()),
         peak_mem_bytes=peak, split_row_err=split_err,
         rel_err_vs_pt_cuda=errs, launches_per_epoch=per_epoch,
         launches={k: v for k, v in PATHS.items()
                   if k.startswith("fat_tree:")}, profile=prof)


def dumbbell_fs(multipath: bool, dev):
    from repro_torch.scenarios import dumbbell_scenario, to_fleetsim
    kw = dict(DUMBBELL, n_wan=4) if multipath else dict(DUMBBELL)
    spec = dumbbell_scenario(kw.pop("n_intra"), kw.pop("n_inter"),
                             multipath=multipath, **kw)
    return to_fleetsim(spec, device=dev)


def dumbbells(dev, card, fs_mp):
    """The four dumbbell runs; each (scheme, backend) run is the path
    `dumbbell[_mp]:<scheme>:<backend>`.  `fs_mp`: the multipath scenario,
    already compiled for phase 3."""
    import torch
    from repro_torch.fleetsim import steady_state
    runs = [("uno", False), ("gemini", False), ("dctcp", False),
            ("uno", True)]
    out = []
    for scheme, multipath in runs:
        fs = fs_mp if multipath else dumbbell_fs(False, dev)
        n = fs.net.routes.shape[0]
        name = "dumbbell_mp" if multipath else "dumbbell"
        res = {}
        for backend in ("cuda", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, goodput = drive(
                f"{name}:{scheme}:{backend}", lambda: steady_state(
                    fs.net, fs.params, n_warm=DB_WARM, n_meas=DB_MEAS,
                    scheme=scheme, is_inter=fs.is_inter, lb=fs.lb,
                    backend=backend), plain=backend == "reference")
            res[backend] = (state, goodput, time.perf_counter() - t0)
            _check_state(state, goodput, n, f"dumbbell {scheme}")
        (s_k, g_k, t_k), (s_p, g_p, _) = res["cuda"], res["reference"]
        cw = float(torch.max(torch.abs(s_k.cwnd - s_p.cwnd)
                             / s_p.cwnd.abs()))
        gp = float(torch.max(torch.abs(g_k - g_p))
                   / g_p.abs().max().clamp(min=1e-30))
        check(cw <= BACKEND_RTOL and gp <= BACKEND_RTOL,
              f"dumbbell {scheme} mp={multipath}: cuda vs reference "
              f"cwnd {cw} goodput {gp}")
        epochs = DB_WARM + DB_MEAS
        out.append(dict(scheme=scheme, multipath=multipath, n_flows=n,
                        n_links=fs.net.n_links, epochs=epochs,
                        ms_per_epoch=t_k / epochs * 1e3,
                        launches=PATHS[f"{name}:{scheme}:cuda"],
                        cwnd_rel_err_vs_reference=cw,
                        goodput_rel_err_vs_reference=gp))
    emit("dumbbells", **card, runs=out)


# ------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.scenarios import fat_tree_spec, to_fleetsim

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    build.load()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.BUILD_INFO.get("seconds"),
         library=str(build.library_path().relative_to(ROOT)),
         ptxas=build.BUILD_INFO.get("ptxas", ""))

    t0 = time.perf_counter()
    spec = fat_tree_spec(**FAT_TREE)
    spec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fs = to_fleetsim(spec, device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0

    fs_mp = dumbbell_fs(True, dev)
    records, extra = kernel_phase(fs.net, dev, FLAT_PATH, MAIN_PATH)
    db_records, db_extra = kernel_phase(fs_mp.net, dev, DB_MP_PATH,
                                        tag="@dumbbell_mp")
    records += db_records
    emit("kernels", records=records, **extra, **db_extra)

    card = dict(device=kind, nvidia_smi=smi)
    main_path(fs, dev, spec_s, compile_s, card)
    dumbbells(dev, card, fs_mp)
    for rec in records:
        rec["launches"] = PATHS[rec["path"]].get(rec["counter"], 0)
        check(rec["launches"] > 0, f"{rec['name']} never launched on its "
              f"path {rec['path']}")
    RESULTS["launches"] = PATHS
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(RESULTS, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
