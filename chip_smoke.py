#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device  — the card's name, count and `nvidia-smi` power limit;
  2. build   — nvcc builds the hand-written kernels from
               src/repro_torch/kernels/csrc for sm_90a, one library per
               source (fleet_kernels.cu, unorc_kernels.cu), in parallel;
  3. kernels — every kernel of every path below against its plain
               PyTorch version on the card, at the shapes that path gives
               it (the full-size k=8 fat-tree layout and the multipath
               n_wan=4 dumbbell layout, random rates and link values):
               per-link relative error <= 1e-6 for the scatter (against
               the plain version evaluated in float64); for the gathers
               (flat K2, and the PathTable function `path_table_gathers`
               in full) exact min and rtol 1e-6 product / sum against the
               plain version and the float64 oracles, bitwise equality
               with the plain version recorded; two runs bitwise equal,
               median CUDA-event time over 25 launches, device kernels
               and device time per call from the profiler, one call under
               `torch.cuda.set_sync_debug_mode("error")` (no host sync);
               each scatter also bitwise equal to its tiled plain version
               (`csr_segment_sum_tiled_ref`) on integer-valued inputs;
               a scatter's time is the wrapper call's (K6's tile pair,
               not concatenated);
  4. main    — the two-DC k=8 fat tree, 100k flows, 8 ECMP paths,
               permutation mix, compiled by the port and run through
               `steady_state(scheme="uno")` on the `pt_cuda` kernels, then
               200 epochs from the shared final state on `pt_cuda`, on
               `cuda` (flat kernels) and on the plain `pt` path;
  5. sharded — the locality-sharded flow axis, shards stepped in
               lock-step on the one card: the phase-4 fat tree on 2 shards
               under the DC-major plan (link tiers + DCs, sender uplinks
               private), 2,000 epochs with the boundary psum and 2,000
               with the neighbor exchange on `pt_cuda` (bitwise equal),
               200 epochs from phase 4's final state on `pt_cuda` and on
               `cuda` held within 1e-4 of the single-device runs, a
               profile of 20 sharded epochs; and the 3-DC ring (k=4, 60k
               flows, 4 paths) on 3 shards with the neighbor exchange,
               1,000 epochs.  Their kernels — K6 (the tiled scatter: flat,
               and PathTable stage 2), K1 stage 1 and K2 at shard 0's
               shapes — against the plain versions as in phase 3, K6 also
               bitwise against K1 on the same CSR;
  6. dumbbells — the 100k-flow dumbbell (1,562 bottlenecks) under uno,
               gemini and dctcp, and its multipath n_wan=4 variant with
               adaptive load balancing, each on the `cuda` kernels and on
               the plain `reference` path;
  7. unorc_kernels — the UnoRC kernels against their plain versions on
               the card at the shapes of one p = 2 chunk of smollm-135m's
               full gradient (2 pods x 16,816,128 f32): K3 encode and
               decode (rows {0, 1} from the survivors), also at the p = 4
               ring's part of a chunk (4 pods x 8 rows x 525,504 bytes,
               `gf_matmul/*@p4`), K4 quant (zero blocks included), K5
               dequant and its fused add, all bitwise, two runs bitwise
               equal, median CUDA-event time over 25 launches, device
               kernels and device time per call from the profiler; K5
               beside `torch.mul` (plain use) and
               `torch.addcmul` (fused use), each a library time only if
               bitwise equal to K5; both K5 uses again at 1, 2, 3, 5 and
               4,099 blocks (the tail of its 4-block warp span), strided
               addend rows; and all 55 erasure patterns of at most two of
               the ten RS(8, 2) rows recovered bitwise;
  8. unorc_sync — `make_uno_grad_sync` over smollm-135m's whole
               134,515,008-parameter bf16 gradient at p = 2 (pairwise)
               and p = 4 (ring), on the kernels and on the plain backend:
               outputs finite with their dtypes and shapes, kernel run
               bitwise equal to the plain run and to a second kernel run,
               p = 2 within the int8 bound of the float64 pod mean, p = 4
               within 5 % of it; ms per sync, payload GB/s, peak memory
               and the DCI byte accounting;
  9. dynamics — (run after phase 6) the churn, reliability and fault
               axes at 100k flows:
               the card's threefry2x32 bitwise against the CPU's on a
               100,003-element draw and against its known answers; the
               phase-6 multipath dumbbell with churn on both classes, the
               adaptive-EC ladder on the inter flows, WAN loss, wan0 down
               from 1 to 3 ms and a burst on wan1, 300 epochs on `cuda`
               against `reference`, then timed from a fresh state in
               chained `simulate` segments before, during and after wan0's
               window (aggregate goodput of each: a transient check, the
               window lies in the start transient); the main path's fat
               tree with the same axes (the first border-to-border WAN
               link down, a burst on the second), 200 epochs `pt_cuda`
               against `pt`, then 300 timed epochs from the `pt_cuda` end
               state and a 20-epoch profile (kernels, busy, idle; the
               epoch's draws alone); and that fat tree on 2 stacked
               shards, the same 300 epochs from the same state held
               within 1e-4 of the timed single-device run with the churn
               masks bitwise equal.  One epoch of each path under
               `torch.cuda.set_sync_debug_mode("error")`; ms/epoch, device
               kernels and threefry2x32 calls per epoch; the fleet
               kernels that phases 3 and 5 held at these layouts must
               each have launched on its dynamics path;
 10. sweeps — (run after phase 9) the scenario sweeps, every cell of a
               grid stepped as one batched epoch: the full-mode fault
               grid of benchmarks/fleetsim_sweep.py:534-573 through
               `fault_sweep` (2 fail times x down / burst x a static and
               an adaptive EC policy, 100k inter flows a cell: 8 cells,
               800k flows, 4,000 + 1,000 epochs; every output finite,
               util > 0; ms/epoch, cell- and flow-epochs/s, device
               kernels, busy and idle per epoch, threefry2x32 calls per
               epoch, peak memory), K1 and K2 flat held at its
               block-diagonal layout as in phase 3 (`…@fault_grid`); the
               same grid over 400 epochs (fail epochs 50 and 200, 143-epoch
               windows) batched and each cell alone through
               `steady_state`, cwnd and rates within 1e-4, fault carries
               bitwise, both timed (`grid_ms_per_epoch`,
               `loop_ms_per_epoch`); and `churn_sweep` at 2 x 100k flows
               (1,000 epochs; two threefry2x32 calls per epoch, the split
               and one draw for every cell), its masks and keys after 200
               epochs bitwise those of each cell alone.

 11. sharded_grid — (run after phase 10) the sharded scenario grid,
               `run_grid(n_shards=2)`: two cells of the main path's fat
               tree, cell 1 its drain what-if (drain x 0.9; the routes
               stay cell 0's), 200,000 flows on 2 stacked shards under
               cell 0's plan lifted to the grid (boundary = 2 x the
               cell's), psum (`run_grid`) and nbr (the same compiled grid
               under the neighbor exchange) on `pt_cuda`, 300 epochs each
               and unsharded; and phase 10's fault grid through
               `fault_sweep(n_shards=2)` (every link boundary: the
               full-buffer exchange, K1 and K2 flat), 400 epochs, and
               unsharded.  Each cell within 1e-5 x the rate scale of the
               unsharded grid, psum and nbr bitwise, fault carries and
               rungs bitwise, split rows summing to 1; ms per grid epoch,
               cell-epochs/s, set-up (`shard_grid`), device kernels, busy
               and idle per epoch, exchange bytes, peak memory, fleet
               kernels per epoch; K1 stage 1, K6 (PathTable stage 2) and
               `pt_gathers` at the fat-tree grid's shard 0, K1 and K2 flat
               at the fault grid's, as in phase 3 (`…@fat_tree_grid:shard2`,
               `…@fault_grid:shard2`);
 12. service — the sweep service (`SweepService`) on a fresh cache
               directory under the temporary directory: cold (the fat
               tree's spec build, compile and bundle publish, and its first
               query, 300 epochs), warm (the query again: 0 layout builds),
               bundle load (a fresh service on the warm directory; the
               arrays bitwise those written), four drain what-ifs as one
               rung-4 batch (its layout built), four other drains (the
               same routes: the layout reused), and a mixed 100k-dumbbell + fat-tree batch
               twice (the second pass: 0 spec builds, 0 layout builds).

Every path that phases 4 to 6 and 8 to 12 drive runs with the launch
counts zeroed just before it and read just after it; each kernel record
carries the count of the path it belongs to (`path`), and a path's
kernel that was never launched in it fails the run.  The comparisons of
phase 3 do not count.  Then a `{"kernels": [...]}` line, the
`nvidia-smi` name/power-limit line, and last the contract line
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
# UnoRC: smollm-135m's full gradient, RunConfig() defaults (8 chunks,
# RS(8, 2), int8 in blocks of 256)
UNO_ARCH = "smollm-135m"
UNO_PODS = (2, 4)
UNO_SYNCS = 10              # timed syncs per pod count, after a warm-up
UNO_P4_RTOL = 0.05          # the reference's own bar for the p = 4 ring
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# sharded flow axis: the main path's fat tree on 2 shards (DC-major plan),
# and the full-mode multi-DC point of benchmarks/fleetsim_sweep.py on 3
SHARD_WARM, SHARD_MEAS = 1_500, 500
SHARD_AB_EPOCHS = 300      # per turn of the psum / nbr A/B timing
MULTI_DC = dict(k=4, n_dc=3, mesh="ring", n_flows=60_000, n_paths=4,
                seed=1)
MDC_WARM, MDC_MEAS = 750, 250
# dynamics: churn (mean on / off, ns), the EC ladder of the reference's
# adaptive-EC fault test, and the fault_sweep defaults for the bursts
DYN_INTRA_CHURN = (50 * 14e3, 50 * 14e3)
DYN_INTER_CHURN = (5 * 2e6, 5 * 2e6)
DYN_LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)),
                  ladder_up=(0.008, 0.05, 1.0),
                  ladder_down=(0.0, 0.004, 0.025))
DYN_DOWN = (1e6, 3e6)        # first WAN link down, ns
DYN_BURST = dict(loss_rate=2e-2, burst=0.3)
DYN_DB_CHECK, DYN_FT_CHECK = 300, 200    # backend-agreement horizons
DYN_FT_TIMED = 300           # timed fat-tree epochs, also the shard check
PRNG_DRAW = 100_003
# sweeps: the full-mode fault grid of benchmarks/fleetsim_sweep.py:534-573
# (2 fail times x 2 kinds x 2 EC policies at 100k inter flows a cell,
# 800k flows in one batched step), its 400-epoch agreement twin, and a
# 2-cell churn grid at 100k flows
SWEEP_FAULT = dict(fault_kinds=("down", "burst"),
                   ec_policies=(((8, 2),), ((8, 1), (8, 2), (8, 4))),
                   fault_rtts=5.0, n_inter=100_000)
SWEEP_WARM, SWEEP_MEAS = 4_000, 1_000
SWEEP_DT = 14_000.0          # the dumbbell's epoch, its intra RTT (ns)
SWEEP_AGREE_FAILS = (50, 200)            # fail epochs
SWEEP_AGREE_RTTS = 1.0                   # 143-epoch fault windows
SWEEP_AGREE_WARM, SWEEP_AGREE_MEAS = 300, 100
SWEEP_CHURN = dict(duty_fracs=(0.3, 1.0), mean_on_rtts=(200.0,),
                   n_flows=100_000)
SWEEP_CHURN_WARM, SWEEP_CHURN_MEAS = 800, 200
SWEEP_CHURN_CHECK = 200      # epochs batched vs alone, masks bitwise
# sharded grid: the main path's fat tree and its drain what-if
# (benchmarks/sweep_server.py:122-126) on 2 stacked shards under cell 0's
# plan lifted to the grid, psum and nbr; the fault grid above through
# fault_sweep(n_shards=2); each against the same grid unsharded over the
# same epochs from the same fresh state
GRID_DRAIN = 0.9
GRID_WARM, GRID_MEAS = 200, 100
SHARD_FAULT_WARM, SHARD_FAULT_MEAS = 300, 100
GRID_RTOL = 1e-5    # x the rate scale: the reference's sharded-grid bar
# service: the main path's fat tree through SweepService on a fresh cache
SVC_WARM, SVC_MEAS = 200, 100
SVC_DRAINS = ((0.8, 0.9, 1.0, 1.1), (0.7, 0.85, 0.95, 1.2))

RESULTS: dict = {}
PATHS: dict = {}            # path name -> its launch counts
DRAWS: dict = {}            # path name -> its threefry2x32 calls
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
    call.  A sleep kernel queued first (a million cycles, ~0.5 ms) keeps
    the card busy while the host enqueues the pair, so the host's launch
    overhead stays out of it."""
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


def bound_ms(n_bytes: int, n_ops: int = 0) -> float:
    """The larger of bytes over the HBM rate and operations over the
    float32 (non-tensor-core) rate, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


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
    after it into PATHS[path] (its threefry2x32 calls, plain torch, into
    DRAWS[path]); a plain path must launch no kernel."""
    import torch
    from repro_torch.fleetsim import prng
    from repro_torch.kernels import fleet_cuda, unorc_cuda
    fleet_cuda.reset_launches()
    unorc_cuda.reset_launches()
    prng.reset_calls()
    out = fn()
    torch.cuda.synchronize()
    PATHS[path] = {**fleet_cuda.LAUNCHES, **unorc_cuda.LAUNCHES}
    DRAWS[path] = prng.CALLS["threefry2x32"]
    check(not plain or not PATHS[path], f"{path} launched {PATHS[path]}")
    return out


def kernel_phase(net, dev, flat_path=None, pt_path=None, tag="", halo=None):
    """Every kernel that the paths over `net`'s layout launch, against its
    plain version at that layout's shapes; returns the per-kernel records
    (`path`: the run whose launch count a record reports, `counter`: the
    key of that count) and the whole-offered-load errors.  The flat
    kernels are checked when `flat_path` is given, the PathTable kernels
    when `pt_path` is.  With `halo` (a shard's boundary count) the flat
    scatter and PathTable stage 2 are K6, the tiled scatter a sharded run
    launches, also held bitwise against K1 on the same CSR."""
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
    records = []

    def scatter_record(use, path, replaces, gather, ptr, v_ext, truth,
                       tiled=False):
        kname = "link_scatter_tiles/" if tiled else "link_scatter/"
        name = kname + use + tag
        k = ptr.shape[0] - 2
        live = int(ptr[k])

        if tiled:
            def call():
                return K.segment_sum_tiles(v_ext, gather, ptr, halo, use=use)

            def kernel():
                return torch.cat(call())

            def plain_fn():
                return ref.csr_segment_sum_tiles_ref(v_ext, gather, ptr,
                                                     halo)
        else:
            def kernel():
                return K.segment_sum(v_ext, gather, ptr, use=use)
            call = kernel

            def plain_fn():
                return ref.csr_segment_sum_ref(v_ext, gather, ptr)

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
        extra = {}
        if tiled:
            k1 = K.segment_sum(v_ext, gather, ptr, use=use)
            extra = dict(n_boundary=halo,
                         bitwise_equal_k1=bool(torch.equal(out1[:k],
                                                           k1[:k])))
            check(extra["bitwise_equal_k1"], f"{name}: differs from K1")
        # the tile edges change nothing: on integer values, where every
        # summation order is exact, bitwise equal to the tiled plain
        # version (and so to the plain sum)
        v_int = torch.randint(0, 16, v_ext.shape, generator=g, device=dev,
                              dtype=torch.int32).float()
        got_int = torch.cat(K.segment_sum_tiles(v_int, gather, ptr, halo,
                                                use=use)) if tiled else \
            K.segment_sum(v_int, gather, ptr, use=use)
        want_int = ref.csr_segment_sum_tiled_ref(v_int, gather, ptr)
        extra["bitwise_equal_tiled_ref"] = bool(
            torch.equal(got_int, want_int) and torch.equal(
                want_int, ref.csr_segment_sum_ref(v_int, gather, ptr)))
        check(extra["bitwise_equal_tiled_ref"],
              f"{name}: differs from the tiled plain version")
        # the wrapper makes no host sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        extra["no_host_sync"] = True
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
            counter=kname + use,
            max_abs_err=float(torch.max(torch.abs(out1 - plain))),
            max_rel_err_f64=rel, bitwise_repeat=bool(torch.equal(out1,
                                                                 out2)),
            ms=time_ms(call), plain_ms=time_ms(plain_fn),
            bound_ms=bound_ms(n_bytes), bound_by="bytes",
            library_ms=time_ms(lambda: lib_out.index_add_(0, keys,
                                                          gathered)),
            bytes=n_bytes, entries=live, segments=k,
            **call_profile(call), tile=ref.SEGSUM_TILE, **extra))
        check(records[-1]["bitwise_repeat"], f"{name}: runs differ")
        return out1

    tiles = "src/repro/kernels/fleet_pallas.py:163"
    # the float64 scatter truth of the whole offered load
    truth_flat = ref.fleet_offered_load_ref(routes, rates.double(),
                                            split.double(), nl)
    if flat_path is not None:
        scatter_record("flat", flat_path,
                       tiles if halo else
                       "src/repro/kernels/fleet_pallas.py:113",
                       lay.sort_sub, lay.link_ptr, vals, truth_flat,
                       tiled=bool(halo))
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
                       tiles if halo else
                       "src/repro/kernels/fleet_pallas.py:259",
                       pt.lcsr_gather.reshape(-1), pt.llink_ptr, seg, None,
                       tiled=bool(halo))
        # the whole pt_cuda offered load against both float64 oracles
        got = K.path_table_scatter(pt, sub)
        truth_pt = ref.fleet_pt_offered_load_ref(
            pt.pre_id, pt.suf_id, pt.seg_idx, rates.double(),
            split.double(), nl)
        rel["pt_cuda"] = max(_rel_err(got[:nl], truth_pt[:nl]),
                             _rel_err(got[:nl], truth_flat[:nl]))
    for b, err in rel.items():
        check(err <= SCATTER_TOL, f"{b} offered load{tag}: {err}")

    vals = (scale, clean, delay)
    vals64 = tuple(v.double() for v in vals)
    flat_oracle = ref.fleet_link_gathers_ref(routes, *vals)
    flat_oracle64 = ref.fleet_link_gathers_ref(routes, *vals64)

    def gather_errs(name, got, want):
        """(product, sum) relative errors of K2's outputs against `want`
        (float32 or float64); the min must be exact."""
        check(torch.equal(got[0].double(), want[0].double()),
              f"{name}: min not exact")
        keep = 1 - want[1].double()
        prod = float(torch.max(torch.abs((1 - got[1].double()) - keep)
                               / keep.abs()))
        tot = float(torch.max(torch.abs(got[2].double() - want[2].double())
                              / want[2].double().abs().clamp(min=1e-30)))
        check(prod <= GATHER_RTOL and tot <= GATHER_RTOL,
              f"{name}: product {prod} / sum {tot}")
        return prod, tot

    def gather_record(counter, path, replaces, kernel, plain_fn, oracles64,
                      n_bytes, **shape):
        name = counter + tag
        o1, o2 = kernel(), kernel()
        torch.cuda.synchronize()
        plain = plain_fn()
        prod_err, sum_err = gather_errs(name, o1, plain)
        errs64 = [gather_errs(f"{name} vs float64 oracle", o1, o)
                  for o in oracles64]
        # the wrapper makes no host sync
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            kernel()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/fleet_kernels.cu",
            replaces=replaces, launches=0, path=path, counter=counter,
            max_abs_err=max(float(torch.max(torch.abs(a - b)))
                            for a, b in zip(o1, plain)),
            prod_rel_err=prod_err, sum_rel_err=sum_err,
            prod_rel_err_f64=max(e[0] for e in errs64),
            sum_rel_err_f64=max(e[1] for e in errs64),
            bitwise_equal_plain=all(torch.equal(a, b)
                                    for a, b in zip(o1, plain)),
            bitwise_repeat=all(torch.equal(a, b) for a, b in zip(o1, o2)),
            no_host_sync=True, ms=time_ms(kernel), plain_ms=time_ms(plain_fn),
            bound_ms=bound_ms(n_bytes), bound_by="bytes", library_ms=None,
            bytes=n_bytes, **call_profile(kernel), **shape))
        check(records[-1]["bitwise_repeat"], f"{name}: runs differ")

    if flat_path is not None:
        gather_record(
            "link_gathers/flat", flat_path,
            "src/repro/kernels/fleet_pallas.py:205",
            lambda: K.link_gathers(lay.pad_idx, *vals),
            lambda: ref.link_gathers_ref(lay.pad_idx, *vals), [flat_oracle64],
            4 * n * p * h + 12 * nl + 12 * n * p, rows=n * p, hops=h)
    composed = [("cuda", K.link_gathers(lay.pad_idx, *vals), [flat_oracle])]
    if pt_path is not None:
        u, hseg = pt.seg_idx.shape
        pt_ids = (pt.pre_id, pt.suf_id, pt.seg_idx)
        gather_record(
            "pt_gathers", pt_path, "src/repro/kernels/fleet_pallas.py:278",
            lambda: K.path_table_gathers(pt, *vals),
            lambda: ref.pt_gathers_ref(*pt_ids, *vals),
            [ref.fleet_pt_gathers_ref(*pt_ids, *vals64), flat_oracle64],
            4 * u * hseg + 12 * nl + 8 * n * p + 12 * n * p,
            subflows=n * p, segments=u, hops=hseg)
        composed.append((
            "pt_cuda", K.path_table_gathers(pt, *vals),
            [ref.fleet_pt_gathers_ref(*pt_ids, *vals), flat_oracle]))
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
        sub = v._asdict().items() if hasattr(v, "_fields") else [("", v)]
        for g, w in sub:      # the nested RelState / FaultCarry too
            if isinstance(w, torch.Tensor) and w.is_floating_point():
                ok = torch.isfinite(w) if f != "win_delay_min" else \
                    ~torch.isnan(w)
                check(bool(ok.all()), f"{what}: state.{f}{g} finite")
    rows = state.split.sum(dim=1)
    err = float(torch.max(torch.abs(rows - 1.0)))
    check(err <= 1e-5, f"{what}: split rows sum to 1 ({err})")
    return err


def _backend_agreement(fs, state, backends, epochs):
    """cwnd and mean goodput after `epochs` from one shared state on each
    backend, relative to the first backend; each backend's run is the
    path `fat_tree:agree:<backend>`.  Returns the errors and each
    backend's (cwnd, mean goodput)."""
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
        errs[b] = _agreement_errs(cw, gp, cw0, gp0)
        check(max(errs[b].values()) <= BACKEND_RTOL,
              f"{b} vs {backends[0]}: {errs[b]}")
    return errs, out


def _agreement_errs(cw, gp, cw0, gp0):
    import torch
    return dict(cwnd=float(torch.max(torch.abs(cw - cw0) / cw0.abs())),
                goodput=float(torch.max(torch.abs(gp - gp0))
                              / gp0.abs().max().clamp(min=1e-30)))


def device_profile(fn, n: int) -> dict:
    """Device kernels per call, device busy time and idle share of `fn`,
    from a torch.profiler trace of n calls (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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
        calls=n, wall_ms_per_call=wall / n * 1e3,
        device_kernels_per_call=n_kernels / n,
        device_busy_ms_per_call=(busy_us / n / 1e3) if n_kernels else None,
        device_idle_share=(1.0 - busy_us / 1e6 / wall) if n_kernels
        else None,
        top_kernels_us_per_call={k[:60]: t / n for k, (t, _) in top})


def call_profile(fn, n: int = 20) -> dict:
    """Device kernels and device time per call of `fn`, from a
    torch.profiler trace of n calls (after one warm-up call).  Sleep
    kernels open and close the trace and are not counted: the profiler
    can miss the first and last events of a short session.  It can also
    drop launches in the middle (device_kernels_per_call then falls
    short of the function's kernel count, and device_us_per_call with
    it), so the mean time of the kernels it did record is kept too."""
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
    total = sum(e.time_range.elapsed_us() for e in kernels)
    return dict(device_kernels_per_call=len(kernels) / n,
                device_us_per_call=total / n,
                device_us_per_kernel=total / len(kernels) if kernels
                else None)


def profile_step(fs, state, n: int = 20):
    """`device_profile` of the eager fat-tree step, per epoch."""
    from repro_torch.fleetsim import make_step
    step = make_step(fs.net, fs.params, "uno", fs.is_inter, lb=fs.lb)
    box = [state]

    def one():
        box[0], _ = step(box[0])

    for _ in range(2):
        one()
    return device_profile(one, n)


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
    errs, single = _backend_agreement(fs, state, ["pt_cuda", "cuda", "pt"],
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
    return state, single


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


# ------------------------------------------------------------- phase 6

def shard_path(scenario: str, n_shards: int, exchange: str,
               backend: str) -> str:
    return f"{scenario}:shard{n_shards}:{exchange}:{backend}"


def _sharded_run(path, sf, n, epochs, **kw):
    """One sharded steady-state run as the path `path`: checked, timed."""
    import torch
    from repro_torch.fleetsim import shard as SH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, goodput = drive(path,
                           lambda: SH.steady_state_prepared(sf, **kw))
    wall = time.perf_counter() - t0
    split_err = _check_state(state, goodput, n, path)
    return state, goodput, dict(
        epochs=epochs, run_s=wall, ms_per_epoch=wall / epochs * 1e3,
        flow_epochs_per_s=n * epochs / wall, split_row_err=split_err,
        launches_per_epoch={k: v / epochs for k, v in PATHS[path].items()})


def _exchange_bytes(sf) -> dict:
    """Per-epoch payload of the boundary exchange, per shard: the psum's
    boundary tile, the neighbor exchange's two sends, and the full
    (n_links + 1,) buffer an unsharded-layout psum would carry."""
    b = sf.plan.n_boundary
    out = dict(psum_bytes_per_shard=4 * b,
               full_buffer_bytes_per_shard=4 * (sf.net.n_links + 1))
    if sf.nbr is not None:
        out["nbr_bytes_per_shard"] = 4 * 2 * int(sf.nbr.shape[2])
    return out


def sharded_phase(fs, dev, card, state, single):
    """The locality-sharded flow axis on the one card, shards stepped in
    lock-step: the main path's fat tree on 2 shards (psum and neighbor
    exchange on `pt_cuda`, 200 epochs on the flat `cuda` kernels) and the
    3-DC ring on 3 shards; their kernels (K6, and K1 / K2 at the shards'
    shapes) against the plain versions.  `state` / `single`: the main
    path's final state and the single-device runs from it."""
    import torch
    from repro_torch.fleetsim import links as L
    from repro_torch.fleetsim import shard as SH
    from repro_torch.scenarios import multi_dc_spec, to_fleetsim

    n = fs.net.routes.shape[0]
    kw = dict(is_inter=fs.is_inter, lb=fs.lb, link_tier=fs.link_tier,
              link_dc=fs.link_dc, seed=fs.seed)
    t0 = time.perf_counter()
    sf = {"psum": SH.shard_scenario(fs.net, fs.params, n_shards=2,
                                    exchange="psum", **kw)}
    sf["nbr"] = SH._with_exchange(sf["psum"], "nbr")
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    plan = sf["psum"].plan
    backend = L._resolve_backend(sf["psum"].shard_net(0), "auto")
    check(backend == "pt_cuda", f"sharded fat tree: auto is {backend}")
    pt_paths = [shard_path("fat_tree", 2, ex, "pt_cuda")
                for ex in ("psum", "nbr")]
    flat = shard_path("fat_tree", 2, "psum", "cuda")
    records, errs = kernel_phase(sf["psum"].shard_net(0), dev, flat,
                                 pt_paths[0], tag="@fat_tree:shard2",
                                 halo=plan.n_boundary)
    records += [dict(r, path=pt_paths[1]) for r in records
                if r["path"] == pt_paths[0]]

    runs, outs = {}, {}
    for ex, path in zip(("psum", "nbr"), pt_paths):
        st, gp, runs[path] = _sharded_run(
            path, sf[ex], n, SHARD_WARM + SHARD_MEAS, n_warm=SHARD_WARM,
            n_meas=SHARD_MEAS, backend="pt_cuda")
        outs[ex] = (st, gp)
    (st_p, gp_p), (st_n, gp_n) = outs["psum"], outs["nbr"]
    bitwise = torch.equal(gp_p, gp_n) and all(
        torch.equal(v, getattr(st_n, f))
        for f, v in st_p._asdict().items() if v is not None)
    check(bitwise, "fat tree: psum and nbr exchanges differ")
    del outs, st_p, st_n

    # from the main path's final state: the sharded runs against the
    # single-device runs of the same kernels
    agree = {}
    for b, path in (("pt_cuda", "fat_tree:shard2:agree:pt_cuda"),
                    ("cuda", flat)):
        st, gp, runs[path] = _sharded_run(
            path, sf["psum"], n, CHECK_EPOCHS, n_warm=0,
            n_meas=CHECK_EPOCHS, backend=b, state0=state)
        agree[b] = _agreement_errs(st.cwnd, gp, *single[b])
        check(max(agree[b].values()) <= BACKEND_RTOL,
              f"sharded {b} vs single-device {b}: {agree[b]}")

    runner = SH.ShardedStep(sf["psum"], backend="pt_cuda")
    box = [runner.split(SH.permute_in(sf["psum"], state))]

    def one():
        box[0], _ = runner.step(box[0])

    prof = device_profile(one, 20)
    del box, runner
    # the two exchanges timed in turns within this call (psum, nbr, nbr,
    # psum), from the main path's final state
    ab = []
    for ex in ("psum", "nbr", "nbr", "psum"):
        runner = SH.ShardedStep(sf[ex], backend="pt_cuda")
        states = runner.split(SH.permute_in(sf[ex], state))
        for _ in range(5):
            states, _ = runner.step(states)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARD_AB_EPOCHS):
            states, _ = runner.step(states)
        torch.cuda.synchronize()
        ab.append([ex, (time.perf_counter() - t0) / SHARD_AB_EPOCHS * 1e3])
    del runner, states

    t0 = time.perf_counter()
    fs3 = to_fleetsim(multi_dc_spec(**MULTI_DC), device=dev)
    sf3 = SH.shard_scenario(fs3.net, fs3.params, n_shards=3, exchange="nbr",
                            is_inter=fs3.is_inter, lb=fs3.lb,
                            link_tier=fs3.link_tier, link_dc=fs3.link_dc,
                            seed=fs3.seed)
    torch.cuda.synchronize()
    mdc_s = time.perf_counter() - t0
    b3 = L._resolve_backend(sf3.shard_net(0), "auto")
    path3 = shard_path("multi_dc", 3, "nbr", b3)
    recs3, errs3 = kernel_phase(
        sf3.shard_net(0), dev, path3 if b3 == "cuda" else None,
        path3 if b3 == "pt_cuda" else None, tag="@multi_dc:shard3",
        halo=sf3.plan.n_boundary)
    records += recs3
    n3 = fs3.net.routes.shape[0]
    _, _, runs[path3] = _sharded_run(path3, sf3, n3, MDC_WARM + MDC_MEAS,
                                     n_warm=MDC_WARM, n_meas=MDC_MEAS)
    main = RESULTS["main"]
    emit("sharded", **card, single_device_ms_per_epoch=main["ms_per_epoch"],
         single_device_flow_epochs_per_s=main["flow_epochs_per_s"],
         fat_tree=dict(
             **FAT_TREE, n_shards=2, plan="link_tier + link_dc, "
             "sender_private", n_links=plan.n_links,
             n_boundary=plan.n_boundary,
             real_flows_per_shard=[int(v) for v in
                                   (plan.gather < plan.n_real).sum(1)],
             nbr_width=int(sf["nbr"].nbr.shape[2]), backend=backend,
             shard_scenario_s=shard_s, **_exchange_bytes(sf["nbr"]),
             psum_nbr_bitwise_equal=bitwise, rel_err_vs_single=agree,
             exchange_ab_ms_per_epoch=ab, profile=prof, **errs),
         multi_dc=dict(
             **MULTI_DC, n_shards=3, n_links=sf3.net.n_links,
             n_boundary=sf3.plan.n_boundary,
             real_flows_per_shard=[int(v) for v in (sf3.plan.gather
                                                    < sf3.plan.n_real).sum(1)],
             nbr_width=int(sf3.nbr.shape[2]), auto_backend=b3,
             build_s=mdc_s, **_exchange_bytes(sf3), **errs3),
         runs=runs, records=records)
    return records, plan


# ------------------------------------------------------------- phase 9

def dynamics_specs():
    """The dumbbell and fat-tree specs of the dynamics paths: phase 6's
    multipath dumbbell and the main path's fat tree with churn on both
    classes, the EC ladder on the inter flows, the first WAN link down
    over DYN_DOWN and a burst on the second (the border-to-border links,
    in spec order, on the fat tree)."""
    from repro_torch.scenarios import (ChurnSpec, FaultSpec, RelSpec,
                                       dumbbell_scenario, fat_tree_spec)
    churn = dict(intra_churn=ChurnSpec(*DYN_INTRA_CHURN),
                 inter_churn=ChurnSpec(*DYN_INTER_CHURN))
    rel = RelSpec(**DYN_LADDER)

    def faults(down, burst):
        return (FaultSpec(down, "down", t_start=DYN_DOWN[0],
                          t_end=DYN_DOWN[1]),
                FaultSpec(burst, "burst", **DYN_BURST))

    kw = dict(DUMBBELL)
    db = dumbbell_scenario(kw.pop("n_intra"), kw.pop("n_inter"),
                           multipath=True, n_wan=4, wan_p_loss=1e-3,
                           inter_rel=rel, faults=faults("wan0", "wan1"),
                           **churn, **kw)
    ft = fat_tree_spec(**FAT_TREE, **churn)
    wan = [l.name for l in ft.links if l.wan]
    check(all(n.startswith("B") and "->B" in n for n in wan[:2]),
          f"fat tree WAN links {wan[:2]}")
    ft = ft._replace(groups=tuple(g._replace(rel=rel) if g.inter else g
                                  for g in ft.groups),
                     faults=faults(wan[0], wan[1])).validate()
    return db, ft


def _axes(fs) -> dict:
    return dict(is_inter=fs.is_inter, lb=fs.lb, churn=fs.churn, rel=fs.rel,
                fault=fs.fault, seed=fs.seed)


def prng_phase(dev) -> dict:
    """threefry2x32 on the card: its known answers, and the draws of a
    few seeds' second split keys (PRNG_DRAW floats each, the churn draw's
    size) bitwise equal to the CPU's; ms and device kernels of one draw."""
    import torch
    from repro_torch.fleetsim import prng
    m = 0xFFFFFFFF

    def cipher(k, x):
        t = [torch.tensor(v, dtype=torch.int64, device=dev)
             for v in (k, [x[0]], [x[1]])]
        return tuple(int(w) for w in prng.threefry2x32(*t))

    check(cipher((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3))
          == (0xc4923a9c, 0x483df7a0), "threefry test vector 1")
    check(cipher((0, 0), (0, 0)) == (0x6b200159, 0x99ba4efe),
          "threefry test vector 0")
    check(cipher((m, m), (m, m)) == (0x1cb996fc, 0xbb002be7),
          "threefry test vector ones")
    k0 = prng.PRNGKey(0, dev)
    check(prng.split(k0).tolist() == [[1797259609, 2579123966],
                                      [928981903, 3453687069]], "split")
    check(prng.fold_in(k0, 0xFA).tolist() == [2774691040, 2925814535],
          "fold_in")
    u4 = prng.uniform(prng.split(k0)[1], (4,)).cpu()
    want4 = torch.tensor([0.00729382, 0.02089119, 0.5814265, 0.36183798])
    check(bool(torch.allclose(u4, want4, rtol=1e-6, atol=0.0)), "uniform")
    seeds = (0, 1, 2 ** 31 - 1, 2 ** 32 + 5, 2 ** 63 - 1)
    for seed in seeds:
        subs = [prng.split(prng.PRNGKey(seed, d))[1] for d in (dev, "cpu")]
        draws = [prng.uniform(k, (PRNG_DRAW,)).cpu() for k in subs]
        check(torch.equal(subs[0].cpu(), subs[1]) and
              torch.equal(*draws), f"threefry draw of seed {seed}: card "
              "differs from the CPU")
    sub = prng.split(k0)[1]
    return dict(known_answers=True, seeds=list(seeds), draw=PRNG_DRAW,
                bitwise_equal_cpu=True,
                uniform_ms=time_ms(lambda: prng.uniform(sub, (PRNG_DRAW,))),
                uniform_profile=call_profile(
                    lambda: prng.uniform(sub, (PRNG_DRAW,))),
                split_profile=call_profile(lambda: prng.split(sub)))


def _dyn_agreement(name, fs, state, backends, epochs):
    """`epochs` from `state` on each backend (path
    `<name>:agree:<backend>`): cwnd and mean goodput within BACKEND_RTOL
    of the first backend's, churn masks, keys and fault carries equal.
    Returns the errors and the first backend's final state."""
    import torch
    from repro_torch.fleetsim import simulate
    out = {}
    for b in backends:
        out[b] = drive(f"{name}:agree:{b}", lambda: simulate(
            fs.net, fs.params, n_epochs=epochs, state0=state, backend=b,
            record=True, **_axes(fs)), plain=not b.endswith("cuda"))
    s0, t0 = out[backends[0]]
    errs = {}
    for b, (st, traj) in out.items():
        errs[b] = _agreement_errs(st.cwnd, traj.mean(dim=0), s0.cwnd,
                                  t0.mean(dim=0))
        check(max(errs[b].values()) <= BACKEND_RTOL,
              f"{name}: {b} vs {backends[0]}: {errs[b]}")
        check(torch.equal(st.active, s0.active) and
              torch.equal(st.key, s0.key) and
              all(torch.equal(x, y) for x, y in zip(st.fault, s0.fault)),
              f"{name}: {b}'s churn masks or fault carry differ")
    return errs, s0


def _no_sync_epoch(fs, state, backend):
    """One epoch of the dynamics step (after one warm-up epoch) under
    `torch.cuda.set_sync_debug_mode("error")`."""
    import torch
    from repro_torch.fleetsim import make_step
    ax = _axes(fs)
    ax.pop("seed")
    step = make_step(fs.net, fs.params, "uno", backend=backend, **ax)
    state, _ = step(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return True


def _dyn_profile(fs, state, backend, n=20):
    """`device_profile` of the dynamics step per epoch, and of the
    epoch's draws alone (`make_step_halves`' `draw`: the churn uniforms
    and burst chains, threefry2x32 in plain torch, and the fault
    modulation)."""
    from repro_torch.fleetsim import make_step, make_step_halves
    ax = _axes(fs)
    ax.pop("seed")
    step = make_step(fs.net, fs.params, "uno", backend=backend, **ax)
    draw = make_step_halves(fs.net, fs.params, "uno", backend=backend,
                            **ax)[0]
    box = [state]

    def one():
        box[0], _ = step(box[0])

    return device_profile(one, n), device_profile(lambda: draw(box[0]), n)


def dynamics_phase(dev, card, records, plan):
    """Phase 9 (module docstring).  `records`: the kernel records so far
    (their uses on the dumbbell layout, the main path's PathTable and the
    2-shard plan are the dynamics paths' too: each must launch there);
    `plan`: phase 5's 2-shard plan of the fat tree."""
    import torch
    from repro_torch.fleetsim import shard as SH
    from repro_torch.fleetsim import simulate, steady_state
    from repro_torch.scenarios import to_fleetsim

    t_phase = t0 = time.perf_counter()
    db_spec, ft_spec = dynamics_specs()
    fs_db = to_fleetsim(db_spec, device=dev)
    fs_ft = to_fleetsim(ft_spec, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    threefry = prng_phase(dev)
    out = dict(threefry=threefry, build_s=build_s)

    # ---- dumbbell_dyn@100k on the flat kernels
    n = fs_db.net.routes.shape[0]
    fresh = simulate(fs_db.net, fs_db.params, n_epochs=0,
                     **_axes(fs_db))[0]
    db = dict(n_flows=n, n_links=fs_db.net.n_links,
              agreement_epochs=DYN_DB_CHECK,
              rel_err_vs_cuda=_dyn_agreement(
                  "dumbbell_dyn", fs_db, fresh, ["cuda", "reference"],
                  DYN_DB_CHECK)[0],
              no_host_sync=_no_sync_epoch(fs_db, fresh, "cuda"))
    dt = float(fs_db.net.dt)
    e0, e1 = round(DYN_DOWN[0] / dt), round(DYN_DOWN[1] / dt)
    spans = {"before": e0, "during": e1 - e0, "after": e1 - e0}
    path = "dumbbell_dyn:segments:cuda"

    def segments():
        state, res = fresh, {}
        for name, span in spans.items():
            state, traj = simulate(fs_db.net, fs_db.params, n_epochs=span,
                                   state0=state, backend="cuda",
                                   record=True, **_axes(fs_db))
            res[name] = float(traj.double().sum(dim=1).mean())
        return state, res, traj.mean(dim=0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, agg, last = drive(path, segments)
    wall = time.perf_counter() - t0
    epochs = sum(spans.values())
    _check_state(state, last, n, path)
    check(all(v > 0.0 for v in agg.values()), f"{path}: {agg}")
    step_prof, draw_prof = _dyn_profile(fs_db, state, "cuda")
    # from a line-rate start with a 2 ms inter RTT all three segments
    # lie in the start transient: the aggregates show the run is live,
    # not what the fault costs
    db.update(segments_epochs=spans, segments_in_start_transient=True,
              aggregate_goodput_bytes_per_ns=agg,
              ms_per_epoch=wall / epochs * 1e3,
              flow_epochs_per_s=n * epochs / wall,
              launches_per_epoch={k: v / epochs
                                  for k, v in PATHS[path].items()},
              threefry_calls_per_epoch=DRAWS[path] / epochs,
              rungs=torch.bincount(state.rel.rung.long()).tolist(),
              active_share=float(state.active.float().mean()),
              profile=step_prof, draws_profile=draw_prof)
    out["dumbbell_dyn"] = db
    del fresh, state

    # ---- fat_tree_dyn@100k on the PathTable kernels
    n = fs_ft.net.routes.shape[0]
    fresh = simulate(fs_ft.net, fs_ft.params, n_epochs=0,
                     **_axes(fs_ft))[0]
    errs, start = _dyn_agreement("fat_tree_dyn", fs_ft, fresh,
                                 ["pt_cuda", "pt"], DYN_FT_CHECK)
    ft = dict(n_flows=n, n_links=fs_ft.net.n_links,
              agreement_epochs=DYN_FT_CHECK, rel_err_vs_pt_cuda=errs,
              no_host_sync=_no_sync_epoch(fs_ft, fresh, "pt_cuda"))
    del fresh
    # the timed run is also the single-device run the shards are held to
    path = "fat_tree_dyn:steady_state:pt_cuda"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = drive(path, lambda: steady_state(
        fs_ft.net, fs_ft.params, n_warm=0, n_meas=DYN_FT_TIMED,
        state0=start, backend="pt_cuda", **_axes(fs_ft)))
    wall = time.perf_counter() - t0
    state, goodput = single
    _check_state(state, goodput, n, path)
    step_prof, draw_prof = _dyn_profile(fs_ft, state, "pt_cuda")
    ft.update(epochs=DYN_FT_TIMED, ms_per_epoch=wall / DYN_FT_TIMED * 1e3,
              flow_epochs_per_s=n * DYN_FT_TIMED / wall,
              main_path_ms_per_epoch=RESULTS["main"]["ms_per_epoch"],
              launches_per_epoch={k: v / DYN_FT_TIMED
                                  for k, v in PATHS[path].items()},
              threefry_calls_per_epoch=DRAWS[path] / DYN_FT_TIMED,
              goodput_sum_bytes_per_ns=float(goodput.double().sum()),
              rungs=torch.bincount(state.rel.rung.long()).tolist(),
              active_share=float(state.active.float().mean()),
              profile=step_prof, draws_profile=draw_prof)

    # ---- fat_tree_dyn@100k:shard2, from the timed run's start state
    t0 = time.perf_counter()
    sf = SH.shard_scenario(fs_ft.net, fs_ft.params, n_shards=2,
                           exchange="psum", plan=plan,
                           link_tier=fs_ft.link_tier, link_dc=fs_ft.link_dc,
                           **_axes(fs_ft))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    spath = shard_path("fat_tree_dyn", 2, "psum", "pt_cuda")
    st, gp, run = _sharded_run(spath, sf, n, DYN_FT_TIMED, n_warm=0,
                               n_meas=DYN_FT_TIMED, backend="pt_cuda",
                               state0=start)
    agree = _agreement_errs(st.cwnd, gp, single[0].cwnd, single[1])
    check(max(agree.values()) <= BACKEND_RTOL,
          f"{spath} vs single device: {agree}")
    masks = torch.equal(st.active, single[0].active) and \
        torch.equal(st.key, single[0].key) and \
        all(torch.equal(x, y) for x, y in zip(st.fault, single[0].fault))
    check(masks, f"{spath}: churn masks or fault carry differ from the "
          "single-device run")
    ft["shard2"] = dict(shard_scenario_s=shard_s, rel_err_vs_single=agree,
                        churn_masks_bitwise_equal=masks,
                        threefry_calls_per_epoch=DRAWS[spath] / DYN_FT_TIMED,
                        **run)
    out["fat_tree_dyn"] = ft

    # the kernels phases 3 and 5 held at these layouts, on these paths
    uses = {DB_MP_PATH: "dumbbell_dyn:segments:cuda", MAIN_PATH: path,
            shard_path("fat_tree", 2, "psum", "pt_cuda"): spath}
    launches = {}
    for r in records:
        if r["path"] in uses:
            dyn = uses[r["path"]]
            count = PATHS[dyn].get(r["counter"], 0)
            check(count > 0, f"{r['name']} never launched on its dynamics "
                  f"path {dyn}")
            launches.setdefault(dyn, {})[r["name"]] = count
    out.update(kernel_launches=launches,
               seconds=time.perf_counter() - t_phase)
    emit("dynamics", **card, **out)


# ------------------------------------------------------------- phase 10

class LoopProbe:
    """Instrumentation of `sweeps.run_grid` and `cc.steady_state` while in
    use: the `Grid` each grid batch stacks, the `ShardedFleet` and the
    synchronized seconds of each `sweeps.shard_grid` (the sharded grid's
    set-up), each `run_grid`'s (final, rates), and every epoch loop
    (`steady_state_core`, the grid's and a single cell's alike): its
    synchronized wall time, epochs, threefry2x32 calls, step and final
    flat state, set-up excluded."""

    def __enter__(self):
        import torch
        from repro_torch.fleetsim import cc, prng
        from repro_torch.fleetsim import sweeps as SW
        self.grids, self.loops, self.sharded, self.results = [], [], [], []
        self._mods = (SW, cc)
        self._stack, self._core = SW.stack_scenarios, SW.steady_state_core
        self._shard, self._run = SW.shard_grid, SW.run_grid

        def stack(cells, **kw):
            self.grids.append(self._stack(cells, **kw))
            return self.grids[-1]

        def shard(g, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sf = self._shard(g, **kw)
            torch.cuda.synchronize()
            self.sharded.append(dict(sf=sf,
                                     seconds=time.perf_counter() - t0))
            return sf

        def run(*a, **kw):
            self.results.append(self._run(*a, **kw))
            return self.results[-1]

        def core(step, state, *, n_warm, n_meas, acc):
            torch.cuda.synchronize()
            calls = prng.CALLS["threefry2x32"]
            t0 = time.perf_counter()
            out = self._core(step, state, n_warm=n_warm, n_meas=n_meas,
                             acc=acc)
            torch.cuda.synchronize()
            self.loops.append(dict(
                seconds=time.perf_counter() - t0, epochs=n_warm + n_meas,
                threefry=prng.CALLS["threefry2x32"] - calls, step=step,
                state=out[0]))
            return out

        SW.stack_scenarios, SW.shard_grid, SW.run_grid = stack, shard, run
        SW.steady_state_core = cc.steady_state_core = core
        return self

    def __exit__(self, *exc):
        SW = self._mods[0]
        SW.stack_scenarios, SW.shard_grid = self._stack, self._shard
        SW.run_grid = self._run
        for mod in self._mods:
            mod.steady_state_core = self._core


def _step_profile(step, state, n=20):
    """`device_profile` of `step` per epoch from `state`."""
    box = [state]

    def one():
        box[0], _ = step(box[0])

    return device_profile(one, n)


def _cell_alone(cell, seed, **run):
    """One grid cell alone through `steady_state`."""
    from repro_torch.fleetsim import steady_state
    net, params, ii, lb, churn, rel, fault = cell
    return steady_state(net, params, is_inter=ii, lb=lb, churn=churn,
                        rel=rel, fault=fault, seed=seed, **run)


def _grid_loop(name, cells, run):
    """The cells as one grid (path `sweep:agree:<name>_grid:cuda`) and
    each alone, one after another (`sweep:agree:<name>_loop:cuda`),
    seeded i.  Returns (grid final, grid rates, the cells' (final,
    rates), and the timing: ms per epoch of the grid's loop and of the
    cells' loops one after another, set-up excluded, the loop's wall with
    the cells' set-up, and threefry2x32 calls per epoch of the grid and
    of one cell)."""
    import torch
    from repro_torch.fleetsim import sweeps as SW
    ep = run["n_warm"] + run["n_meas"]
    with LoopProbe() as probe:
        final, rates = drive(f"sweep:agree:{name}_grid:cuda",
                             lambda: SW.run_grid(cells, seed=0, **run))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = drive(f"sweep:agree:{name}_loop:cuda", lambda: [
            _cell_alone(SW._norm_scenario(c), i, **run)
            for i, c in enumerate(cells)])
        loop_wall = time.perf_counter() - t0
    grid, singles = probe.loops[0], probe.loops[1:]
    check(len(singles) == len(cells), f"{name}: {len(singles)} cell loops")
    loop_s = sum(c["seconds"] for c in singles)
    timing = dict(
        grid_ms_per_epoch=grid["seconds"] / ep * 1e3,
        loop_ms_per_epoch=loop_s / ep * 1e3,
        loop_with_setup_ms_per_epoch=loop_wall / ep * 1e3,
        grid_cell_epochs_per_s=len(cells) * ep / grid["seconds"],
        loop_cell_epochs_per_s=len(cells) * ep / loop_s,
        grid_threefry_calls_per_epoch=grid["threefry"] / ep,
        cell_threefry_calls_per_epoch=sum(c["threefry"] for c in singles)
        / (ep * len(cells)))
    return final, rates, alone, timing


def _fleet_launches(path, epochs):
    """The path's fleet-kernel launches per epoch; a path that launched
    no fleet kernel fails the run."""
    fleet = {k: v / epochs for k, v in PATHS[path].items()
             if k.startswith(("link_scatter", "link_gathers", "pt_"))}
    check(bool(fleet), f"{path} launched no fleet kernel")
    return fleet


def sweeps_phase(dev, card):
    """Phase 10 (module docstring); returns the kernel records of K1 and
    K2 at the fault grid's shapes."""
    import torch
    from repro_torch.fleetsim import links as L
    from repro_torch.fleetsim import make_step, prng
    from repro_torch.fleetsim import sweeps as SW

    t_phase = time.perf_counter()
    fk = dict(fault_kinds=SWEEP_FAULT["fault_kinds"],
              ec_policies=SWEEP_FAULT["ec_policies"])
    n_inter = SWEEP_FAULT["n_inter"]

    # ---- fault_grid@8x100k: the benchmark's full-mode grid, fault_sweep
    epochs = SWEEP_WARM + SWEEP_MEAS
    span = epochs * SWEEP_DT
    kw = dict(SWEEP_FAULT, fail_times=(0.2 * span, 0.5 * span))
    path = "sweep:fault_grid:cuda"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LoopProbe() as probe:
        res = drive(path, lambda: SW.fault_sweep(
            n_warm=SWEEP_WARM, n_meas=SWEEP_MEAS, device=dev, **kw))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(probe.grids) == 1, "fault grid: one batch")
    grid, loop = probe.grids[0], probe.loops[0]
    for key in ("util", "jain", "retx_ratio", "rec_ratio", "loss_ratio",
                "nacks", "nack_lat", "rung_mean", "rates"):
        check(bool(torch.isfinite(res[key]).all()), f"fault grid: {key} "
              "not finite")
    check(bool((res["util"] > 0.0).all()), "fault grid: util <= 0")
    n = grid.net.routes.shape[0]
    fault_grid = dict(
        **kw, n_warm=SWEEP_WARM, n_meas=SWEEP_MEAS, epochs_cut=None,
        cells=grid.n_cells, flows=n, links=grid.net.n_links,
        backend=L._resolve_backend(grid.net, "auto"), wall_s=wall,
        setup_s=wall - loop["seconds"], run_s=loop["seconds"],
        ms_per_epoch=loop["seconds"] / epochs * 1e3,
        cell_epochs_per_s=grid.n_cells * epochs / loop["seconds"],
        flow_epochs_per_s=n * epochs / loop["seconds"],
        fleet_launches_per_epoch=_fleet_launches(path, epochs),
        threefry_calls_per_epoch=loop["threefry"] / epochs,
        profile=_step_profile(loop["step"], loop["state"]),
        peak_mem_bytes=peak,
        **{k: res[k].reshape(-1).tolist()
           for k in ("util", "rung_mean", "loss_ratio")},
        fault_config=res["fault_config"])
    records, errs = kernel_phase(grid.net, dev, path, tag="@fault_grid")
    fault_grid.update(errs)
    del grid, loop, probe, res

    # ---- fault_grid_agree: the same 2x2x2 grid over 400 epochs, batched
    # and each cell alone
    dur = round(SWEEP_AGREE_RTTS * 2e6 / SWEEP_DT)
    check(dur >= 100, f"agreement fault window {dur} epochs")
    cells, _ = SW._fault_cells(
        [e * SWEEP_DT for e in SWEEP_AGREE_FAILS], n_inter=n_inter,
        fault_rtts=SWEEP_AGREE_RTTS, device=dev, **fk)
    run = dict(n_warm=SWEEP_AGREE_WARM, n_meas=SWEEP_AGREE_MEAS)
    ep = SWEEP_AGREE_WARM + SWEEP_AGREE_MEAS
    final, rates, alone, timing = _grid_loop("fault", cells, run)
    errs, rungs_differ = [], 0
    for i, (st, g) in enumerate(alone):
        errs.append(_agreement_errs(final.cwnd[i], rates[i], st.cwnd, g))
        check(max(errs[-1].values()) <= BACKEND_RTOL,
              f"fault grid cell {i} vs alone: {errs[-1]}")
        check(all(torch.equal(getattr(final.fault, f)[i],
                              getattr(st.fault, f))
                  for f in ("epoch", "ge_bad", "key")),
              f"fault grid cell {i}: fault carry differs from alone")
        rungs_differ += int((final.rel.rung[i] != st.rel.rung).sum())
    cell0 = SW._norm_scenario(cells[0])
    step0 = make_step(cell0[0], cell0[1], "uno", cell0[2], lb=cell0[3],
                      churn=cell0[4], rel=cell0[5], fault=cell0[6])
    agree = dict(
        fail_epochs=list(SWEEP_AGREE_FAILS), fault_window_epochs=dur,
        n_inter=n_inter, epochs=ep, cells=len(cells),
        rel_err_vs_alone=errs, max_rel_err=max(max(e.values())
                                               for e in errs),
        fault_carries_bitwise=True, rung_mismatches=rungs_differ,
        **timing,
        grid_fleet_launches_per_epoch=_fleet_launches(
            "sweep:agree:fault_grid:cuda", ep),
        cell_fleet_launches_per_epoch=_fleet_launches(
            "sweep:agree:fault_loop:cuda", ep * len(cells)),
        cell_profile=_step_profile(step0, alone[0][0]))
    check(timing["grid_threefry_calls_per_epoch"] ==
          timing["cell_threefry_calls_per_epoch"],
          "fault grid draws more often than one cell")
    del final, rates, alone, cells, step0

    # ---- churn_grid@2x100k: churn_sweep, and 200 epochs batched vs alone
    path = "sweep:churn_grid:cuda"
    cep = SWEEP_CHURN_WARM + SWEEP_CHURN_MEAS
    with LoopProbe() as probe:
        res = drive(path, lambda: SW.churn_sweep(
            n_warm=SWEEP_CHURN_WARM, n_meas=SWEEP_CHURN_MEAS, device=dev,
            **SWEEP_CHURN))
    loop = probe.loops[0]
    check(bool(torch.isfinite(res["util"]).all() and
               (res["util"] > 0.0).all()), f"churn grid util {res['util']}")
    churn = dict(
        **SWEEP_CHURN, n_warm=SWEEP_CHURN_WARM, n_meas=SWEEP_CHURN_MEAS,
        cells=probe.grids[0].n_cells, flows=probe.grids[0].cell_flows
        * probe.grids[0].n_cells,
        ms_per_epoch=loop["seconds"] / cep * 1e3,
        cell_epochs_per_s=probe.grids[0].n_cells * cep / loop["seconds"],
        threefry_calls_per_epoch=loop["threefry"] / cep,
        fleet_launches_per_epoch=_fleet_launches(path, cep),
        util=res["util"].reshape(-1).tolist(),
        jain=res["jain"].reshape(-1).tolist(),
        profile=_step_profile(loop["step"], loop["state"]),
        # threefry's share of the grid epoch: the epoch's churn split and
        # its one draw over every cell's flows, alone
        draw_profiles=dict(
            split=call_profile(lambda: prng.split(loop["state"].key)),
            uniform=call_profile(lambda: prng.uniform(
                loop["state"].key, (SWEEP_CHURN["n_flows"],)))))
    # the churn split and the one draw of every cell's flows
    check(churn["threefry_calls_per_epoch"] == 2.0,
          f"churn grid threefry per epoch {churn['threefry_calls_per_epoch']}")
    del probe, loop, res
    cells = SW._churn_cells(SWEEP_CHURN["duty_fracs"],
                            SWEEP_CHURN["mean_on_rtts"],
                            n_flows=SWEEP_CHURN["n_flows"], device=dev)
    run = dict(n_warm=SWEEP_CHURN_CHECK // 2,
               n_meas=SWEEP_CHURN_CHECK - SWEEP_CHURN_CHECK // 2)
    final, rates, alone, timing = _grid_loop("churn", cells, run)
    masks = all(torch.equal(final.active[i], st.active) and
                torch.equal(final.key[i], st.key)
                for i, (st, _) in enumerate(alone))
    check(masks, "churn grid: masks or keys differ from the cells alone")
    churn.update(
        check_epochs=SWEEP_CHURN_CHECK, masks_keys_bitwise=masks,
        active_share=[float(st.active.float().mean()) for st, _ in alone],
        rel_err_vs_alone=[_agreement_errs(final.cwnd[i], rates[i],
                                          st.cwnd, g)
                          for i, (st, g) in enumerate(alone)],
        **timing)
    check(churn["grid_threefry_calls_per_epoch"] ==
          churn["cell_threefry_calls_per_epoch"],
          "churn grid draws more often than one cell")
    del final, rates, alone, cells
    emit("sweeps", **card, fault_grid=fault_grid, fault_grid_agree=agree,
         churn_grid=churn, records=records,
         seconds=time.perf_counter() - t_phase)
    return records


# ------------------------------------------------------------- phase 11

def _grid_run(path, fn):
    """fn() (a `run_grid` or sweep call) as the path `path`, under a
    LoopProbe; returns (its result, the probe, wall seconds, peak
    memory)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with LoopProbe() as probe:
        out = drive(path, fn)
    wall = time.perf_counter() - t0
    return out, probe, wall, torch.cuda.max_memory_allocated()


def _grid_timing(path, probe, wall, peak, n_cells, n_flows):
    """Set-up, ms per grid epoch, cell- and flow-epochs/s, peak memory,
    the fleet kernels per epoch and a 20-epoch profile of the path's one
    epoch loop."""
    check(len(probe.loops) == 1, f"{path}: {len(probe.loops)} epoch loops")
    loop = probe.loops[0]
    ep, run_s = loop["epochs"], loop["seconds"]
    out = dict(epochs=ep, wall_s=wall, setup_s=wall - run_s, run_s=run_s,
               ms_per_epoch=run_s / ep * 1e3,
               cell_epochs_per_s=n_cells * ep / run_s,
               flow_epochs_per_s=n_flows * ep / run_s, peak_mem_bytes=peak,
               fleet_launches_per_epoch=_fleet_launches(path, ep),
               profile=_step_profile(loop["step"], loop["state"]))
    if probe.sharded:
        out["shard_grid_s"] = probe.sharded[0]["seconds"]
    return out


def _cell(final, i):
    from repro_torch.fleetsim import sweeps as SW
    return SW._map(lambda v: v[i], final)


def _grid_checks(final, rates, what):
    """Every cell's state finite, its split rows summing to 1; the
    largest split-row error."""
    return max(_check_state(_cell(final, i), rates[i], rates.shape[1],
                            f"{what} cell {i}")
               for i in range(rates.shape[0]))


def _states_bitwise(a, b) -> bool:
    import torch
    for f, v in a._asdict().items():
        w = getattr(b, f)
        if hasattr(v, "_fields"):
            if not _states_bitwise(v, w):
                return False
        elif (v is None) != (w is None) or \
                (v is not None and not torch.equal(v, w)):
            return False
    return True


def _vs_unsharded(rates, rates0):
    """Per cell: max |rates - rates0| over the grid's rate scale."""
    scale = float(rates0.abs().max().clamp(min=1e-30))
    return [float((r - r0).abs().max()) / scale
            for r, r0 in zip(rates, rates0)]


def sharded_grid_phase(fs, dev, card):
    """Phase 11 (module docstring); returns the kernel records at the
    sharded grids' shard 0."""
    import warnings
    import torch
    from repro_torch.fleetsim import links as L
    from repro_torch.fleetsim import shard as SH
    from repro_torch.fleetsim import sweeps as SW
    from repro_torch.scenarios import plan_shards

    t_phase = time.perf_counter()
    # ---- fat_tree_grid@2x100k:shard2: the main path's fat tree and its
    # drain what-if (benchmarks/sweep_server.py:122-126), one routing
    cells = [fs, fs._replace(net=fs.net._replace(drain=fs.net.drain
                                                 * GRID_DRAIN))]
    n_cell = fs.net.routes.shape[0]
    run = dict(n_warm=GRID_WARM, n_meas=GRID_MEAS, seed=0)
    base = "sweep:fat_tree_grid:pt_cuda"
    (f0, r0), probe, wall, peak = _grid_run(
        base, lambda: SW.run_grid(cells, **run))
    check(L._resolve_backend(probe.grids[0].net, "auto") == "pt_cuda",
          "unsharded fat-tree grid: not on pt_cuda")
    runs = {base: _grid_timing(base, probe, wall, peak, 2, 2 * n_cell)}
    split_err = _grid_checks(f0, r0, base)
    del probe
    outs, sfs, paths = {}, {}, {}
    for ex in ("psum", "nbr"):
        paths[ex] = path = shard_path("fat_tree_grid", 2, ex, "pt_cuda")
        if ex == "psum":
            outs[ex], probe, wall, peak = _grid_run(
                path, lambda: SW.run_grid(cells, n_shards=2, **run))
            g, sfs[ex] = probe.grids[0], probe.sharded[0]["sf"]
        else:
            # the grid's own exchange is the psum: the neighbor exchange
            # runs the compiled grid under the other exchange tables
            sfs[ex] = SH._with_exchange(sfs["psum"], ex)
            outs[ex], probe, wall, peak = _grid_run(
                path, lambda: SW._run_sharded(
                    g, sfs[ex], SW._grid_seeds(2, run["seed"], None),
                    scheme="uno", n_warm=GRID_WARM, n_meas=GRID_MEAS,
                    backend="auto"))
        runs[path] = _grid_timing(path, probe, wall, peak, 2, 2 * n_cell)
        split_err = max(split_err, _grid_checks(*outs[ex], path))
        del probe
    sf = sfs["psum"]
    check(all(L._resolve_backend(sf.shard_net(s), "auto") == "pt_cuda"
              for s in range(2)), "sharded fat-tree grid: not on pt_cuda")
    plan0 = plan_shards(fs.net.routes, fs.net.n_links, 2,
                        link_tier=fs.link_tier)
    halo = sf.plan.n_boundary
    check(halo == 2 * plan0.n_boundary and 0 < halo < sf.plan.n_links,
          f"grid boundary {halo}, cell's {plan0.n_boundary}")
    (fp, rp), (fn_, rn) = outs["psum"], outs["nbr"]
    bitwise = torch.equal(rp, rn) and _states_bitwise(fp, fn_)
    check(bitwise, "fat-tree grid: psum and nbr differ")
    errs = _vs_unsharded(rp, r0)
    check(max(errs) <= GRID_RTOL, f"fat-tree grid vs unsharded: {errs}")
    records, kerrs = kernel_phase(sf.shard_net(0), dev, None, paths["psum"],
                                  tag="@fat_tree_grid:shard2", halo=halo)
    records += [dict(r, path=paths["nbr"]) for r in records]
    fat_tree = dict(
        **FAT_TREE, cells=2, drain_whatif=GRID_DRAIN, n_shards=2,
        plan="cell 0 (link_tier) lifted to the grid", flows=2 * n_cell,
        links=sf.plan.n_links, n_boundary=halo,
        cell_n_boundary=plan0.n_boundary,
        rows_per_shard=sf.plan.rows,
        segments_per_shard=[lay.path_table.n_segments
                            for lay in sf.layouts],
        nbr_width=int(sfs["nbr"].nbr.shape[2]),
        **_exchange_bytes(sfs["nbr"]), n_warm=GRID_WARM, n_meas=GRID_MEAS,
        rel_err_vs_unsharded=errs, psum_nbr_bitwise_equal=bitwise,
        split_row_err=split_err, runs=runs, **kerrs)
    del outs, f0, r0, fp, rp, fn_, rn, sfs, sf, g

    # ---- fault_grid@8x100k:shard2: phase 10's grid through fault_sweep
    # on 2 shards, and unsharded, over the same epochs
    epochs = SHARD_FAULT_WARM + SHARD_FAULT_MEAS
    span = epochs * SWEEP_DT
    kw = dict(SWEEP_FAULT, fail_times=(0.2 * span, 0.5 * span),
              n_warm=SHARD_FAULT_WARM, n_meas=SHARD_FAULT_MEAS, device=dev)
    twin = "sweep:fault_grid_twin:cuda"
    res0, probe, wall, peak = _grid_run(twin, lambda: SW.fault_sweep(**kw))
    f0, r0 = probe.results[0]
    n_flows = f0.cwnd.numel()
    runs = {twin: _grid_timing(twin, probe, wall, peak, 8, n_flows)}
    del probe
    path = shard_path("fault_grid", 2, "psum", "cuda")
    with warnings.catch_warnings():
        # a dumbbell flow's every hop is a hub: the planner deals the
        # flows round-robin, as the reference's does, and says so
        warnings.filterwarnings("ignore", message=".*every hop")
        res1, probe, wall, peak = _grid_run(
            path, lambda: SW.fault_sweep(n_shards=2, **kw))
    f1, r1 = probe.results[0]
    sf = probe.sharded[0]["sf"]
    runs[path] = _grid_timing(path, probe, wall, peak, 8, n_flows)
    del probe
    check(sf.plan.n_boundary == sf.plan.n_links,
          "sharded fault grid: expected every link boundary")
    errs = _vs_unsharded(r1, r0)
    check(max(errs) <= GRID_RTOL, f"fault grid vs unsharded: {errs}")
    carries = all(torch.equal(getattr(f1.fault, f), getattr(f0.fault, f))
                  for f in ("epoch", "ge_bad", "key"))
    rungs = torch.equal(f1.rel.rung, f0.rel.rung)
    check(carries and rungs, "sharded fault grid: carries or rungs differ")
    keys = ("util", "jain", "retx_ratio", "rec_ratio", "loss_ratio",
            "nacks", "nack_lat", "rung_mean", "rates")
    for k in keys:
        check(bool(torch.isfinite(res1[k]).all()), f"sharded fault grid {k}")
    key_errs = {k: float((res1[k].double() - res0[k].double()).abs().max())
                for k in keys}
    split_err = max(_grid_checks(f0, r0, twin), _grid_checks(f1, r1, path))
    recs, kerrs = kernel_phase(sf.shard_net(0), dev, path,
                               tag="@fault_grid:shard2")
    records += recs
    fault = dict(
        **{k: v for k, v in kw.items() if k != "device"}, cells=8,
        n_shards=2, plan="round-robin (every hop of a flow is a hub)",
        flows=n_flows, links=sf.plan.n_links, n_boundary=sf.plan.n_boundary,
        rows_per_shard=sf.plan.rows, **_exchange_bytes(sf),
        rel_err_vs_unsharded=errs, output_abs_err_vs_unsharded=key_errs,
        fault_carries_bitwise=carries, rungs_bitwise=rungs,
        split_row_err=split_err, runs=runs, **kerrs)
    emit("sharded_grid", **card, fat_tree_grid=fat_tree, fault_grid=fault,
         records=records, seconds=time.perf_counter() - t_phase)
    return records


# ------------------------------------------------------------- phase 12

def service_phase(dev, card, records):
    """Phase 12 (module docstring): the sweep service on a fresh cache
    directory under the temporary directory, removed afterwards.  Adds to
    `records` the main path's PathTable kernel records for the cold
    query's path."""
    import tempfile
    import torch
    from repro_torch.fleetsim import service as SV

    t_phase = time.perf_counter()
    out = {}

    def timed(name, fn, epochs=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = drive(name, fn)
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0)
        if epochs:
            rec["fleet_launches_per_epoch"] = _fleet_launches(name, epochs)
        out[name] = rec
        return res

    def rates_ok(results, what):
        for _, r in results:
            check(bool(torch.isfinite(r).all()) and float(r.sum()) > 0.0,
                  f"service {what}: rates")

    ep = SVC_WARM + SVC_MEAS
    with tempfile.TemporaryDirectory(prefix="uno_sweep_cache_") as cache:
        svc = SV.SweepService(cache_dir=cache, device=dev)
        cold = "service:cold:fat_tree:pt_cuda"

        def first():
            t0 = time.perf_counter()
            fs = svc.scenario("fat_tree", **FAT_TREE)
            torch.cuda.synchronize()
            out["scenario_s"] = time.perf_counter() - t0
            q = SV.SweepQuery(fs, n_warm=SVC_WARM, n_meas=SVC_MEAS)
            return fs, q, svc.submit([q])

        fs, q, res_cold = timed(cold, first, ep)
        check(svc.stats()["scenario_cache"]["builds"] == 1, "cold: no build")
        warm = "service:warm:fat_tree:pt_cuda"
        res_warm = timed(warm, lambda: svc.submit([q]), ep)
        check(torch.equal(res_warm[0][1], res_cold[0][1]),
              "service: warm rates differ from cold")
        check(svc.stats()["grid_layouts"] == {"built": 1, "reused": 1},
              f"warm query: {svc.stats()['grid_layouts']}")
        # a fresh service on the warm directory: the bundle replaces the
        # spec build, and loads bitwise the arrays that were written
        t0 = time.perf_counter()
        fresh = SV.SweepService(cache_dir=cache, device=dev)
        fs2 = fresh.scenario("fat_tree", **FAT_TREE)
        torch.cuda.synchronize()
        out["bundle_load_s"] = time.perf_counter() - t0
        check(fresh.stats()["scenario_cache"]["disk_hits"] == 1,
              "bundle load: not a disk hit")
        same = _states_bitwise(fs2.net, fs.net) and \
            _states_bitwise(fs2.params, fs.params) and \
            torch.equal(fs2.is_inter, fs.is_inter) and \
            (fs2.lb is None) == (fs.lb is None) and \
            (fs.lb is None or _states_bitwise(fs2.lb, fs.lb))
        check(same, "service: the bundle did not load bitwise")
        out["bundle_bytes"] = SV.cache_stats(cache)["bytes"]
        del fresh, fs2
        # two batches of four drain what-ifs, one rung-4 batch each: the
        # first builds the 4-cell grid's layout, the second (other drains,
        # the same routes) reuses it
        for name, drains, built in (("whatif4", SVC_DRAINS[0], 1),
                                    ("whatif4_warm", SVC_DRAINS[1], 0)):
            before = dict(svc.stats()["grid_layouts"])
            whatifs = [SV.SweepQuery(
                (fs.net._replace(drain=fs.net.drain * f), fs.params,
                 fs.is_inter, fs.lb, fs.churn, fs.rel), seed=i,
                n_warm=SVC_WARM, n_meas=SVC_MEAS)
                for i, f in enumerate(drains)]
            path = f"service:{name}:fat_tree:pt_cuda"
            batches = svc.stats()["scenario_cache"]["batches"]
            res = timed(path, lambda: svc.submit(whatifs), ep)
            rates_ok(res, "what-ifs")
            check(svc.stats()["scenario_cache"]["batches"] == batches + 1,
                  "what-ifs: not one batch")
            lay = svc.stats()["grid_layouts"]
            out[path].update(
                queries=len(whatifs), queries_per_s=len(whatifs)
                / out[path]["seconds"],
                grid_layouts_built=lay["built"] - before["built"],
                grid_layouts_reused=lay["reused"] - before["reused"])
            check(out[path]["grid_layouts_built"] == built,
                  f"{name}: {out[path]}")
            del res, whatifs
        # a mixed dumbbell + fat-tree batch, twice: the second pass hits
        # every cache (no spec build, no grid layout)
        db = dict(DUMBBELL)
        mixed = []
        for p in (1, 2):
            before = (dict(svc.stats()["grid_layouts"]),
                      svc.stats()["scenario_cache"]["builds"])
            name = f"service:mixed{p}"

            def batch():
                d = svc.scenario("dumbbell", **db)
                return svc.submit([
                    SV.SweepQuery(d, seed=0, n_warm=SVC_WARM,
                                  n_meas=SVC_MEAS),
                    SV.SweepQuery(fs, seed=1, n_warm=SVC_WARM,
                                  n_meas=SVC_MEAS),
                    SV.SweepQuery(d, seed=2, n_warm=SVC_WARM,
                                  n_meas=SVC_MEAS)])

            res = timed(name, batch)
            rates_ok(res, name)
            lay = svc.stats()["grid_layouts"]
            out[name].update(
                spec_builds=svc.stats()["scenario_cache"]["builds"]
                - before[1],
                grid_layouts_built=lay["built"] - before[0]["built"],
                grid_layouts_reused=lay["reused"] - before[0]["reused"],
                fleet_launches=_fleet_launches(name, 1))
            mixed.append(res)
        check(out["service:mixed2"]["spec_builds"] == 0 and
              out["service:mixed2"]["grid_layouts_built"] == 0,
              f"mixed batch, second pass: {out['service:mixed2']}")
        check(all(torch.equal(a[1], b[1]) for a, b in zip(*mixed)),
              "mixed batch: the two passes differ")
        stats = svc.stats()
        del mixed, res, svc
    stats.pop("cache_dir")
    main_recs = [r for r in records if r["path"] == MAIN_PATH]
    check(len(main_recs) == 3, "main path: three PathTable records")
    records += [dict(r, path=cold) for r in main_recs]
    emit("service", **card, fat_tree=FAT_TREE, dumbbell=DUMBBELL,
         n_warm=SVC_WARM, n_meas=SVC_MEAS,
         drains=[list(d) for d in SVC_DRAINS],
         cold_s=out[cold]["seconds"], warm_s=out[warm]["seconds"],
         scenario_build_s=out["scenario_s"],
         bundle_load_s=out["bundle_load_s"],
         bundle_bytes=out["bundle_bytes"],
         whatif4_s=out["service:whatif4:fat_tree:pt_cuda"]["seconds"],
         whatif4_warm_s=out["service:whatif4_warm:fat_tree:pt_cuda"][
             "seconds"],
         runs=out, stats=stats, seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------------- phase 7/8

def uno_path(p: int, backend: str = "cuda") -> str:
    return f"uno_sync:{UNO_ARCH}:p{p}:{backend}"


def uno_chunk_len(n_params: int, run) -> int:
    """One chunk of the sync's flat vector: padded to uno_chunks x
    uno_ec_data x 256, as `_pod_ring_psum` pads it."""
    unit = run.uno_chunks * run.uno_ec_data * 256
    return -(-n_params // unit) * unit // run.uno_chunks


def unorc_kernel_phase(dev, cfg, n_pods: int = 2):
    """Every UnoRC kernel use against its plain version on the card at the
    shapes of one chunk of the p = 2 sync, K3 also at one part of a chunk
    of the p = 4 ring, and the 55 erasure patterns;
    returns the per-kernel records (`path`/`counter` as in
    `kernel_phase`) and the pattern count."""
    import itertools
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import gf, ops, ref
    from repro_torch.kernels import unorc_cuda as K
    from repro_torch.models import params as P

    run = RunConfig()
    nx, ny = run.uno_ec_data, run.uno_ec_parity
    c = uno_chunk_len(P.param_count(P.param_defs(cfg)), run)
    g = torch.Generator(device=dev).manual_seed(4321)
    x = torch.randn(n_pods, c, device=dev, generator=g) * 1e-3
    x[:, 5 * 256:6 * 256] = 0.0          # zero blocks: scale 1, q 0
    x[1, :256] = 0.0
    records = []

    def record(counter, path, replaces, kernel, plain, n_bytes, n_ops=0,
               library=None, name=None):
        """`library`: one PyTorch call that may compute the same
        function, timed; its time is `library_ms` only if it is bitwise
        equal to the kernel.  `name` defaults to the counter."""
        o1, o2 = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain()
        o1, o2, want = ((o,) if torch.is_tensor(o) else o
                        for o in (o1, o2, want))
        name = name or counter
        check(all(torch.equal(a, b) for a, b in zip(o1, want)),
              f"{name}: kernel differs from its plain version")
        check(all(torch.equal(a, b) for a, b in zip(o1, o2)),
              f"{name}: runs differ")
        bound = bound_ms(n_bytes, n_ops)
        extra = {}
        if library is not None:
            extra = dict(library_call_ms=time_ms(library),
                         library_bitwise_equal=torch.equal(
                             library().reshape(o1[0].shape), o1[0]))
        records.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/unorc_kernels.cu",
            replaces=replaces, launches=0, path=path, counter=counter,
            max_abs_err=max(float((a.double() - b.double()).abs().max())
                            for a, b in zip(o1, want)),
            bitwise_equal=True, bitwise_repeat=True,
            ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=bound,
            bound_by="bytes" if bound == bound_ms(n_bytes) else
            "operations",
            library_ms=extra.get("library_call_ms")
            if extra.get("library_bitwise_equal") else None,
            bytes=n_bytes, ops=n_ops, **call_profile(kernel),
            shape=[int(v) for v in o1[0].shape], **extra))
        return o1 if len(o1) > 1 else o1[0]

    nb = c // 256
    q, s = record("quant_int8", uno_path(2),
                  "src/repro/kernels/quant_pallas.py:36",
                  lambda: K.quant_int8(x), lambda: ref.quant_int8_ref(x),
                  n_pods * (4 * c + c + 4 * nb), n_pods * c)
    check(bool((s[:, 5] == 1.0).all()) and float(s[1, 0]) == 1.0,
          "quant_int8: zero blocks must have scale 1")
    rows = q.view(torch.uint8).reshape(n_pods, nx, -1)
    width = rows.shape[-1]
    enc = gf.rs_generator_rows(nx, ny)
    parity = record("gf_matmul/encode", uno_path(2),
                    "src/repro/kernels/rs_pallas.py:56",
                    lambda: K.gf_matmul(rows, enc, use="encode"),
                    lambda: ref.gf_matmul_ref(enc, rows),
                    n_pods * (nx + ny) * width)
    surv = torch.cat([rows[:, ny:], parity], dim=1)
    dec = gf.rs_decode_matrix(nx, ny, tuple(range(ny)), tuple(range(ny)))
    rebuilt = record("gf_matmul/decode", uno_path(2),
                     "src/repro/kernels/rs_pallas.py:56",
                     lambda: K.gf_matmul(surv, dec, use="decode"),
                     lambda: ref.gf_matmul_ref(dec, surv),
                     n_pods * (nx + ny) * width)
    check(torch.equal(rebuilt, rows[:, :ny]), "decode: rows {0, 1} lost")
    # K3 at the p = 4 ring's shape: each of its 48 + 48 launches a sync
    # protects one part (1 / p) of a chunk for every pod
    p4 = max(UNO_PODS)
    part = -(-c // p4)
    w4 = -(-part // 256) * 256 // nx
    rows4 = torch.randint(0, 256, (p4, nx, w4), dtype=torch.uint8,
                          device=dev, generator=g)
    parity4 = record("gf_matmul/encode", uno_path(p4),
                     "src/repro/kernels/rs_pallas.py:56",
                     lambda: K.gf_matmul(rows4, enc, use="encode"),
                     lambda: ref.gf_matmul_ref(enc, rows4),
                     p4 * (nx + ny) * w4, name=f"gf_matmul/encode@p{p4}")
    surv4 = torch.cat([rows4[:, ny:], parity4], dim=1)
    rebuilt4 = record("gf_matmul/decode", uno_path(p4),
                      "src/repro/kernels/rs_pallas.py:56",
                      lambda: K.gf_matmul(surv4, dec, use="decode"),
                      lambda: ref.gf_matmul_ref(dec, surv4),
                      p4 * (nx + ny) * w4, name=f"gf_matmul/decode@p{p4}")
    check(torch.equal(rebuilt4, rows4[:, :ny]),
          f"decode at p={p4}: rows {{0, 1}} lost")
    del rows4, parity4, surv4, rebuilt4
    qb, sb = q.view(n_pods, nb, 256), s[..., None]
    record("dequant_int8", uno_path(4), "src/repro/kernels/quant_pallas.py:59",
           lambda: K.dequant_int8(q, s), lambda: ref.dequant_int8_ref(q, s),
           n_pods * (c + 4 * nb + 4 * c), n_pods * c,
           library=lambda: torch.mul(qb, sb))
    xb = x.view(n_pods, nb, 256)
    record("dequant_int8/acc", uno_path(2),
           "src/repro/kernels/quant_pallas.py:59",
           lambda: K.dequant_int8(q, s, x),
           lambda: ref.dequant_int8_ref(q, s, acc=x),
           n_pods * (c + 4 * nb + 8 * c), 2 * n_pods * c,
           library=lambda: torch.addcmul(xb, qb, sb))
    # both uses at block counts on either side of K5's per-warp span of
    # 4 blocks (the tail), with the addend's rows strided
    for n_blocks in (b for b in (1, 2, 3, 5, 4099) if 256 * (b + 1) <= c):
        tq, ts = K.quant_int8(x[:, :256 * n_blocks])
        wide = x[:, 256:256 * (n_blocks + 2)]
        tacc = wide[:, :256 * n_blocks]
        check(torch.equal(K.dequant_int8(tq, ts),
                          ref.dequant_int8_ref(tq, ts)) and
              torch.equal(K.dequant_int8(tq, ts, tacc),
                          ref.dequant_int8_ref(tq, ts, acc=tacc)),
              f"dequant_int8: tail of {n_blocks} blocks differs")
    # every pattern of one or two lost rows among the nx + ny, one width
    data = rows[0].contiguous()
    n_patterns = 0
    for m in range(1, ny + 1):
        for lost in itertools.combinations(range(nx + ny), m):
            missing = tuple(i for i in lost if i < nx)
            avail = tuple(j for j in range(ny) if nx + j not in lost)
            _, rec = ops.rs_block_roundtrip(data, ny, missing, avail)
            check(torch.equal(rec, data[list(missing)]),
                  f"erasure pattern {lost} not recovered")
            n_patterns += 1
    torch.cuda.synchronize()
    return records, n_patterns


def uno_stacked_grads(cfg, n_pods: int, dev, seed: int):
    """Pod-stacked gradients of every parameter of `cfg`: N(0, 1) x 1e-3
    from a seeded generator on the card, cast to the parameter dtype."""
    import torch
    from repro_torch.models import params as P
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves, treedef = P.flatten(P.param_defs(cfg))
    return P.unflatten(treedef, [
        (torch.randn((n_pods, *d.shape), device=dev, generator=g) * 1e-3
         ).to(d.dtype) for d in leaves])


def unorc_sync_phase(dev, card, cfg, n_syncs: int = UNO_SYNCS):
    """The UnoRC gradient sync at each pod count of UNO_PODS: the kernel
    path `uno_sync:<arch>:p<p>:cuda` and the plain one on the card,
    checked and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import uno_collectives as U
    from repro_torch.kernels import ref
    from repro_torch.models import params as P

    run = RunConfig()
    defs = P.flatten(P.param_defs(cfg))[0]
    n_params = P.param_count(P.param_defs(cfg))
    out_runs = []
    for p in UNO_PODS:
        stacked = uno_stacked_grads(cfg, p, dev, seed=100 + p)
        sync = U.make_uno_grad_sync(cfg, run, p, device=dev)
        plain = U.make_uno_grad_sync(cfg, run, p, device=dev,
                                     backend="plain")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = drive(uno_path(p), lambda: sync(stacked))
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out_plain = drive(uno_path(p, "plain"), lambda: plain(stacked),
                          plain=True)
        sends = run.uno_chunks * (1 if p == 2 else 2 * (p - 1))
        want = {"quant_int8": sends, "gf_matmul/encode": sends,
                "gf_matmul/decode": sends}
        if p == 2:
            want["dequant_int8/acc"] = sends
        else:
            want["dequant_int8/acc"] = want["dequant_int8"] = sends // 2
        check(PATHS[uno_path(p)] == want,
              f"{uno_path(p)} launched {PATHS[uno_path(p)]}, want {want}")
        leaves = P.flatten(out)[0]
        for o, o_plain, d in zip(leaves, P.flatten(out_plain)[0], defs):
            check(o.dtype == d.dtype and tuple(o.shape) == d.shape,
                  f"p={p}: leaf {tuple(o.shape)} {o.dtype} vs {d}")
            check(bool(torch.isfinite(o).all()), f"p={p}: non-finite leaf")
            check(torch.equal(o, o_plain), f"p={p}: kernels vs plain differ")
        again = P.flatten(sync(stacked))[0]
        check(all(torch.equal(a, b) for a, b in zip(leaves, again)),
              f"p={p}: two syncs differ")
        # against the float64 pod mean
        flat, _ = U._flatten(stacked, p)
        got = torch.cat([o.reshape(-1).double() for o in leaves])
        mean = flat.double().mean(dim=0)
        err = (got - mean).abs()
        acc = dict(max_abs_err=float(err.max()),
                   max_rel_err=float(err.max() / mean.abs().max()))
        if p == 2:
            # half a quant step of the partner's block, halved by the
            # mean, plus the bf16 rounding of the output
            _, sc = ref.quant_int8_ref(F.pad(flat[1], (0, (-n_params) % 256)))
            step = sc.repeat_interleave(256)[:n_params].double()
            bound = 0.25 * step * (1 + 2.0 ** -20) + 2.0 ** -8 * got.abs() \
                + 2.0 ** -20 * mean.abs()
            acc["max_err_over_bound"] = float((err / bound).max())
            check(acc["max_err_over_bound"] <= 1.0,
                  f"p=2: outside the int8 bound {acc}")
        else:
            check(acc["max_rel_err"] <= UNO_P4_RTOL,
                  f"p={p}: relative error {acc['max_rel_err']}")
        del flat, got, mean, err, again
        times = []
        for _ in range(n_syncs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sync(stacked)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        plain_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain(stacked)
            torch.cuda.synchronize()
            plain_times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        payload = p * n_params * 4
        out_runs.append(dict(
            arch=UNO_ARCH, n_pods=p, n_params=n_params,
            chunks=run.uno_chunks, ec=[run.uno_ec_data, run.uno_ec_parity],
            chunk_len=uno_chunk_len(n_params, run),
            protected_sends_per_chunk=sends // run.uno_chunks,
            ms_per_sync=ms, ms_per_sync_all=[t * 1e3 for t in times],
            plain_ms_per_sync=statistics.median(plain_times) * 1e3,
            first_sync_s=first_s, payload_bytes=payload,
            payload_gb_per_s=payload / (ms * 1e-3) / 1e9,
            peak_mem_bytes=peak, launches=PATHS[uno_path(p)],
            profile=device_profile(lambda: sync(stacked), 3), **acc))
        del stacked, out, out_plain, leaves
        torch.cuda.empty_cache()
    raw = n_params * 4                  # benchmarks/uno_collectives_bench.py
    q = n_params
    ec = q * (1 + run.uno_ec_parity / run.uno_ec_data) + 4 * n_params // 256
    emit("unorc_sync", **card, runs=out_runs,
         dci_bytes_raw=raw, dci_bytes_uno=int(ec),
         dci_compression_x=raw / ec)


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
    from repro_torch.configs.registry import get_config
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
    build.build_all()
    emit("build", seconds=time.perf_counter() - t0, libraries={
        n: dict(source=str(src.relative_to(ROOT)),
                library=str(build.library_path(n).relative_to(ROOT)),
                nvcc_seconds=build.BUILD_INFO[n]["seconds"],
                ptxas=build.BUILD_INFO[n]["ptxas"])
        for n, src in build.SOURCES.items()})

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
    state, single = main_path(fs, dev, spec_s, compile_s, card)
    shard_records, plan = sharded_phase(fs, dev, card, state, single)
    records += shard_records
    del state, single
    dumbbells(dev, card, fs_mp)
    dynamics_phase(dev, card, records, plan)
    records += sweeps_phase(dev, card)
    records += sharded_grid_phase(fs, dev, card)
    service_phase(dev, card, records)
    uno_cfg = get_config(UNO_ARCH)
    uno_records, n_patterns = unorc_kernel_phase(dev, uno_cfg)
    emit("unorc_kernels", records=uno_records, erasure_patterns=n_patterns)
    unorc_sync_phase(dev, card, uno_cfg)
    records += uno_records
    for rec in records:
        rec["launches"] = PATHS[rec["path"]].get(rec["counter"], 0)
        check(rec["launches"] > 0, f"{rec['name']} never launched on its "
              f"path {rec['path']}")
    RESULTS["launches"] = PATHS
    RESULTS["threefry_calls"] = DRAWS
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
