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
               800k flows, 2,000 + 500 epochs; every output finite,
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

 10b. rel_epoch — (run after phase 10) the reliability kernel
               (`fleet_cuda.rel_epoch`) at both benchmark cells' shapes:
               fault_sweep128's 128 x 100k flows with per-cell ladder
               tables and recovery_sweep64's 64 x 100k with static EC,
               seeded mid-run states: bitwise `rel_step`'s plain version
               on the same card inputs, every field of every flow
               (loss-free flows' recovered bytes exactly 0), the input
               state unwritten, no host sync, two runs bitwise equal;
               median CUDA-event time over
               25 launches beside its byte bound (`rel_epoch_bytes`) and
               the plain version's; then `fault_sweep` and
               `recovery_sweep` at those grids for 20 epochs, one launch
               an epoch (paths `rel:*`);
 10c. lb_update — (run after phase 10b) UnoLB's split update kernel
               (`fleet_cuda.LbUpdate`) at wan_derate16's LB tables, 16
               cells x 500k flows x 8 path slots, seeded on the card
               (empty slots, repaths, per-flow knobs): bitwise
               `cc.lb_update_plain` on the same card inputs, the inputs
               unwritten, no host sync, two runs bitwise equal; median
               CUDA-event time beside its byte bound (`lb_update_bytes`)
               and the plain version's (record path: the main path,
               which launches it once an epoch);
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
 13. train — (run after phase 8) smollm-135m at full width (30 layers,
               d_model 576, vocab 49,152; seeded random weights), a global
               batch of 8 x 1,024 tokens from `synth_batch(seed=0)`,
               AdamW: the baseline step (`train:smollm-135m:base`, no
               kernel) and the Uno step at p = 2 and 4 pods on the card
               (`train:smollm-135m:p{2,4}:cuda`: K3 encode and decode, K4
               and K5 inside every step, each launch count checked), 3
               warm-up and 20 timed steps each from the same seeded
               state: ms/step, tokens/s, peak memory, the sync's share of
               the step (CUDA events around `uno_sync`, and the device
               time of the sync alone over that of a step from
               `torch.profiler`); the loss finite and falling (the
               first batch's loss under the trained params below step
               0's), every
               step's Uno loss within 1e-2 of the baseline's and the
               params after step 1 within 5e-4 (the reference's bars,
               tests/test_collectives.py:52-53); `sync_and_update` on the
               kernels bitwise the plain backend on the same stacked
               gradients; `torch.addcmul` (AdamW's fused multiply-add)
               one rounding and `torch.sqrt` correctly rounded on the
               card; and a restart drill (`ft.Supervisor`, checkpoints
               every 5 steps, `fail_at(12)`, a fresh supervisor resumes:
               the restored state bitwise the one saved at step 9, the
               resumed losses within 1e-3 of the timed p = 2 run's over
               the same steps; save and restore seconds, checkpoint
               bytes).
 14. validate — (run after phase 12) the fluid halves of two
               `fleetsim.validate` comparisons, the 2-flow dumbbell of
               `compare_steady_state(1, 1)` and the k=4 cross-pod incast
               of `compare_fat_tree_steady_state()`, on the card
               (backend auto: the flat K1 / K2) and on the CPU, 2,000 +
               500 epochs each: rates within 1e-5 x the link rate (the
               fat tree: or 4 x the card's divergence between its kernel
               and plain backends), ms per epoch on each device, the
               kernels launched.  The packet halves run on the port's
               netsim in a child process started before phase 2 that
               imports no torch (`packet_halves`: host seconds, events):
               the 2-flow rates equal the reference's, pinned in
               `VALIDATE_2FLOW_NETSIM`, bit for bit, and the 2-flow
               comparison's error and utilizations are recorded (no
               bar at this depth); then the fault acceptance whole at
               the reference's depth, `compare_fault_recovery()`: packet
               rates over [45, 70) ms equal to `VALIDATE_FAULT_NETSIM`,
               3,214 + 1,786 fluid epochs on the card, agg_rel_err <
               0.10.  K1 / K2 flat held at each of the three layouts as
               in phase 3 (`…@validate_<case>`);
 15. serve — (run after phase 13) smollm-135m served at full width
               (seeded bf16 weights, TF32 off) through
               `launch.serve.serve`: the reference CLI's default mix
               (16 requests of 64 + 32 tokens, batch 8, 2 waves) and a
               long-prompt mix (8 of 1,024 + 128, one wave; a 212 MB KV
               cache): TTFT and inter-token p50, tokens/s, wall seconds,
               prefill ms, peak memory, device kernels, busy and idle per
               decode step (a profile of 10 steps); completions bitwise
               equal across two runs, logits finite; and the serving
               example's reduced qwen2.5 in float32 on the card against
               the CPU (prefill and decode logits within 1e-4
               normalized, the 12 requests' greedy completions token for
               token).  The serving path launches no hand-written kernel.
 16. families — (run after phase 15) the MoE, SSM and hybrid families:
               mamba2-130m at full width and depth (24 layers, d_model
               768, 16 SSD heads of 96, state 128, vocab 50,280; seeded
               weights) trained as in phase 13 (8 x 1,024 tokens, AdamW,
               3 warm-up and 10 timed steps) on the baseline step
               (`train:mamba2-130m:base`) and the Uno step at p = 2
               (`train:mamba2-130m:p2:cuda`: K3 encode and decode, K4 and
               K5 in every step on its gradient of bf16 and float32
               leaves, each held first at one chunk of it), with phase
               13's checks; served on phase 15's two mixes
               (`serve:mamba2-130m:*`; its O(1) state cache beside
               smollm's KV cache); qwen3-moe-235b-a22b at full width (d
               4,096, 64 / 4 heads of 128, 128 experts top-8, expert
               d_ff 1,536, vocab 151,936) with 2 of its 94 layers, the
               one cut (`reduced`), served on the default mix (the
               decode step's byte bound beside it: every expert's
               weights are read) and trained on the baseline step with
               its Muon (bf16 momentum, the state donated), 3 + 5 steps
               of 8 x 1,024 tokens, peak memory; and the reduced mamba2,
               qwen3-moe and jamba in float32 on the card against the
               CPU (prefill and decode logits within 1e-4 normalized,
               greedy completions token for token).
 17. dryrun — (run after phase 16) the cost and roofline tools
               (`launch.dryrun`, `.op_costs`, `.roofline`) checked on the
               card: smollm-135m's baseline train step (phase 13's 8 x
               1,024 tokens, AdamW, `dryrun:train:smollm-135m:base`), its
               Uno step at p = 2 (`…:p2:cuda`, K3-K5 as the
               `torch.ops.repro_torch` custom ops) and one decode step of
               phase 15's long mix, each traced on meta and run on the
               card under the op counter: flops, bytes, the op multiset
               and the K3-K5 launches equal (the counter's launches also
               equal to the wrappers' LAUNCHES), the counted peak within
               10 % of `torch.cuda.max_memory_allocated` (less what was
               allocated before other than the arguments), ms/step
               against the roofline bound, its fraction and dominant
               term; then the records of the dry run of every SHAPES
               cell of smollm-135m, mamba2-130m and qwen3-moe-235b-a22b
               at full size and of their Uno train cells (on meta, in 4
               child processes that see no card, after every timing of
               the run; seconds per cell) and the report's table.

 18. mesh — (run after phase 17) the batch axes of the mesh:
               smollm-135m at full width (phase 13's seeded weights and
               8 x 1,024-token batch) with its 30 layers through the
               stacked GPipe pipeline (`transformer.loss_fn` with
               `pipeline.pipeline_layers`: the embedding outside, the layers on 8 microbatches of
               1 x 1,024 tokens, then the norm, head and chunked loss) at
               S = 2 and 5 stages, forward and backward, against the same
               layers run one microbatch after another (S = 1): loss and
               every gradient bitwise; the loss within 1e-4 of `loss_fn`
               on the whole batch; ms/step (one warm-up, 1 timed),
               bubble fraction, peak memory, a device profile of one
               S = 5 pass (kernels, busy, idle); the bytes one stage boundary
               carries per step each way (the bf16 activations the
               forward hands across, and their gradients back) beside
               `uno_collectives.wire_bytes` at p = 2 for the same model
               (paths `mesh:smollm-135m:pipeline:S*`, no kernel); then
               `launch.train` at full width for 3 steps under torchrun
               with one rank (`--mesh 1x1x1`: a set-up and drive check
               of the group, the DeviceMesh on cuda, the data shard, the
               replication check and the step's all-reduces through NCCL
               on the card, each the identity at one rank) and without a
               group, the losses bitwise equal; the state is placed as
               DTensors on the 1-rank mesh;
 19. mesh_weights — the weight axes: rank 0's program of granite-8b x
               train_4k (full width and depth, 36 layers; 8 x 4,096
               tokens a device) on the (2, 16, 16) pod x data x model
               mesh over a `fake` process group of 512 ranks, the params
               and AdamW state DTensors placed by `state_pspecs`, the
               baseline and the Uno step at 2 pods (K3-K5 on rank 0's
               local gradient blocks, path
               `dryrun:multipod:train:granite-8b:uno:cuda`).  The fake
               group's collectives move no data, so no value is checked:
               each step traced on meta and run on the card under the op
               counter after a warm-up each (the same ops, flops, bytes
               and K3-K5 launches; the counted peak within 10 % of the
               allocator's), ms per local step (median of 3 after a
               warm-up; collectives move no data), and the collective and
               DCI bytes a device puts on the wire per step; the bound
               on the card leaves the collectives out (`bound_ms_local`),
               beside it the dry run's terms with them priced
               (`bound_ms_multipod`).  Then K3-K5 on one chunk of the
               Uno ring's vector at that path's shape (rank 0's local
               gradient blocks, one pod row) against their plain
               versions, timed (records `*@multipod`).

Every path that phases 4 to 6, 8 to 12 and 13 to 19 drive runs with the launch
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

import atexit
import json
import math
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
SWEEP_WARM, SWEEP_MEAS = 2_000, 500    # cut from 4,000 + 1,000 (time)
SWEEP_DT = 14_000.0          # the dumbbell's epoch, its intra RTT (ns)
SWEEP_AGREE_FAILS = (50, 200)            # fail epochs
SWEEP_AGREE_RTTS = 1.0                   # 143-epoch fault windows
SWEEP_AGREE_WARM, SWEEP_AGREE_MEAS = 300, 100
SWEEP_CHURN = dict(duty_fracs=(0.3, 1.0), mean_on_rtts=(200.0,),
                   n_flows=100_000)
SWEEP_CHURN_WARM, SWEEP_CHURN_MEAS = 800, 200
SWEEP_CHURN_CHECK = 200      # epochs batched vs alone, masks bitwise
# the reliability kernel at the benchmark cells' shapes: fault_sweep128's
# grid (8 fail times x 4 fault kinds x 4 EC policies, the static ones
# padded to the ladder's three rungs: per-cell tables) and
# recovery_sweep64's (4 overloads x 4 static EC geometries x 4 NACK
# holdoffs), 100k inter flows a cell, the NACK batch a quarter RTT
REL_GRIDS = {
    "fault_sweep128": dict(cells=128, policies=(
        ((8, 1),) * 3, ((8, 2),) * 3, ((8, 4),) * 3,
        ((8, 1), (8, 2), (8, 4)))),
    "recovery_sweep64": dict(cells=64, ecs=((4, 1), (8, 1), (8, 2), (8, 4)),
                             holds_rtts=(0.0, 0.5, 1.0, 2.0)),
}
REL_FLOWS = 100_000          # a cell's inter flows
REL_INTER_RTT = 2e6          # ns
REL_RUN_EPOCHS = 20          # epochs of each grid's short run (launch count)
# UnoLB's split update at fat_tree_k8.wan_derate16's LB tables
LB_CELLS, LB_CELL_FLOWS, LB_PATHS = 16, 500_000, 8
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
# train: smollm-135m at full width, a global batch of 8 x 1,024 tokens
# from synth_batch(seed=0), the baseline step and the Uno step at each
# pod count of UNO_PODS from the same seeded state; the reference's bars
# between them (tests/test_collectives.py:52-53); a restart drill
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_WARM, TRAIN_STEPS = 3, 20
TRAIN_RUN = dict(learning_rate=3e-4, warmup_steps=10)
TRAIN_LOSS_ATOL, TRAIN_PARAM_ATOL = 1e-2, 5e-4
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_DRILL_STEPS = 5, 12, 15
TRAIN_RESUME_ATOL = 1e-3

RESULTS: dict = {}
PATHS: dict = {}            # path name -> its launch counts
DRAWS: dict = {}            # path name -> its threefry2x32 calls
# phase 14: the fluid halves of two fleetsim.validate comparisons
VALIDATE_WARM, VALIDATE_MEAS = 2_000, 500  # cut from 5,000 + 500 (time)
VALIDATE_ATOL = 1e-5        # x the link rate: the dumbbell bar
# ... and the packet halves of the 2-flow comparison and of the fault
# acceptance, run by the port's netsim in a child process started before
# the build.  Their per-flow rates as the reference's netsim gives them
# (tests/test_torch_validate_accept.py holds both packages to these)
VALIDATE_2FLOW_NETSIM = ("0x1.a8b54eba30a14p+2", "0x1.229869a71bf18p+2")
VALIDATE_FAULT_NETSIM = (
    "0x1.41b3ff766d44ap+0", "0x1.5b5f4c40cb4c4p+0", "0x1.52fbd07070558p+0",
    "0x1.395083a6124dep-1", "0x1.525ac0c0cfe96p+0", "0x1.f7b1a7d84bb10p+0",
    "0x1.bec6faa5ce056p+0", "0x1.5a07b352a8438p-1")
VALIDATE_FAULT_BAR = 0.10   # agg_rel_err, tests/test_faults.py:386-391
PACKET_OUT = ROOT / "chiprun_out" / "validate_packet.json"
PACKET_WAIT_S = 300
# phase 15: smollm-135m serving at full width, seeded bf16 weights
SERVE_ARCH = "smollm-135m"
SERVE_MIXES = {             # the reference CLI's defaults; 8 x 1,024 + 128
    "defaults": dict(requests=16, prompt=64, gen=32, batch=8),
    "long": dict(requests=8, prompt=1024, gen=128, batch=8)}
SERVE_PROFILE_STEPS = 10
SERVE_CARD_RTOL = 1e-4      # reduced qwen2.5 f32, card against CPU
# phase 16: the MoE, SSM and hybrid families.  mamba2-130m whole (24
# layers, d_model 768, 16 SSD heads of 96, state 128), trained as smollm
# is (fewer timed steps) and served on SERVE_MIXES; qwen3-moe at full
# width with 2 of its 94 layers (one layer's experts alone are 4.8 GB of
# bf16; training 94 needs expert or pipeline sharding over several cards)
FAM_SSM = "mamba2-130m"
FAM_MOE = "qwen3-moe-235b-a22b"
FAM_MOE_LAYERS = 2
FAM_WARM, FAM_STEPS = 3, 10
FAM_MOE_STEPS = 5
FAM_REDUCED = ("mamba2-130m", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b")

# phase 17: the cost and roofline tools (launch.dryrun) on the card
DRY_ARCHS = ("smollm-135m", "mamba2-130m", "qwen3-moe-235b-a22b")
DRY_PEAK_RTOL = 0.10        # counted peak against max_memory_allocated
DRY_TIMED = 3               # timed steps after the counted one
DRY_PROCS = 8               # child processes of the dry run (8 cores)
DRY_WAIT_S = 600            # the dry run's children, at most
DRY_DIR = ROOT / "chiprun_out" / "dryrun_torch"
DRY_PATHS = {"base": f"dryrun:train:{UNO_ARCH}:base",
             "p2": f"dryrun:train:{UNO_ARCH}:p2:cuda",
             "decode": f"dryrun:serve:{SERVE_ARCH}:long:decode"}

# phase 18: the batch axes of the mesh.  smollm-135m's 30 layers through
# the stacked GPipe pipeline at S = 2 and 5 stages (phase 13's batch as 8
# microbatches of 1 x 1,024 tokens), against the layers run one
# microbatch after another (S = 1, bitwise) and loss_fn on the whole
# batch; then launch.train over a 1-rank NCCL group against no group
MESH_STAGES = (2, 5)
MESH_MICRO = 8
MESH_TIMED = 1              # timed pipeline steps after one warm-up
MESH_LOSS_RTOL = 1e-4       # pipeline loss against loss_fn, whole batch
MESH_NCCL_STEPS = 3
MESH_NCCL_TIMEOUT_S = 300

# phase 19: the weight axes.  Rank 0's program of granite-8b x train_4k
# on the multi-pod mesh over a fake process group, baseline and Uno
MESHW_ARCH = "granite-8b"
MESHW_SHAPE = "train_4k"
MESHW_TIMED = 3             # timed steps after a warm-up
MESHW_PATHS = {"base": f"dryrun:multipod:train:{MESHW_ARCH}:base",
               "uno": f"dryrun:multipod:train:{MESHW_ARCH}:uno:cuda"}

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
    check(per_epoch.get("lb_update") == 1.0,
          f"{MAIN_PATH}: UnoLB's kernel per epoch {per_epoch}")
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


# ------------------------------------------------------------ rel_epoch

def rel_grid_params(tag: str, dev):
    """RelParams of a benchmark cell's grid (`REL_GRIDS`), stacked as
    `sweeps.stack_scenarios` stacks them."""
    from repro_torch.fleetsim import make_rel_params
    from repro_torch.fleetsim import sweeps as SW
    g = REL_GRIDS[tag]
    period = max(int(round(0.25 * REL_INTER_RTT / SWEEP_DT)), 1)
    if "policies" in g:
        pol = g["policies"]
        rels = [make_rel_params(REL_FLOWS, ladder=pol[b % len(pol)],
                                nack_period=period, device=dev)
                for b in range(g["cells"])]
    else:
        combos = [(ec, h) for ec in g["ecs"] for h in g["holds_rtts"]]
        rels = [make_rel_params(
            REL_FLOWS, ec=combos[b % len(combos)][0], nack_period=period,
            nack_hold=int(round(combos[b % len(combos)][1] * REL_INTER_RTT
                                / SWEEP_DT)), device=dev)
            for b in range(g["cells"])]
    return SW._stack_rel(rels)


def rel_epoch_inputs(rel, dev, seed: int = 30):
    """A mid-run reliability phase: seeded state and flow inputs for
    `rel`, a quarter of the flows loss-free, one path."""
    import torch
    from repro_torch.fleetsim import reliability as R
    n = rel.enabled.numel()
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((n, *shape), device=dev,
                                           generator=gen)

    def i(hi):
        return torch.randint(0, hi, (n,), device=dev, generator=gen,
                             dtype=torch.int32)
    n_rungs = 1 if rel.ladder_k is None else rel.ladder_k.shape[-1]
    st = R.RelState(
        pending=u(0, 9e3), backlog=u(0, 5e4), ack_cd=i(40), hold=i(3),
        md_cd=u(0, 2e6) * (i(4) > 0), rtx_ewma=u(0, 1), lat_ewma=u(0, 3e6),
        nacks=u(0, 90).round(), rec_bytes=u(0, 1e8), rtx_bytes=u(0, 1e8),
        wire_bytes=u(0, 1e10), lost_bytes=u(0, 1e8), rung=i(n_rungs),
        loss_ewma=u(0, 0.06), adapt_cd=u(0, 2e6) * (i(3) > 0))
    sub_loss = u(0, 0.08, 1) * (i(4) > 0)[:, None]
    rate = u(0, 12.5)
    rtt = torch.full((n,), REL_INTER_RTT, device=dev)
    rtx = R.rtx_rate(rel, st, rate, rtt)
    dt = torch.tensor(SWEEP_DT, device=dev)
    return (rel, st, rate, rtx, torch.ones((n, 1), device=dev), sub_loss,
            u(0.3, 1.0), dt, rtt)


def rel_epoch_bytes(rel, n_paths: int) -> int:
    """The bytes one reliability phase needs, each read or written once:
    per flow rate, rtx, sc and rtt, split and loss on each path, enabled,
    the NACK period, holdoff and quantum, the RelState read and written
    (15 fields with a ladder, 12 without), the cut and the goodput; with
    a ladder also adapt_on; each flow that reads its own geometry (no
    ladder, or not adapting) its k, r, eff and coef[1..r]; the ladder
    tables once."""
    import torch
    n = rel.enabled.numel()
    ladder = rel.ladder_k is not None
    state = 15 if ladder else 12
    per_flow = 4 * 4 + 2 * 4 * n_paths + 1 + 3 * 4 + 2 * 4 * state + 1 + 4
    total = n * (per_flow + (1 if ladder else 0))
    own = ~rel.adapt_on if ladder else torch.ones_like(rel.enabled)
    total += 12 * int(own.sum()) + 4 * int(rel.ec_r[own].sum())
    if ladder:
        total += 4 * sum(getattr(rel, f).numel() for f in (
            "ladder_k", "ladder_r", "ladder_eff", "ladder_coef",
            "ladder_up", "ladder_down"))
    return total


def rel_epoch_errors(args, got, want) -> dict:
    """The kernel's outputs against the plain version's, which it matches
    bit for bit (fleet_kernels.cu sums in torch.sum's order): the fields
    that differ, with the flows and the largest relative difference of
    each, and whether the loss-free flows' recovered bytes stay exactly
    what they were."""
    import torch
    st, split, sub_loss = args[1], args[4], args[5]
    (new, cut, gp), (w_new, w_cut, w_gp) = got, want
    differ = {}
    for f, g, w in [*zip(new._fields, new, w_new), ("cut", cut, w_cut),
                    ("goodput", gp, w_gp)]:
        if not torch.equal(g, w):
            g, w = g.double(), w.double()
            differ[f] = dict(flows=int((g != w).sum()), max_rel=float(
                ((g - w).abs() / w.abs().clamp(min=1e-30)).max()))
    zero = split[:, 0] * sub_loss[:, 0] == 0.0
    return dict(bitwise_equal=not differ, differ=differ,
                loss_free_exact=bool(torch.equal(new.rec_bytes[zero],
                                                 st.rec_bytes[zero])))


def rel_epoch_phase(dev, card):
    """The reliability kernel at both benchmark cells' shapes (`rel_epoch`
    line): against the plain version (`rel_epoch_errors`), the input state
    unwritten, no host sync, time and device time beside its byte bound
    and the plain version's; then each grid's program (`fault_sweep`,
    `recovery_sweep`) for REL_RUN_EPOCHS epochs, one launch an epoch.
    Returns the records."""
    import torch
    from repro_torch.fleetsim import reliability as R
    from repro_torch.fleetsim import sweeps as SW
    from repro_torch.kernels import fleet_cuda as K

    t_phase = time.perf_counter()
    records, runs = [], {}
    for tag in REL_GRIDS:
        rel = rel_grid_params(tag, dev)
        args = rel_epoch_inputs(rel, dev)
        st0 = type(args[1])(*(t.clone() for t in args[1]))
        form = "static" if rel.ladder_k is None else "ladder"
        counter = "rel_epoch/" + form
        K.reset_launches()
        got = R.rel_step(*args)
        check(K.LAUNCHES[counter] == 1, f"rel_epoch@{tag}: {K.LAUNCHES}")
        want = R.rel_step(*args, plain=True)
        errs = rel_epoch_errors(args, got, want)
        check(errs["bitwise_equal"] and errs["loss_free_exact"],
              f"rel_epoch@{tag}: {errs}")
        again = R.rel_step(*args)
        repeat = all(bool(torch.equal(a, b)) for a, b in zip(
            (*got[0], *got[1:]), (*again[0], *again[1:])))
        unwritten = all(bool(torch.equal(a, b))
                        for a, b in zip(args[1], st0))
        check(repeat and unwritten, f"rel_epoch@{tag}: repeat {repeat}, "
              f"input unwritten {unwritten}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            R.rel_step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        del got, want, again, st0
        n_bytes = rel_epoch_bytes(rel, 1)
        path = f"rel:{tag}:cuda"
        records.append(dict(
            name=f"rel_epoch/{form}@{tag}", route="cuda",
            source="src/repro_torch/kernels/csrc/fleet_kernels.cu",
            replaces="none (reliability.py is jnp, fused by XLA)",
            launches=0, path=path, counter=counter, max_abs_err=None,
            **errs, ms=time_ms(lambda: R.rel_step(*args)),
            plain_ms=time_ms(lambda: R.rel_step(*args, plain=True)),
            bound_ms=bound_ms(n_bytes), bound_by="bytes", library_ms=None,
            bytes=n_bytes, flows=rel.enabled.numel(),
            bytes_per_flow=n_bytes / rel.enabled.numel(),
            **call_profile(lambda: R.rel_step(*args)),
            plain_profile=call_profile(
                lambda: R.rel_step(*args, plain=True))))
        del args, rel
        # the grid's own program: one launch an epoch
        kw = dict(n_inter=REL_FLOWS, n_warm=REL_RUN_EPOCHS // 2,
                  n_meas=REL_RUN_EPOCHS - REL_RUN_EPOCHS // 2, device=dev)
        if tag == "fault_sweep128":
            fn = lambda: SW.fault_sweep(  # noqa: E731
                [100 * SWEEP_DT * (i + 1) for i in range(8)],
                ["down", "brownout", "flap", "burst"],
                REL_GRIDS[tag]["policies"], fault_rtts=5.0, **kw)
        else:
            fn = lambda: SW.recovery_sweep(  # noqa: E731
                [1.0, 1.5, 2.0, 3.0], REL_GRIDS[tag]["ecs"],
                REL_GRIDS[tag]["holds_rtts"], **kw)
        t0 = time.perf_counter()
        drive(path, fn)
        runs[path] = dict(seconds=time.perf_counter() - t0,
                          epochs=REL_RUN_EPOCHS, launches=PATHS[path])
        check(PATHS[path].get(counter) == REL_RUN_EPOCHS,
              f"{path}: {PATHS[path]}")
    emit("rel_epoch", **card, records=records, runs=runs,
         seconds=time.perf_counter() - t_phase)
    return records


# ------------------------------------------------------------ lb_update

def lb_update_inputs(dev, n: int, n_paths: int, seed: int = 33):
    """(lb, fb, mask, split, path_frac, sub_frac, bad_count) for `n`
    flows over `n_paths` slots, drawn on the card: a tenth of the slots
    empty (slot 0 always a path), marks and filter gains over [0, 1),
    bad counts 0-3 against patiences 1-4, so that repaths fire."""
    import torch
    from repro_torch.fleetsim.state import LbParams
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev)  # noqa: E731
    mask = u(n, n_paths) < 0.9
    mask[:, 0] = True
    split = u(n, n_paths) * mask
    split = split / split.sum(dim=1, keepdim=True)
    lb = LbParams(eta=0.5 + 19.5 * u(n), repath_thresh=0.05 + 0.55 * u(n),
                  repath_patience=(1 + 4 * u(n)).int(),
                  w_floor=0.1 * u(n), ec_eff=torch.ones(n, device=dev))
    return (lb, u(n), mask, split, u(n, n_paths), u(n, n_paths),
            (4 * u(n, n_paths)).int() * mask)


def lb_update_bytes(n: int, n_paths: int) -> int:
    """The bytes one LB phase needs, each read or written once: per flow
    split, path_frac, sub_frac and bad_count read and path_frac', split'
    and bad_count' written (7 x 4 B a slot), the mask (1 B a slot), fb,
    eta, the repath threshold and patience and w_floor (20 B)."""
    return n * (7 * 4 * n_paths + n_paths + 20)


def lb_update_phase(dev, card):
    """UnoLB's split update kernel at wan_derate16's LB tables (`lb_update`
    line): against the plain version, bitwise, every output of every flow;
    the inputs unwritten, no host sync, two runs bitwise equal; time and
    device time beside its byte bound and the plain version's.  Returns
    the record; its launches are the main path's, one an epoch."""
    import torch
    from repro_torch.fleetsim import cc as C
    from repro_torch.kernels import fleet_cuda as K

    t_phase = time.perf_counter()
    n = LB_CELLS * LB_CELL_FLOWS
    args = lb_update_inputs(dev, n, LB_PATHS)
    lb, fb, mask, *rows = args
    before = [t.clone() for t in rows]
    step = K.LbUpdate(lb, fb, mask)
    K.reset_launches()
    got = step(*rows)
    check(K.LAUNCHES["lb_update"] == 1, f"lb_update: {K.LAUNCHES}")
    want = C.lb_update_plain(*args)
    differ = {}
    for name, g, w in zip(("path_frac", "split", "bad_count"), got, want):
        if not torch.equal(g, w):
            ulps = (g.view(torch.int32).long() - w.view(torch.int32).long())
            differ[name] = dict(slots=int((g != w).sum()),
                                max_ulps=int(ulps.abs().max()))
    again = step(*rows)
    repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    unwritten = all(bool(torch.equal(a, b)) for a, b in zip(rows, before))
    repaths = int(((rows[3] > 0) & (got[2] == 0) & mask).sum())
    check(not differ and repeat and unwritten and repaths > 0,
          f"lb_update: differ {differ}, repeat {repeat}, input unwritten "
          f"{unwritten}, repaths {repaths}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del got, want, again, before
    n_bytes = lb_update_bytes(n, LB_PATHS)
    rec = dict(
        name="lb_update@wan_derate16", route="cuda",
        source="src/repro_torch/kernels/csrc/fleet_kernels.cu",
        replaces="none (cc.update_split is jnp, fused by XLA)",
        launches=0, path=MAIN_PATH, counter="lb_update", max_abs_err=None,
        bitwise_equal=True, repaths=repaths, ms=time_ms(lambda: step(*rows)),
        plain_ms=time_ms(lambda: C.lb_update_plain(*args)),
        bound_ms=bound_ms(n_bytes), bound_by="bytes", library_ms=None,
        bytes=n_bytes, flows=n, paths=LB_PATHS, bytes_per_flow=n_bytes / n,
        **call_profile(lambda: step(*rows)),
        plain_profile=call_profile(lambda: C.lb_update_plain(*args)))
    emit("lb_update", **card, records=[rec],
         seconds=time.perf_counter() - t_phase)
    return [rec]


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
    check(len(main_recs) == 4,
          "main path: three PathTable records and UnoLB's kernel")
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


def sync_launches(run, p: int) -> dict:
    """The UnoRC kernel launches of one sync at p pods: one protected send
    per chunk at p = 2 (the pairwise mean, K5 fused with the add), 2 (p -
    1) per chunk on the ring (half of them adds, half plain dequants)."""
    sends = run.uno_chunks * (1 if p == 2 else 2 * (p - 1))
    want = {"quant_int8": sends, "gf_matmul/encode": sends,
            "gf_matmul/decode": sends}
    if p == 2:
        want["dequant_int8/acc"] = sends
    else:
        want["dequant_int8/acc"] = want["dequant_int8"] = sends // 2
    return want


def uno_chunk_len(n_params: int, run) -> int:
    """One chunk of the sync's flat vector: padded to uno_chunks x
    uno_ec_data x 256, as `_pod_ring_psum` pads it."""
    unit = run.uno_chunks * run.uno_ec_data * 256
    return -(-n_params // unit) * unit // run.uno_chunks


def unorc_kernel_phase(dev, cfg, n_pods: int = 2, path_p2: str = "",
                       tag: str = "", extended: bool = True,
                       n_values: int = 0, rows: int = 0):
    """Every UnoRC kernel use against its plain version on the card at the
    shapes of one chunk of the p = 2 sync, K3 also at one part of a chunk
    of the p = 4 ring, and the 55 erasure patterns;
    returns the per-kernel records (`path`/`counter` as in
    `kernel_phase`) and the pattern count.  The p = 2 records count the
    launches of `path_p2` (default `uno_path(2)`) and carry `tag` in
    their names; without `extended` only the four uses of a p = 2 sync
    (K4, K3 encode and decode, K5 fused with the add) are held.
    `n_values` (default: cfg's parameter count) is the length of the
    synced vector and `rows` (default n_pods) the pod rows a rank holds:
    one on a rank of a pod group."""
    import itertools
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import gf, ops, ref
    from repro_torch.kernels import unorc_cuda as K
    from repro_torch.models import params as P

    run = RunConfig()
    nx, ny = run.uno_ec_data, run.uno_ec_parity
    c = uno_chunk_len(n_values or P.param_count(P.param_defs(cfg)), run)
    rows_here = rows or n_pods
    g = torch.Generator(device=dev).manual_seed(4321)
    x = torch.randn(rows_here, c, device=dev, generator=g) * 1e-3
    x[:, 5 * 256:6 * 256] = 0.0          # zero blocks: scale 1, q 0
    x[-1, :256] = 0.0
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

    p2 = path_p2 or uno_path(2)
    nb = c // 256
    q, s = record("quant_int8", p2,
                  "src/repro/kernels/quant_pallas.py:36",
                  lambda: K.quant_int8(x), lambda: ref.quant_int8_ref(x),
                  rows_here * (4 * c + c + 4 * nb), rows_here * c,
                  name=f"quant_int8{tag}")
    check(bool((s[:, 5] == 1.0).all()) and float(s[-1, 0]) == 1.0,
          "quant_int8: zero blocks must have scale 1")
    rows = q.view(torch.uint8).reshape(rows_here, nx, -1)
    width = rows.shape[-1]
    enc = gf.rs_generator_rows(nx, ny)
    parity = record("gf_matmul/encode", p2,
                    "src/repro/kernels/rs_pallas.py:56",
                    lambda: K.gf_matmul(rows, enc, use="encode"),
                    lambda: ref.gf_matmul_ref(enc, rows),
                    rows_here * (nx + ny) * width,
                    name=f"gf_matmul/encode{tag}")
    surv = torch.cat([rows[:, ny:], parity], dim=1)
    dec = gf.rs_decode_matrix(nx, ny, tuple(range(ny)), tuple(range(ny)))
    rebuilt = record("gf_matmul/decode", p2,
                     "src/repro/kernels/rs_pallas.py:56",
                     lambda: K.gf_matmul(surv, dec, use="decode"),
                     lambda: ref.gf_matmul_ref(dec, surv),
                     rows_here * (nx + ny) * width,
                     name=f"gf_matmul/decode{tag}")
    check(torch.equal(rebuilt, rows[:, :ny]), "decode: rows {0, 1} lost")
    xb = x.view(rows_here, nb, 256)
    qb, sb = q.view(rows_here, nb, 256), s[..., None]
    record("dequant_int8/acc", p2,
           "src/repro/kernels/quant_pallas.py:59",
           lambda: K.dequant_int8(q, s, x),
           lambda: ref.dequant_int8_ref(q, s, acc=x),
           rows_here * (c + 4 * nb + 8 * c), 2 * rows_here * c,
           library=lambda: torch.addcmul(xb, qb, sb),
           name=f"dequant_int8/acc{tag}")
    if not extended:
        torch.cuda.synchronize()
        return records, 0
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
    record("dequant_int8", uno_path(4), "src/repro/kernels/quant_pallas.py:59",
           lambda: K.dequant_int8(q, s), lambda: ref.dequant_int8_ref(q, s),
           rows_here * (c + 4 * nb + 4 * c), rows_here * c,
           library=lambda: torch.mul(qb, sb))
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
        want = sync_launches(run, p)
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
    ec = U.wire_bytes(n_params, run, 2)  # one pod's frames, padded chunks
    emit("unorc_sync", **card, runs=out_runs,
         dci_bytes_raw=raw, dci_bytes_uno=ec,
         dci_compression_x=raw / ec)


# ------------------------------------------------------------- phase 13

def train_path(p: int, arch: str = UNO_ARCH) -> str:
    return f"train:{arch}:p{p}:cuda"


def _train_batches(cfg, dev, n, start=0):
    from repro_torch.data import synth_batch
    return [{k: v.to(dev) for k, v in synth_batch(
        cfg, start + i, TRAIN_BATCH, TRAIN_SEQ, seed=0).items()}
        for i in range(n)]


def _train_run(step, state, batches, snap: bool = True):
    """Every batch through `step` (step_idx = its index), one host-clock
    time per step to a synchronize; returns the state, the losses, the
    seconds per step and (with `snap`) a copy of the params after step 1."""
    import torch
    from repro_torch.models import params as P
    losses, secs, snapped = [], [], None
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 1 and snap:
            snapped = [t.clone() for t in P.flatten(state["params"])[0]]
    return state, losses, secs, snapped


def _states_equal(a, b) -> bool:
    import torch
    from repro_torch.models import params as P
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(P.flatten(a)[0], P.flatten(b)[0]))


def _clone(tree):
    from repro_torch.models import params as P
    leaves, treedef = P.flatten(tree)
    return P.unflatten(treedef, [t.clone() for t in leaves])


def _fma_on_card(dev) -> dict:
    """The port's AdamW contracts as XLA does: `optim.fma32`
    (torch.addcmul) must round once on the card, and `_sqrt32` be the
    correctly rounded root; both against their float64 definitions,
    on 16M random triples and on ties a second rounding breaks."""
    import torch
    from repro_torch import optim
    g = torch.Generator(device=dev).manual_seed(7)
    a, b, c = (torch.randn(1 << 24, device=dev, generator=g)
               for _ in range(3))
    k = torch.tensor([0.0, 5.0, -7.0, 20.0], device=dev, dtype=torch.float64)
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev,
                        dtype=torch.float64)
    a = torch.cat([a, (sign * 2.0 ** -24 * (1 + 2.0 ** -23) * 2.0 ** k)
                   .float()])
    b = torch.cat([b, torch.full((4,), 1 - 2.0 ** -23, device=dev)])
    c = torch.cat([c, ((1 + 2.0 ** -23) * 2.0 ** k).float()])
    fma_ok = torch.equal(optim.fma32(a, b, c), optim.fma32_exact(a, b, c))
    v = a.abs()
    sqrt_ok = torch.equal(optim._sqrt32(v),
                          torch.sqrt(v.double()).float())
    check(fma_ok, "torch.addcmul is not one rounding on the card")
    check(sqrt_ok, "torch.sqrt is not correctly rounded on the card")
    return dict(n=int(a.numel()), fma32_single_rounding=fma_ok,
                sqrt_correctly_rounded=sqrt_ok)


def _restart_drill(cfg, run, dev, uninterrupted) -> dict:
    """ft.Supervisor on the p = 2 Uno step: checkpoints every
    TRAIN_CKPT_EVERY steps, fail_at(TRAIN_FAIL_AT) interrupts it, a fresh
    supervisor resumes (bitwise the state saved at the last checkpoint)
    and its losses hold those of an uninterrupted run over the same
    steps within TRAIN_RESUME_ATOL.  `uninterrupted`: the losses of the
    timed p = 2 run (the same seed, batches and step)."""
    import pathlib
    import tempfile
    import torch
    from repro_torch import ckpt, data, ft, train

    step = train.make_train_step(cfg, run, n_pods=2, device=dev)
    fresh = lambda: train.make_train_state(cfg, seed=0, device=dev)
    saved_at = (TRAIN_FAIL_AT // TRAIN_CKPT_EVERY) * TRAIN_CKPT_EVERY - 1
    snap, losses, save_s = {}, {}, []

    def keep(state, batch, i):
        state, m = step(state, batch, i)
        if i == saved_at:
            snap["state"] = _clone(state)
        return state, m

    def on(tag):
        return lambda i, m, w: losses.setdefault(tag, {}).__setitem__(
            i, float(m["loss"]))

    real_save = ckpt.save

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = real_save(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return out

    pipe = lambda start=0: data.ShardedPipeline(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0, start_step=start,
        device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ftc = ft.FTConfig(ckpt_dir=tmp, ckpt_every=TRAIN_CKPT_EVERY,
                          async_ckpt=False)
        ckpt.save = timed_save
        try:
            with pipe() as batches:
                sup = ft.Supervisor(ftc, state_template=fresh())
                failed = False
                try:
                    sup.run(fresh(), keep, iter(batches),
                            n_steps=TRAIN_DRILL_STEPS,
                            inject=ft.fail_at(TRAIN_FAIL_AT),
                            on_metrics=on("interrupted"))
                except ft.InjectedFailure:
                    failed = True
        finally:
            ckpt.save = real_save
        check(failed, "restart drill: the injected failure did not fire")
        latest = ckpt.latest_step(tmp)
        check(latest == saved_at, f"restart drill: latest checkpoint "
              f"{latest}, want {saved_at}")
        ckpt_bytes = sum(f.stat().st_size for f in
                         (pathlib.Path(tmp) / f"step_{latest}").iterdir())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ckpt.restore(tmp, latest, fresh())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bitwise = _states_equal(restored, snap.pop("state"))
        check(bitwise, "restart drill: the restored state differs from "
              f"the state saved at step {saved_at}")
        del restored
        start = latest + 1
        sup2 = ft.Supervisor(ftc, state_template=fresh())
        with pipe(start) as batches:
            _, last = sup2.run(fresh(), step, iter(batches),
                               n_steps=TRAIN_DRILL_STEPS,
                               on_metrics=on("resumed"))
        check({"kind": "resume", "step": latest} in sup2.events,
              f"restart drill: no resume from step {latest}")
    diffs = {i: abs(losses["resumed"][i] - uninterrupted[i])
             for i in losses["resumed"]}
    check(last == TRAIN_DRILL_STEPS and sorted(diffs) == list(
        range(start, TRAIN_DRILL_STEPS)), "restart drill: wrong steps")
    check(max(diffs.values()) <= TRAIN_RESUME_ATOL,
          f"restart drill: resumed losses off by {max(diffs.values())}")
    return dict(ckpt_every=TRAIN_CKPT_EVERY, fail_at=TRAIN_FAIL_AT,
                saved_at=saved_at, resumed_at=start,
                restored_bitwise=bitwise, save_s=save_s,
                restore_s=restore_s, ckpt_bytes=ckpt_bytes,
                max_resumed_loss_diff=max(diffs.values()),
                resumed_losses=losses["resumed"],
                uninterrupted_losses=uninterrupted[start:TRAIN_DRILL_STEPS],
                events=sup.events + sup2.events)


def progress(what: str, rec: dict):
    """One line of a phase's progress (ms/step, losses, memory) on
    stdout, so that a run that fails a later check still shows it."""
    keys = ("ms_per_step", "tokens_per_s", "peak_mem_bytes", "sync_ms",
            "max_loss_diff", "param_diff_after_step1", "held_loss",
            "losses", "wall_ms", "agg_rel_err",
            "device_kernels", "device_busy_ms_per_call",
            "busy_ms_by_kind", "bound_ms", "roofline_fraction",
            "counted_peak_bytes", "card_counted_peak_bytes",
            "allocated_peak_bytes", "peak_gap")
    print(json.dumps({"progress": what,
                      **{k: rec[k] for k in keys if k in rec}}), flush=True)


def _falls(cfg, batch, losses, params, rec, what):
    """Finite losses, and the loss of the first batch lower under the
    trained params than under the initial ones (step 0's loss): one
    batch before and after, so that no batch-to-batch spread enters."""
    import torch
    from repro_torch import models
    check(all(math.isfinite(x) for x in losses), f"{what}: non-finite")
    with torch.no_grad():
        rec["held_loss"] = [losses[0],
                            float(models.loss_fn(params, batch, cfg))]
    check(rec["held_loss"][1] < rec["held_loss"][0],
          f"{what}: the first batch's loss did not fall "
          f"({rec['held_loss']})")


def train_runs(dev, cfg, run, batches, warm, pods, out):
    """The baseline step and the Uno step at each pod count of `pods`
    (K3-K5 inside the step) from the same seeded state over `batches`,
    the first `warm` untimed; fills out["baseline"] and out["uno"]:
    ms/step, tokens/s, peak memory, the sync's share (events and device
    time), profiles; checks the losses fall, every Uno loss within 1e-2
    of the baseline's, the params after step 1 within 5e-4, each Uno
    path's launch counts, and `sync_and_update` on the kernels bitwise
    the plain backend on the same stacked gradients.  Paths
    `train:<arch>:base` and `train_path(p, arch)`."""
    import torch
    from repro_torch import train
    from repro_torch.models import params as P

    arch = cfg.name
    n = len(batches)
    tokens = batches[0]["targets"].numel()
    timed = slice(warm, n)

    def summary(losses, secs):
        ms = statistics.median(secs[timed]) * 1e3
        return dict(ms_per_step=ms, tokens_per_s=tokens / (ms * 1e-3),
                    ms_per_step_all=[t * 1e3 for t in secs],
                    first_step_s=secs[0], losses=losses)

    base_step = train.make_train_step(cfg, run, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base_state, base_losses, base_secs, base_snap = drive(
        f"train:{arch}:base", lambda: _train_run(
            base_step, train.make_train_state(cfg, seed=0, device=dev),
            batches), plain=True)
    # filled as the runs go, so a failed check leaves what came before it
    out["baseline"] = dict(**summary(base_losses, base_secs),
                           peak_mem_bytes=torch.cuda.max_memory_allocated())
    out["uno"] = {}
    _falls(cfg, batches[0], base_losses, base_state["params"],
           out["baseline"], f"{arch} baseline")
    progress(f"{arch} baseline", out["baseline"])
    out["baseline"]["profile"] = _step_device_profile(
        base_step, cfg, dev, batches[0])
    progress(f"{arch} baseline profile", out["baseline"]["profile"])
    for p in pods:
        step = train.make_train_step(cfg, run, n_pods=p, device=dev)
        events = []
        sync = step.uno_sync

        def timed_sync(stacked, sync=sync, events=events):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            grads = sync(stacked)
            e1.record()
            events.append((e0, e1))
            return grads

        step.uno_sync = timed_sync
        path = train_path(p, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, losses, secs, snap = drive(path, lambda: _train_run(
            step, train.make_train_state(cfg, seed=0, device=dev), batches))
        peak = torch.cuda.max_memory_allocated()
        step.uno_sync = sync
        torch.cuda.synchronize()
        sync_ms = [a.elapsed_time(b) for a, b in events]
        loss_diff = [abs(a - b) for a, b in zip(losses, base_losses)]
        param_diff = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(snap, base_snap))
        sync_med = statistics.median(sync_ms[timed])
        rec = out["uno"][f"p{p}"] = dict(
            **summary(losses, secs), peak_mem_bytes=peak,
            sync_ms=sync_med, sync_ms_all=sync_ms,
            sync_share_event=sync_med / statistics.median(secs[timed])
            / 1e3,
            max_loss_diff=max(loss_diff), loss_diffs=loss_diff,
            param_diff_after_step1=param_diff,
            param_diff_final=max(
                float((a.float() - b.float()).abs().max()) for a, b in
                zip(P.flatten(state["params"])[0],
                    P.flatten(base_state["params"])[0])),
            launches=PATHS[path])
        _falls(cfg, batches[0], losses, state["params"], rec,
               f"{arch} uno p={p}")
        progress(f"{arch} uno p={p}", rec)
        check(max(loss_diff) <= TRAIN_LOSS_ATOL,
              f"{arch} uno p={p}: loss off the baseline's by "
              f"{max(loss_diff)}")
        check(param_diff <= TRAIN_PARAM_ATOL,
              f"{arch} uno p={p}: params after step 1 off by {param_diff}")
        want = {k: v * n for k, v in sync_launches(run, p).items()}
        check(PATHS[path] == want,
              f"{path} launched {PATHS[path]}, want {want}")
        # the Uno update on the kernels and on the plain backend, the
        # same stacked gradients
        _, stacked = step.pod_grads(state["params"], batches[0])
        plain = train.make_train_step(cfg, run, n_pods=p, device=dev,
                                      backend="plain")
        s_k, g_k = step.sync_and_update(state, stacked, n)
        s_p, g_p = drive(f"train:{arch}:p{p}:plain",
                         lambda: plain.sync_and_update(state, stacked, n),
                         plain=True)
        bitwise = _states_equal(s_k, s_p) and _states_equal(g_k, g_p)
        check(bitwise, f"{arch} uno p={p}: sync_and_update on the kernels "
              "differs from the plain backend")
        rec["grad_dtypes"] = sorted({str(g.dtype).removeprefix("torch.")
                                     for g in P.flatten(g_k)[0]})
        prof_sync = device_profile(lambda: step.uno_sync(stacked), 3)
        del s_k, s_p, g_k, g_p, stacked
        prof_step = _step_device_profile(step, cfg, dev, batches[0])
        rec.update(
            sync_device_ms=prof_sync["device_busy_ms_per_call"],
            step_device_ms=prof_step["device_busy_ms_per_call"],
            sync_share_device=prof_sync["device_busy_ms_per_call"]
            / prof_step["device_busy_ms_per_call"]
            if prof_step["device_busy_ms_per_call"] else None,
            profile=prof_step, sync_profile=prof_sync,
            kernels_vs_plain_bitwise=bitwise)
        del state, snap
        torch.cuda.empty_cache()
    del base_state, base_snap
    torch.cuda.empty_cache()


def train_phase(dev, card, cfg, uno_records):
    """smollm-135m training on the card: `train_runs` at each pod count
    of UNO_PODS, then the restart drill.  Returns kernel records for the
    train paths (the unorc_kernels phase's measurements at the same
    shapes, with the train paths' counts)."""
    import torch
    from repro_torch.configs.base import RunConfig

    t_phase = time.perf_counter()
    run = RunConfig(**TRAIN_RUN)
    batches = _train_batches(cfg, dev, TRAIN_WARM + TRAIN_STEPS)
    out = RESULTS["train"] = dict(
        arch=UNO_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        tokens_per_step=TRAIN_BATCH * TRAIN_SEQ, run=TRAIN_RUN,
        warmup_steps=TRAIN_WARM, timed_steps=TRAIN_STEPS,
        fma_check=_fma_on_card(dev))
    train_runs(dev, cfg, run, batches, TRAIN_WARM, UNO_PODS, out)
    records = [dict(r, name=f"{r['name']}@train", path=train_path(p))
               for p in UNO_PODS for r in uno_records
               if r["path"] == uno_path(p)]
    out["restart_drill"] = _restart_drill(cfg, run, dev,
                                          out["uno"]["p2"]["losses"])
    out["seconds"] = time.perf_counter() - t_phase
    emit("train", **card, **out)
    del batches
    torch.cuda.empty_cache()
    return records


def _kernel_kind(name: str) -> str:
    n = name.lower()
    for kind, keys in (("unorc", ("gf_matmul", "quant_int8")),
                       ("gemm_f32", ("gemm_f32", "sgemm")),
                       ("gemm_bf16", ("gemm", "nvjet", "s16816", "cutlass")),
                       ("reduce", ("reduce",)),
                       ("copy_index_cat", ("cat", "copy", "index",
                                           "gather", "scatter", "roll")),
                       ("elementwise", ("elementwise",))):
        if any(k in n for k in keys):
            return kind
    return "other"


def _step_device_profile(step, cfg, dev, batch):
    """One step from a fresh state (after one warm-up step) under
    torch.profiler: device kernels, busy ms, idle share, and the busy
    time by kernel kind (f32 / bf16 GEMMs, elementwise, reductions,
    copies and indexing, the UnoRC kernels)."""
    import torch
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import train
    state = train.make_train_state(cfg, seed=0, device=dev)
    state, _ = step(state, batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds, n_kernels = Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kinds[_kernel_kind(e.name)] += e.time_range.elapsed_us() / 1e3
            n_kernels += 1
    busy = sum(kinds.values())
    return dict(wall_ms=wall * 1e3, device_kernels=n_kernels,
                device_busy_ms_per_call=busy if n_kernels else None,
                device_idle_share=1.0 - busy / (wall * 1e3) if n_kernels
                else None,
                busy_ms_by_kind=dict(kinds.most_common()))


# ------------------------------------------------------------- phase 14

def validate_path(case: str, backend: str = "cuda") -> str:
    return f"validate:{case}:{backend}"


def _cpu_threads(n: int):
    """A context that runs torch on `n` CPU threads (the eager fleet step
    on small tensors is far slower on many)."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def ctx():
        prev = torch.get_num_threads()
        torch.set_num_threads(n)
        try:
            yield
        finally:
            torch.set_num_threads(prev)
    return ctx()


def _packet_cases() -> dict:
    """Phase 14's packet runs: case -> (spec, horizon, t0), the specs of
    `compare_steady_state(1, 1)` and `compare_fault_recovery()` built from
    the scenario layer alone (no torch)."""
    from repro_torch.scenarios import FaultSpec, LbSpec, dumbbell_scenario
    return {
        "dumbbell_2flow": (dumbbell_scenario(
            1, 1, multipath=True, seed=1,
            inter_lb=LbSpec(kind="rps", n_subflows=8)), 45e6, 15e6),
        "fault": (dumbbell_scenario(
            0, 8, multipath=True, n_wan=4,
            inter_lb=LbSpec(kind="unolb", n_subflows=4),
            faults=(FaultSpec(link="wan0", kind="down", t_start=4e6),),
            seed=1), 70e6, 45e6),
    }


def packet_halves(out: str) -> None:
    """The packet halves of phase 14 on the port's netsim (plain Python on
    the host), in a process that imports no torch: per case the per-flow
    rates (hex), the spec's fingerprint, the host seconds, the events
    simulated and the simulated span; JSON into `out`."""
    t_start = time.perf_counter()
    from repro_torch.scenarios import netsim_scenario_rates, spec_fingerprint
    res = {}
    for case, (spec, horizon, t0) in _packet_cases().items():
        info = {}
        t = time.perf_counter()
        rates = netsim_scenario_rates(spec, horizon=horizon, t0=t0,
                                      info=info)
        host_s = time.perf_counter() - t
        res[case] = dict(
            rates=[float(x).hex() for x in rates],
            fingerprint=spec_fingerprint(spec), host_s=host_s,
            events=info["events"], sim_ms=horizon / 1e6,
            t0_ms=t0 / 1e6, events_per_s=info["events"] / host_s,
            host_s_per_sim_ms=host_s / (horizon / 1e6))
    res["imported"] = sorted(m for m in ("torch", "jax", "repro")
                             if m in sys.modules)
    res["wall_s"] = time.perf_counter() - t_start
    pathlib.Path(out).write_text(json.dumps(res))


def _kill(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_packet_halves():
    """`packet_halves` in a child process that sees no card, started
    before the build so that it overlaps it (killed at exit if still
    running); returns (process, log, start time)."""
    import os
    PACKET_OUT.parent.mkdir(parents=True, exist_ok=True)
    if PACKET_OUT.exists():
        PACKET_OUT.unlink()
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log = open(PACKET_OUT.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"packet_halves({str(PACKET_OUT)!r})"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(_kill, proc)
    return proc, log, time.perf_counter()


def wait_packet_halves(packet) -> dict:
    """The child's results (`wall_s`: its own, imports included)."""
    proc, log, t_start = packet
    try:
        rc = proc.wait(timeout=max(1.0, PACKET_WAIT_S
                                   - (time.perf_counter() - t_start)))
    finally:
        _kill(proc)
        log.close()
    check(rc == 0, f"packet halves exited {rc} "
          "(chiprun_out/validate_packet.log)")
    out = json.loads(PACKET_OUT.read_text())
    check(not out["imported"], f"packet child imported {out['imported']}")
    return out


def validate_phase(dev, card, packet):
    """The fluid halves of `compare_steady_state(1, 1)` (the 2-flow
    dumbbell) and `compare_fat_tree_steady_state()` (k=4 cross-pod
    incast) through `fleetsim.validate` on the card (backend auto: the
    flat kernels) and on the CPU at the same depth: per-flow rates within
    1e-5 x the link rate on the dumbbell; on the fat tree within max(1e-5
    x the rate, 4 x the card's own divergence between its kernel and
    plain backends).  The packet halves come from `packet` (the child
    of `start_packet_halves`): the 2-flow rates equal
    `VALIDATE_2FLOW_NETSIM` bit for bit, and the 2-flow comparison's
    error and utilizations are recorded (no bar: the fluid half is not
    at its 220,000-epoch depth).  Then the fault acceptance whole at the
    reference's depth: the port's packet rates over [45, 70) ms (equal to
    `VALIDATE_FAULT_NETSIM`), the fluid half's 3,214 + 1,786 epochs on the
    card, `agg_rel_err` < 0.10.  K1 / K2 flat are held against their
    plain versions at each layout (`…@validate_<case>`).  Returns those
    kernel records."""
    import numpy as np
    import torch
    from repro_torch.fleetsim import links as L
    from repro_torch.fleetsim import validate as V
    from repro_torch.scenarios import spec_fingerprint, to_fleetsim

    t_phase = time.perf_counter()
    pk = wait_packet_halves(packet)
    for case, spec in (("dumbbell_2flow", V.steady_state_spec(1, 1)),
                       ("fault", V.fault_spec())):
        check(pk[case]["fingerprint"] == spec_fingerprint(spec),
              f"validate {case}: the packet child's spec differs")
    check(tuple(pk["dumbbell_2flow"]["rates"]) == VALIDATE_2FLOW_NETSIM,
          f"validate: 2-flow packet rates {pk['dumbbell_2flow']['rates']} "
          "differ from the reference's")
    check(tuple(pk["fault"]["rates"]) == VALIDATE_FAULT_NETSIM,
          f"validate: fault packet rates {pk['fault']['rates']} differ "
          "from the reference's")
    ns = {case: np.array([float.fromhex(h) for h in pk[case]["rates"]])
          for case in ("dumbbell_2flow", "fault")}

    depth = dict(n_warm=VALIDATE_WARM, n_meas=VALIDATE_MEAS)
    epochs = VALIDATE_WARM + VALIDATE_MEAS
    records, runs = [], {}
    for case, spec in (("dumbbell_2flow", V.steady_state_spec(1, 1)),
                       ("fat_tree_k4", V.fat_tree_steady_spec())):
        path = validate_path(case)
        fs = to_fleetsim(spec, device=dev)
        backend = L._resolve_backend(fs.net, "auto")
        check(backend == "cuda", f"validate {case}: auto -> {backend}")
        recs, _ = kernel_phase(fs.net, dev, path, tag=f"@validate_{case}")
        records += recs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if case == "dumbbell_2flow":
            cmp = drive(path, lambda: V.compare_steady_state(
                1, 1, netsim=ns[case], device=dev, **depth))
            card_rates = cmp["fluid"]
        else:
            card_rates = drive(path, lambda: V.fluid_scenario_rates(
                spec, device=dev, **depth))
        card_s = time.perf_counter() - t0
        with _cpu_threads(1):
            t0 = time.perf_counter()
            cpu_rates = V.fluid_scenario_rates(spec, device="cpu", **depth)
            cpu_s = time.perf_counter() - t0
        check(card_rates.shape == (spec.n_flows,)
              and bool(np.isfinite(card_rates).all()),
              f"validate {case}: rates not finite of shape ({spec.n_flows},)")
        err = float(np.max(np.abs(card_rates.astype(np.float64)
                                  - cpu_rates))) / spec.rate
        noise = None
        tol = VALIDATE_ATOL
        if case.startswith("fat_tree"):
            plain = drive(validate_path(case, "reference"),
                          lambda: V.fluid_scenario_rates(
                              spec, device=dev, backend="reference",
                              **depth), plain=True)
            noise = float(np.max(np.abs(card_rates.astype(np.float64)
                                        - plain))) / spec.rate
            tol = max(VALIDATE_ATOL, 4.0 * noise)
        check(err <= tol, f"validate {case}: card vs CPU {err} > {tol}")
        runs[case] = dict(
            n_flows=spec.n_flows, n_links=fs.net.n_links, backend=backend,
            epochs=epochs, card_s=card_s, cpu_s=cpu_s,
            card_ms_per_epoch=card_s / epochs * 1e3,
            cpu_ms_per_epoch=cpu_s / epochs * 1e3,
            rel_err_card_vs_cpu=err, backend_noise=noise, tol=tol,
            util_fluid=float(card_rates.sum() / spec.rate),
            launches=PATHS[path])
        if case == "dumbbell_2flow":
            runs[case]["compare"] = dict(
                netsim=cmp["netsim"].tolist(), fluid=cmp["fluid"].tolist(),
                max_rel_err=cmp["max_rel_err"],
                util_netsim=cmp["util_netsim"],
                util_fluid=cmp["util_fluid"])
        progress(f"validate {case}", dict(wall_ms=card_s * 1e3))

    # ---- the fault acceptance, whole, at the reference's depth
    spec = V.fault_spec()
    path = validate_path("fault")
    fs = to_fleetsim(spec, device=dev)
    backend = L._resolve_backend(fs.net, "auto")
    check(backend == "cuda", f"validate fault: auto -> {backend}")
    records += kernel_phase(fs.net, dev, path, tag="@validate_fault")[0]
    n_warm, n_meas = V.fault_window(spec, 45e6, 70e6, dt=float(fs.net.dt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = drive(path, lambda: V.compare_fault_recovery(
        netsim=ns["fault"], device=dev))
    card_s = time.perf_counter() - t0
    check(bool(np.isfinite(res["fluid"]).all())
          and np.isfinite(res["agg_fluid"]) and res["agg_netsim"] > 0,
          "validate fault: aggregates not finite and positive")
    check(res["agg_rel_err"] < VALIDATE_FAULT_BAR,
          f"validate fault: agg_rel_err {res['agg_rel_err']} >= "
          f"{VALIDATE_FAULT_BAR}")
    runs["fault"] = dict(
        n_flows=spec.n_flows, n_links=fs.net.n_links, backend=backend,
        n_warm=n_warm, n_meas=n_meas, card_s=card_s,
        card_ms_per_epoch=card_s / (n_warm + n_meas) * 1e3,
        agg_netsim=res["agg_netsim"], agg_fluid=res["agg_fluid"],
        agg_rel_err=res["agg_rel_err"], bar=VALIDATE_FAULT_BAR,
        util_netsim=res["util_netsim"], util_fluid=res["util_fluid"],
        netsim=res["netsim"].tolist(), fluid=res["fluid"].tolist(),
        launches=PATHS[path])
    progress("validate fault", dict(wall_ms=card_s * 1e3,
                                    agg_rel_err=res["agg_rel_err"]))
    packet_out = {case: {k: v for k, v in pk[case].items()
                         if k != "fingerprint"}
                  for case in ("dumbbell_2flow", "fault")}
    emit("validate", **card, n_warm=VALIDATE_WARM, n_meas=VALIDATE_MEAS,
         runs=runs, packet=dict(**packet_out, wall_s=pk["wall_s"]),
         seconds=time.perf_counter() - t_phase)
    return records


# ------------------------------------------------------------- phase 15

def serve_path(mix: str, arch: str = SERVE_ARCH) -> str:
    return f"serve:{arch}:{mix}"


def _cache_bytes(cfg, batch: int, max_len: int) -> int:
    """The serving cache's bytes: K/V, or the SSM's conv / SSD states."""
    from repro_torch import models
    from repro_torch.models import params as P
    return sum(t.numel() * t.element_size() for t in P.flatten(
        models.abstract_cache(cfg, batch, max_len))[0])


def _serve_mix(cfg, params, dev, mix, path=None):
    """One request mix served twice through `launch.serve.serve` (the
    second run timed, under the peak-memory counter, as `path`), the
    completions of both runs bitwise equal; then one wave's prefill
    timed and 10 decode steps profiled."""
    import torch
    from repro_torch.launch import serve as S
    max_len = mix["prompt"] + mix["gen"]

    def run():
        reqs = S.make_requests(cfg, mix["requests"], mix["prompt"],
                               mix["gen"])
        stats = S.serve(cfg, reqs, batch=mix["batch"], max_len=max_len,
                        params=params, device=dev)
        return stats, [r.out for r in reqs]

    _, outs0 = run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, outs = drive(path or serve_path(mix["name"]), run, plain=True)
    peak = torch.cuda.max_memory_allocated()
    check(outs == outs0, f"serve {mix['name']}: completions differ "
          "between two runs")
    check(stats["tokens"] == mix["requests"] * mix["gen"],
          f"serve {mix['name']}: {stats['tokens']} tokens")
    eng = S.Engine(cfg, batch=mix["batch"], max_len=max_len, params=params,
                   device=dev)
    x = eng.wave_inputs(S.make_requests(cfg, mix["batch"], mix["prompt"],
                                    mix["gen"]))
    with torch.inference_mode():
        prefill_ms = time_ms(lambda: eng.prefill(params, x), n=10)
        logits, cache, pos = eng.prefill(params, x)
        check(bool(torch.isfinite(logits).all()),
              f"serve {mix['name']}: prefill logits not finite")
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        box = [pos]

        def one_step():
            eng.decode(params, cache, tok, box[0])
            box[0] = box[0] + 1 if box[0] + 1 < max_len else pos

        prof = device_profile(one_step, SERVE_PROFILE_STEPS)
    del cache, logits
    return dict(
        **{k: mix[k] for k in ("requests", "prompt", "gen", "batch")},
        waves=-(-mix["requests"] // mix["batch"]), max_len=max_len,
        cache_bytes=_cache_bytes(cfg, mix["batch"], max_len),
        ttft_p50_ms=stats["ttft_p50_ms"], itl_p50_ms=stats["itl_p50_ms"],
        tok_per_s=stats["tok_per_s"], wall_s=stats["wall_s"],
        tokens=stats["tokens"], prefill_ms=prefill_ms,
        peak_mem_bytes=peak, decode_profile=prof,
        completions_bitwise_repeat=True, first_completion=outs[0][:16])


def _serve_card_vs_cpu(dev, cfg=None, n_req: int = 12, prompt: int = 48,
                       gen: int = 24, batch: int = 4):
    """A reduced model in float32 (TF32 off; default the serving example's
    qwen2.5), the same seeded params on the card and on the CPU: prefill
    logits and one decode step's within 1e-4 normalized, and `n_req`
    requests of `prompt` + `gen` tokens in waves of `batch` completed
    with the same greedy tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import models
    from repro_torch.launch import serve as S, serve_batched
    from repro_torch.models import params as P
    cfg = dataclasses.replace(cfg or serve_batched.example_config(),
                              param_dtype="float32",
                              compute_dtype="float32")
    leaves, treedef = P.flatten(models.init_params(
        cfg, torch.Generator().manual_seed(0)))
    cpu = P.unflatten(treedef, [l.float() for l in leaves])
    card_p = P.unflatten(treedef, [l.float().to(dev) for l in leaves])
    max_len = prompt + gen
    x = torch.from_numpy(np.stack([r.prompt for r in S.make_requests(
        cfg, batch, prompt, gen)]))
    errs = {}
    with torch.inference_mode(), _cpu_threads(1):
        want_l, want_c, pos = models.prefill(cpu, x, cfg, max_len)
        got_l, got_c, _ = models.prefill(card_p, x.to(dev), cfg, max_len)
        tok = want_l.argmax(-1).to(torch.int32)[:, None]
        want_d, _ = models.decode_step(cpu, want_c, tok, pos, cfg)
        got_d, _ = models.decode_step(card_p, got_c, tok.to(dev), pos, cfg)
    for name, got, want in (("prefill", got_l, want_l),
                            ("decode", got_d, want_d)):
        errs[name] = float((got.cpu() - want).abs().max()
                           / want.abs().max())
        check(errs[name] <= SERVE_CARD_RTOL,
              f"serve {cfg.name} f32 {name} logits: card vs CPU "
              f"{errs[name]}")
    outs = {}
    for where, prm in (("cpu", cpu), ("card", card_p)):
        reqs = S.make_requests(cfg, n_req, prompt, gen)
        with _cpu_threads(1):
            S.serve(cfg, reqs, batch=batch, max_len=max_len, params=prm,
                    device="cpu" if where == "cpu" else dev)
        outs[where] = [r.out for r in reqs]
    check(outs["card"] == outs["cpu"], f"serve {cfg.name} f32: greedy "
          "completions on the card differ from the CPU's")
    return dict(logits_rel_err=errs, tokens=sum(map(len, outs["card"])),
                completions_equal=True)


def _serve_progress(what, rec):
    progress(what, dict(
        ms_per_step=rec["itl_p50_ms"], tokens_per_s=rec["tok_per_s"],
        peak_mem_bytes=rec["peak_mem_bytes"], wall_ms=rec["wall_s"] * 1e3,
        device_kernels=rec["decode_profile"]["device_kernels_per_call"],
        device_busy_ms_per_call=rec["decode_profile"][
            "device_busy_ms_per_call"]))


def serve_phase(dev, card):
    """smollm-135m served at full width from seeded bf16 weights: the two
    request mixes of SERVE_MIXES (TTFT and inter-token p50, tokens/s,
    wall, prefill ms, peak memory, device kernels / busy / idle per
    decode step), completions bitwise equal across two runs, logits
    finite; then the reduced qwen2.5 in float32 on the card against the
    CPU."""
    import torch
    from repro_torch import models
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    out = RESULTS["serve"] = dict(arch=SERVE_ARCH, mixes={})
    for name, mix in SERVE_MIXES.items():
        rec = out["mixes"][name] = _serve_mix(cfg, params, dev,
                                              dict(mix, name=name))
        _serve_progress(f"serve {name}", rec)
    del params
    torch.cuda.empty_cache()
    out["qwen2_5_reduced_f32_card_vs_cpu"] = _serve_card_vs_cpu(dev)
    out["seconds"] = time.perf_counter() - t_phase
    emit("serve", **card, **out)


# ------------------------------------------------------------- phase 16

def _moe_cfg():
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(FAM_MOE), n_layers=FAM_MOE_LAYERS)


def families_phase(dev, card):
    """The MoE, SSM and hybrid families on the card.  mamba2-130m at full
    width and depth: `train_runs` at p = 2 (paths
    `train:mamba2-130m:base` / `:p2:cuda`; its K3-K5 records at one chunk
    of its mixed bf16 / float32 gradient, returned), then served on the
    two mixes of SERVE_MIXES (`serve:mamba2-130m:*`); qwen3-moe at full
    width with FAM_MOE_LAYERS layers served on the default mix and
    trained with its Muon (bf16 momentum, the state donated) for 3 + 5
    baseline steps; the reduced mamba2, qwen3-moe and jamba in float32
    on the card against the CPU."""
    import torch
    from repro_torch import models, train
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models import params as P

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    # --- mamba2-130m training, baseline and Uno at p = 2
    cfg = get_config(FAM_SSM)
    run = RunConfig(**TRAIN_RUN)
    n_params = P.param_count(P.param_defs(cfg))
    records, _ = unorc_kernel_phase(dev, cfg, path_p2=train_path(2, FAM_SSM),
                                    tag=f"@train:{FAM_SSM}", extended=False)
    out = RESULTS["families"] = dict(records=records, card_vs_cpu={},
                                     allocated_at_start=held)
    batches = _train_batches(cfg, dev, FAM_WARM + FAM_STEPS)
    tr = out["train_ssm"] = dict(
        arch=FAM_SSM, n_params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        tokens_per_step=TRAIN_BATCH * TRAIN_SEQ, run=TRAIN_RUN,
        warmup_steps=FAM_WARM, timed_steps=FAM_STEPS)
    train_runs(dev, cfg, run, batches, FAM_WARM, (2,), tr)
    check(tr["uno"]["p2"]["grad_dtypes"] == ["bfloat16", "float32"],
          f"{FAM_SSM}: gradient dtypes {tr['uno']['p2']['grad_dtypes']}")
    del batches
    # --- mamba2-130m serving
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    sv = out["serve_ssm"] = dict(arch=FAM_SSM, mixes={})
    for name, mix in SERVE_MIXES.items():
        rec = sv["mixes"][name] = _serve_mix(
            cfg, params, dev, dict(mix, name=name), serve_path(name, FAM_SSM))
        rec["smollm_kv_cache_bytes"] = _cache_bytes(
            get_config(SERVE_ARCH), mix["batch"], rec["max_len"])
        _serve_progress(f"serve {FAM_SSM} {name}", rec)
    del params
    torch.cuda.empty_cache()
    # --- qwen3-moe at full width, FAM_MOE_LAYERS layers
    mcfg = _moe_cfg()
    moe = out["moe"] = dict(
        arch=f"{FAM_MOE}@{FAM_MOE_LAYERS}L",
        reduced=f"n_layers {get_config(FAM_MOE).n_layers} -> "
        f"{FAM_MOE_LAYERS}", n_params=P.param_count(P.param_defs(mcfg)),
        param_bytes=P.param_bytes(P.param_defs(mcfg)))
    params = models.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(0))
    mix = dict(SERVE_MIXES["defaults"], name="defaults")
    rec = moe["serve"] = _serve_mix(mcfg, params, dev, mix,
                                    serve_path("defaults", moe["arch"]))
    # a decode step's expert products read every expert's weights (cap 8
    # slots each): the whole parameter set, once a step
    rec["decode_bound_ms"] = bound_ms(moe["param_bytes"])
    _serve_progress(f"serve {moe['arch']}", rec)
    del params
    torch.cuda.empty_cache()
    batches = _train_batches(mcfg, dev, FAM_WARM + FAM_MOE_STEPS)
    step = train.make_train_step(mcfg, run, device=dev, donate=True)
    torch.cuda.reset_peak_memory_stats()
    state, losses, secs, _ = drive(
        f"train:{moe['arch']}:base", lambda: _train_run(
            step, train.make_train_state(mcfg, seed=0, device=dev), batches,
            snap=False), plain=True)
    ms = statistics.median(secs[FAM_WARM:]) * 1e3
    moe["train"] = dict(
        optimizer=mcfg.optimizer, opt_state_dtype=mcfg.opt_state_dtype,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, warmup_steps=FAM_WARM,
        timed_steps=FAM_MOE_STEPS, ms_per_step=ms,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms * 1e-3),
        ms_per_step_all=[t * 1e3 for t in secs], losses=losses,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    _falls(mcfg, batches[0], losses, state["params"], moe["train"],
           f"{moe['arch']} baseline")
    progress(f"train {moe['arch']}", moe["train"])
    del state, batches, step
    torch.cuda.empty_cache()
    # --- the reduced families in float32, card against CPU
    for arch in FAM_REDUCED:
        out["card_vs_cpu"][arch] = _serve_card_vs_cpu(
            dev, reduced(get_config(arch)), n_req=6, prompt=32, gen=16,
            batch=3)
    out["seconds"] = time.perf_counter() - t_phase
    emit("families", **card, **out)
    return records


# ------------------------------------------------------------- phase 17

def dry_cell_list() -> list:
    """(arch, shape, uno) of every SHAPES cell of DRY_ARCHS and of their
    train cells' Uno step, the slowest first (on the CPU of an H100
    machine: ~50 s for qwen3-moe's Uno step down to 0.4 s)."""
    from repro_torch.configs.base import SHAPES
    cells = [(a, s, uno) for a in DRY_ARCHS for s, spec in SHAPES.items()
             for uno in ((False, True) if spec.kind == "train" else (False,))]
    rank = {("train", True): 0, ("prefill", False): 1, ("train", False): 2}
    return sorted(cells, key=lambda c: (rank.get((SHAPES[c[1]].kind, c[2]),
                                                 3), DRY_ARCHS.index(c[0])))


def dry_cells(out_dir: str) -> None:
    """`launch.dryrun.cost_cell` of each cell of `dry_cell_list()` that no
    other child has claimed (an exclusive claim file per cell, the
    slowest cells first), on meta: one record each in `out_dir`, with
    the cell's wall seconds."""
    from repro_torch.launch import dryrun
    for arch, shape, uno in dry_cell_list():
        claim = pathlib.Path(out_dir) / f"{arch}__{shape}__{uno}.claim"
        try:
            claim.open("x").close()
        except FileExistsError:
            continue
        t0 = time.perf_counter()
        rec = dryrun.cost_cell(arch, shape, uno=uno)
        rec["wall_s"] = time.perf_counter() - t0
        path = dryrun.write_result(rec, pathlib.Path(out_dir))
        print(f"{path.name} {rec['wall_s']:.2f} s", flush=True)


def run_dry_cells() -> float:
    """`dry_cells` in DRY_PROCS child processes that see no card, sharing
    the cells; returns the wall seconds.  Every child is waited for, or
    killed."""
    import os
    DRY_DIR.mkdir(parents=True, exist_ok=True)
    for old in [*DRY_DIR.glob("*.json"), *DRY_DIR.glob("*.claim")]:
        old.unlink()
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(DRY_PROCS):
            log = open(DRY_DIR.parent / f"dryrun_cells_{i}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import chip_smoke; chip_smoke."
                 f"dry_cells({str(DRY_DIR)!r})"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                log))
        for i, (proc, _) in enumerate(procs):
            rc = proc.wait(timeout=max(1.0, DRY_WAIT_S
                                       - (time.perf_counter() - t0)))
            check(rc == 0, f"dry run child {i} exited {rc} "
                  f"(chiprun_out/dryrun_cells_{i}.log)")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return time.perf_counter() - t0


def _counted_on_card(fn, *args, pod_size=None):
    """(out, costs, measured peak): `op_costs.analyze_on` of fn(*args) on
    the card (collectives priced on a mesh of `pod_size`-rank pods), and
    the peak the allocator saw in it, counted as the counter counts its
    peak: max_memory_allocated after a reset, less what was allocated
    before the call other than the call's arguments."""
    import gc
    import torch
    from repro_torch.launch import op_costs
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, costs = op_costs.analyze_on(pod_size, fn, *args)
    torch.cuda.synchronize()
    other = before - costs["argument_bytes"]
    return out, costs, torch.cuda.max_memory_allocated() - other


def _dry_compare(what, meta, cuda, measured_peak, secs) -> dict:
    """The meta trace against the card's: flops, bytes, the op multiset
    and the K3-K5 launches equal; the counted peak within DRY_PEAK_RTOL
    of the allocator's; the measured step against the roofline bound."""
    from collections import Counter
    from repro_torch.launch.roofline import roofline_terms
    diff = Counter(cuda["ops"])
    diff.subtract(meta["ops"])
    diff = {k: v for k, v in diff.items() if v}
    check(not diff, f"{what}: the card ran other ops than the meta trace "
          f"(card - meta) {diff}")
    for key in ("flops", "flops_by_dtype", "hbm_bytes", "n_ops",
                "kernel_launches", "argument_bytes"):
        check(meta[key] == cuda[key], f"{what}: {key} {meta[key]} on meta, "
              f"{cuda[key]} on the card")
    gap = (meta["peak_bytes"] - measured_peak) / measured_peak
    terms = roofline_terms(meta["flops"], meta["hbm_bytes"], 0.0, 1,
                           flops_by_dtype=meta["flops_by_dtype"])
    bound_s = max(terms["t_compute_s"], terms["t_memory_s"])
    ms = statistics.median(secs) * 1e3
    rec = dict(
        flops=meta["flops"], flops_by_dtype=meta["flops_by_dtype"],
        hbm_bytes=meta["hbm_bytes"], n_ops=meta["n_ops"],
        kernel_launches=meta["kernel_launches"],
        argument_bytes=meta["argument_bytes"],
        counted_peak_bytes=meta["peak_bytes"],
        card_counted_peak_bytes=cuda["peak_bytes"],
        allocated_peak_bytes=measured_peak, peak_gap=gap,
        roofline=terms, bound_ms=bound_s * 1e3, ms_per_step=ms,
        ms_per_step_all=[t * 1e3 for t in secs],
        roofline_fraction=bound_s * 1e3 / ms,
        top_ops_by_bytes=meta["top_ops_by_bytes"][:5],
        top_ops_by_flops=meta["top_ops_by_flops"][:3])
    progress(what, rec)
    check(abs(gap) <= DRY_PEAK_RTOL, f"{what}: counted peak "
          f"{meta['peak_bytes']} against {measured_peak} allocated ({gap:+.3f})")
    return rec


def _dry_train(dev, cfg, n_pods: int, path: str) -> dict:
    """smollm's train step at TRAIN_BATCH x TRAIN_SEQ (AdamW, full width)
    traced on meta and run on the card, each under the op counter, then
    timed; n_pods = 2 is the Uno step with K3-K5."""
    import torch
    from repro_torch import models, optim, train
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.launch import op_costs
    run = RunConfig(**TRAIN_RUN)
    params = models.abstract_params(cfg)
    mstate = {"params": params, "opt": optim.init_opt_state(params, cfg)}
    mbatch = models.train_input_specs(
        cfg, ShapeSpec("card", TRAIN_SEQ, TRAIN_BATCH, "train"))
    t0 = time.perf_counter()
    _, meta = op_costs.analyze(
        train.make_train_step(cfg, run, n_pods=n_pods, device="meta"),
        mstate, mbatch, 1)
    trace_s = time.perf_counter() - t0
    # the batches in the specs' dtypes (synth_batch's token ids are int64,
    # the reference's input specs int32: the model casts either way)
    batches = [{k: v.to(mbatch[k].dtype) for k, v in b.items()}
               for b in _train_batches(cfg, dev, 2 + DRY_TIMED)]
    step = train.make_train_step(cfg, run, n_pods=n_pods, device=dev)
    state, _ = step(train.make_train_state(cfg, seed=0, device=dev),
                    batches[0], 0)
    (state2, _), cuda, peak = drive(
        path, lambda: _counted_on_card(step, state, batches[1], 1),
        plain=n_pods == 1)
    check(cuda["kernel_launches"] == PATHS[path],
          f"{path}: the counter saw {cuda['kernel_launches']}, the wrappers "
          f"counted {PATHS[path]}")
    del state
    secs = []
    for i, batch in enumerate(batches[2:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state2, m = step(state2, batch, 2 + i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(math.isfinite(float(m["loss"])), f"{path}: loss not finite")
    rec = _dry_compare(path, meta, cuda, peak, secs)
    rec.update(n_pods=n_pods, meta_trace_s=trace_s,
               launches=dict(PATHS[path]))
    del state2, batches, step
    torch.cuda.empty_cache()
    return rec


def _dry_decode(dev, cfg, path: str) -> dict:
    """One decode step of SERVE_MIXES["long"] (batch 8 against a cache of
    1,024 + 128, after the prompt's prefill) traced on meta and run on
    the card, each under the op counter, then timed."""
    import torch
    from repro_torch import models, train
    from repro_torch.launch import op_costs
    mix = SERVE_MIXES["long"]
    b, pos, max_len = mix["batch"], mix["prompt"], mix["prompt"] + mix["gen"]
    decode = train.make_decode_step(cfg)
    with torch.inference_mode():
        t0 = time.perf_counter()
        _, meta = op_costs.analyze(
            decode, models.abstract_params(cfg),
            models.abstract_cache(cfg, b, max_len),
            torch.empty((b, 1), dtype=torch.int32, device="meta"), pos)
        trace_s = time.perf_counter() - t0
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        g = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (b, pos), generator=g,
                               device=dev, dtype=torch.int32)
        logits, cache, p0 = train.make_prefill_step(cfg, max_len)(params,
                                                                  prompt)
        check(p0 == pos, f"prefill returned pos {p0}")
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        decode(params, cache, tok, pos)
        (logits, _), cuda, peak = drive(
            path, lambda: _counted_on_card(decode, params, cache, tok, pos),
            plain=True)
        check(bool(torch.isfinite(logits).all()), f"{path}: logits")
        secs = []
        for _ in range(DRY_TIMED + 7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(params, cache, tok, pos)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    rec = _dry_compare(path, meta, cuda, peak, secs)
    rec.update(batch=b, pos=pos, max_len=max_len, meta_trace_s=trace_s)
    del params, cache, logits
    torch.cuda.empty_cache()
    return rec


def dryrun_phase(dev, card, uno_records) -> list:
    """The dry run checked on the card: smollm's baseline and Uno p = 2
    train steps and the long mix's decode step traced on meta and run on
    the card under the op counter (equal flops, bytes, ops and K3-K5
    launches; the counted peak within DRY_PEAK_RTOL of the allocator's;
    ms/step against the roofline bound), then the dry run of DRY_ARCHS'
    cells in child processes (`run_dry_cells`) and the report's table.
    Returns K3-K5's records for the Uno step's path (the unorc_kernels
    phase's measurements at the same shapes)."""
    import torch
    from repro_torch.configs.base import SHAPES, RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import roofline_report
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(UNO_ARCH)
    out = RESULTS["dryrun"] = dict(arch=UNO_ARCH, batch=TRAIN_BATCH,
                                   seq=TRAIN_SEQ, steps={})
    for key, n_pods in (("base", 1), ("p2", 2)):
        rec = out["steps"][key] = _dry_train(dev, cfg, n_pods,
                                             DRY_PATHS[key])
    rec = out["steps"]["decode"] = _dry_decode(dev, get_config(SERVE_ARCH),
                                               DRY_PATHS["decode"])
    out["cells_wall_s"] = run_dry_cells()
    cells = {}
    for arch in DRY_ARCHS:
        for shape, spec in SHAPES.items():
            for tag in ("card", "card-uno") if spec.kind == "train" \
                    else ("card",):
                f = DRY_DIR / f"{arch}__{shape}__{tag}.json"
                check(f.exists(), f"dry run: no record {f.name}")
                r = json.loads(f.read_text())
                cells[f.stem] = dict(
                    skipped=r["skipped"], wall_s=r["wall_s"],
                    **({} if r["skipped"] else dict(
                        trace_s=r["trace_s"], peak_bytes=r["peak_bytes"],
                        fits_one_card=r["fits_one_card"],
                        roofline=r["roofline"],
                        dci_bytes=r["costs"]["dci_bytes"],
                        kernel_launches=r["costs"]["kernel_launches"])))
                if tag == "card-uno":
                    check(r["costs"]["kernel_launches"]
                          == sync_launches(RunConfig(), 2),
                          f"{f.name}: {r['costs']['kernel_launches']}")
    out["cells"] = cells
    out["report"] = roofline_report.report(DRY_DIR).splitlines()
    for line in out["report"]:
        print(line, flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("dryrun", **card, **out)
    return [dict(r, name=f"{r['name']}@dryrun", path=DRY_PATHS["p2"])
            for r in uno_records if r["path"] == uno_path(2)]


# ------------------------------------------------------------- phase 18

def mesh_path(what: str) -> str:
    return f"mesh:{UNO_ARCH}:{what}"


def _pipeline_grads(cfg, params, batch, n_stages):
    """(loss, grads of every param) of `transformer.loss_fn` with the
    layer stack through the stacked pipeline at n_stages stages and
    MESH_MICRO microbatches."""
    import functools
    import torch
    from repro_torch.models import params as P
    from repro_torch.models import transformer
    from repro_torch.sharding.pipeline import PipelineConfig, pipeline_layers
    leaves, treedef = P.flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss = transformer.loss_fn(
        P.unflatten(treedef, leaves), batch, cfg,
        layers_fn=pipeline_layers(PipelineConfig(n_stages, MESH_MICRO),
                                  functools.partial(transformer.run_layers,
                                                    cfg=cfg)))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _pipeline_runs(dev, cfg, out):
    """The layer stack through the stacked pipeline at 1 (the layers one
    microbatch after another) and MESH_STAGES stages: one warm-up and
    MESH_TIMED timed forward + backward passes each (host clock to a
    synchronize), peak memory; loss and every gradient of each stage
    count bitwise the one-stage run's; the loss within MESH_LOSS_RTOL of
    `loss_fn` on the whole batch; a device profile of one pass of the
    deepest pipeline (the forms' kernels differ by under 1 %: 57,366 /
    57,525 / 58,008 at S = 1 / 2 / 5 on the H100, where a profile costs
    ~30 s of trace processing)."""
    import torch
    from repro_torch import models
    from repro_torch.models import transformer
    from repro_torch.sharding.pipeline import PipelineConfig
    gen = torch.Generator(device=dev).manual_seed(0)
    params = models.init_params(cfg, gen)
    batch = _train_batches(cfg, dev, 1)[0]
    with torch.no_grad():
        h = transformer.embed_inputs(params, batch["inputs"], cfg)
        whole = float(models.loss_fn(params, batch, cfg))
    out["activation_dtype"] = str(h.dtype).removeprefix("torch.")
    out["boundary_bytes_per_step_each_way"] = h.numel() * h.element_size()
    del h
    first = None
    for s in (1,) + MESH_STAGES:
        pcfg = PipelineConfig(s, MESH_MICRO)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        secs, res = [], None
        for _ in range(1 + MESH_TIMED):
            del res
            t0 = time.perf_counter()
            res = drive(mesh_path(f"pipeline:S{s}"), lambda s=s:
                        _pipeline_grads(cfg, params, batch, s), plain=True)
            secs.append(time.perf_counter() - t0)
        rec = out["pipeline"][f"S{s}"] = dict(
            n_stages=s, n_microbatches=MESH_MICRO, n_ticks=pcfg.n_ticks,
            bubble_fraction=pcfg.bubble_fraction,
            ms_per_step=statistics.median(secs[1:]) * 1e3,
            ms_per_step_all=[t * 1e3 for t in secs],
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            loss=float(res[0]))
        if first is None:
            first = res
            rec["loss_fn_whole_batch"] = whole
            rec["loss_rel_err"] = abs(rec["loss"] - whole) / abs(whole)
            check(rec["loss_rel_err"] <= MESH_LOSS_RTOL,
                  f"pipeline loss {rec['loss']} against loss_fn {whole}")
        else:
            rec["loss_bitwise"] = torch.equal(res[0], first[0])
            rec["grads_bitwise"] = all(torch.equal(a, b) for a, b in
                                       zip(res[1], first[1]))
            rec["max_abs_grad_diff"] = max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(res[1], first[1]))
            check(rec["loss_bitwise"] and rec["grads_bitwise"],
                  f"pipeline S={s} differs from the layers one microbatch "
                  f"after another: {rec}")
        if s == MESH_STAGES[-1]:     # the forms launch the same kernels
            rec["profile"] = device_profile(
                lambda s=s: _pipeline_grads(cfg, params, batch, s), 1)
        progress(f"pipeline S={s}", {**rec, **rec.get("profile", {})})
    del first, res, params
    torch.cuda.empty_cache()


def _train_cli(args, group: bool, out_json: pathlib.Path) -> dict:
    """`launch.train` at full width in a child process, under torchrun
    (one rank) when `group`; returns its --out record."""
    import os
    cmd = [sys.executable]
    if group:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1"]
    cmd += ["-m", "repro_torch.launch.train", "--arch", UNO_ARCH,
            "--steps", str(MESH_NCCL_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1", "--out",
            str(out_json), *args]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=MESH_NCCL_TIMEOUT_S)
    check(res.returncode == 0, f"{' '.join(cmd)} exited {res.returncode}: "
          f"{res.stdout[-2000:]} {res.stderr[-3000:]}")
    rec = json.loads(out_json.read_text())
    rec["wall_s"] = time.perf_counter() - t0
    rec["stdout_tail"] = res.stdout.strip().splitlines()[-(2 + MESH_NCCL_STEPS):]
    return rec


def mesh_phase(dev, card):
    """Phase 18: the pipeline at full width (`_pipeline_runs`), its
    stage-boundary bytes beside the Uno sync's wire bytes for the same
    model, then the train CLI over a 1-rank NCCL group (`--mesh 1x1x1`:
    the group, the DeviceMesh on cuda, the data shard and the step's
    collectives set up and driven through NCCL, each the identity at one
    rank) against the same steps with no group, losses bitwise.  No hand-written kernel runs in this phase."""
    import torch
    from repro_torch import models
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.uno_collectives import wire_bytes
    from repro_torch.models import params as P
    t_phase = time.perf_counter()
    cfg = get_config(UNO_ARCH)
    n_params = P.param_count(models.param_defs(cfg))
    out = RESULTS["mesh"] = dict(
        arch=UNO_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=MESH_MICRO, pipeline={}, n_params=n_params,
        uno_wire_bytes_p2=wire_bytes(n_params, RunConfig(**TRAIN_RUN), 2))
    _pipeline_runs(dev, cfg, out)
    torch.cuda.synchronize()
    d = OUT.parent
    d.mkdir(parents=True, exist_ok=True)
    on = ["--device", dev.type]
    plain = _train_cli(on, False, d / "mesh_nogroup.json")
    nccl = _train_cli(on + ["--mesh", "1x1x1"], True, d / "mesh_nccl.json")
    out["nccl_1rank"] = dict(nogroup=plain, nccl=nccl, losses_bitwise=(
        plain["losses"] == nccl["losses"]))
    progress("train over 1 NCCL rank", out["nccl_1rank"])
    check(out["nccl_1rank"]["losses_bitwise"] and nccl["mesh"] == [1, 1, 1],
          f"--mesh 1x1x1 over NCCL: {out['nccl_1rank']}")
    out["seconds"] = time.perf_counter() - t_phase
    emit("mesh", **card, **out)


# ------------------------------------------------------------- phase 19

def _meshw_cfg():
    from repro_torch.configs.registry import get_config
    return get_config(MESHW_ARCH)


def _meshw_variant(dev, cfg, uno: bool, path: str) -> dict:
    """One variant of phase 19 on a cuda fake mesh (so that DTensor takes
    the card's collectives on meta too): the step traced on meta (a
    warm-up for DTensor's plans, then counted), then the state drawn on
    the card, a warm-up step, a counted step (under `drive`) and
    MESHW_TIMED timed steps."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun, op_costs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.models import params as P
    shape = SHAPES[MESHW_SHAPE]
    mesh = mesh_lib.make_fake_mesh(*dryrun.MULTIPOD, device="cuda")
    chips = mesh.size
    try:
        state, rows = dryrun.rank_inputs(cfg, shape, mesh)
        step = dryrun.rank_step(cfg, shape, mesh, uno)
        step(state, rows, 0)
        t0 = time.perf_counter()
        _, meta = op_costs.analyze_on(dryrun.POD_SIZE, step, state, rows, 1)
        trace_s = time.perf_counter() - t0
        del state, rows, step
        t0 = time.perf_counter()
        state, rows = dryrun.rank_inputs(cfg, shape, mesh, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the length of the vector the Uno ring syncs: rank 0's local
        # gradient blocks, placed as the params
        n_local = sum(l.to_local().numel()
                      for l in P.flatten(state["params"])[0])
        step = dryrun.rank_step(cfg, shape, mesh, uno, device=dev)
        state, _ = step(state, rows, 0)
        (state, m), cuda, peak = drive(path, lambda: _counted_on_card(
            step, state, rows, 1, pod_size=dryrun.POD_SIZE), plain=not uno)
        check(cuda["kernel_launches"] == PATHS[path],
              f"{path}: the counter saw {cuda['kernel_launches']}, the "
              f"wrappers counted {PATHS[path]}")
        secs = []
        for i in range(MESHW_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, rows, 2 + i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        del state, rows, step, m
    finally:
        mesh_lib.destroy_fake_mesh()
    torch.cuda.empty_cache()
    rec = _dry_compare(path, meta, cuda, peak, secs)
    check(meta["collectives"] == cuda["collectives"],
          f"{path}: collectives {meta['collectives']} on meta, "
          f"{cuda['collectives']} on the card")
    # the fake group moves no data, so the card's bound leaves the
    # collectives out; beside it the terms `dryrun --multipod` gives the
    # same cell, its collectives priced
    for key in ("bound_ms", "roofline_fraction", "roofline"):
        rec[f"{key}_local"] = rec.pop(key)
    rec["roofline_multipod"] = terms = roofline_terms(
        meta["flops"], meta["hbm_bytes"], meta["collective_bytes"], chips,
        flops_by_dtype=meta["flops_by_dtype"],
        off_host_bytes=meta["collectives"]["off_host_bytes"])
    rec["bound_ms_multipod"] = 1e3 * max(
        terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"])
    rec.update(uno=uno, meta_trace_s=trace_s, init_s=init_s,
               local_grad_values=n_local,
               collectives=meta["collectives"],
               collective_bytes_per_step=meta["collectives"]["total_bytes"],
               dci_bytes_per_step=meta["collectives"]["dci_bytes"],
               launches=dict(PATHS[path]),
               timing="rank 0's local step; the fake group's collectives "
                      "move no data")
    return rec


def mesh_weights_phase(dev, card) -> list:
    """Phase 19 (see the module docstring).  Returns K3-K5's records for
    the Uno variant's path: each held against its plain version and
    timed on one chunk of the ring's vector at that path's length (rank
    0's local gradient blocks) and rows (one, a rank of the pod group)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = _meshw_cfg()
    out = RESULTS["mesh_weights"] = dict(
        arch=MESHW_ARCH, shape=MESHW_SHAPE, n_layers=cfg.n_layers,
        mesh=[2, 16, 16], steps={})
    for key, uno in (("base", False), ("uno", True)):
        out["steps"][key] = _meshw_variant(dev, cfg, uno, MESHW_PATHS[key])
    recs, _ = unorc_kernel_phase(
        dev, cfg, path_p2=MESHW_PATHS["uno"], tag="@multipod",
        extended=False, n_values=out["steps"]["uno"]["local_grad_values"],
        rows=1)
    out["kernels"] = recs
    out["seconds"] = time.perf_counter() - t_phase
    emit("mesh_weights", **card, **out)
    return recs


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

    packet = start_packet_halves()
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
    records += rel_epoch_phase(dev, card)
    records += lb_update_phase(dev, card)
    records += sharded_grid_phase(fs, dev, card)
    del fs, fs_mp
    service_phase(dev, card, records)
    records += validate_phase(dev, card, packet)
    uno_cfg = get_config(UNO_ARCH)
    uno_records, n_patterns = unorc_kernel_phase(dev, uno_cfg)
    emit("unorc_kernels", records=uno_records, erasure_patterns=n_patterns)
    unorc_sync_phase(dev, card, uno_cfg)
    records += uno_records
    records += train_phase(dev, card, uno_cfg, uno_records)
    serve_phase(dev, card)
    records += families_phase(dev, card)
    records += dryrun_phase(dev, card, uno_records)
    mesh_phase(dev, card)
    records += mesh_weights_phase(dev, card)
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
