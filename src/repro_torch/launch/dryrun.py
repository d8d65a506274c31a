"""Dry run of every (arch x shape) cell on one card: the reference's
``repro.launch.dryrun`` for the port.

The reference lowers and compiles each cell on 512 placeholder devices
and reads XLA's analyses.  The port builds each cell's state on
``device="meta"`` (shapes and dtypes, no storage), runs its own step on
it under the op counter (``launch.op_costs``) and prices the counts
against the H100 (``launch.roofline``).  Nothing is computed, on the CPU
or on a card, and nothing is allocated: a full-size cell costs seconds
of host time.  chip_smoke's ``dryrun`` phase holds the counter's meta
trace against the same step run on the card.

Per cell it writes the reference's record (`arch`, `shape`,
`multi_pod` (always false: one card), `uno`, `chips` (1), `skipped` /
`reason`, `costs`, `model_flops`, `param_bytes_total`, `param_count`,
`roofline`, `useful_flops_ratio`; the memory analysis under XLA's
names), `trace_s` in place of `lower_s` / `compile_s`, and
`peak_bytes` with `fits_one_card` against the card's 80 GB.  With
``--uno`` a train cell costs the Uno step at 2 pods on the one card
(K3-K5 as the custom ops, each launch billed); `dci_bytes` is then the
wire bytes one pod sends a step, from the sync's frame sizes
(``uno_collectives.wire_bytes``).

With ``--multipod`` each cell runs as rank 0's program on the (2, 16,
16) pod x data x model mesh of cards over a ``fake`` process group of
512 ranks (``launch.mesh.make_fake_mesh``; no card is needed), on meta:
the params and optimizer state as DTensors placed by
`train.state_pspecs`, rank 0's rows of the batch, the train step
(``--uno``: the pod ring between the two pods on rank 0's local
blocks), prefill or decode through the serving steps.  The step runs
once uncounted first (DTensor plans each redistribution on first sight,
with ops of its own).  The counts are then one device's: its local ops
and the collectives it issues (``launch.collectives``, the reference's
``analyze_collectives`` keys under `collectives`, with the DCI bytes,
those of groups that span both pods), and the record says ``multi_pod:
true``, ``chips: 512``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k [--uno]
  python -m repro_torch.launch.dryrun --all [--uno]   # every (train) cell
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \
      --multipod [--uno]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import torch

from repro_torch import models, optim, sharding, train
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.core import uno_collectives
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_costs
from repro_torch.launch.roofline import H100_SXM, roofline_terms
from repro_torch.models import params as P

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")
UNO_PODS = 2
CHIPS = 1
MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))
POD_SIZE = 256


def analytic_model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference),
    plus attention quadratic terms (causal-halved).  The reference's
    formula (``dryrun.py:47-74``) over the port's ParamDef tree, walked
    in the tree's own key order as the reference walks it."""
    defs = models.param_defs(cfg)
    # active fraction for MoE expert weights
    n_active = 0
    for path, d in _flat_items(defs):
        n = math.prod(d.shape)
        if "embed" in path:
            continue
        if cfg.n_experts and ("w_gate" in path or "w_up" in path or "w_down" in path) \
                and len(d.shape) >= 3 and d.shape[-3] == cfg.n_experts or \
                (cfg.n_experts and d.shape[1:2] == (cfg.n_experts,)):
            n = n * cfg.top_k / cfg.n_experts
        n_active += n
    B, S = shape.global_batch, shape.seq_len
    n_attn = cfg.n_layers if cfg.n_heads else 0
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
    if shape.kind == "train":
        tokens = B * S
        return 6 * n_active * tokens + 6 * n_attn * B * S * S * cfg.q_dim
    if shape.kind == "prefill":
        tokens = B * S
        return 2 * n_active * tokens + 2 * n_attn * B * S * S * cfg.q_dim
    # decode: one token vs KV of S
    return 2 * n_active * B + 4 * n_attn * B * S * cfg.q_dim


def _flat_items(defs, prefix=""):
    if isinstance(defs, dict):
        for k, v in defs.items():
            yield from _flat_items(v, f"{prefix}/{k}")
    else:
        yield prefix, defs


def _trace(cfg, shape, uno: bool):
    """The op counter's costs of one cell's step traced on meta."""
    if shape.kind == "train":
        params = models.abstract_params(cfg)
        state = {"params": params, "opt": optim.init_opt_state(params, cfg)}
        batch = models.train_input_specs(cfg, shape)
        step = train.make_train_step(cfg, RunConfig(),
                                     n_pods=UNO_PODS if uno else 1,
                                     device="meta")
        return op_costs.analyze(step, state, batch, 0)[1]
    params = models.abstract_params(cfg)
    with torch.inference_mode():
        if shape.kind == "prefill":
            step = train.make_prefill_step(cfg, shape.seq_len)
            return op_costs.analyze(step, params,
                                    models.prefill_input_specs(cfg, shape))[1]
        cache = models.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        step = train.make_decode_step(cfg)
        return op_costs.analyze(step, params, cache,
                                models.decode_input_specs(cfg, shape),
                                shape.seq_len - 1)[1]


def rank_inputs(cfg, shape, mesh, device="meta"):
    """One rank's arguments of a cell's step on `mesh`: (state, this
    rank's batch rows) for a train cell; (params, inputs) or (params,
    cache, inputs, pos) for prefill / decode, placed as the serving
    engine places them.  Meta blocks unless `device` is a card (zeros
    and the seeded weights there)."""
    rules = sharding.profile_rules(cfg)
    if shape.kind == "train":
        state = train.make_train_state(cfg, device=device, mesh=mesh)
        specs = models.train_input_specs(cfg, shape)
        sh = train.batch_shardings(cfg, mesh, specs)
        rows = {k: _block(sh[k], v, device) for k, v in specs.items()}
        return state, rows
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(0)
    params = models.init_params(cfg, gen, mesh=mesh)
    with sharding.use_mesh(mesh, rules):
        if shape.kind == "prefill":
            x = models.prefill_input_specs(cfg, shape)
        else:
            x = models.decode_input_specs(cfg, shape)
        x_sh = sharding.named_sharding(
            "kv_batch", *([None] * (x.dim() - 1)), shape=x.shape)
        x = sharding.wrap_block(_block(x_sh, x, device), x_sh, x.shape)
        if shape.kind == "prefill":
            return params, x
        cdefs = models.cache_defs(cfg, shape.global_batch, shape.seq_len)
        leaves, treedef = P.flatten(cdefs)
        cache = []
        for d in leaves:
            csh = sharding.named_sharding(*d.axes, shape=d.shape)
            t = torch.empty(d.shape, dtype=d.dtype, device="meta")
            cache.append(sharding.wrap_block(_block(csh, t, device), csh,
                                             d.shape))
        return params, P.unflatten(treedef, cache), x, shape.seq_len - 1


def _block(sh, t, device):
    """`sh`'s block of the meta tensor `t`: meta, or zeros on a card."""
    blk = sh.local(t)
    if torch.device(device).type == "meta":
        return blk.clone()
    return torch.zeros(blk.shape, dtype=blk.dtype, device=device)


def rank_step(cfg, shape, mesh, uno: bool, device="meta"):
    """The step a rank of `mesh` runs for a cell: fn(*rank_inputs)."""
    rules = sharding.profile_rules(cfg)
    if shape.kind == "train":
        return train.make_train_step(cfg, RunConfig(),
                                     n_pods=UNO_PODS if uno else 1,
                                     device=device, mesh=mesh)
    if shape.kind == "prefill":
        inner = train.make_prefill_step(cfg, shape.seq_len)
    else:
        inner = train.make_decode_step(cfg)

    def step(*args):
        with sharding.use_mesh(mesh, rules), torch.no_grad():
            return inner(*args)
    return step


def _trace_multipod(cfg, shape, uno: bool, mesh):
    """The op counter's costs of rank 0's step on the fake mesh."""
    args = rank_inputs(cfg, shape, mesh)
    step = rank_step(cfg, shape, mesh, uno)
    if shape.kind == "train":
        args = args + (0,)
    step(*args)                       # DTensor's plans, not the step's
    return op_costs.analyze_on(POD_SIZE, step, *args)[1]


def cost_cell(arch: str, shape_name: str, uno: bool = False,
              mesh=None) -> dict:
    """The record of one cell (see the module docstring); `uno` costs a
    train cell's Uno step at 2 pods; `mesh` (the fake multi-pod mesh)
    costs rank 0's program on it."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi = mesh is not None
    chips = mesh.size if multi else CHIPS
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi,
                "uno": uno, "chips": chips, "skipped": True, "reason": why}
    if uno and shape.kind != "train":
        raise ValueError(f"--uno costs a train cell; {shape_name} is "
                         f"{shape.kind}")
    t0 = time.perf_counter()
    costs = (_trace_multipod(cfg, shape, uno, mesh) if multi
             else _trace(cfg, shape, uno))
    trace_s = time.perf_counter() - t0
    defs = models.param_defs(cfg)
    n_params = P.param_count(defs)
    if multi:
        costs["dci_bytes"] = costs["collectives"]["dci_bytes"]
    else:
        costs["dci_bytes"] = float(uno_collectives.wire_bytes(
            n_params, RunConfig(), UNO_PODS)) if uno else 0.0
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi,
           "uno": uno, "chips": chips, "skipped": False,
           # DTensor's sharding strategies, and with them a multi-pod
           # cell's collectives, change between torch releases
           "torch": torch.__version__,
           "trace_s": round(trace_s, 2),
           "argument_size_in_bytes": costs["argument_bytes"],
           "temp_size_in_bytes": costs["temp_bytes"],
           "output_size_in_bytes": costs["output_bytes"],
           "costs": costs,
           "model_flops": analytic_model_flops(cfg, shape)}
    rec["param_bytes_total"] = P.param_bytes(defs)
    rec["param_count"] = n_params
    rec["roofline"] = roofline_terms(
        costs["flops"], costs["hbm_bytes"], costs["collective_bytes"],
        chips, flops_by_dtype=costs["flops_by_dtype"],
        off_host_bytes=costs["collectives"]["off_host_bytes"])
    rec["useful_flops_ratio"] = (
        rec["model_flops"] / (costs["flops"] * chips)
        if costs["flops"] else None)
    if multi:
        rec["collectives"] = costs["collectives"]
    rec["peak_bytes"] = costs["peak_bytes"]
    rec["fits_one_card"] = costs["peak_bytes"] <= H100_SXM["hbm_bytes"]
    return rec


def record_path(rec, out_dir: pathlib.Path) -> pathlib.Path:
    tag = "multipod" if rec.get("multi_pod") else "card"
    tag += "-uno" if rec.get("uno") else ""
    return out_dir / f"{rec['arch']}__{rec['shape']}__{tag}.json"


def write_result(rec, out_dir: pathlib.Path) -> pathlib.Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = record_path(rec, out_dir)
    path.write_text(json.dumps(rec, indent=1))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multipod", action="store_true",
                    help="rank 0's program on the (2, 16, 16) mesh over a "
                         "fake process group of 512 ranks")
    ap.add_argument("--uno", action="store_true",
                    help="cost the Uno step (2 pods on the card) of a "
                         "train cell")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES
                 if not args.uno or SHAPES[s].kind == "train"]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    # a mesh of cards: DTensor then issues the collectives it issues on
    # the H100s (on a CPU mesh it all-gathers and chunks where a card's
    # Shard-to-Shard redistribution is one all-to-all)
    mesh = (mesh_lib.make_fake_mesh(*MULTIPOD, device="cuda")
            if args.multipod else None)
    try:
        for arch, shape_name in cells:
            rec = cost_cell(arch, shape_name, uno=args.uno, mesh=mesh)
            path = write_result(rec, out_dir)
            what = (f"skipped: {rec['reason']}" if rec["skipped"] else
                    f"{rec['trace_s']:.1f} s, {rec['costs']['n_ops']} ops")
            print(f"wrote {path} ({what})", flush=True)
    finally:
        if mesh is not None:
            mesh_lib.destroy_fake_mesh()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
