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

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k [--uno]
  python -m repro_torch.launch.dryrun --all [--uno]   # every (train) cell
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import torch

from repro_torch import models, optim, train
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import ARCH_IDS, cell_supported, get_config
from repro_torch.core import uno_collectives
from repro_torch.launch import op_costs
from repro_torch.launch.roofline import H100_SXM, roofline_terms
from repro_torch.models import params as P

RESULTS_DIR = (pathlib.Path(__file__).resolve().parents[3] / "results"
               / "dryrun_torch")
UNO_PODS = 2
CHIPS = 1


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


def cost_cell(arch: str, shape_name: str, uno: bool = False) -> dict:
    """The record of one cell (see the module docstring); `uno` costs a
    train cell's Uno step at 2 pods."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": False,
                "uno": uno, "chips": CHIPS, "skipped": True, "reason": why}
    if uno and shape.kind != "train":
        raise ValueError(f"--uno costs a train cell; {shape_name} is "
                         f"{shape.kind}")
    t0 = time.perf_counter()
    costs = _trace(cfg, shape, uno)
    trace_s = time.perf_counter() - t0
    defs = models.param_defs(cfg)
    n_params = P.param_count(defs)
    costs["dci_bytes"] = float(uno_collectives.wire_bytes(
        n_params, RunConfig(), UNO_PODS)) if uno else 0.0
    rec = {"arch": arch, "shape": shape_name, "multi_pod": False,
           "uno": uno, "chips": CHIPS, "skipped": False,
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
        CHIPS, flops_by_dtype=costs["flops_by_dtype"])
    rec["useful_flops_ratio"] = (
        rec["model_flops"] / (costs["flops"] * CHIPS)
        if costs["flops"] else None)
    rec["peak_bytes"] = costs["peak_bytes"]
    rec["fits_one_card"] = costs["peak_bytes"] <= H100_SXM["hbm_bytes"]
    return rec


def record_path(rec, out_dir: pathlib.Path) -> pathlib.Path:
    tag = "card-uno" if rec.get("uno") else "card"
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
                    help="not yet ported (ROADMAP item 9c-ii)")
    ap.add_argument("--uno", action="store_true",
                    help="cost the Uno step (2 pods on the card) of a "
                         "train cell")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.multipod:
        raise SystemExit("--multipod: the multi-pod dry run and its "
                         "collective bytes are not ported yet (ROADMAP item "
                         "9c-ii)")
    out_dir = pathlib.Path(args.out)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES
                 if not args.uno or SHAPES[s].kind == "train"]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    for arch, shape_name in cells:
        rec = cost_cell(arch, shape_name, uno=args.uno)
        path = write_result(rec, out_dir)
        what = (f"skipped: {rec['reason']}" if rec["skipped"] else
                f"{rec['trace_s']:.1f} s, {rec['costs']['n_ops']} ops")
        print(f"wrote {path} ({what})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
