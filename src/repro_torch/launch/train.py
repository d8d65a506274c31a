"""End-to-end training CLI (the reference's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 [--uno --pods 2] \\
      [--ckpt-dir /tmp/ck] [--reduced] [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node P*D \\
      -m repro_torch.launch.train --mesh PxDx1 [--uno] ...

The reference's flags, plus `--device` (default cuda; with no card it
raises), `--pods` and `--out` (the result as JSON, written by rank 0).
`--mesh` names the (pod, data, model) axes ("P", "DxM" or "PxDxM").
Started by torchrun (or inside an initialized process group) the run
takes one rank per (pod, data) device, P * D ranks: NCCL with one card
per rank on cuda, gloo on the CPU; each rank steps its rows of the
global batch on replicated weights, the baseline averaging the
gradients over pod x data, `--uno` over data and then through the
protected pod ring (`core.uno_collectives`, K3-K5 on the card); rank 0
writes the checkpoints.  Without a process group, `--mesh Px1x1` is P
pods stacked on the one card, and a data axis above 1 raises (start P *
D ranks).  A model axis above 1 raises: it shards the weights (ROADMAP
item 9c-ii).  The supervisor's straggler QA feeds the host chunk-window
scheduler (`core.window_scheduler`).  On a CPU use `--reduced` (a tiny
same-family config).
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _axes(args) -> dict:
    """{"pod": P, "data": D, "model": M} from --mesh ("P", "DxM" or
    "PxDxM" as the reference names its axes) or --pods."""
    if not args.mesh:
        return {"pod": args.pods, "data": 1, "model": 1}
    dims = tuple(int(x) for x in args.mesh.split("x"))
    names = ("pod", "data", "model")[-len(dims):]
    axes = {"pod": 1, "data": 1, "model": 1, **dict(zip(names, dims))}
    if axes["model"] > 1:
        raise ValueError(f"--mesh {args.mesh}: a model axis above 1 shards "
                         "the weights (ROADMAP item 9c-ii, the weight axes)")
    return axes


def _init_group(args, axes):
    """The process group torchrun set up the environment for, or the one
    already initialized; None when there is neither.  Raises when a data
    axis above 1 has no group, or the group is not P * D ranks."""
    import torch
    import torch.distributed as dist
    need = axes["pod"] * axes["data"]
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        if axes["data"] > 1:
            raise ValueError(
                f"--mesh {args.mesh}: a data axis above 1 runs one rank per "
                f"(pod, data) device: start {need} ranks with torchrun "
                "(one card takes Px1x1 stacked)")
        return None
    if not args.mesh:
        raise ValueError("a process group trains over --mesh PxDx1")
    if not dist.is_initialized():
        if args.device.startswith("cuda"):
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if args.device.startswith("cuda") else "gloo")
    if dist.get_world_size() != need:
        raise ValueError(f"--mesh {args.mesh} takes {need} ranks, the group "
                         f"has {dist.get_world_size()}")
    return dist.group.WORLD


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="",
                    help="PxDx1: P pods x D data ranks (a process group of "
                         "P*D ranks, or Px1x1 stacked on one card)")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--uno", action="store_true")
    ap.add_argument("--uno-chunks", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    axes = _axes(args)

    import torch
    import torch.distributed as dist

    from repro_torch import data, ft, sharding, train
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh

    owns_group = not dist.is_initialized()
    group = _init_group(args, axes)
    dev = resolve_device(args.device)
    if group is not None and dev.type == "cuda":    # this rank's card
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    run = RunConfig(learning_rate=args.lr, uno_enabled=args.uno,
                    uno_chunks=args.uno_chunks, seed=args.seed)
    n_pods = axes["pod"] if args.uno else 1

    mesh = shardings = None
    if group is not None:
        mesh = make_mesh((axes["pod"], axes["data"], 1),
                         ("pod", "data", "model"), group)
        if args.batch % mesh.size:
            raise ValueError(f"batch {args.batch} does not split over the "
                             f"{mesh.size} ranks of --mesh {args.mesh}")
        with sharding.use_mesh(mesh):
            specs = train.batch_pspecs(cfg, data.synth_batch(
                cfg, 0, args.batch, args.seq))
        shardings = sharding.spec_tree_to_shardings(mesh, specs)
    rank0 = group is None or dist.get_rank(group) == 0
    state = train.make_train_state(cfg, seed=args.seed, device=dev,
                                   mesh=mesh)
    step = train.make_train_step(cfg, run, n_pods=n_pods, device=dev,
                                 mesh=mesh)
    sup = ft.Supervisor(ft.FTConfig(ckpt_dir=args.ckpt_dir or None,
                                    ckpt_every=args.ckpt_every),
                        state_template=state, group=group)
    losses = []

    def on_metrics(i, metrics, wall):
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 and rank0:
            tok_s = args.batch * args.seq / wall
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{wall * 1e3:7.1f} ms/step  {tok_s:9.0f} tok/s",
                  flush=True)

    t0 = time.time()
    try:
        with data.ShardedPipeline(cfg, batch=args.batch, seq=args.seq,
                                  shardings=shardings, seed=args.seed,
                                  device=dev) as pipe:
            state, last = sup.run(state, step, iter(pipe),
                                  n_steps=args.steps, on_metrics=on_metrics)
    finally:
        if group is not None and owns_group:
            dist.destroy_process_group()
    where = (f"{mesh.size} ranks of mesh {mesh.shape} on {dev.type}"
             if mesh is not None else str(dev))
    out = {"losses": losses, "last_step": last, "events": sup.events,
           "n_pods": n_pods, "mesh": list(mesh.shape) if mesh else None,
           "device": str(dev)}
    if rank0:
        print(f"done: {last} steps in {time.time() - t0:.1f}s on {where}"
              f"{f' ({n_pods} pods, uno)' if n_pods > 1 else ''}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"ft events: {len(sup.events)}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
