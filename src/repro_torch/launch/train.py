"""End-to-end training CLI (the reference's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 [--uno --pods 2] \\
      [--ckpt-dir /tmp/ck] [--reduced] [--device cpu]
  PYTHONPATH=src torchrun --standalone --nproc-per-node P*D \\
      -m repro_torch.launch.train --mesh PxDxM [--uno] ...

The reference's flags, plus `--device` (default cuda; with no card it
raises), `--pods` and `--out` (the result as JSON, written by rank 0).
`--mesh` names the (pod, data, model) axes ("P", "DxM" or "PxDxM").
Started by torchrun (or inside an initialized process group) the run
takes one rank per (pod, data, model) device, P * D * M ranks: NCCL with
one card per rank on cuda, gloo on the CPU.  The params and optimizer
state are DTensors placed by `train.state_pspecs` (the weights split
over the data and model axes as the config's profile resolves them),
each rank steps its rows of the global batch, the baseline reducing the
gradients over the batch axes, `--uno` within each pod and then through
the protected pod ring on each rank's local blocks
(`core.uno_collectives`, K3-K5 on the card); every rank gathers the
checkpoints and rank 0 writes them, and a restart restores onto the
placements.  Without a process group, `--mesh Px1x1` is P pods stacked
on the one card, and a data or model axis above 1 raises (start P * D *
M ranks).  The supervisor's straggler QA feeds the host chunk-window
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
    return {"pod": 1, "data": 1, "model": 1, **dict(zip(names, dims))}


def _init_group(args, axes):
    """The process group torchrun set up the environment for, or the one
    already initialized; None when there is neither.  Raises when a data
    or model axis above 1 has no group, or the group is not P * D * M
    ranks."""
    import torch
    import torch.distributed as dist
    need = axes["pod"] * axes["data"] * axes["model"]
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        if axes["data"] > 1 or axes["model"] > 1:
            raise ValueError(
                f"--mesh {args.mesh}: a data or model axis above 1 runs one "
                f"rank per (pod, data, model) device: start {need} ranks "
                "with torchrun (one card takes Px1x1 stacked)")
        return None
    if not args.mesh:
        raise ValueError("a process group trains over --mesh PxDxM")
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
                    help="PxDxM: P pods x D data x M model ranks (a process "
                         "group of P*D*M ranks, or Px1x1 stacked on one "
                         "card)")
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

    from repro_torch import data, ft, train
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

    mesh = shardings = state_sh = None
    if group is not None:
        mesh = make_mesh((axes["pod"], axes["data"], axes["model"]),
                         ("pod", "data", "model"), group)
        rows = axes["pod"] * axes["data"]
        if args.batch % rows:
            raise ValueError(f"batch {args.batch} does not split over the "
                             f"{rows} pod x data ranks of --mesh {args.mesh}")
        shardings = train.batch_shardings(cfg, mesh, data.synth_batch(
            cfg, 0, args.batch, args.seq))
        state_sh = train.state_shardings(cfg, mesh)
    rank0 = group is None or dist.get_rank(group) == 0
    state = train.make_train_state(cfg, seed=args.seed, device=dev,
                                   mesh=mesh)
    step = train.make_train_step(cfg, run, n_pods=n_pods, device=dev,
                                 mesh=mesh)
    sup = ft.Supervisor(ft.FTConfig(ckpt_dir=args.ckpt_dir or None,
                                    ckpt_every=args.ckpt_every),
                        state_template=state, state_shardings=state_sh,
                        group=group)
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
