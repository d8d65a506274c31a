"""End-to-end training CLI on one card (the reference's
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 [--uno --pods 2] \\
      [--ckpt-dir /tmp/ck] [--reduced] [--device cpu]

The reference's flags, plus `--device` (default cuda; with no card it
raises) and `--pods`.  One card has no mesh: `--mesh Px1x1` is read as P
pods, and a data or model axis above 1 raises (several cards are ROADMAP
item 7).  `--uno` with P > 1 pods syncs each step's gradients through the
protected pod exchange (`core.uno_collectives`, the K3-K5 kernels on the
card); the supervisor's straggler QA feeds the host chunk-window
scheduler (`core.window_scheduler`).  On a CPU use `--reduced` (a tiny
same-family config).
"""
from __future__ import annotations

import argparse
import time


def _pods(args) -> int:
    """The pod count from --pods or --mesh ("P", "DxM" or "PxDxM" as the
    reference names its axes); raises on a data or model axis > 1."""
    if not args.mesh:
        return args.pods
    dims = tuple(int(x) for x in args.mesh.split("x"))
    names = ("pod", "data", "model")[-len(dims):]
    axes = dict(zip(names, dims))
    if any(axes.get(n, 1) > 1 for n in ("data", "model")):
        raise ValueError(
            f"--mesh {args.mesh}: a data or model axis above 1 needs "
            "several cards (ROADMAP item 7); one card takes Px1x1")
    return axes.get("pod", 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="",
                    help="Px1x1 => P pods on the one card")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--uno", action="store_true")
    ap.add_argument("--uno-chunks", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pods = _pods(args)

    from repro_torch import data, ft, train
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    run = RunConfig(learning_rate=args.lr, uno_enabled=args.uno,
                    uno_chunks=args.uno_chunks, seed=args.seed)
    n_pods = pods if args.uno else 1

    state = train.make_train_state(cfg, seed=args.seed, device=dev)
    step = train.make_train_step(cfg, run, n_pods=n_pods, device=dev)
    sup = ft.Supervisor(ft.FTConfig(ckpt_dir=args.ckpt_dir or None,
                                    ckpt_every=args.ckpt_every),
                        state_template=state)
    losses = []

    def on_metrics(i, metrics, wall):
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0:
            tok_s = args.batch * args.seq / wall
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{wall * 1e3:7.1f} ms/step  {tok_s:9.0f} tok/s",
                  flush=True)

    t0 = time.time()
    with data.ShardedPipeline(cfg, batch=args.batch, seq=args.seq,
                              seed=args.seed, device=dev) as pipe:
        state, last = sup.run(state, step, iter(pipe), n_steps=args.steps,
                              on_metrics=on_metrics)
    print(f"done: {last} steps in {time.time() - t0:.1f}s on {dev}"
          f"{f' ({n_pods} pods, uno)' if n_pods > 1 else ''}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"ft events: {len(sup.events)}", flush=True)
    return {"losses": losses, "last_step": last, "events": sup.events,
            "n_pods": n_pods}


if __name__ == "__main__":
    main()
