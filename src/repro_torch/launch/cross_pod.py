"""Cross-pod training with the Uno DCI exchange on one card — the
reference's ``examples/cross_pod_training.py`` drill (the paper's Fig 13 C
workload), with both pods of the (pod=2) exchange on the one card.

  PYTHONPATH=src python -m repro_torch.launch.cross_pod [--device cpu]

Shows: (1) the Uno step (int8 + RS(8, 2) protected pod exchange, K3-K5
on the card) tracking the baseline step's loss while compressing the DCI
payload; (2) the host window scheduler reacting to an injected DCI flap at
step 12 (Quick-Adapt window collapse + subflow re-route), then
recovering; (3) a checkpoint at step 15 and a restore at step 20.
"""
from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)

    from repro_torch import ckpt, data, train
    from repro_torch.configs.base import RunConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.core.window_scheduler import (ChunkWindowScheduler,
                                                    SchedulerConfig)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    n_pods = 2
    cfg = reduced(get_config("granite-8b"), n_layers=4, d_model=128,
                  d_ff=512)
    run = RunConfig(uno_chunks=8)
    print(f"pods {n_pods} on {dev}, model {cfg.name}", flush=True)

    state = train.make_train_state(cfg, seed=0, device=dev)
    base = train.make_train_step(cfg, run, device=dev)
    uno = train.make_train_step(cfg, run, n_pods=n_pods, device=dev)
    sched = ChunkWindowScheduler(SchedulerConfig(chunk_bytes=1 << 18))
    drifts = []

    s_base, s_uno = state, state
    with tempfile.TemporaryDirectory() as ckdir, \
            data.ShardedPipeline(cfg, batch=16, seq=64, device=dev) as pipe:
        for i in range(args.steps):
            _, batch = next(pipe)
            t0 = time.perf_counter()
            s_base, m_base = base(s_base, batch, i)
            s_uno, m_uno = uno(s_uno, batch, i)
            drift = abs(float(m_base["loss"]) - float(m_uno["loss"]))
            wall = time.perf_counter() - t0
            drifts.append(drift)
            # feed the scheduler; a "DCI flap" at step 12
            n = sched.n_chunks
            lat = [3e-3] * n if i != 12 else \
                [3e-3] * (n // 4) + [None] * (n - n // 4)
            dec = sched.on_step(lat)
            if i % 5 == 0 or dec["qa"]:
                print(f"step {i:3d} loss={float(m_uno['loss']):.4f} "
                      f"drift_vs_baseline={drift:.2e} "
                      f"chunks={dec['n_chunks']} {wall * 1e3:.1f} ms"
                      f"{'  << QA collapse + reroute' if dec['qa'] else ''}",
                      flush=True)
            if i == 15:
                ckpt.save(ckdir, i, s_uno)
                print(f"step {i:3d} checkpoint saved", flush=True)
            if i == 20:
                s_uno = ckpt.restore(ckdir, 15, s_uno)
                print("step  20 restored from step-15 checkpoint "
                      "(restart drill)", flush=True)
    print(f"\nscheduler: {sched.cc.n_qa} QA events, "
          f"{sched.n_reroutes} re-routes; final chunk window "
          f"{sched.n_chunks}")
    print("cross-pod example OK", flush=True)
    return {"drifts": drifts, "n_qa": sched.cc.n_qa,
            "n_reroutes": sched.n_reroutes, "n_chunks": sched.n_chunks,
            "log": sched.window_log}


if __name__ == "__main__":
    main()
