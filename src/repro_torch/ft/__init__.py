"""Fault tolerance: supervisor loop, straggler QA, failure injection.

`Supervisor` wraps the training loop with the production behaviors a
1000-node run needs, each of them the trainer-level mirror of a Uno
mechanism:

  * periodic atomic checkpoints + automatic restart-from-latest
    (checkpoint/restart drill: tests kill the loop mid-run and resume);
  * straggler detection = Quick Adapt: the per-step wall time feeds the
    same UnoCC-derived window controller; a QA trigger (sharp completion
    drop) marks the step "suspect", collapses the cross-pod chunk window
    and rotates the subflow assignment for the next step;
  * failure injection hooks (step N raises / NaN grads / slow step) used by
    the restart drill and by `launch.cross_pod`.

The reference's ``repro.ft`` with the port's checkpoints and scheduler; a
state is a nested dict of tensors and restores onto its template's
devices.  Under a process group (``group=``, the ranks of a mesh) every
rank gathers the state's DTensor leaves whole, rank 0 alone writes the
checkpoints, in the reference's on-disk format, and every rank restores
from the step rank 0 names (after rank 0's writer has finished), so all
resume in step: onto `state_shardings` (a tree of
`sharding.NamedSharding`, as `train.state_shardings` gives it: each rank
keeps its block, whatever mesh wrote the checkpoint), else as the
template is placed.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

from repro_torch import ckpt as ckpt_lib
from repro_torch.core.window_scheduler import (ChunkWindowScheduler,
                                                SchedulerConfig)


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 2.0      # step slower than f x EWMA => straggler
    max_restarts: int = 3


class Supervisor:
    """Runs `step_fn(state, batch, i) -> (state, metrics)` with checkpoint/
    restart, NaN quarantine and straggler-QA bookkeeping."""

    def __init__(self, cfg: FTConfig, *, state_template=None,
                 state_shardings=None, dci_chunk_bytes: float = 1 << 20,
                 group=None):
        self.cfg = cfg
        self.template = state_template
        self.shardings = state_shardings
        self.group = group
        self.sched = ChunkWindowScheduler(
            SchedulerConfig(chunk_bytes=dci_chunk_bytes))
        self.step_ewma = None
        self.events: list[dict] = []
        self.restarts = 0
        self._ckpt_thread = None

    # ------------------------------------------------------------ restart

    def try_resume(self, state, start_step: int):
        if self.cfg.ckpt_dir is None:
            return state, start_step
        latest = self._latest()
        if latest is None:
            return state, start_step
        restored = ckpt_lib.restore(self.cfg.ckpt_dir, latest,
                                    self.template or state, self.shardings)
        self.events.append({"kind": "resume", "step": latest})
        return restored, latest + 1

    def _latest(self):
        """The newest complete checkpoint: rank 0's, after its writer
        thread, on every rank of the group."""
        if self.group is None:
            return ckpt_lib.latest_step(self.cfg.ckpt_dir)
        import torch.distributed as dist
        step = [None]
        if dist.get_rank(self.group) == 0:
            self._drain()
            step = [ckpt_lib.latest_step(self.cfg.ckpt_dir)]
        dist.broadcast_object_list(step, dist.get_global_rank(self.group, 0),
                                   group=self.group)
        return step[0]

    def _drain(self):
        if self._ckpt_thread is not None:       # drain the async writer
            self._ckpt_thread.join(timeout=120)
            self._ckpt_thread = None

    def _writes(self) -> bool:
        if self.group is None:
            return True
        import torch.distributed as dist
        return dist.get_rank(self.group) == 0

    # --------------------------------------------------------------- loop

    def run(self, state, step_fn, batches, *, n_steps: int,
            start_step: int = 0, inject: Optional[Callable] = None,
            on_metrics: Optional[Callable] = None):
        """batches: iterator of (step, batch).  inject(i) may raise
        InjectedFailure or sleep (straggler).  Returns (state, last_step)."""
        i = start_step
        state, i = self.try_resume(state, i)
        while i < n_steps:
            step_start = time.perf_counter()
            if inject is not None:
                inject(i)
            bstep, batch = next(batches)
            state, metrics = step_fn(state, batch, i)
            loss = float(metrics["loss"])
            if math.isnan(loss) or math.isinf(loss):
                # NaN quarantine: restart from the last good checkpoint
                self.events.append({"kind": "nan", "step": i})
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("too many restarts")
                state, i = self.try_resume(state, i)
                continue
            wall = time.perf_counter() - step_start
            self._straggler_qa(i, wall)
            if on_metrics is not None:
                on_metrics(i, metrics, wall)
            if (self.cfg.ckpt_dir is not None and
                    (i + 1) % self.cfg.ckpt_every == 0):
                host = ckpt_lib.to_host(state)     # every rank: gathers
                if self._writes():
                    self._ckpt_thread = ckpt_lib.write(
                        self.cfg.ckpt_dir, i, host,
                        background=self.cfg.async_ckpt, keep=self.cfg.keep)
                self.events.append({"kind": "ckpt", "step": i})
            i += 1
        self._drain()
        return state, i

    def _straggler_qa(self, i: int, wall: float) -> None:
        # adapt DOWN instantly (warm-up steps must not inflate the
        # baseline), up slowly — step 0 includes the kernel builds and the
        # allocator's growth
        if self.step_ewma is None or wall < 0.5 * self.step_ewma:
            self.step_ewma = wall
        slow = wall > self.cfg.straggler_factor * self.step_ewma
        self.step_ewma = 0.9 * self.step_ewma + 0.1 * wall
        # feed the chunk scheduler: a slow step looks like slow DCI chunks
        n = max(1, self.sched.n_chunks)
        lat = [wall / n] * n
        decision = self.sched.on_step(lat)
        if slow or decision["qa"]:
            self.events.append({"kind": "straggler_qa", "step": i,
                                "wall_s": wall,
                                "next_chunks": decision["n_chunks"],
                                "reroute": decision["reroute"]})


# ------------------------------------------------------------ injections

def fail_at(step: int):
    def inject(i):
        if i == step:
            raise InjectedFailure(f"injected failure at step {i}")
    return inject


def slow_at(step: int, seconds: float):
    def inject(i):
        if i == step:
            time.sleep(seconds)
    return inject
