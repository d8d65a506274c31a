"""Train step factory: the reference's ``repro.train`` for one card.

`make_train_step(cfg, run)` returns the baseline step: the gradients of
the whole batch, then the optimizer.  With ``n_pods=P > 1`` it returns
the Uno step, which does what the reference's Uno path does on its
``("pod", ...)`` mesh with every pod on the one card:

  * `pod_grads`: the batch is split along dim 0 into P pod batches (the
    reference's `split`), one backward pass per pod batch (its `vmap`),
    and the gradients stacked along a leading pod axis;
  * `sync_and_update`: ``core.uno_collectives.make_uno_grad_sync`` (the
    chunked, int8-quantized, RS(8, 2)-protected pod exchange; on a CUDA
    tensor it launches K3, K4 and K5 or raises), then the optimizer.

The loss is ``lvals.mean()`` over the pods.  ``backend="plain"`` runs the
sync's plain versions (a reference run on the card).  ``donate=True``
writes each step's new params and optimizer state into the given
state's tensors (``optim.apply_updates(donate=True)``; the reference's
train CLI jits its step with ``donate_argnums=(0,)``): the step then
holds one copy of them, which a model whose params, gradients and
optimizer state fill most of the card needs; the state passed in is
consumed.  The serving steps
`make_prefill_step` / `make_decode_step` wrap ``models.prefill`` /
``models.decode_step`` (run them with gradients off).
"""
from __future__ import annotations

import torch

from repro_torch import models, optim
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.uno_collectives import make_uno_grad_sync
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import params as P

F32 = torch.float32


def make_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> dict:
    """params (drawn from a generator seeded with `seed` on `device`) and
    the optimizer state."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = models.init_params(cfg, gen)
    return {"params": params, "opt": optim.init_opt_state(params, cfg)}


def _grad_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in P.flatten(grads)[0]))


class TrainStep:
    """step(state, batch, step_idx) -> (state, metrics); see the module
    docstring.  Metrics are 0-d tensors on the device: "loss" and
    "grad_norm" (of the synced gradients)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, n_pods: int = 1,
                 device: DeviceLike = None, backend: str = "auto",
                 donate: bool = False):
        self.cfg, self.run, self.n_pods = cfg, run, n_pods
        self.donate = donate
        self.device = resolve_device(device)
        self.uno_sync = (make_uno_grad_sync(cfg, run, n_pods, self.device,
                                            backend)
                         if n_pods > 1 else None)

    def grads(self, params, batch):
        """(loss, grads) of one batch: the model's backward pass."""
        leaves, treedef = P.flatten(params)
        leaves = [l.detach().requires_grad_() for l in leaves]
        loss = models.loss_fn(P.unflatten(treedef, leaves), batch, self.cfg)
        gs = torch.autograd.grad(loss, leaves)
        return loss.detach(), P.unflatten(treedef, list(gs))

    def pod_grads(self, params, batch):
        """(lvals (P,), stacked): one backward pass per pod batch (dim 0 of
        every batch tensor split into n_pods), the gradients stacked along
        a leading pod axis."""
        p = self.n_pods
        b = next(iter(batch.values())).shape[0]
        if b % p:
            raise ValueError(f"batch {b} does not split into {p} pods")
        lvals, per_pod = [], []
        for i in range(p):
            sl = slice(i * (b // p), (i + 1) * (b // p))
            loss, g = self.grads(params, {k: v[sl] for k, v in batch.items()})
            lvals.append(loss)
            per_pod.append(P.flatten(g)[0])
        treedef = P.flatten(params)[1]
        stacked = [torch.stack(ls) for ls in zip(*per_pod)]
        return torch.stack(lvals), P.unflatten(treedef, stacked)

    def update(self, state, grads, step_idx: int):
        lr = optim.lr_schedule(step_idx, self.run.learning_rate,
                               self.run.warmup_steps)
        params, opt = optim.apply_updates(state["params"], grads,
                                          state["opt"], self.cfg, lr,
                                          donate=self.donate)
        return {"params": params, "opt": opt}

    def sync_and_update(self, state, stacked, step_idx: int):
        """The Uno step's second half: (new state, synced grads)."""
        with torch.no_grad():
            grads = self.uno_sync(stacked)
        return self.update(state, grads, step_idx), grads

    def __call__(self, state, batch, step_idx: int):
        if self.uno_sync is None:
            loss, grads = self.grads(state["params"], batch)
            new = self.update(state, grads, step_idx)
        else:
            lvals, stacked = self.pod_grads(state["params"], batch)
            loss = lvals.mean()
            new, grads = self.sync_and_update(state, stacked, step_idx)
        return new, {"loss": loss, "grad_norm": _grad_norm(grads)}


def make_train_step(cfg: ModelConfig, run: RunConfig, n_pods: int = 1,
                    device: DeviceLike = None, backend: str = "auto",
                    donate: bool = False) -> TrainStep:
    """The baseline step (n_pods = 1) or the Uno step over n_pods pods on
    the one card.  `device`: None means cuda (raises with no card)."""
    return TrainStep(cfg, run, n_pods, device, backend, donate)


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """step(params, inputs) -> (last-token logits, cache, pos)."""
    def step(params, inputs):
        return models.prefill(params, inputs, cfg, max_len)
    return step


def make_decode_step(cfg: ModelConfig):
    """step(params, cache, inputs, pos) -> (logits, cache)."""
    def step(params, cache, inputs, pos):
        return models.decode_step(params, cache, inputs, pos, cfg)
    return step
