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

The loss is ``lvals.mean()`` over the pods.

Over a mesh with process groups (``mesh=``, `launch.mesh.make_mesh` of
shape (P, D, 1): one rank per (pod, data) device, ranks pod-major) each
rank steps its own rows of the global batch (`batch_pspecs`) on weights
replicated on every rank (`make_train_state` checks that every rank drew
the same ones; the weight axes are ROADMAP item 9c-ii).  The baseline
averages the gradients with one `all_reduce` over pod x data, the
reference's GSPMD psum.  The Uno step averages them over the in-pod
`data` group, which gives each pod its pod batch's gradients, then runs
the protected ring over the `pod` group, one pod per rank
(``make_uno_grad_sync(group=)``); each rank keeps its own copy of the
pod mean.  The loss is the mean over the ranks.  ``backend="plain"`` runs the
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

from repro_torch import models, optim, sharding
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.uno_collectives import make_uno_grad_sync
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import params as P

F32 = torch.float32


def batch_pspecs(cfg: ModelConfig, specs) -> dict:
    """Each batch tensor's spec on the active mesh: dim 0 on the logical
    'batch' axis, the rest replicated."""
    return {k: sharding.resolve("batch", *([None] * (t.dim() - 1)),
                                shape=t.shape) for k, t in specs.items()}


def state_pspecs(cfg: ModelConfig) -> dict:
    """The train state's specs on the active mesh: the params', and each
    optimizer-state leaf that mirrors a param (by its path under the
    state key) takes that param's spec if its rank allows; factored and
    scalar states are replicated (the reference's prefix lookup)."""
    pspecs = models.param_pspecs(cfg)
    opt_shape = optim.init_opt_state(models.abstract_params(cfg), cfg)
    flat_p = optim.flatten_with_paths(pspecs)

    def spec_for(path, leaf):
        sub = path.split("/", 1)[1] if "/" in path else ""
        cand = flat_p.get(sub)
        return cand if cand is not None and len(cand) <= leaf.dim() else ()

    opt_specs = optim.unflatten_like(opt_shape, {
        k: spec_for(k, v)
        for k, v in optim.flatten_with_paths(opt_shape).items()})
    return {"params": pspecs, "opt": opt_specs}


def _bits(leaves) -> torch.Tensor:
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])


def check_replicated(tree, group) -> None:
    """Raise on every rank unless every rank of `group` holds bitwise
    rank 0's tree."""
    import torch.distributed as dist
    mine = _bits(P.flatten(tree)[0])
    first = mine.clone()
    dist.broadcast(first, dist.get_global_rank(group, 0), group=group)
    bad = torch.tensor([int(not torch.equal(mine, first))],
                       device=mine.device)
    dist.all_reduce(bad, group=group)
    if bad.item():
        raise RuntimeError(f"{bad.item()} ranks hold other weights than "
                           "rank 0")


def make_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None, mesh=None) -> dict:
    """params (drawn from a generator seeded with `seed` on `device`) and
    the optimizer state.  On a mesh with process groups every rank draws
    them, and all must have drawn bitwise the same."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = models.init_params(cfg, gen)
    if mesh is not None:
        check_replicated(params, _mesh_group(mesh))
    return {"params": params, "opt": optim.init_opt_state(params, cfg)}


def _mesh_group(mesh):
    if mesh.group is None:
        raise ValueError("a train step over a mesh needs its process groups "
                         "(launch.mesh.make_mesh); one card steps its pods "
                         "stacked without a mesh")
    if mesh.axis_sizes.get("model", 1) > 1:
        raise ValueError(f"mesh {mesh.shape}: a model axis above 1 shards "
                         "the weights, ROADMAP item 9c-ii (the weight axes)")
    return mesh.group


def _group_mean(tree, group):
    """The tree averaged over the ranks of `group`: one float32
    `all_reduce` of every leaf, divided by the rank count, each leaf cast
    back to its dtype."""
    import torch.distributed as dist
    leaves, treedef = P.flatten(tree)
    flat = torch.cat([l.reshape(-1).to(F32) for l in leaves])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off:off + l.numel()].reshape(l.shape).to(l.dtype))
        off += l.numel()
    return P.unflatten(treedef, out)


def _grad_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in P.flatten(grads)[0]))


class TrainStep:
    """step(state, batch, step_idx) -> (state, metrics); see the module
    docstring.  Metrics are 0-d tensors on the device: "loss" and
    "grad_norm" (of the synced gradients)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, n_pods: int = 1,
                 device: DeviceLike = None, backend: str = "auto",
                 donate: bool = False, mesh=None):
        self.cfg, self.run, self.n_pods = cfg, run, n_pods
        self.donate = donate
        self.device = resolve_device(device)
        self.mesh = mesh
        pod_group = None
        if mesh is not None:
            _mesh_group(mesh)
            pods = mesh.axis_sizes.get("pod", 1)
            if n_pods not in (1, pods):
                raise ValueError(f"n_pods {n_pods} on a mesh of {pods} pods")
            if n_pods > 1:
                pod_group = mesh.axis_group("pod")
        self.uno_sync = (make_uno_grad_sync(cfg, run, n_pods, self.device,
                                            backend, group=pod_group)
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

    def mesh_grads(self, params, batch):
        """(loss, grads) of this rank's rows over the mesh: the baseline's
        mean over pod x data, or the Uno step's mean over data then the
        pod ring (this rank's copy); the loss is the mean over the
        ranks."""
        loss, grads = self.grads(params, batch)
        if self.uno_sync is None:
            grads = _group_mean(grads, self.mesh.group)
        else:
            if "data" in self.mesh.axis_names:
                grads = _group_mean(grads, self.mesh.axis_group("data"))
            with torch.no_grad():
                grads = self.uno_sync(grads)
        return _group_mean({"loss": loss}, self.mesh.group)["loss"], grads

    def __call__(self, state, batch, step_idx: int):
        if self.mesh is not None:
            loss, grads = self.mesh_grads(state["params"], batch)
            new = self.update(state, grads, step_idx)
        elif self.uno_sync is None:
            loss, grads = self.grads(state["params"], batch)
            new = self.update(state, grads, step_idx)
        else:
            lvals, stacked = self.pod_grads(state["params"], batch)
            loss = lvals.mean()
            new, grads = self.sync_and_update(state, stacked, step_idx)
        return new, {"loss": loss, "grad_norm": _grad_norm(grads)}


def make_train_step(cfg: ModelConfig, run: RunConfig, n_pods: int = 1,
                    device: DeviceLike = None, backend: str = "auto",
                    donate: bool = False, mesh=None) -> TrainStep:
    """The baseline step (n_pods = 1) or the Uno step over n_pods pods,
    stacked on the one card, or over the ranks of `mesh` (a (P, D, 1)
    mesh with process groups; n_pods = P for the Uno step).  `device`:
    None means cuda (raises with no card)."""
    return TrainStep(cfg, run, n_pods, device, backend, donate, mesh)


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
