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
shape (P, D, M): one rank per device, ranks pod-major) the params and
the optimizer state are DTensors placed as `state_pspecs` resolves them
(`make_train_state(mesh=)`: every rank draws the seeded weights, keeps
its block of each leaf and checks that rank 0 drew the same), and the
batch is a DTensor on the batch axes (each rank hands the step its own
rows, `batch_shardings`).  Each pod runs the model code on them on its
in-pod mesh (data x model), which gives each pod its pod batch's
gradients: DTensor's backward does the reduction over the in-pod batch
axis, and each gradient comes back placed as its param.  The baseline
then averages each rank's local blocks over the `pod` group (with the
in-pod reduction, GSPMD's psum over pod x data); the Uno step runs the
protected ring over the `pod` group on them (the reference's pod-manual
region, its 'batch' axis on `data`, and its ``leaf_local`` sync:
``make_uno_grad_sync(group=)`` on ``to_local()``, K3-K5 on a CUDA rank),
the result wrapped back into the same placements.  The loss is the mean
over the pods.  ``backend="plain"`` runs the
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

import math

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


def check_draw(leaf, group) -> None:
    """Raise on every rank unless every rank of `group` drew bitwise rank
    0's whole `leaf` (so each rank's block is its block of rank 0's
    draw)."""
    import torch.distributed as dist
    mine = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    first = mine.clone()
    dist.broadcast(first, dist.get_global_rank(group, 0), group=group)
    bad = torch.tensor([int(not torch.equal(mine, first))],
                       device=mine.device)
    dist.all_reduce(bad, group=group)
    if bad.item():
        raise RuntimeError(f"{bad.item()} ranks drew other weights than "
                           "rank 0")


def state_shardings(cfg: ModelConfig, mesh) -> dict:
    """`state_pspecs` on `mesh` (under the config's profile rules) as
    `sharding.NamedSharding`s, the host step counter left out."""
    with sharding.use_mesh(mesh, sharding.profile_rules(cfg)):
        specs = state_pspecs(cfg)
    specs["opt"] = {k: v for k, v in specs["opt"].items() if k != "step"}
    return sharding.spec_tree_to_shardings(mesh, specs)


def batch_shardings(cfg: ModelConfig, mesh, specs) -> dict:
    """Each batch tensor's `NamedSharding` on `mesh` (`batch_pspecs`
    under the config's profile rules): the rows `data.ShardedPipeline`
    hands each rank and the mesh step takes."""
    with sharding.use_mesh(mesh, sharding.profile_rules(cfg)):
        return sharding.spec_tree_to_shardings(mesh, batch_pspecs(cfg, specs))


def make_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None, mesh=None) -> dict:
    """params (drawn from a generator seeded with `seed` on `device`) and
    the optimizer state.  On a mesh with process groups both are DTensors
    placed by `state_pspecs`: every rank draws each leaf whole, checks it
    against rank 0's (`check_draw`) and keeps its block.  On ``meta``
    nothing is drawn."""
    dev = resolve_device(device)
    if mesh is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = models.init_params(cfg, gen)
        return {"params": params, "opt": optim.init_opt_state(params, cfg)}
    group = _mesh_group(mesh)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    check = None if gen is None else (lambda leaf: check_draw(leaf, group))
    params = models.init_params(cfg, gen, mesh=mesh, check=check)
    return {"params": params, "opt": optim.init_opt_state(params, cfg)}


def _mesh_group(mesh):
    if mesh.group is None:
        raise ValueError("a train step over a mesh needs its process groups "
                         "(launch.mesh.make_mesh); one card steps its pods "
                         "stacked without a mesh")
    return mesh.group


# the reference's pod-manual region: the batch on the in-pod data axis
POD_RULES = {"batch": ("data",), "kv_batch": ("data",),
             "fsdp_pod": ("data",)}


def _place_batch(batch, mesh, rules: dict, drop: tuple = ()):
    """Each rank's batch rows -> DTensors on `mesh`: the rows' spec is
    `batch_pspecs`'s under `rules` on `mesh` plus the `drop`ped axes (a
    pod's mesh: the rows as the whole mesh splits them, the pod axis
    dropped), the global rows the local rows times the shards.  DTensors
    pass through."""
    out = {}
    full = sharding.Mesh(mesh.axis_names + drop,
                         mesh.shape + (1,) * len(drop))
    for k, v in batch.items():
        if sharding.is_dtensor(v):
            out[k] = v
            continue
        with sharding.use_mesh(full, rules):
            spec = sharding.resolve("batch", *([None] * (v.dim() - 1)))
        spec = tuple(tuple(a for a in sharding.mesh_axes((e,))
                           if a not in drop) or None for e in spec)
        n = math.prod(mesh.axis_sizes[a] for a in sharding.mesh_axes(spec))
        shape = (v.shape[0] * n,) + tuple(v.shape[1:])
        out[k] = sharding.wrap_block(v, sharding.NamedSharding(mesh, spec),
                                     shape)
    return out


def _group_mean(tree, group):
    """The tree averaged over the ranks of `group`: one `all_reduce` of
    the leaves of each dtype in that dtype (the reference's psum reduces
    a gradient in its own dtype), divided by the rank count."""
    import torch.distributed as dist
    leaves, treedef = P.flatten(tree)
    out = list(leaves)
    for dt in dict.fromkeys(l.dtype for l in leaves):
        idx = [i for i, l in enumerate(leaves) if l.dtype == dt]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(leaves[i].shape)
            off += n
    return P.unflatten(treedef, out)


def _grad_norm(grads):
    out = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                         for g in P.flatten(grads)[0]))
    return out.full_tensor() if sharding.is_dtensor(out) else out


def _placed_like(tree, like):
    """Each DTensor leaf of `tree` redistributed to the placements of the
    leaf of `like` (a gradient's pending sums reduced as its param is
    placed)."""
    leaves, treedef = P.flatten(tree)
    return P.unflatten(treedef, [
        g.redistribute(p.device_mesh, p.placements)
        if sharding.is_dtensor(g) and tuple(g.placements) != tuple(
            p.placements) else g
        for g, p in zip(leaves, P.flatten(like)[0])])


def _to_mesh(tree, mesh):
    """DTensor leaves -> the same blocks on `mesh` (a pod's in-pod mesh:
    the pod axis dropped, each leaf first replicated along it)."""
    from torch.distributed.tensor import DTensor, Replicate
    leaves, treedef = P.flatten(tree)
    out = []
    for l in leaves:
        names = l.device_mesh.mesh_dim_names
        keep = [names.index(a) for a in mesh.axis_names]
        pl = list(l.placements)
        if any(not pl[i].is_replicate() for i in range(len(pl))
               if i not in keep):
            pl = [p if i in keep else Replicate() for i, p in enumerate(pl)]
            l = l.redistribute(l.device_mesh, pl)
        out.append(DTensor.from_local(
            l.to_local(), mesh.device_mesh, [pl[i] for i in keep],
            shape=l.shape, stride=l.stride(), run_check=False))
    return P.unflatten(treedef, out)


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
            self.rules = sharding.profile_rules(cfg)
            pods = mesh.axis_sizes.get("pod", 1)
            if n_pods not in (1, pods):
                raise ValueError(f"n_pods {n_pods} on a mesh of {pods} pods")
            if n_pods > 1:
                pod_group = mesh.axis_group("pod")
            in_pod = tuple(a for a in mesh.axis_names if a != "pod")
            self.pod_mesh = sharding.Mesh(
                in_pod, tuple(mesh.axis_sizes[a] for a in in_pod),
                None if mesh.device_mesh is None
                else mesh.device_mesh[in_pod])
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

    def pod_mesh_grads(self, params, batch):
        """(this pod's loss, its gradients) from this rank's rows: the
        model run on the pod's in-pod mesh (the Uno step under the
        reference's pod-manual rules); DTensors on that mesh, each
        gradient placed as its param there."""
        rules = dict(self.rules)
        if self.uno_sync is not None:
            rules.update(POD_RULES)
        sub = _to_mesh(params, self.pod_mesh)
        # the rows as the whole mesh's rules split them, the pod axis
        # dropped
        b = _place_batch(batch, self.pod_mesh, self.rules, ("pod",))
        with sharding.use_mesh(self.pod_mesh, rules):
            loss, grads = self.grads(sub, b)
            grads = _placed_like(grads, sub)
            loss = loss.full_tensor()
        return loss, grads

    def mesh_grads(self, params, batch):
        """(loss, grads) of this rank's rows over the mesh (params
        DTensors, batch this rank's rows or DTensors), the gradients
        placed as the params, the loss the mean over the pods.  Each pod
        runs the model on its in-pod mesh (`pod_mesh_grads`: DTensor
        reduces over the in-pod batch axis); then the baseline averages
        each rank's local blocks over the pod group (an all-reduce in
        each gradient's dtype: with the in-pod reduction, GSPMD's psum
        over pod x data), the Uno step runs the protected pod ring on them."""
        loss, grads = self.pod_mesh_grads(params, batch)
        pods = self.mesh.axis_sizes.get("pod", 1)
        local = sharding.local_tree(grads)
        if self.uno_sync is not None:
            with torch.no_grad():
                local = self.uno_sync(local)
        elif pods > 1:
            local = _group_mean(local, self.mesh.axis_group("pod"))
        if pods > 1:
            loss = _group_mean({"loss": loss},
                               self.mesh.axis_group("pod"))["loss"]
        return loss, sharding.wrap_like(local, params)

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
