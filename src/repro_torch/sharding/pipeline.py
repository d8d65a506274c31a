"""Pipeline parallelism over a `pipe` axis, GPipe schedule (the
reference's ``repro.sharding.pipeline``).

For depth-dominated models a `pipe` axis trades the all-layer FSDP
gathers for point-to-point activation transfers.  Layout: the layer
stack (L, ...) is split into S stages of L/S layers (`split_stack`); each
stage holds its layers' parameters.  The rotation loop runs
T = n_micro + S - 1 ticks; at tick t

    stage s computes its layers on its current microbatch activations,
    then every activation hops one stage forward while stage 0 injects
    the next microbatch,

so stage s works on microbatch t - s, and the last stage finishes
microbatch t - (S - 1).  Autograd differentiates straight through the
ticks: the reverse pass replays the schedule backwards, each hop's
transpose the reverse hop, which is pipelined backprop.  The classic
bubble of (S - 1) / T ticks is `bubble_fraction`.

On the DCI question this module is Uno-relevant: a stage boundary on the
`pod` axis turns the cross-DC traffic from gradient-sized all-reduces
into activation-sized transfers, the same "what crosses the slow link"
decision the paper's cross-DC training workload makes.

Two forms, one schedule:

  * stacked (``group=None``): all S stages in this process on one
    device; the hop is a rotation of the per-stage activations along the
    stage dim.  A stage on a bubble tick (no microbatch) is skipped: its
    result reaches no output, so outputs and gradients are unchanged, and
    every stage evaluates each microbatch at the shape the layers would
    see run one microbatch after another (the results are bitwise those).
  * rank form (``group=``): one stage per rank of a `pipe` process group;
    the hop is `sharding.ring_shift` (`batch_isend_irecv`) inside an
    autograd Function whose backward is the reverse hop.  A rank on a
    bubble tick passes its activation on unchanged, so every rank's hops
    form one chain and the backward pass runs them on every rank in the
    same reverse order.  The reference ends with a psum that hands every
    stage the last stage's outputs; here the last rank broadcasts them,
    and the backward keeps one cotangent (the last rank's), not the sum
    of the S identical ones.  The microbatches' gradient is summed over
    the ranks (only stage 0 reads them), so it is whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import params as P
from repro_torch.sharding import ring_shift


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int          # must be >= n_stages for reasonable bubbles

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks


def _tree_map(fn, tree):
    leaves, treedef = P.flatten(tree)
    return P.unflatten(treedef, [fn(t) for t in leaves])


def split_stack(params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-major views."""
    def re(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             "stages")
        return p.reshape((n_stages, L // n_stages) + tuple(p.shape[1:]))
    return _tree_map(re, params)


class _Hop(torch.autograd.Function):
    """One tick's hop to the next rank; backward: the reverse hop."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        return ring_shift([h], group, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.group, -1)[0], None


class _FromLast(torch.autograd.Function):
    """The last rank's outputs on every rank.  `anchor` (the last hop's
    result) ties the chain of hops to the output on every rank; it gets
    a zero cotangent."""

    @staticmethod
    def forward(ctx, outs, anchor, group, src):
        import torch.distributed as dist
        ctx.last = dist.get_rank(group) == src
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        buf = outs.clone()
        dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.anchor
        return (g if ctx.last else None,
                torch.zeros(shape, dtype=dtype, device=device), None, None)


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward: the cotangent summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _stacked(cfg, stage_fn, stage_params, x_micro):
    S, M = cfg.n_stages, cfg.n_microbatches
    stages = [_tree_map(lambda p, s=s: p[s], stage_params) for s in range(S)]
    state = [None] * S
    outs = [None] * M
    for t in range(cfg.n_ticks):
        if t < M:
            state[0] = x_micro[t]
        h = [stage_fn(stages[s], state[s]) if 0 <= t - s < M else None
             for s in range(S)]
        if t >= S - 1:
            outs[t - (S - 1)] = h[S - 1]
        state = h[-1:] + h[:-1]             # stage s + 1 takes stage s's
    return torch.stack(outs)


def _ranked(cfg, stage_fn, stage_params, x_micro, group):
    import torch.distributed as dist
    S, M = cfg.n_stages, cfg.n_microbatches
    n = dist.get_world_size(group)
    if n != S:
        raise ValueError(f"{S} stages on a pipe group of {n} ranks")
    idx = dist.get_rank(group)
    params = _tree_map(lambda p: p[0], stage_params)
    xs = _SumGrad.apply(x_micro, group)
    state = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(cfg.n_ticks):
        if t < M:                  # connected on every rank: one chain
            state = torch.where(torch.tensor(idx == 0, device=state.device),
                                xs[t], state)
        m = t - idx
        h = stage_fn(params, state) if 0 <= m < M else state
        if idx == S - 1 and m >= 0:
            outs.append(h)
        state = _Hop.apply(h, group) if S > 1 else h
    local = (torch.stack(outs) if outs else
             torch.empty((M,) + tuple(x_micro.shape[1:]),
                         dtype=x_micro.dtype, device=x_micro.device))
    return _FromLast.apply(local, state, group, S - 1)


def pipeline_apply(cfg: PipelineConfig, stage_fn: Callable, stage_params,
                   x_micro, group=None):
    """Run a layer stack through the pipeline.

    stage_fn(params_stage, h) -> h     (one stage's layers on one microbatch)
    stage_params: a tree whose leaves have a leading stage dim: all S
                  stages (stacked form), or this rank's stage alone, a
                  leading dim of 1 (rank form: ``p[rank:rank + 1]`` of the
                  `split_stack` tree, the reference's shard of it)
    x_micro:      (n_micro, mb, ...) microbatched activations (the same on
                  every rank; stage 0 consumes them in order)
    group:        None (stacked) or the `pipe` process group of S ranks
    Returns (n_micro, mb, ...): the last stage's outputs (on every rank).
    """
    if x_micro.shape[0] != cfg.n_microbatches:
        raise ValueError(f"x_micro holds {x_micro.shape[0]} microbatches, "
                         f"the config {cfg.n_microbatches}")
    if group is None:
        return _stacked(cfg, stage_fn, stage_params, x_micro)
    return _ranked(cfg, stage_fn, stage_params, x_micro, group)


def pipeline_layers(cfg: PipelineConfig, stage_fn: Callable, group=None):
    """A layer-stack runner for `transformer.forward(layers_fn=)`:
    run(layers, h) splits the stacked layers into `cfg.n_stages` stages
    (this rank's alone with a `pipe` `group`), h (B, ...) into
    `cfg.n_microbatches` microbatches along dim 0, and returns
    `pipeline_apply`'s outputs as (B, ...).  One stage runs the layers
    one microbatch after another."""
    def run(layers, h):
        B, M = h.shape[0], cfg.n_microbatches
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             "microbatches")
        stages = split_stack(layers, cfg.n_stages)
        if group is not None:
            import torch.distributed as dist
            r = dist.get_rank(group)
            stages = _tree_map(lambda t: t[r:r + 1], stages)
        y = pipeline_apply(cfg, stage_fn, stages,
                           h.reshape((M, B // M) + tuple(h.shape[1:])), group)
        return y.reshape(h.shape)
    return run
