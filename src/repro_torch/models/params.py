"""Parameter metadata shared by every model family, and pytrees of
tensors in JAX's leaf order: the reference's ``repro.models.api``.

Each family module (`transformer`, `ssm`, `hybrid`) gives its tree of
`ParamDef` (shape, logical axes, dtype, init) as `param_defs(cfg)`;
`param_defs` here dispatches on the family.  `abstract_params` gives a
tree as meta-device tensors (``api.abstract_params``), `init_params`
materializes it (``api.init_params``) from an explicit
`torch.Generator` on the target device, leaf by leaf in JAX's order
(on a mesh each rank keeps its block of every leaf as a DTensor),
each leaf in its own dtype (the MoE router and the SSM's ``dt_bias``,
``A_log`` and ``D`` are float32 leaves in a bfloat16 tree).  The draws
are torch's, not ``jax.random``'s: parity with the reference comes from
carrying its weights across with `tree_from_arrays`.

A parameter or gradient tree is a nested dict of tensors.  `flatten`
walks it in ``jax.tree.flatten``'s order, which sorts dict keys at every
level: the UnoRC sync concatenates the leaves into one vector and cuts
it into int8 blocks that straddle leaf boundaries, so the leaf order
decides the bits.  `tree_from_arrays`/`tree_to_arrays` carry a tree of
numpy arrays (the reference's params or grads) across; bfloat16 leaves
travel as their uint16 bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]          # logical axis per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                     # normal | zeros | ones
    scale: Optional[float] = None            # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def param_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of `cfg`'s family: the family module's
    `param_defs` (``models.param_defs``)."""
    from repro_torch import models
    return models.param_defs(cfg)


def _materialize(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    scale = d.scale
    if scale is None:
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=generator, device=dev,
                    dtype=torch.float32)
    return (x * scale).to(d.dtype)


def init_params(defs: dict, generator: Optional[torch.Generator],
                shardings=None, check=None) -> dict:
    """The ParamDef tree materialized on `generator`'s device: ones and
    zeros as declared, else N(0, 1) x scale (1/sqrt(fan_in) by default)
    in float32, cast to the leaf dtype.  Leaves draw in JAX leaf order.

    `shardings` (the same tree of `sharding.NamedSharding`): each leaf
    is drawn whole, this rank's block kept as a DTensor and the rest
    dropped, so the numbers equal the unsharded draw; `check(leaf)` sees
    each whole leaf first (`train.make_train_state` holds it against
    rank 0's).  generator None: meta tensors (nothing is drawn; with
    `shardings`, each rank's block)."""
    leaves, treedef = flatten(defs)
    shs = flatten(shardings)[0] if shardings is not None else [None] * len(
        leaves)
    out = []
    for d, sh in zip(leaves, shs):
        if generator is None:
            shape = d.shape if sh is None else sh.local_block(d.shape)[1]
            block = torch.empty(shape, dtype=d.dtype, device="meta")
            out.append(block if sh is None else sharding.wrap_block(
                block, sh, d.shape))
            continue
        full = _materialize(d, generator)
        if sh is None:
            out.append(full)
            continue
        if check is not None:
            check(full)
        out.append(sharding.wrap_block(sh.local(full).clone(), sh, d.shape))
        del full
    return unflatten(treedef, out)


def param_count(defs: dict) -> int:
    return sum(math.prod(d.shape) for d in flatten(defs)[0])


def abstract_params(defs: dict) -> dict:
    """The ParamDef tree as meta-device tensors: shapes and dtypes, no
    storage (the reference's ShapeDtypeStructs)."""
    leaves, treedef = flatten(defs)
    return unflatten(treedef, [torch.empty(d.shape, dtype=d.dtype,
                                           device="meta") for d in leaves])


def param_pspecs(defs: dict) -> dict:
    """Each ParamDef's logical axes resolved on the active mesh
    (``sharding.resolve`` with its shape): a tree of specs."""
    leaves, treedef = flatten(defs)
    return unflatten(treedef, [sharding.resolve(*d.axes, shape=d.shape)
                               for d in leaves])


def param_bytes(defs: dict) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in flatten(defs)[0])


# ------------------------------------------------------------ pytrees

def flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef): the leaves in JAX's order (dict keys sorted at
    every level); treedef is the nested key structure for `unflatten`."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        leaves.append(node)
        return None

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> dict:
    """The inverse of `flatten`: a nested dict with `leaves` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tree_from_arrays(tree, device, shardings=None) -> dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    `device`.  ml_dtypes bfloat16 arrays (as JAX hands them to numpy) keep
    their bits: uint16 view -> torch.bfloat16 view.  `shardings` (the
    same tree of `sharding.NamedSharding`): each leaf placed as a
    DTensor, this rank's block copied to `device`."""
    leaves, treedef = flatten(tree)
    shs = flatten(shardings)[0] if shardings is not None else [None] * len(
        leaves)
    out = []
    for a, sh in zip(leaves, shs):
        a = np.asarray(a)
        t = torch.tensor(a.view(np.int16)).view(torch.bfloat16) \
            if _is_bf16(a) else torch.tensor(a)
        out.append(t.to(device) if sh is None else sharding.wrap_block(
            sh.local(t).to(device), sh, t.shape))
    return unflatten(treedef, out)


def tree_to_arrays(tree) -> dict:
    """A nested dict of tensors -> numpy arrays on the host; bfloat16
    leaves come back as ml_dtypes bfloat16 arrays with the same bits."""
    leaves, treedef = flatten(tree)
    out = []
    for t in leaves:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out.append(t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        else:
            out.append(t.numpy())
    return unflatten(treedef, out)
