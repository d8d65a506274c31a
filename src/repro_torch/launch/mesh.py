"""Production meshes and meshes over process groups (the reference's
``repro.launch.mesh``).  Functions, not module constants: importing this
module touches no process group.

`make_production_mesh` is shape-only: `sharding.resolve` needs only the
axis names and sizes, and one card cannot host the 256 or 512 ranks of
the production meshes.  `make_mesh` builds a mesh over the ranks of an
initialized ``torch.distributed`` group, ranks row-major over the axes
(pod-major, as ``jax.make_mesh`` orders devices).  `make_fake_mesh` is
one process's mesh over a ``fake`` process group of ``prod(shape)``
ranks: that rank's program of a production mesh (its local blocks, its
sharding propagation, its collectives issued but moving no data), which
the multi-pod dry run costs on ``meta`` and chip_smoke runs on the card.
"""
from __future__ import annotations

import math

from repro_torch.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) data x model single pod; (2, 16, 16) pod x data x model
    multi-pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes, group=None) -> Mesh:
    """A mesh over the first prod(shape) ranks of `group` (the default
    group if None): their DeviceMesh (on cuda under NCCL, else on the
    CPU) and the group of those ranks.  Every rank of `group` calls it;
    it raises when the group has too few ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialized torch.distributed process "
            "group (start the ranks with torchrun); make_production_mesh "
            "gives a shape-only mesh")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = math.prod(shape)
    if len(ranks) < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the group has "
                           f"{len(ranks)}")
    kind = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    dm = DeviceMesh(kind, torch.tensor(ranks[:n]).reshape(shape),
                    mesh_dim_names=axes)
    sub = group if len(ranks) == n else dist.new_group(ranks[:n])
    return Mesh(axes, shape, dm, sub)


def make_fake_mesh(shape, axes, device: str = "cpu") -> Mesh:
    """One process's mesh of `shape` over a ``fake`` process group of
    prod(shape) ranks, as rank 0 (its DeviceMesh on cuda for
    ``device="cuda"``, else on the CPU; meta tensors run on a CPU mesh).
    The group's collectives return at once and move no data: values
    that cross ranks are not computed, shapes, placements and the
    collectives' sizes are.  Initializes the default group (raises when
    one is up); `destroy_fake_mesh` takes it down."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = tuple(shape), tuple(axes)
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the fake mesh "
                           "needs its own default group")
    n = math.prod(shape)
    # meta too: the Uno ring's point-to-point hops on meta blocks
    dist.init_process_group("cpu:fake,cuda:fake,meta:fake",
                            store=FakeStore(), rank=0, world_size=n)
    kind = "cuda" if torch.device(device).type == "cuda" else "cpu"
    dm = DeviceMesh(kind, torch.arange(n).reshape(shape),
                    mesh_dim_names=axes)
    return Mesh(axes, shape, dm, dist.group.WORLD)


def destroy_fake_mesh() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
