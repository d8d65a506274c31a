"""Logical-axis sharding: map model-code axis names onto whatever mesh is
active (the reference's ``repro.sharding``).

Model code names the axes of params and activations *logically*
("batch", "tensor", "fsdp", "expert", "vocab", ...).  The rules below
resolve those onto the axis names of the active mesh ("pod", "data",
"model").  Axes absent from the mesh resolve to None (replicated), so the
same model code runs on one device, a (data, model) pod or a (pod, data,
model) multi-pod mesh.

The port's `Mesh` carries the axis names and the shape, and, when a
``torch.distributed`` process group of ``prod(shape)`` ranks is up
(`launch.mesh.make_mesh`), the `DeviceMesh` over those ranks and the group
of all of them.  `resolve` needs only the names and sizes, so a
shape-only mesh (`launch.mesh.make_production_mesh`) resolves the
production specs on any machine.  A spec is a tuple with one entry per
tensor dim: None, one mesh-axis name, or a tuple of names (the entries of
the reference's ``PartitionSpec``).  `NamedSharding` turns a spec into
DTensor placements, one ``Shard(dim)`` or ``Replicate()`` per mesh dim; a
dim spread over several mesh axes, such as ("pod", "data"), is split
major to minor, as JAX splits it (and as DTensor splits a dim that
several mesh dims shard, in mesh-dim order).

The active mesh and rules are process-wide (`_State`).  The reference's
`shard_map` and `set_mesh` are JAX plumbing (a per-device program, a
mesh context for tracing) and have no counterpart: a rank of a process
group is already its own program.

Params, optimizer state and the batch are DTensors on the mesh's
`DeviceMesh` (`distribute`): model code runs on them unchanged, DTensor's
sharding propagation inserting the gathers, partial-sum reductions and
reduce-scatters that GSPMD would, and `shard` at the reference's call
sites redistributes an activation where the reference constrains it.  The
few bodies DTensor cannot propagate (an op with no sharding strategy, or
plain tensors made inside the body) run on local tensors between
`to_local` and `from_local`, whose placements say where each operand is
gathered to and how its gradient comes back; each such place names its
collective bytes in ROADMAP.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence

# Logical axis -> tuple of mesh axes (joined) in priority order.  A mesh
# axis is used only if present in the active mesh.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),   # data parallel over pods x in-pod data axis
    "fsdp": ("data",),          # parameter/optimizer-state sharding (ZeRO/FSDP)
    "fsdp_pod": ("pod", "data"),  # cross-pod ZeRO-3 (opt-in per config)
    "tensor": ("model",),       # megatron tensor parallel
    "expert": ("model",),       # expert parallel (MoE), in-pod by design
    "vocab": ("model",),        # vocab/embedding sharding
    "seq": (),                  # sequence parallel (off by default)
    "kv_batch": ("pod", "data"),  # KV-cache batch dim
    "seq_kv": (),               # KV-cache sequence dim (long_500k remaps -> data)
    "none": (),
}

Spec = tuple   # one entry per tensor dim: None, an axis name, or a tuple of names


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes; `device_mesh` (a DeviceMesh over
    the first prod(shape) ranks) and `group` (the process group of those
    ranks) when a process group is up, else None (a shape-only mesh)."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_mesh: Any = None
    group: Any = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coordinate(self) -> dict[str, int]:
        """This rank's index along every mesh axis (a DeviceMesh's
        coordinate; ranks are numbered row-major, pod-major)."""
        if self.device_mesh is None:
            raise ValueError("a shape-only mesh has no ranks")
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        return dict(zip(self.axis_names, coord))

    def axis_group(self, name: str):
        """The process group of this rank's line along mesh axis `name`."""
        if self.device_mesh is None:
            raise ValueError("a shape-only mesh has no process groups")
        return self.device_mesh.get_group(name)


class _State:
    """The active mesh and rules, process-wide: the autograd engine runs
    a CUDA backward (and the recompute of a checkpoint in it) on its own
    device thread, which must see the mesh the forward ran under."""

    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)


_STATE = _State()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Activate `mesh` (+ optional rule overrides) for logical sharding."""
    prev_mesh, prev_rules = _STATE.mesh, _STATE.rules
    _STATE.mesh = mesh
    if rules:
        merged = dict(DEFAULT_RULES)
        merged.update(rules)
        _STATE.rules = merged
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev_mesh, prev_rules


@contextlib.contextmanager
def use_rules(overrides: dict):
    """Rule overrides for a region (e.g. the Uno step's per-pod batches,
    whose 'batch' axis must stop referencing 'pod')."""
    prev = _STATE.rules
    merged = dict(prev)
    merged.update(overrides)
    _STATE.rules = merged
    try:
        yield
    finally:
        _STATE.rules = prev


def active_mesh() -> Optional[Mesh]:
    return _STATE.mesh


def resolve(*logical_axes: Optional[str],
            shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve logical axis names to a spec for the active mesh (() with
    no mesh, as the reference's P()).

    If `shape` is given, mesh axes that do not evenly divide the
    corresponding dim are dropped (from the right), e.g. 9 heads on a
    16-way `model` axis, or batch = 1 cells."""
    mesh = _STATE.mesh
    if mesh is None:
        return ()
    sizes = mesh.axis_sizes
    used: set[str] = set()
    out = []
    for i, ax in enumerate(logical_axes):
        if ax is None:
            out.append(None)
            continue
        picked = [a for a in _STATE.rules.get(ax, ())
                  if a in sizes and a not in used]
        if shape is not None:
            while picked and shape[i] % math.prod(sizes[a] for a in picked):
                picked.pop()
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return tuple(out)


def profile_rules(cfg) -> dict:
    """Logical-rule overrides for a config's sharding profile.

    'dp': tiny models (e.g. 135M on 256 chips) waste the mesh on 2D
    sharding: indivisible head/ff dims leave weights half-replicated while
    activations thrash through reshards.  Replicate the weights outright
    and give the batch every mesh axis."""
    if getattr(cfg, "sharding_profile", "2d") == "dp":
        every = ("pod", "data", "model")
        return {"batch": every, "kv_batch": every, "fsdp": (),
                "fsdp_pod": (), "tensor": (), "vocab": (), "expert": ()}
    return {}


def batch_group_count(n: int) -> int:
    """How many shards the logical 'batch' axis maps to on the active mesh
    (and that divide n): MoE dispatch keeps its token sort / scatter local
    to each batch shard."""
    mesh = _STATE.mesh
    if mesh is None:
        return 1
    sizes = mesh.axis_sizes
    g = 1
    for a in _STATE.rules.get("batch", ()):
        if a in sizes:
            g *= sizes[a]
    while g > 1 and n % g:
        g //= 2
    return g


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding(NamedTuple):
    """A spec on a mesh: its DTensor placements and each rank's block."""
    mesh: Mesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: Shard(d) where the spec
        puts that mesh axis on tensor dim d, else Replicate().  An axis
        of size 1 is Replicate() either way (its one rank holds the
        whole dim; DTensor then merges and splits that dim freely)."""
        from torch.distributed.tensor import Replicate, Shard
        where = {}
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            order = [self.mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry!r} splits dim {d} against the mesh "
                    f"order {self.mesh.axis_names}: DTensor splits a dim "
                    "over several mesh dims in mesh order")
            where.update({a: d for a in axes})
        sizes = self.mesh.axis_sizes
        return tuple(Shard(where[a]) if a in where and sizes[a] > 1
                     else Replicate() for a in self.mesh.axis_names)

    def local_block(self, shape: Sequence[int],
                    coord: Optional[dict] = None):
        """(offsets, sizes) of the block of a `shape` tensor that the rank
        at `coord` (this rank's by default) holds: each sharded dim split
        major to minor over its axes, in torch.chunk's (DTensor's)
        blocks."""
        coord = self.mesh.coordinate() if coord is None else coord
        sizes = self.mesh.axis_sizes
        offs, lens = [], []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            off = 0
            for a in _entry_axes(entry):
                step = -(-n // sizes[a])
                lo = min(coord[a] * step, n)
                off += lo
                n = min(step, n - lo)
            offs.append(off)
            lens.append(n)
        return tuple(offs), tuple(lens)

    def local(self, x, coord: Optional[dict] = None):
        """This rank's block of the global tensor `x` (a view)."""
        offs, lens = self.local_block(x.shape, coord)
        for d, (o, n) in enumerate(zip(offs, lens)):
            if n != x.shape[d]:
                x = x.narrow(d, o, n)
        return x


def shard(x, *logical_axes: Optional[str]):
    """The reference's with_sharding_constraint under the active mesh: a
    DTensor is redistributed to the resolved placements; a plain tensor
    (a rank-local activation) and any tensor with no mesh are returned
    unchanged."""
    mesh = _STATE.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve(*logical_axes, shape=x.shape)
    return x.redistribute(mesh.device_mesh,
                          NamedSharding(mesh, spec).placements)


def named_sharding(*logical_axes: Optional[str],
                   shape: Optional[Sequence[int]] = None
                   ) -> Optional[NamedSharding]:
    mesh = _STATE.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve(*logical_axes, shape=shape))


def spec_tree_to_shardings(mesh: Mesh, spec_tree):
    """A nested dict of specs -> the same dict of `NamedSharding`."""
    if isinstance(spec_tree, dict):
        return {k: spec_tree_to_shardings(mesh, v)
                for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def ring_shift(tensors: Sequence, group, shift: int = 1) -> list:
    """The ring permutation over the ranks of `group` (the reference's
    ``ppermute(x, axis, [(i, (i + shift) % n)])``): this rank sends each
    tensor to rank + shift and receives the same-shaped tensors from rank
    - shift, all in one `batch_isend_irecv` (at n = 2 both neighbors are
    one rank).  Returns the received tensors."""
    import torch
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i)
           for i, t in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag=i)
            for i, t in enumerate(recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


# ------------------------------------------------------------ DTensors

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = _STATE.mesh if mesh is None else mesh
    if mesh is None or mesh.device_mesh is None:
        raise ValueError("DTensor placement needs a mesh with a DeviceMesh "
                         "(launch.mesh.make_mesh / make_fake_mesh)")
    return mesh


def placements(spec: Spec, partial: Sequence[str] = (),
               mesh: Optional[Mesh] = None) -> tuple:
    """`NamedSharding(mesh, spec).placements` (the active mesh by
    default), with each mesh axis named in `partial` a pending sum
    (``Partial()``) instead."""
    from torch.distributed.tensor import Partial
    mesh = _mesh(mesh)
    out = NamedSharding(mesh, spec).placements
    return tuple(Partial() if a in partial else p
                 for a, p in zip(mesh.axis_names, out))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_local(t, spec: Spec, shape, partial: Sequence[str] = (),
               mesh: Optional[Mesh] = None):
    """The DTensor of global `shape` whose block on this rank is `t`,
    placed by `spec` (and pending sums over the `partial` axes).
    Differentiable: the gradient comes back as this rank's block."""
    from torch.distributed.tensor import DTensor
    mesh = _mesh(mesh)
    return DTensor.from_local(t, mesh.device_mesh,
                              placements(spec, partial, mesh),
                              shape=tuple(shape),
                              stride=_contiguous_stride(shape),
                              run_check=False)


def to_local(x, spec: Spec, grad_partial: Sequence[str] = (),
             mesh: Optional[Mesh] = None):
    """This rank's block of DTensor `x` redistributed to `spec`.  Its
    gradient is taken as a pending sum over the `grad_partial` axes (the
    axes along which this rank's use of the block covers only its own
    rows, e.g. the batch axes of a replicated weight)."""
    mesh = _mesh(mesh)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh=mesh)) \
        .to_local(grad_placements=placements(spec, grad_partial, mesh))


def replicate_like(x, *ts):
    """`ts` as DTensors replicated on `x`'s mesh when `x` is a DTensor
    (positions, masks and tables made inside model code), else as they
    are."""
    if not is_dtensor(x):
        return ts if len(ts) > 1 else ts[0]
    from torch.distributed.tensor import DTensor, Replicate
    dm = x.device_mesh
    out = tuple(DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                                   run_check=False) for t in ts)
    return out if len(out) > 1 else out[0]


def mesh_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes a spec uses, in spec order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def distribute(tree, shardings):
    """A nested dict of global tensors -> the same dict of DTensors, each
    leaf built from this rank's block (a copy) under the same dict of
    `NamedSharding`, with the leaf's global shape: no collective, and on
    ``meta`` nothing is materialized."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return wrap_block(shardings.local(tree).clone(), shardings, tree.shape)


def wrap_block(block, sh: NamedSharding, shape):
    """This rank's `block` of a `shape` tensor placed by `sh`, as a
    DTensor (no collective)."""
    return from_local(block.contiguous(), sh.spec, shape, mesh=sh.mesh)


def local_tree(tree):
    """Each DTensor leaf's local block (plain leaves as they are)."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    return tree.to_local() if is_dtensor(tree) else tree


def wrap_like(tree, like):
    """Local blocks -> DTensors with the placements and global shapes of
    the DTensor leaves of `like` (plain leaves of `like`: as they are)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: wrap_like(v, like[k]) for k, v in tree.items()}
    if not is_dtensor(like):
        return tree
    return DTensor.from_local(tree, like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride(),
                              run_check=False)
