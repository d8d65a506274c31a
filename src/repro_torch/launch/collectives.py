"""Collective traffic of one rank's program (the reference's
``repro.launch.hlo_analysis.analyze_collectives``).

The reference parses the collectives of its compiled per-device HLO.
The port's rank program issues them eagerly, so `CollectiveCounter` (a
``TorchDispatchMode``) sees each one as it is dispatched: the
``_c10d_functional`` collectives that DTensor's redistributions issue
(all-gather, reduce-scatter, all-reduce, all-to-all, and DTensor's own
``shard_dim_alltoall``) and the
point-to-point ``c10d`` send / recv of ``batch_isend_irecv`` (the Uno
ring's hops, the pipeline's boundaries) and ``dist.all_reduce`` (the
baseline's pod mean), under any process group, a
``fake`` one included: its collectives move no data, but their ops,
shapes and groups are this rank's.

Each op's bytes follow the reference's ring estimates on the result's
per-device size (``hlo_analysis.py:8-12``):

  all-gather        result * (G-1)/G
  reduce-scatter    result * (G-1)
  all-reduce        2 * result * (G-1)/G
  all-to-all        result * (G-1)/G
  collective-permute result           (a send: the bytes received there)

with G the group's size.  A received buffer is the other side of some
rank's send and is not counted again.  The group's members come from
the op's group (its name for the functional collectives, the process
group for send / recv), as global ranks; a collective counts as DCI when
its group spans more than one pod (ranks pod-major, `pod_size` ranks a
pod), a send when its peer is in another pod; likewise it leaves the
host when its ranks span more than one host of `HOST_CARDS` consecutive
ranks (the roofline prices those bytes at the network's rate, the rest
at NVLink's).  `summarize(events)` returns the reference's keys: ``total_bytes``,
``by_op``, ``dci_bytes``, ``count``, and ``off_host_bytes``.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_fc = torch.ops._c10d_functional
HOST_CARDS = 8          # H100 SXM cards joined by NVLink in one host

# functional collective -> (the reference's op name, index of the group
# name among its arguments)
_FUNCTIONAL = {
    _fc.all_gather_into_tensor.default: ("all-gather", 2),
    _fc.reduce_scatter_tensor.default: ("reduce-scatter", 3),
    _fc.all_reduce.default: ("all-reduce", 2),
    _fc.all_to_all_single.default: ("all-to-all", 3),
    # DTensor's Shard(i) -> Shard(j) on a card (a CPU mesh all-gathers and
    # chunks instead)
    torch.ops._dtensor.shard_dim_alltoall.default: ("all-to-all", 3),
}


def moved_bytes(op: str, result_bytes: float, group_size: int) -> float:
    """Bytes one device moves for `op` on a `result_bytes` result over a
    group of `group_size` (the reference's ring estimates)."""
    g = group_size
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return result_bytes
    raise ValueError(op)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(name: str) -> list[int]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_process_group_ranks(_resolve_process_group(name))


def _pg_ranks(pg) -> list[int]:
    """The global ranks of a send's process group (a boxed script
    object in the op's arguments)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup
    return dist.get_process_group_ranks(ProcessGroup.unbox(pg))


def is_collective(func) -> bool:
    """A collective or point-to-point op the counter prices (their waits
    and wrappers move nothing)."""
    return func in _FUNCTIONAL or func in (torch.ops.c10d.send.default,
                                           torch.ops.c10d.recv_.default,
                                           torch.ops.c10d.allreduce_.default)


class CollectiveCounter(TorchDispatchMode):
    """Records every collective this rank issues while active (see the
    module docstring); `events` holds (op, dtype, result shape, group
    ranks, bytes, dci) per op.  DTensor ops are let through to DTensor
    (``NotImplemented``), whose redistributions then come back here as
    plain collectives."""

    def __init__(self, pod_size: int):
        super().__init__()
        self.pod_size = pod_size
        self.events: list[dict] = []

    def _pods(self, ranks) -> int:
        return len({r // self.pod_size for r in ranks})

    @staticmethod
    def _off_host(ranks) -> bool:
        return len({r // HOST_CARDS for r in ranks}) > 1

    def record(self, func, args, kwargs, out) -> None:
        """Price one collective (`func` called with `args` gave `out`)."""
        import torch.distributed as dist
        if func in _FUNCTIONAL:
            op, gi = _FUNCTIONAL[func]
            ranks = _group_ranks(args[gi])
            res = out
            ev = {"op": op, "dtype": str(res.dtype).removeprefix("torch."),
                  "shape": list(res.shape), "group": ranks}
            ev["bytes"] = moved_bytes(op, _nbytes(res), len(ranks))
            ev["dci"] = self._pods(ranks) > 1
        elif func is torch.ops.c10d.allreduce_.default:
            # dist.all_reduce (the baseline's pod mean, in place)
            tensors = args[0]
            ranks = _pg_ranks(args[1])
            n = sum(_nbytes(t) for t in tensors)
            ev = {"op": "all-reduce",
                  "dtype": str(tensors[0].dtype).removeprefix("torch."),
                  "shape": list(tensors[0].shape), "group": ranks,
                  "bytes": moved_bytes("all-reduce", n, len(ranks)),
                  "dci": self._pods(ranks) > 1}
        elif func is torch.ops.c10d.send.default:
            tensors, pg, dst = args[0], args[1], args[2]
            ranks = _pg_ranks(pg)
            peer = ranks[dst]
            me = dist.get_rank()
            n = sum(_nbytes(t) for t in tensors)
            ev = {"op": "collective-permute",
                  "dtype": str(tensors[0].dtype).removeprefix("torch."),
                  "shape": list(tensors[0].shape), "group": [me, peer],
                  "bytes": float(n),
                  "dci": me // self.pod_size != peer // self.pod_size}
        else:
            return                  # a recv: the sender's permute
        ev["off_host"] = self._off_host(ev["group"])
        self.events.append(ev)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if is_collective(func):
            self.record(func, args, kwargs, out)
        return out


def summarize(events) -> dict:
    """The reference's record of a list of `CollectiveCounter` events."""
    by_op: dict[str, float] = defaultdict(float)
    dci = off = 0.0
    for ev in events:
        by_op[ev["op"]] += ev["bytes"]
        dci += ev["bytes"] if ev["dci"] else 0.0
        off += ev["bytes"] if ev["off_host"] else 0.0
    return {"total_bytes": float(sum(by_op.values())), "by_op": dict(by_op),
            "dci_bytes": float(dci), "count": len(events),
            "off_host_bytes": float(off)}
