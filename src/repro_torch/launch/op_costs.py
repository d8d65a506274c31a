"""Op-level cost model of one eager run: flops, HBM bytes and memory (the
reference's ``repro.launch.hlo_costs`` for one card).

`analyze(fn, *args)` runs ``fn(*args)`` under `CostMode`, a
``TorchDispatchMode`` that sees every ATen op the run dispatches (the
autograd engine's backward ops and a checkpoint's recompute included) and
the UnoRC kernels as the custom ops ``repro_torch::gf_matmul`` /
``::quant_int8`` / ``::dequant_int8``.  On ``device="meta"`` nothing is
computed and nothing is allocated, which makes it the port's counterpart
of the reference's 512 placeholder devices: the dry run costs a full-size
step on the CPU in seconds.  On CUDA or CPU tensors the same mode counts
a real run, op for op.

Per run it records:

  flops          ``torch.utils.flop_counter``'s registered formulas (the
                 products, convolutions and attention), applied as
                 ``FlopCounterMode`` applies them, so the totals agree
                 with it; `flops_by_dtype` splits them by the dtype of
                 each op's first floating operand (the roofline prices
                 bf16 and float32 products at their own peaks);
  hbm_bytes      operand plus result bytes of every op that moves data;
                 views (``view``, ``expand``, ``transpose``, ``permute``,
                 ``slice``, ``select``, ``detach``, ``alias``, ...: the
                 ops whose schema returns an alias, and
                 ``_unsafe_view``), allocations without a write
                 (``empty*``) and metadata queries count 0.  K3-K5's
                 custom ops count their operands and results like any op;
  memory         the counterpart of XLA's ``memory_analysis``: argument
                 bytes (the storages ``args`` hold), peak live bytes (every
                 storage an op creates is live from that op until it is
                 released, the arguments throughout), temp bytes (peak -
                 arguments) and output bytes (the storages of the result);
  ops            `n_ops`, the count of each op, the top ops by bytes and
                 by flops, and `kernel_launches`: the UnoRC custom ops
                 under the keys of ``unorc_cuda.LAUNCHES``;
  collectives    `collective_bytes`, `collective_by_op` and
                 `collective_sites` (the count), priced as
                 ``launch.collectives`` prices them, and `collectives`,
                 that module's record with the DCI bytes (`analyze_on`
                 names the pod size; one card issues none).  They are
                 not HBM bytes here: the roofline's collective term
                 holds them.

On a mesh the run's tensors are DTensors: the mode lets each DTensor op
through to DTensor (``NotImplemented``), which dispatches this rank's
local ops and its collectives back through the mode, so the counts are
one rank's program; the ops DTensor's sharding propagation runs on fake
tensors to infer shapes are run and not counted.

The reference multiplies each while-loop body by its trip count, because
XLA's ``cost_analysis`` counts a scanned layer once.  Eager PyTorch
replays each layer, so every op is seen as often as it runs and no
multiplier is needed.
"""
from __future__ import annotations

import gc
import weakref
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import unorc_cuda
from repro_torch.launch import collectives

_aten = torch.ops.aten

# metadata queries: FlopCounterMode passes them through uncounted
_METADATA = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default,
    # a functional collective's wait and wrapper: no work on the device
    # (a meta tensor's collective is not waited on)
    torch.ops._c10d_functional.wait_tensor.default,
    torch.ops._c10d_functional._wrap_tensor_autograd.default,
}
# no data moved: allocations that write nothing, a view without an alias
# annotation
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
}
TOP = 10


def _tensors(tree) -> list:
    """The tensors of `tree`, a DTensor as its local block."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def moves_data(func) -> bool:
    return not (func.is_view or func in _NO_BYTES)


def _flop_dtype(tensors) -> str:
    for t in tensors:
        if t.is_floating_point():
            return str(t.dtype).removeprefix("torch.")
    return "none"


class CostMode(TorchDispatchMode):
    """Counts every op dispatched while it is active; see the module
    docstring.  `track_args(args)` marks the run's argument storages
    live before the run starts."""

    def __init__(self, pod_size=None):
        super().__init__()
        self.coll = None if pod_size is None else \
            collectives.CollectiveCounter(pod_size)
        self.flops = 0
        self.flops_by_dtype: Counter = Counter()
        self.hbm_bytes = 0
        self.ops: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.launches: Counter = Counter()
        # live[0]: bytes of live storages; the finalizers of released
        # storages subtract from it
        self._live = [0]
        self._seen: set = set()
        self.peak = 0

    # -- storages
    def _track(self, t: torch.Tensor) -> int:
        """Mark t's storage live if it is new; returns its new bytes."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen or st.nbytes() == 0:
            return 0
        n = st.nbytes()
        self._seen.add(key)
        self._live[0] += n
        weakref.finalize(st, _release, self._live, self._seen, key, n)
        return n

    def track_args(self, args) -> int:
        n = sum(self._track(t) for t in _tensors(args))
        self.peak = max(self.peak, self._live[0])
        return n

    # -- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor dispatches its local ops
        if func in _METADATA or _propagating():
            return func(*args, **kwargs)
        if collectives.is_collective(func):
            out = func(*args, **kwargs)
            self.ops[func.name()] += 1
            if self.coll is None:
                self.coll = collectives.CollectiveCounter(1 << 30)
            self.coll.record(func, args, kwargs, out)
            for t in _tensors(out):
                self._track(t)
            self.peak = max(self.peak, self._live[0])
            return out
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.name()
        self.ops[name] += 1
        inputs = _tensors((args, kwargs))
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_dtype[_flop_dtype(inputs)] += n
            self.flops_by_op[name] += n
        outputs = _tensors(out)
        if moves_data(func):
            b = sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
            self.hbm_bytes += b
            self.bytes_by_op[name] += b
        for t in outputs:
            self._track(t)
        self.peak = max(self.peak, self._live[0])
        key = unorc_cuda.launch_key(name, args, kwargs)
        if key is not None:
            self.launches[key] += 1
        return out


def _propagating() -> bool:
    """DTensor's sharding propagation is running ops on fake tensors."""
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _release(live, seen, key, n):
    live[0] -= n
    seen.discard(key)


def _top(counter: Counter) -> list:
    return [[k, v] for k, v in counter.most_common(TOP) if v]


def analyze(fn, *args, **kwargs) -> tuple:
    """`analyze_on` with no mesh: (out, costs) of fn(*args, **kwargs)."""
    return analyze_on(None, fn, *args, **kwargs)


def analyze_on(pod_size, fn, *args, **kwargs) -> tuple:
    """(out, costs): fn(*args, **kwargs) run under `CostMode`, and the
    costs of that run as a JSON-ready dict (see the module docstring).
    Python's cycle collector is run before the call and paused during
    it, so that the memory figures do not depend on when a collection
    happens to run: a storage is released when its last reference goes,
    on every device alike, and one held by a reference cycle (the frames
    of the exception with which torch's checkpoint stops its recompute
    early) lives to the end of the call.  The peak is then exact for
    that schedule and an upper bound where the collector runs mid-step
    (qwen3-moe's Uno train_4k step: 10.34 TB paused, 9.40 TB not)."""
    gc.collect()
    paused = gc.isenabled()
    gc.disable()
    mode = CostMode(pod_size)
    try:
        arg_bytes = mode.track_args((args, kwargs))
        with mode:
            out = fn(*args, **kwargs)
    finally:
        if paused:
            gc.enable()
    arg_keys = set()
    for t in _tensors((args, kwargs)):
        arg_keys.add(id(t.untyped_storage()))
    out_storages = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                    for t in _tensors(out)}
    out_bytes = sum(n for k, n in out_storages.items() if k not in arg_keys)
    coll = collectives.summarize(mode.coll.events if mode.coll else [])
    costs = {
        "flops": float(mode.flops),
        "flops_by_dtype": {k: float(v) for k, v in
                           sorted(mode.flops_by_dtype.items())},
        "hbm_bytes": float(mode.hbm_bytes),
        "collective_bytes": coll["total_bytes"],
        "collective_by_op": coll["by_op"],
        "collective_sites": coll["count"],
        "collectives": coll,
        "argument_bytes": arg_bytes,
        "peak_bytes": mode.peak,
        "temp_bytes": mode.peak - arg_bytes,
        "output_bytes": out_bytes,
        "n_ops": sum(mode.ops.values()),
        "ops": dict(sorted(mode.ops.items())),
        "top_ops_by_bytes": _top(mode.bytes_by_op),
        "top_ops_by_flops": _top(mode.flops_by_op),
        "kernel_launches": dict(sorted(mode.launches.items())),
    }
    return out, costs
