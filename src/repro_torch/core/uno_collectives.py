"""UnoRC applied to cross-pod training: the chunked, int8-quantized,
RS(8, 2)-protected gradient exchange over the `pod` axis (the paper's
Fig 13 C workload: data-parallel training across two DCs with an
Allreduce per iteration).

The reference (``repro.core.uno_collectives``) runs one program per pod
under `shard_map` and moves each protected chunk with `ppermute`.  Here
every pod's copy lives on one card as dim 0 of a (p, N) tensor, and the
transfer `ppermute(x, "pod", [(i, (i + 1) % p)])` is the same permutation
along dim 0: pod j receives pod j - 1's value (`torch.roll`).  The ring's
per-pod `take`/`put` at index (pod - s) become gathers and scatters with
per-pod index tensors.  Every hop is protected:

  * `_protect`: int8 block quantization (K4), the bytes framed into
    `uno_ec_data` rows, `uno_ec_parity` RS parity rows (K3 encode);
  * `_unprotect`: the receiver RS-decodes rows {0 .. y-1} from the
    survivors (K3 decode) and dequantizes (K5).

`_quant`/`_dequant`/`_rs_encode`/`_rs_decode` go through the kernel
wrappers, which launch the Hopper kernels for CUDA tensors and run the
plain versions for CPU ones; ``backend="plain"`` runs the plain versions
on any device (the card's reference run).

The f32 arithmetic follows the reference one for one, in the same order,
in its jitted form.  The pairwise mean is (c + recv) * 0.5 and the ring
adds take + recv, where XLA contracts the receiver's dequantize (q *
scale) and the add into one fused multiply-add, fma(q, scale, c): so does
the port (K5 with an addend).  The ring's final `/ n_pods` is, under jit,
a multiply by f32(1 / p).

On one card the reference's two implementations (`uno_impl` "leaf_local"
and "flat") compute the same function: with no in-pod axes their padding
units are equal.  The port has the one code path.

With a pod process group (``group=``, one pod per rank) the same ring
runs over ranks: each rank holds its own (1, N) row, the roll along dim
0 becomes one `batch_isend_irecv` (`sharding.ring_shift`: the rows,
scales and parity go to pod + 1, this rank receives pod - 1's), and the
ring's per-pod indices index this rank's own row.  Each rank returns its
own row, which is what each device of the reference's pod mesh keeps;
every op is row-local, so rank j's result is bitwise row j of the
stacked run.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import params as P
from repro_torch.sharding import ring_shift

F32 = torch.float32
BACKENDS = ("auto", "plain")


def _check_backend(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _quant(v, backend):
    if backend == "auto":
        return ops.quant_int8(v)
    vp = F.pad(v, (0, (-v.shape[-1]) % ops.QUANT_BLOCK))
    q, s = ref.quant_int8_ref(vp, ops.QUANT_BLOCK)
    return q, s, v.shape[-1]


def _dequant(q, s, n0, backend, acc=None):
    if backend == "auto":
        return ops.dequant_int8(q, s, n0, acc=acc)
    if acc is not None:
        acc = ops.pad_to(acc, q.shape[-1])
    return ref.dequant_int8_ref(q, s, ops.QUANT_BLOCK, acc=acc)[..., :n0]


def _rs_encode(rows, r, backend):
    if backend == "auto":
        return ops.rs_encode(rows, r)
    return ref.rs_encode_ref(rows, r)


def _rs_decode(survivors, k, r, missing, parity_avail, backend):
    if backend == "auto":
        return ops.rs_decode(survivors, k, r, missing, parity_avail)
    return ref.rs_decode_ref(survivors, k, r, missing, parity_avail)


# --------------------------------------------------------------- wire format

def _protect(chunk, run: RunConfig, backend: str = "auto"):
    """chunk f32 (..., C) -> (q_rows uint8 (..., x, Cpad / x), scales f32
    (..., Cpad / 256), parity uint8 (..., y, Cpad / x), n0 = C)."""
    x, y = run.uno_ec_data, run.uno_ec_parity
    q, scales, n0 = _quant(chunk, backend)
    rows = q.view(torch.uint8).reshape(*q.shape[:-1], x, -1)
    return rows, scales, _rs_encode(rows, y, backend), n0


def _unprotect(rows, scales, parity, n0, run: RunConfig, dtype=F32,
               backend: str = "auto", acc=None):
    """Receiver: RS-decode rows {0 .. y-1} from the survivors and use the
    reconstruction (equal to the wire copy when nothing was lost).  With
    `acc` ((..., n0) f32) it returns acc + the received chunk as one fused
    multiply-add, fma(q, scale, acc): XLA contracts the reference's
    dequantize-then-add into exactly that."""
    x, y = run.uno_ec_data, run.uno_ec_parity
    missing = tuple(range(y))                      # designated decode rows
    survivors = torch.cat([rows[..., y:, :], parity], dim=-2)
    rebuilt = _rs_decode(survivors, x, y, missing, tuple(range(y)), backend)
    full = torch.cat([rebuilt, rows[..., y:, :]], dim=-2)
    q = full.reshape(*full.shape[:-2], -1).view(torch.int8)
    return _dequant(q, scales, n0, backend, acc).to(dtype)


# ------------------------------------------------------------- pod exchange

def _pod_ring_psum(v, run: RunConfig, n_pods: int, backend: str = "auto",
                   group=None):
    """Every pod's copy of the mean over pods of a pod-stacked (p, N) f32
    tensor, via `uno_chunks` independent protected chunk streams (ring
    reduce-scatter + all-gather for p > 2, one pairwise exchange for
    p = 2).  Returns (p, N): row j is what pod j ends with; the rows
    differ by the quantization of the hops each pod received.  With a
    pod `group` of n_pods ranks, `v` is this rank's (1, N) row and the
    result its (1, N) row."""
    _check_backend(backend)
    rows_here, n = v.shape
    if group is None:
        if rows_here != n_pods:
            raise ValueError(f"v has {rows_here} pod rows, n_pods is "
                             f"{n_pods}")
        pod = torch.arange(n_pods, device=v.device)
    else:
        import torch.distributed as dist
        if rows_here != 1 or dist.get_world_size(group) != n_pods:
            raise ValueError(f"v of shape {tuple(v.shape)} on a pod group "
                             f"of {dist.get_world_size(group)} ranks, "
                             f"n_pods {n_pods}: want (1, N) on n_pods")
        pod = torch.full((1,), dist.get_rank(group), device=v.device)
    row = torch.arange(rows_here, device=v.device)
    n_chunks = max(1, run.uno_chunks)
    vp = F.pad(v, (0, (-n) % (n_chunks * run.uno_ec_data * ops.QUANT_BLOCK)))
    chunks = vp.chunk(n_chunks, dim=1)

    def send(chunk, acc=None):
        """Protect, move pod j-1's wire bytes to pod j, unprotect (adding
        the received chunk to `acc` when it is given)."""
        wire = _protect(chunk, run, backend)
        if group is None:
            rows, scales, parity = (torch.roll(t, 1, dims=0)
                                    for t in wire[:3])
        else:
            rows, scales, parity = ring_shift(wire[:3], group)
        return _unprotect(rows, scales, parity, wire[3], run,
                          backend=backend, acc=acc)

    if n_pods == 2:
        out = [send(c, acc=c) * 0.5 for c in chunks]     # (c + recv) * 0.5
        return torch.cat(out, dim=1)[:, :n]

    inv_p = float(np.float32(1.0 / n_pods))
    out_chunks = []
    for c in chunks:
        cp = F.pad(c, (0, (-c.shape[1]) % n_pods))
        parts = cp.reshape(rows_here, n_pods, -1)  # (pod row, part, L)
        # RS phase: step s moves the running sum of ring index (pod - s)
        for s in range(n_pods - 1):
            tgt = (pod - s - 1) % n_pods               # take + recv:
            parts[row, tgt] = send(parts[row, (pod - s) % n_pods],
                                   acc=parts[row, tgt])  # from pod - 1
        # pod j now owns the full sum of part (j + 1) % p
        # AG phase: circulate the owned parts around the ring
        for s in range(n_pods - 1):
            recv = send(parts[row, (pod + 1 - s) % n_pods])
            parts[row, (pod - s) % n_pods] = recv
        out_chunks.append(parts.reshape(rows_here, -1)[:, :c.shape[1]]
                          * inv_p)
    return torch.cat(out_chunks, dim=1)[:, :n]


def wire_bytes(n_params: int, run: RunConfig, n_pods: int) -> int:
    """Bytes one pod sends across the DCI per sync of an n_params
    gradient: every protected send's frame as `_protect` builds it (the
    int8 rows, the RS parity rows and the f32 scales of a padded chunk at
    p = 2, of a padded ring part at p > 2), over the sends of
    `_pod_ring_psum` (one per chunk at p = 2, 2 (p - 1) on the ring)."""
    n_chunks = max(1, run.uno_chunks)
    unit = n_chunks * run.uno_ec_data * ops.QUANT_BLOCK
    part = -(-n_params // unit) * unit // n_chunks
    sends = 1
    if n_pods > 2:
        sends = 2 * (n_pods - 1)
        part = -(-part // n_pods)
        part += (-part) % ops.QUANT_BLOCK
    frame = (part + part // run.uno_ec_data * run.uno_ec_parity
             + 4 * (part // ops.QUANT_BLOCK))
    return n_chunks * sends * frame


# ----------------------------------------------------------------- flattening

def _flatten(stacked, n_pods: int):
    """Pod-stacked tree -> ((p, N) f32 in JAX leaf order, meta)."""
    leaves, treedef = P.flatten(stacked)
    flat = torch.cat([l.reshape(n_pods, -1).to(F32) for l in leaves], dim=1)
    return flat, (treedef, [l.shape[1:] for l in leaves],
                  [l.dtype for l in leaves])


def _unflatten(flat, meta):
    """(N,) f32 -> the tree, each leaf cast back to its dtype (bf16 by
    round-to-nearest-even, as XLA casts)."""
    treedef, shapes, dtypes = meta
    out, off = [], 0
    for shp, dt in zip(shapes, dtypes):
        n = int(np.prod(shp, dtype=np.int64))
        out.append(flat[off:off + n].reshape(shp).to(dt))
        off += n
    return P.unflatten(treedef, out)


# ------------------------------------------------------------------ public

def make_uno_grad_sync(cfg: ModelConfig, run: RunConfig, n_pods: int,
                       device: DeviceLike = None, backend: str = "auto",
                       group=None) -> Callable:
    """Returns uno_sync(stacked): per-pod gradient copies (a nested dict of
    tensors on `device`, each leaf with a leading pod axis of n_pods) ->
    the pod-mean gradients without that axis, leaf dtypes kept.

    `cfg` names the model whose gradients are synced (the reference uses
    it for their partition specs; the port syncs replicated weights).
    The result is pod 0's copy, the one the reference's replicated output
    reads.  With a pod `group` (n_pods ranks, one pod each) uno_sync takes
    this rank's gradients (no pod axis) and returns this rank's copy of
    the pod mean.  `device`: None means cuda (raises with no card); "cpu"
    runs the plain versions.  ``backend="plain"`` runs the plain versions
    on the card too.
    """
    _check_backend(backend)
    dev = resolve_device(device)
    rows = n_pods if group is None else 1

    def uno_sync(stacked):
        leaves, treedef = P.flatten(stacked)
        if group is not None:                  # this rank's row of the stack
            leaves = [l[None] for l in leaves]
            stacked = P.unflatten(treedef, leaves)
        for leaf in leaves:
            if leaf.device.type != dev.type:
                raise ValueError(f"uno_sync for {dev.type}: a leaf is on "
                                 f"{leaf.device}")
            if leaf.shape[0] != rows:
                raise ValueError(f"leaf of shape {tuple(leaf.shape)} has no "
                                 f"leading pod axis of {rows}")
        if n_pods == 1:
            return P.unflatten(treedef, [l[0] for l in leaves])
        flat, meta = _flatten(stacked, rows)
        return _unflatten(_pod_ring_psum(flat, run, n_pods, backend,
                                         group)[0], meta)

    return uno_sync
