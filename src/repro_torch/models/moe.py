"""Top-k MoE FFN with capacity-bounded sort-scatter dispatch: the
reference's ``repro.models.moe`` in PyTorch.

Routing runs in float32 (softmax, top-k, the gates renormalized); each
token's k expert slots are sorted by expert (a stable sort), ranked
within their expert, and scattered into an (E * cap + 1, d) buffer whose
last row absorbs every slot past its expert's capacity `cap`.  The
expert products run as batched matmuls over (E, cap, d) in the compute
dtype, the one that feeds the float32 activation in float32; the outputs
go back through the same permutation, dropped slots as zeros, and are
summed over k weighted by the gates in float32.

Without a mesh the reference's batch groups collapse to one
(``sharding.batch_group_count`` is 1), so the dispatch runs over all
B * S tokens at once; under a mesh each batch shard dispatches its own
tokens, and `shard` constrains the buffers at the reference's sites
(``moe.py:78, 91, 102, 106``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef
from repro_torch.sharding import shard

F32 = torch.float32


def moe_param_defs(cfg: ModelConfig, n_layers: int, d_ff: int) -> dict:
    d, E = cfg.d_model, cfg.n_experts
    L = (n_layers,)
    ax = (None,)
    return {
        "norm": ParamDef(L + (d,), ax + (None,), init="ones"),
        "router": ParamDef(L + (d, E), ax + ("fsdp", None), F32),
        "w_gate": ParamDef(L + (E, d, d_ff), ax + ("expert", "fsdp", None)),
        "w_up": ParamDef(L + (E, d, d_ff), ax + ("expert", "fsdp", None)),
        "w_down": ParamDef(L + (E, d_ff, d), ax + ("expert", None, "fsdp")),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: n_tokens * k / E * capacity_factor in Python
    floats, truncated, rounded up to a multiple of 8, at least 8."""
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def _route(logits, k: int):
    """float32 router logits (T, E) -> (gates (T, k), top-k experts)."""
    probs = torch.softmax(logits, dim=-1)
    gates, topk_idx = torch.topk(probs, k, dim=-1)           # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, topk_idx


def _dispatch(xg, eg, E: int, k: int, cap: int):
    """One batch group: xg (Tg, d) tokens, eg (Tg * k,) their experts ->
    (xe (E, cap, d), order, keep, slot), by one stable sort."""
    Tk, d = eg.shape[0], xg.shape[1]
    order = torch.argsort(eg, stable=True)
    e_sorted = eg[order]
    rank = torch.arange(Tk, device=xg.device) - torch.searchsorted(
        e_sorted, e_sorted, side="left")
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(e_sorted, E * cap))
    tok = order // k
    # every dropped slot lands on the last row (written several times, in
    # no set order on the card), which is sliced away
    buf = torch.zeros((E * cap + 1, d), dtype=xg.dtype, device=xg.device)
    buf = buf.index_put((slot,), xg[tok])
    return buf[:E * cap].reshape(E, cap, d), order, keep, slot


def _combine(yg, order, keep, slot, gates, E: int, cap: int):
    """One batch group: its expert outputs yg (E, cap, d) back through
    the permutation (dropped slots as zeros), summed over k weighted by
    the gates in float32 -> (Tg, d) float32."""
    d = yg.shape[-1]
    Tg, k = gates.shape
    y_rows = yg.reshape(E * cap, d)
    y_sorted = torch.where(keep[:, None],
                           y_rows[torch.clamp(slot, max=E * cap - 1)],
                           torch.zeros((), dtype=yg.dtype, device=yg.device))
    y_flat = torch.zeros((Tg * k, d), dtype=yg.dtype,
                         device=yg.device).index_put((order,), y_sorted)
    return (y_flat.reshape(Tg, k, d).to(F32) * gates[..., None]).sum(dim=1)


def _experts(xee, p, cfg: ModelConfig, dtype):
    """The expert FFN over (E, slots, d).  The jitted reference casts the
    activation's product to float32 at once, and XLA then computes it in
    float32 without rounding it to the compute dtype first: so does the
    port (as `transformer._logits`)."""
    if cfg.act == "swiglu":
        g = torch.bmm(xee.to(F32), p["w_gate"].to(F32))
        u = torch.bmm(xee, p["w_up"])
        z = F.silu(g).to(dtype) * u
    else:
        u = torch.bmm(xee.to(F32), p["w_up"].to(F32))
        z = F.gelu(u, approximate="tanh").to(dtype)
    return torch.bmm(z, p["w_down"])


def moe_ffn(h, p, cfg: ModelConfig, d_ff: int):
    """h: (B, S, d) -> (B, S, d).  p: one layer's slice of
    `moe_param_defs`.

    The dispatch is local to each of the G batch groups
    (``sharding.batch_group_count``, 1 without a mesh): each group's
    tokens are sorted and scattered into its own (E, cap, d) buffer, cap
    from the group's token count, and the expert products run over (E,
    G * cap, d), the slot dim group-major.  On DTensors each rank holds
    one group: routing, sort and scatter (no sharding strategy) run on
    its local rows, the buffer becomes the (G, E, cap, d) DTensor that
    the reference constrains to "batch", its transpose is constrained to
    ("expert", "batch") (a local slice of this rank's experts), the
    expert products propagate, and the outputs are gathered back over
    the expert axis to combine on the local rows.

    ``torch.topk`` orders equal probabilities as the device's sort does;
    ``lax.top_k`` takes the lower expert index first.  A tie between the
    k-th and the (k+1)-th probability of a token would therefore route
    it differently from the reference; with float32 probabilities from
    real activations such ties do not come up (the tests draw random
    ones)."""
    del d_ff                                   # the weights' shapes carry it
    B, S, d = h.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = sharding.batch_group_count(T)
    Tg = T // G
    cap = capacity(Tg, cfg)
    x = h.reshape(T, d)

    # --- routing (f32 for numerics)
    logits = torch.matmul(x.to(F32), p["router"].to(F32))
    if sharding.is_dtensor(h):
        return _moe_groups_dtensor(h, x, logits, p, cfg, G, cap)
    gates, topk_idx = _route(logits, k)

    # --- capacity-bounded group-local dispatch
    eg = topk_idx.reshape(G, Tg * k)
    groups = [_dispatch(x[g * Tg:(g + 1) * Tg], eg[g], E, k, cap)
              for g in range(G)]
    xe = torch.stack([grp[0] for grp in groups])              # (G, E, cap, d)
    xe = shard(xe, "batch", None, None, None)
    xee = xe.transpose(0, 1).reshape(E, G * cap, d)
    xee = shard(xee, "expert", "batch", None)
    ye = _experts(xee, p, cfg, h.dtype)
    ye = shard(ye, "expert", "batch", None)
    yg = ye.reshape(E, G, cap, d).transpose(0, 1)             # (G, E, cap, d)
    yg = shard(yg, "batch", None, None, None)
    y = torch.cat([_combine(yg[g], *groups[g][1:],
                            gates[g * Tg:(g + 1) * Tg], E, cap)
                   for g in range(G)])
    return y.reshape(B, S, d).to(h.dtype)


def _moe_groups_dtensor(h, x, logits, p, cfg, G: int, cap: int):
    """`moe_ffn` on DTensors, one batch group per rank (see there)."""
    B, S, d = h.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    x_spec = sharding.resolve("batch", None, shape=(T, d))
    mesh = sharding.active_mesh()
    sizes = mesh.axis_sizes
    n_rows = math.prod(sizes[a] for a in sharding.mesh_axes(x_spec))
    if n_rows != G:
        raise ValueError(f"{T} tokens in {n_rows} batch shards but "
                         f"{G} dispatch groups")
    gates, topk_idx = _route(sharding.to_local(logits, x_spec), k)
    xl = sharding.to_local(x, x_spec)
    xe_l, order, keep, slot = _dispatch(xl, topk_idx.reshape(-1), E, k, cap)
    g_spec = sharding.resolve("batch", None, None, None, shape=(G, E, cap, d))
    xe = sharding.from_local(xe_l[None], g_spec, (G, E, cap, d))
    xe = shard(xe, "batch", None, None, None)
    xee = xe.transpose(0, 1).reshape(E, G * cap, d)
    xee = shard(xee, "expert", "batch", None)
    ye = _experts(xee, p, cfg, h.dtype)
    ye = shard(ye, "expert", "batch", None)
    yg = ye.reshape(E, G, cap, d).transpose(0, 1)
    yg = shard(yg, "batch", None, None, None)
    yl = sharding.to_local(yg, g_spec)[0]
    y = _combine(yl, order, keep, slot, gates, E, cap).to(h.dtype)
    h_spec = sharding.resolve("batch", None, None, shape=h.shape)
    return sharding.from_local(y.reshape(-1, S, d), h_spec, h.shape)


def aux_load_balance_loss(h, router_w, cfg: ModelConfig):
    """Switch-style load-balance auxiliary: E * sum over experts of the
    top-1 fraction times the mean router probability.  As in the
    reference, no loss of the models calls it."""
    d = h.shape[-1]
    x = h.reshape(-1, d).to(F32)
    probs = torch.softmax(x @ router_w.to(F32), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).to(F32).mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac * imp)
