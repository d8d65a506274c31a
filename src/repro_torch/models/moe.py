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

On one card the reference's batch groups collapse to one
(``sharding.batch_group_count`` is 1 without a mesh), so the dispatch
runs over all B * S tokens at once; `shard` is a no-op there and has no
counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

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


def moe_ffn(h, p, cfg: ModelConfig, d_ff: int):
    """h: (B, S, d) -> (B, S, d).  p: one layer's slice of
    `moe_param_defs`.

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
    x = h.reshape(T, d)

    # --- routing (f32 for numerics)
    logits = torch.matmul(x.to(F32), p["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)
    gates, topk_idx = torch.topk(probs, k, dim=-1)           # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # --- capacity-bounded dispatch via one stable sort
    cap = capacity(T, cfg)
    eg = topk_idx.reshape(T * k)
    order = torch.argsort(eg, stable=True)
    e_sorted = eg[order]
    rank = torch.arange(T * k, device=h.device) - torch.searchsorted(
        e_sorted, e_sorted, side="left")
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(e_sorted, E * cap))
    tok = order // k
    # every dropped slot lands on the last row (written several times, in
    # no set order on the card), which is sliced away
    buf = torch.zeros((E * cap + 1, d), dtype=h.dtype, device=h.device)
    buf = buf.index_put((slot,), x[tok])
    xe = buf[:E * cap].reshape(E, cap, d)

    # --- expert FFN (swiglu or plain, per cfg.act)
    # the jitted reference casts the activation's product to float32 at
    # once, and XLA then computes it in float32 without rounding it to the
    # compute dtype first: so does the port (as `transformer._logits`)
    if cfg.act == "swiglu":
        g = torch.bmm(xe.to(F32), p["w_gate"].to(F32))
        u = torch.bmm(xe, p["w_up"])
        z = F.silu(g).to(h.dtype) * u
    else:
        u = torch.bmm(xe.to(F32), p["w_up"].to(F32))
        z = F.gelu(u, approximate="tanh").to(h.dtype)
    ye = torch.bmm(z, p["w_down"])

    # --- combine: back through the permutation, dropped slots as zeros
    y_rows = ye.reshape(E * cap, d)
    y_sorted = torch.where(keep[:, None],
                           y_rows[torch.clamp(slot, max=E * cap - 1)],
                           torch.zeros((), dtype=h.dtype, device=h.device))
    y_flat = torch.zeros((T * k, d), dtype=h.dtype,
                         device=h.device).index_put((order,), y_sorted)
    y = (y_flat.reshape(T, k, d).to(F32) * gates[..., None]).sum(dim=1)
    return y.reshape(B, S, d).to(h.dtype)


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
