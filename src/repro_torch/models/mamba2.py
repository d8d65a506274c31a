"""Mamba2 / SSD (state-space duality) block, chunked train scan and O(1)
decode: the reference's ``repro.models.mamba2`` in PyTorch.

Within a chunk of Q tokens the SSD form is attention-like, a (Q, Q)
product with a causal decay mask; across chunks a linear recurrence
carries the (B, H, N, P) state.  B and C use one group broadcast over the
heads.  The arithmetic is the reference's, in its order: the causal conv
accumulates its taps in float32, `dt` is a float32 softplus, the chunk
body runs in float32.  Its three-operand einsums are written as two
products each, so that no (B, Q, K, H, P) intermediate is ever formed
(3.2 GB a chunk at mamba2-130m's width and 8 x 1,024 tokens).  As the
reference checkpoints its scan body, each chunk runs under a
non-reentrant ``torch.utils.checkpoint`` when gradients are on: the
backward pass keeps the state carry and recomputes the rest.

On a mesh `shard` constrains the input projection and the gated output
to "tensor" (``mamba2.py:86, 134``); the conv and the scan between them
run on each rank's batch rows (`_ssd_local`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import checkpointed, rms_norm
from repro_torch.models.params import ParamDef
from repro_torch.sharding import shard

F32 = torch.float32


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    H = cfg.n_ssm_heads
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    conv_ch = d_in + 2 * N                      # conv runs over (x, B, C)
    zxbcdt = 2 * d_in + 2 * N + H               # z, x, B, C, dt
    return d_in, H, N, P, conv_ch, zxbcdt


def mamba_param_defs(cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    d_in, H, N, P, conv_ch, zxbcdt = ssm_dims(cfg)
    L = (n_layers,)
    ax = (None,)
    return {
        "norm": ParamDef(L + (d,), ax + (None,), init="ones"),
        "in_proj": ParamDef(L + (d, zxbcdt), ax + ("fsdp", "tensor")),
        "conv_w": ParamDef(L + (cfg.ssm_conv_width, conv_ch),
                           ax + (None, "tensor"), scale=0.5),
        "conv_b": ParamDef(L + (conv_ch,), ax + ("tensor",), init="zeros"),
        "dt_bias": ParamDef(L + (H,), ax + ("tensor",), F32, init="zeros"),
        "A_log": ParamDef(L + (H,), ax + ("tensor",), F32, init="zeros"),
        "D": ParamDef(L + (H,), ax + ("tensor",), F32, init="ones"),
        "gate_norm": ParamDef(L + (d_in,), ax + ("tensor",), init="ones"),
        "out_proj": ParamDef(L + (d_in, d), ax + ("tensor", "fsdp")),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv of width W.  xbc: (B, S, C); w: (W, C);
    b: (C,).  The taps accumulate in order in float32, the bias is added
    after them, then silu; the result in xbc's dtype."""
    W = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    acc = torch.zeros(xbc.shape, dtype=F32, device=xbc.device)
    for i in range(W):
        acc = acc + pad[:, i:i + S].to(F32) * w[i].to(F32)
    return F.silu(acc + b.to(F32)).to(xbc.dtype)


def _split_proj(proj, cfg: ModelConfig):
    d_in, H, N, P, conv_ch, _ = ssm_dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + conv_ch]
    dt = proj[..., d_in + conv_ch:]
    return z, xbc, dt


def _chunk_body(state, cum_k, clast_k, B_k, C_k, dtx_k):
    """One chunk of the SSD scan, float32.  state: (B, H, N, P); cum_k:
    (B, Q, H) inclusive cumulative log decay; clast_k: (B, H); B_k, C_k:
    (B, Q, N); dtx_k: (B, Q, H, P).  Returns (new state, y (B, Q, H, P))."""
    Q = cum_k.shape[1]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=cum_k.device))
    CB = torch.bmm(C_k, B_k.transpose(1, 2))                   # (B, Q, K)
    # the causal mask goes on the exponent, not (as in the reference) on
    # its result: above the diagonal cum_q - cum_k grows with the chunk
    # and overflows to inf at mamba2-130m's chunk of 256, and the masked
    # inf turns the reference's gradient NaN (0 x inf); exp(-inf) = 0
    # gives the same values and finite gradients (ROADMAP caveats)
    seg = torch.exp(torch.where(
        tri[None, :, :, None], cum_k[:, :, None, :] - cum_k[:, None, :, :],
        torch.full((), float("-inf"), dtype=F32, device=cum_k.device)))
    # y_in[b,q,h,p] = sum_k CB[b,q,k] seg[b,q,k,h] dtx[b,k,h,p]
    M = (CB[..., None] * seg).permute(0, 3, 1, 2)              # (B, H, Q, K)
    y_in = torch.matmul(M, dtx_k.permute(0, 2, 1, 3))          # (B, H, Q, P)
    # y_x[b,q,h,p] = sum_n C[b,q,n] state[b,h,n,p] exp(cum[b,q,h])
    y_x = torch.matmul(C_k[:, None], state) * \
        torch.exp(cum_k).permute(0, 2, 1)[..., None]           # (B, H, Q, P)
    # contrib[b,h,n,p] = sum_k B[b,k,n] dtx[b,k,h,p] exp(clast - cum)[b,k,h]
    w = dtx_k * torch.exp(clast_k[:, None] - cum_k)[..., None]  # (B,K,H,P)
    contrib = torch.matmul(B_k.transpose(1, 2)[:, None],
                           w.permute(0, 2, 1, 3))              # (B, H, N, P)
    state = state * torch.exp(clast_k)[..., None, None] + contrib
    return state, (y_in + y_x).permute(0, 2, 1, 3)


def _ssd(proj, p, cfg: ModelConfig, S0: int, return_state: bool):
    """The causal conv and the chunked SSD scan on plain tensors.
    proj: (B, S, zxbcdt) with S padded to whole chunks.  Returns the
    gated y (B, S0, d_in) float32, and with `return_state` also the
    prefill handoff (conv_tail, final state)."""
    B, S, _ = proj.shape
    d_in, H, N, P, conv_ch, _ = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, S0)
    nc = S // Q
    z, xbc_raw, dt_raw = _split_proj(proj, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs, B_, C_ = xbc[..., :d_in], xbc[..., d_in:d_in + N], xbc[..., d_in + N:]

    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))     # (B, S, H)
    if S != S0:  # padded steps must be state-identity (decay 1, contribution 0)
        dt = dt * (torch.arange(S, device=proj.device) < S0).to(F32)[
            None, :, None]
    A = -torch.exp(p["A_log"].to(F32))                          # (H,)
    x_h = xs.reshape(B, S, H, P)
    dtx = x_h.to(F32) * dt[..., None]                           # (B, S, H, P)

    # chunked views
    a_c = (dt * A).reshape(B, nc, Q, H)          # per-step log decay
    cum = torch.cumsum(a_c, dim=2)               # inclusive
    c_last = cum[:, :, -1]                       # (B, nc, H)
    Bc = B_.reshape(B, nc, Q, N).to(F32)
    Cc = C_.reshape(B, nc, Q, N).to(F32)
    dtx_c = dtx.reshape(B, nc, Q, H, P)

    body = checkpointed(_chunk_body)
    state = torch.zeros((B, H, N, P), dtype=F32, device=proj.device)
    ys = []
    for c in range(nc):
        state, y_c = body(state, cum[:, c], c_last[:, c], Bc[:, c],
                          Cc[:, c], dtx_c[:, c])
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    y = y + p["D"].to(F32)[None, None, :, None] * x_h.to(F32)
    y = (y.reshape(B, S, d_in) * F.silu(z.to(F32)))[:, :S0]
    if not return_state:
        return y
    W = cfg.ssm_conv_width
    lo = max(0, S0 - (W - 1))
    conv_tail = xbc_raw[:, lo:S0]                     # (B, <= W - 1, conv_ch)
    if S0 < W - 1:
        conv_tail = F.pad(conv_tail, (0, 0, W - 1 - S0, 0))
    return y, conv_tail, state


_SSD_PARAMS = ("conv_w", "conv_b", "dt_bias", "A_log", "D")


def _ssd_local(proj, p, cfg: ModelConfig, S0: int, return_state: bool):
    """`_ssd` on DTensors: proj gathered whole along its model dim (the
    conv and the split of z, x, B, C and dt have no sharding strategy)
    and every head computed on each rank's batch rows; the small SSD
    params replicated, their gradients pending over the batch axes.
    Outputs replicated along the model axis."""
    B, S, Z = proj.shape
    d_in = ssm_dims(cfg)[0]
    spec = sharding.resolve("batch", None, None, shape=proj.shape)
    batch = sharding.mesh_axes(spec)
    local = {n: sharding.to_local(p[n], (), grad_partial=batch)
             for n in _SSD_PARAMS}
    out = _ssd(sharding.to_local(proj, spec), local, cfg, S0, return_state)
    if not return_state:
        return sharding.from_local(out, spec, (B, S0, d_in))
    y, tail, state = out
    return (sharding.from_local(y, spec, (B, S0, d_in)),
            sharding.from_local(tail.contiguous(), spec,
                                (B,) + tuple(tail.shape[1:])),
            sharding.from_local(state, spec + (None, None),
                                (B,) + tuple(state.shape[1:])))


def mamba_block(h, p, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence SSD with the residual.  h: (B, S, d) -> (B, S, d).

    With return_state=True also returns (conv_tail, final_ssm_state) for
    the prefill -> decode handoff: conv_tail is the last W - 1 *pre-conv*
    xbc rows (B, W - 1, conv_ch), left-padded with zeros when S < W - 1."""
    B, S0, d = h.shape
    Q = min(cfg.ssm_chunk, S0)
    pad = (-S0) % Q

    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    if pad:
        hn = F.pad(hn, (0, 0, 0, pad))
    proj = torch.matmul(hn, p["in_proj"])
    proj = shard(proj, "batch", None, "tensor")
    ssd = _ssd_local if sharding.is_dtensor(proj) else _ssd
    out = ssd(proj, p, cfg, S0, return_state)
    y = out[0] if return_state else out
    y = rms_norm(y.to(h.dtype), p["gate_norm"], cfg.norm_eps)
    y = shard(y, "batch", None, "tensor")
    out_h = h + torch.matmul(y, p["out_proj"])
    if return_state:
        return out_h, (out[1], out[2])
    return out_h


def mamba_cache_defs(cfg: ModelConfig, n_layers: int, batch: int) -> dict:
    """The SSM's decode state: the last W - 1 pre-conv rows (compute
    dtype) and the (H, N, P) float32 state, per layer; O(1) in the
    sequence length."""
    d_in, H, N, P, conv_ch, _ = ssm_dims(cfg)
    W = cfg.ssm_conv_width
    return {
        "conv": ParamDef((n_layers, batch, W - 1, conv_ch),
                         (None, "kv_batch", None, "tensor"), init="zeros"),
        "ssm": ParamDef((n_layers, batch, H, N, P),
                        (None, "kv_batch", "tensor", None, None), F32,
                        init="zeros"),
    }


def mamba_decode_step(h, cache_l, p, cfg: ModelConfig):
    """One-token SSD step.  h: (B, 1, d); cache_l = (conv_state (B, W - 1,
    C), ssm_state (B, H, N, P)).  Returns (out, (new_conv, new_ssm)); the
    window is concatenated in the cache's dtype, the conv runs in float32
    (and, unlike `mamba_block`'s, its output stays float32)."""
    B = h.shape[0]
    d_in, H, N, P, conv_ch, _ = ssm_dims(cfg)
    conv_state, ssm_state = cache_l

    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    proj = torch.matmul(hn, p["in_proj"])
    z, xbc, dt_raw = _split_proj(proj, cfg)
    window = torch.cat([conv_state, xbc[:, :1].to(conv_state.dtype)], dim=1)
    conv_out = (window.to(F32) * p["conv_w"].to(F32)[None]).sum(dim=1)
    xbc_t = F.silu(conv_out + p["conv_b"].to(F32))              # (B, C) f32
    new_conv = window[:, 1:]

    xs, B_, C_ = xbc_t[:, :d_in], xbc_t[:, d_in:d_in + N], xbc_t[:, d_in + N:]
    dt = F.softplus(dt_raw[:, 0].to(F32) + p["dt_bias"].to(F32))  # (B, H)
    A = -torch.exp(p["A_log"].to(F32))
    x_h = xs.reshape(B, H, P)
    decay = torch.exp(dt * A)                                   # (B, H)
    contrib = B_[:, None, :, None] * (x_h * dt[..., None])[:, :, None, :]
    new_ssm = ssm_state * decay[..., None, None] + contrib      # (B,H,N,P)
    y = torch.matmul(C_[:, None, None, :], new_ssm)[:, :, 0] + \
        p["D"].to(F32)[None, :, None] * x_h                     # (B, H, P)
    y = y.reshape(B, 1, d_in) * F.silu(z.to(F32))
    y = rms_norm(y.to(h.dtype), p["gate_norm"], cfg.norm_eps)
    out = h + torch.matmul(y, p["out_proj"])
    return out, (new_conv, new_ssm)
