"""Core layers of the dense LM: RMSNorm, RoPE, GQA attention with an
online softmax over KV blocks, the three MLPs and the chunked
cross-entropy.

The reference's ``repro.models.layers`` in plain PyTorch: activations in
the config's compute dtype (bf16), norm, softmax and loss numerics in
float32, in the reference's order of operations.  Where the reference
wraps a scan body in ``jax.checkpoint`` (the attention block step, the
loss chunk) the port runs the body under ``torch.utils.checkpoint``
(non-reentrant): the backward pass recomputes the (q, k) score block and
the chunk's logits instead of keeping them; with gradients off (serving,
under ``torch.inference_mode()``) the bodies run directly.  The large
products stay ``torch.matmul`` / ``einsum``.  `decode_attention` is the
serving path's one-token attention against the padded KV cache.

On DTensors (a mesh's params and batch, `sharding.distribute`) the
products, norms and elementwise ops propagate; `shard` constrains the
MLP's hidden activation and the loss chunk's logits where the reference
does (``layers.py:133, 157``).  Three bodies run on each rank's local
blocks instead, because they make plain tensors (masks, carries) or use
ops with no sharding strategy: the attention core on this rank's heads
(q's head block with the KV heads it reads), the embedding lookup on
this rank's vocab rows (masked, its output a pending sum over the vocab
axes, as GSPMD's), and the loss chunk's pick and log-sum-exp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.sharding import shard

F32 = torch.float32
NEG_INF = -1e30


def checkpointed(fn):
    """`fn` under a non-reentrant ``torch.utils.checkpoint`` when
    gradients are on (``jax.checkpoint``: the backward pass recomputes
    its intermediates from its inputs); called directly otherwise.  The
    checkpointed bodies draw no random numbers, so no RNG state is
    stashed and restored around the recompute (`preserve_rng_state`:
    the card's trace then holds the ops a meta trace holds)."""
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return wrapped


def rms_norm(x, w, eps):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(F32)).to(x.dtype)


# ---------------------------------------------------------------- RoPE

def rope_cos_sin(positions, head_dim, theta, dtype):
    """positions: int[...]; returns cos/sin of shape
    positions.shape + (head_dim / 2,)."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=F32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = sharding.replicate_like(x, cos, sin)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------- attention

def _kv_block_step(m, l, acc, qf, k_j, v_j, q_pos, k_pos, causal, kv_len):
    """One online-softmax step over a KV block; f32 m, l and acc."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_j.to(F32))
    mask = None
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if kv_len is not None:
        valid = (k_pos < kv_len)[None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, v_j.to(F32))
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    kv_block: int = 1024, kv_len=None):
    """Online-softmax attention over KV blocks (bounded memory).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); GQA via Hq = G * Hkv.
    kv_len: optional — positions >= kv_len are masked (padded KV cache).
    Returns (B, Sq, Hq, D) in q.dtype.
    """
    if sharding.is_dtensor(q):
        return local_heads(flash_attention, q, k, v, causal=causal,
                           q_offset=q_offset, kv_block=kv_block,
                           kv_len=kv_len)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    blk = min(kv_block, Skv)
    if Skv % blk:
        raise ValueError(f"Skv {Skv} is not a multiple of kv_block {blk}")
    n_blocks = Skv // blk

    scale = D ** -0.5
    qf = (q.to(F32) * scale).reshape(B, Sq, Hkv, G, D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=F32, device=q.device)
    for j in range(n_blocks):
        k_pos = j * blk + torch.arange(blk, device=q.device)
        sl = slice(j * blk, (j + 1) * blk)
        args = (m, l, acc, qf, k[:, sl], v[:, sl], q_pos, k_pos, causal,
                kv_len)
        m, l, acc = checkpointed(_kv_block_step)(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token attention against a padded KV cache.

    q: (B, 1, Hq, D); caches: (B, Smax, Hkv, D); kv_len: the valid length
    (positions >= kv_len are masked).  f32 scores over the whole cache,
    softmax, f32 product with V; GQA through (B, Hkv, G, D).
    """
    if sharding.is_dtensor(q):
        return local_heads(decode_attention, q, k_cache, v_cache,
                           kv_len=kv_len)
    B, _, Hq, D = q.shape
    _, Smax, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qf = (q.to(F32) * D ** -0.5).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(F32))
    mask = torch.arange(Smax, device=q.device)[None, None, None, :] < kv_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(F32))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def local_heads(fn, q, k, v, **kw):
    """`fn(q, k, v, **kw)` (an attention over (B, S, H, D) operands) on
    each rank's local blocks: q's batch rows and head block as `shard`
    left them, k / v redistributed to the same batch rows (heads as
    resolved for their count).  When the KV heads are replicated but q's
    heads are split (granite-8b's 8 KV heads on a 16-way model axis), a
    rank reads only the KV heads of its q block: a slice when the block
    holds whole GQA groups, else one KV head per q head (G = 1 locally);
    their gradient is then a pending sum over the head axes.  Returns
    the DTensor of q's shape and placements."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    q_spec = sharding.resolve("batch", None, "tensor", None, shape=q.shape)
    kv_spec = sharding.resolve("batch", None, "tensor", None, shape=k.shape)
    mesh = sharding.active_mesh()
    split_q = sharding.mesh_axes(q_spec[2:3])
    part = split_q if not sharding.mesh_axes(kv_spec[2:3]) else ()
    ql = sharding.to_local(q, q_spec)
    kl = sharding.to_local(k, kv_spec, grad_partial=part)
    vl = sharding.to_local(v, kv_spec, grad_partial=part)
    if part:
        h0 = sharding.NamedSharding(mesh, q_spec).local_block(q.shape)[0][2]
        hq = ql.shape[2]
        if h0 % G == 0 and hq % G == 0:
            kl = kl[:, :, h0 // G:(h0 + hq) // G]
            vl = vl[:, :, h0 // G:(h0 + hq) // G]
        else:
            idx = torch.arange(h0, h0 + hq, device=ql.device) // G
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    return sharding.from_local(fn(ql, kl, vl, **kw).contiguous(), q_spec,
                               q.shape)


def embed_lookup(table, tokens):
    """`F.embedding(tokens, table)`.  On DTensors each rank looks up its
    batch rows in its vocab block of the table (gathered along the model
    dim) and zeroes the tokens outside it: the result is a pending sum
    over the vocab axes, which the reference's ``shard(h, "batch", None,
    None)`` then reduces (GSPMD's masked gather and all-reduce)."""
    if not sharding.is_dtensor(table):
        return F.embedding(tokens.long(), table)
    t_spec = sharding.resolve("vocab", None, shape=table.shape)
    x_spec = sharding.resolve("batch", None, shape=tokens.shape)
    vocab = sharding.mesh_axes(t_spec)
    tl = sharding.to_local(table, t_spec,
                           grad_partial=sharding.mesh_axes(x_spec))
    xl = sharding.to_local(tokens, x_spec).long()
    if vocab:
        mesh = sharding.active_mesh()
        v0 = sharding.NamedSharding(mesh, t_spec).local_block(
            table.shape)[0][0]
        idx = xl - v0
        inside = (idx >= 0) & (idx < tl.shape[0])
        out = F.embedding(idx.clamp(0, tl.shape[0] - 1), tl)
        out = torch.where(inside[..., None], out, out.new_zeros(()))
    else:
        out = F.embedding(xl, tl)
    return sharding.from_local(out, x_spec + (None,),
                               tuple(tokens.shape) + (table.shape[1],),
                               partial=vocab)


# ---------------------------------------------------------------- MLP

def mlp(h, p, act: str):
    """p holds w_up/w_down (+ w_gate for swiglu). h: (B, S, d)."""
    if act == "swiglu":
        g = torch.matmul(h, p["w_gate"])
        u = torch.matmul(h, p["w_up"])
        z = F.silu(g.to(F32)).to(h.dtype) * u
    else:
        u = torch.matmul(h, p["w_up"])
        if act == "squared_relu":
            r = torch.relu(u.to(F32))
            z = (r * r).to(h.dtype)
        elif act == "gelu":
            # jax.nn.gelu's default is the tanh approximation
            z = F.gelu(u.to(F32), approximate="tanh").to(h.dtype)
        else:
            raise ValueError(act)
    z = shard(z, "batch", None, "tensor")
    return torch.matmul(z, p["w_down"])


# ---------------------------------------------------------------- losses

def _nll(logits, yx):
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.gather(logits, -1, torch.clamp(yx, min=0)[..., None])[..., 0]
    valid = (yx >= 0).to(F32)
    nll = (lse - pick) * valid
    return nll.sum(), valid.sum()


def _xent_chunk(hx, yx, lm_head):
    logits = torch.matmul(hx, lm_head).to(F32)
    logits = shard(logits, "batch", None, "vocab")
    if sharding.is_dtensor(logits):
        return _nll_sharded(logits, yx)
    return _nll(logits, yx)


def _nll_sharded(logits, yx):
    """`_nll` on DTensor logits.  Unsplit vocab: `_nll` on each rank's
    batch rows, its sums pending over the batch axes.  Split vocab: the
    log-sum-exp as a max and a sum of exponentials over the vocab axes
    (DTensor reductions: an all-reduce each), the target's logit picked
    on the rank whose vocab block holds it (a pending sum)."""
    l_spec = sharding.resolve("batch", None, "vocab", shape=logits.shape)
    y_spec = sharding.resolve("batch", None, shape=yx.shape)
    batch = sharding.mesh_axes(y_spec)
    vocab = sharding.mesh_axes(l_spec[2:])
    yl = sharding.to_local(yx, y_spec)
    valid = (yl >= 0).to(F32)
    if not vocab:
        t, c = _nll(sharding.to_local(logits, l_spec), yl)
        return (sharding.from_local(t, (), (), partial=batch),
                sharding.from_local(c, (), (), partial=batch))
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    ll = sharding.to_local(logits, l_spec)
    mesh = sharding.active_mesh()
    v0 = sharding.NamedSharding(mesh, l_spec).local_block(logits.shape)[0][2]
    idx = torch.clamp(yl, min=0) - v0
    inside = (idx >= 0) & (idx < ll.shape[-1])
    pick = torch.gather(ll, -1, idx.clamp(0, ll.shape[-1] - 1)[..., None])
    pick = torch.where(inside, pick[..., 0], pick.new_zeros(()))
    pick = sharding.from_local(pick, y_spec, yx.shape, partial=vocab)
    nll = (lse - pick) * sharding.from_local(valid, y_spec, yx.shape)
    return nll.sum(), sharding.from_local(valid.sum(), (), (),
                                          partial=batch)


def chunked_softmax_xent(h, lm_head, labels, *, chunk: int = 1024):
    """Next-token CE without materializing (B, S, V) logits.

    h: (B, S, d) final hidden states; lm_head: (d, V); labels: int (B, S)
    (already shifted; -1 entries are masked out).  Returns the mean nll
    (f32 scalar)."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S {S} is not a multiple of chunk {chunk}")
    tot = torch.zeros((), dtype=F32, device=h.device)
    cnt = torch.zeros((), dtype=F32, device=h.device)
    tot, cnt = sharding.replicate_like(h, tot, cnt)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = checkpoint(_xent_chunk, h[:, sl], labels[:, sl], lm_head,
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)
