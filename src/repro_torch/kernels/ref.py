"""Plain PyTorch versions of the port's kernels.

Fleet flow<->link kernels, in two families:

  * the oracles of ``repro.kernels.ref`` (fleet half), restated in torch:
    `fleet_offered_load_ref` (one `index_add_` into an (L+1,) buffer), its
    per-shard tile split `fleet_offered_load_tiles_ref`,
    `fleet_link_gathers_ref`, and the PathTable pair
    `fleet_pt_offered_load_ref` / `fleet_pt_gathers_ref`;
  * the exact functions the CUDA kernels compute, on the kernels' own
    operands: `csr_segment_sum_ref` (K1, a segmented sum over a sorted CSR
    entry list), `csr_segment_sum_tiled_ref` (the same sum as the kernel
    decomposes it into tiles of entries, carries and head pieces),
    `csr_segment_sum_tiles_ref` (K6, the sum cut into private and
    boundary tiles), `link_gathers_ref` (K2 flat: min / 1-prod / sum
    over each subflow's hops) and `pt_gathers_ref` (K2 over the
    PathTable: the same per unique segment, composed per subflow), both
    reduced hop by hop and composed in the kernels' order, so the results
    are bitwise comparable.

UnoRC kernels (``repro.kernels.ref``'s GF and quant half): `gf_mul_ref`,
`gf_matmul_ref` (log/exp table gathers, XOR-accumulated), `rs_encode_ref`,
`rs_decode_ref`, `quant_int8_ref` and `dequant_int8_ref` (with
`fma_f32_ref` for its fused add), each taking any leading batch dims.

The wrappers in `repro_torch.kernels.fleet_cuda` and `unorc_cuda` run
these plain versions for tensors on the CPU; the card's kernels are held
against them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import gf


# ------------------------------------------------ oracles (repro.kernels.ref)

def fleet_offered_load_ref(routes, rates, split, n_links: int):
    """Ravel'd scatter-add link aggregation.

    routes: (n_flows, n_paths, max_hops) int32 with -1 padding; rates:
    (n_flows,); split: (n_flows, n_paths).  Returns the (n_links + 1,)
    offered-load buffer (pad slot last, holding 0.0: -1 hops are masked).
    """
    pad_idx = torch.where(routes >= 0, routes, n_links)
    hop_mask = (routes >= 0).to(rates.dtype)
    per_hop = (rates[:, None] * split)[:, :, None] * hop_mask
    buf = torch.zeros(n_links + 1, dtype=rates.dtype, device=rates.device)
    return buf.index_add_(0, pad_idx.reshape(-1).long(), per_hop.reshape(-1))


def fleet_offered_load_tiles_ref(routes, rates, split, n_links: int,
                                 n_boundary: int):
    """Oracle of the per-shard tiled scatter (fleet_pallas
    .link_scatter_tiles): the (n_links + 1,) buffer of
    `fleet_offered_load_ref` split at n_links - n_boundary into (private,
    boundary + scratch) tiles.  Only the real links are the contract."""
    buf = fleet_offered_load_ref(routes, rates, split, n_links)
    return buf[:n_links - n_boundary], buf[n_links - n_boundary:]


def append_identity(v, fill: float):
    """(L + 1,) `v` with the scratch slot's identity value appended."""
    return torch.cat([v, v.new_full((1,), fill)])


def fleet_link_gathers_ref(routes, scale, clean, delay):
    """Three link -> flow gathers: min over hops of scale, 1 - prod over
    hops of clean, sum over hops of delay, with -1 hops contributing the
    identities 1 / 1 / 0.  Each output is (n_flows, n_paths)."""
    n_links = scale.shape[0]
    pad_idx = torch.where(routes >= 0, routes, n_links).long()
    return (torch.amin(append_identity(scale, 1.0)[pad_idx], dim=2),
            1.0 - torch.prod(append_identity(clean, 1.0)[pad_idx], dim=2),
            torch.sum(append_identity(delay, 0.0)[pad_idx], dim=2))


def fleet_pt_offered_load_ref(pre_id, suf_id, seg_idx, rates, split,
                              n_links: int):
    """Two-stage unique-segment aggregation via plain `index_add_`
    scatters.  seg_idx: (U, hseg) hop links in [0, n_links] (pads already
    at the scratch slot).  Returns the (n_links + 1,) buffer."""
    sub = (rates[:, None] * split).reshape(-1)
    u, hseg = seg_idx.shape
    seg = torch.zeros(u, dtype=sub.dtype, device=sub.device)
    seg = seg.index_add_(0, pre_id.reshape(-1).long(), sub)
    seg = seg.index_add_(0, suf_id.reshape(-1).long(), sub)
    buf = torch.zeros(n_links + 1, dtype=sub.dtype, device=sub.device)
    per_hop = seg[:, None].expand(u, hseg).reshape(-1)
    return buf.index_add_(0, seg_idx.reshape(-1).long(), per_hop)


def compose_clean(pre_id, suf_id, seg_clean):
    """(n, p) product of each subflow's prefix and suffix segment values."""
    return seg_clean[pre_id.long()] * seg_clean[suf_id.long()]


def compose_segments(pre_id, suf_id, seg_scale, seg_clean, seg_delay):
    """Per-unique-segment reductions composed per subflow across its
    prefix/suffix split: min of scales, 1 - product of the clean
    probabilities, sum of delays.  Each output is (n_flows, n_paths)."""
    pre, suf = pre_id.long(), suf_id.long()
    return (torch.minimum(seg_scale[pre], seg_scale[suf]),
            1.0 - compose_clean(pre, suf, seg_clean),
            seg_delay[pre] + seg_delay[suf])


def fleet_pt_gathers_ref(pre_id, suf_id, seg_idx, scale, clean, delay):
    """Per-unique-segment reductions composed per subflow across the
    prefix/suffix split.  Same return contract as
    `fleet_link_gathers_ref`."""
    si = seg_idx.long()
    return compose_segments(
        pre_id, suf_id, torch.amin(append_identity(scale, 1.0)[si], dim=1),
        torch.prod(append_identity(clean, 1.0)[si], dim=1),
        torch.sum(append_identity(delay, 0.0)[si], dim=1))


# ----------------------------------------- the kernels' own plain versions

def csr_segment_sum_ref(vals_ext, gather, ptr):
    """K1's function: out[k] = sum of vals_ext[gather[ptr[k]:ptr[k+1]]]
    for the K = len(ptr) - 2 real segments; out[K] (the scratch/sentinel
    segment) is 0.0.

    vals_ext: (V,) f32 values; gather: (E,) int32 value ids in by-segment
    sorted order; ptr: (K + 2,) int32 CSR offsets.  Returns (K + 1,) f32.
    """
    k = ptr.shape[0] - 2
    counts = (ptr[1:k + 1] - ptr[:k]).long()
    live = int(ptr[k])      # host read: the plain version is no graph path
    keys = torch.repeat_interleave(
        torch.arange(k, device=vals_ext.device), counts,
        output_size=live)
    out = torch.zeros(k + 1, dtype=vals_ext.dtype, device=vals_ext.device)
    return out.index_add_(0, keys, vals_ext[gather[:live].long()])


def csr_segment_sum_tiles_ref(vals_ext, gather, ptr, n_boundary: int):
    """K6's function: `csr_segment_sum_ref` cut at K - n_boundary into
    (private (K - n_boundary,), boundary (n_boundary + 1,)) tiles, the
    scratch/sentinel slot (0.0) last."""
    out = csr_segment_sum_ref(vals_ext, gather, ptr)
    cut = ptr.shape[0] - 2 - n_boundary
    return out[:cut], out[cut:]


SEGSUM_TILE = 2048      # entries per block of K1/K6 (fleet_kernels.cu kTile)


def csr_segment_sum_tiled_ref(vals_ext, gather, ptr,
                              tile: int = SEGSUM_TILE):
    """K1's function computed as the kernel decomposes it: the entries cut
    into tiles of `tile` (the grid covers [0, len(gather)]), and

      * a segment wholly inside one tile is that tile's piece of it, an
        empty segment +0.0 (owned by the tile holding its start offset);
      * a tile whose last segment runs past its end leaves that piece as
        its carry, a tile where a segment that began earlier ends leaves
        the piece as its head (with the segment's id);
      * the fix-up sums each spanning segment's pieces in tile order: the
        carries from its first tile to the one before its last, then the
        head.

    Entries at or past ptr[K] are never read; out[K] is 0.0.  The sum
    order inside a piece is not the kernel's (a fixed-order scan there),
    so on integer-valued inputs, where every order is exact, the two agree
    bitwise.  Returns (K + 1,) like `csr_segment_sum_ref`."""
    k = ptr.shape[0] - 2
    dev = vals_ext.device
    p = ptr.long()
    live = int(p[k])        # host read: the plain version is no graph path
    n_tiles = gather.shape[0] // tile + 1
    seg = torch.repeat_interleave(torch.arange(k, device=dev),
                                  p[1:k + 1] - p[:k], output_size=live)
    tid = torch.arange(live, device=dev) // tile
    # a piece opens at a segment's first entry or at a tile's first entry
    opens = torch.ones(live, dtype=torch.bool, device=dev)
    opens[1:] = (seg[1:] != seg[:-1]) | (tid[1:] != tid[:-1])
    piece = torch.cumsum(opens, 0) - 1
    n_pieces = int(opens.sum())
    sums = torch.zeros(n_pieces, dtype=vals_ext.dtype, device=dev)
    sums.index_add_(0, piece, vals_ext[gather[:live].long()])
    pseg, ptile = seg[opens], tid[opens]
    starts_here = p[pseg] >= ptile * tile
    ends_here = p[pseg + 1] <= (ptile + 1) * tile
    out = torch.zeros(k + 1, dtype=vals_ext.dtype, device=dev)
    own = starts_here & ends_here
    out[pseg[own]] = sums[own]
    carry = torch.zeros(n_tiles, dtype=vals_ext.dtype, device=dev)
    carry[ptile[~ends_here]] = sums[~ends_here]
    head = ends_here & ~starts_here
    hseg, htile = pseg[head], ptile[head]
    first = p[hseg] // tile
    total = carry[first]
    for j in range(1, int((htile - first).max()) if hseg.numel() else 0):
        more = first + j < htile
        total = torch.where(more, total + carry[(first + j).clamp(
            max=n_tiles - 1)], total)
    out[hseg] = total + sums[head]
    return out


def hop_reduce_ref(idx, scale, clean, delay):
    """(min of scale, product of clean, sum of delay) over each row of
    the (R, h) int32 hop table into the (L,) per-link vectors, hop id L
    reading the identity (1, 1, 0); reduced hop 0 first, one rounding per
    step — K2's order.  Returns three (R,) f32."""
    i = idx.long()
    s = append_identity(scale, 1.0)[i]
    c = append_identity(clean, 1.0)[i]
    d = append_identity(delay, 0.0)[i]
    mn, prod, tot = s[:, 0], c[:, 0], d[:, 0]
    for j in range(1, idx.shape[1]):
        mn = torch.minimum(mn, s[:, j])
        prod = prod * c[:, j]
        tot = tot + d[:, j]
    return mn, prod, tot


def link_gathers_ref(pad_idx, scale, clean, delay):
    """K2's flat function: pad_idx (n, p, h) int32 in [0, L] -> (min of
    scale, 1 - product of clean, sum of delay) per subflow, each (n, p)
    f32, in the kernel's order."""
    n, p, h = pad_idx.shape
    mn, prod, tot = hop_reduce_ref(pad_idx.reshape(n * p, h), scale, clean,
                                   delay)
    return mn.reshape(n, p), (1.0 - prod).reshape(n, p), tot.reshape(n, p)


def pt_gathers_ref(pre_id, suf_id, seg_idx, scale, clean, delay):
    """K2's PathTable function (`path_table_gathers` in full): each unique
    segment of seg_idx (U, hseg) reduced as `hop_reduce_ref` does, then
    per subflow min(pre, suf), 1 - prod_pre * prod_suf and sum_pre +
    sum_suf — the clean products multiplied directly, as the kernel does.
    Returns three (n, p) f32."""
    return compose_segments(pre_id, suf_id,
                            *hop_reduce_ref(seg_idx, scale, clean, delay))


# ----------------------------------------------- UnoRC: GF(2^8) and int8

def gf_mul_ref(a, b):
    """Elementwise GF(256) product of byte-valued integer tensors via the
    log/exp tables (int64 result)."""
    a, b = a.long(), b.long()
    exp = torch.as_tensor(gf.EXP, dtype=torch.int64, device=a.device)
    log = torch.as_tensor(gf.LOG, dtype=torch.int64, device=a.device)
    prod = exp[log[a] + log[b]]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(prod), prod)


def gf_matmul_ref(coeffs, x):
    """(M, K) GF(256) coefficients (nested ints) times (..., K, B) uint8
    data -> (..., M, B) uint8: out[m] = XOR over k of coeffs[m][k] * x[k],
    accumulated k = 0 first."""
    m = len(coeffs)
    if m == 0:
        return x[..., :0, :].clone()
    c = torch.as_tensor(np.array(coeffs, dtype=np.int64), device=x.device)
    prods = gf_mul_ref(c[:, :, None], x.long()[..., None, :, :])
    out = prods[..., 0, :]
    for k in range(1, prods.shape[-2]):
        out = out ^ prods[..., k, :]
    return out.to(torch.uint8)


def rs_encode_ref(data, r: int):
    """Systematic RS parity: data (..., k, B) uint8 -> (..., r, B) uint8."""
    return gf_matmul_ref(gf.rs_generator_rows(data.shape[-2], r), data)


def rs_decode_ref(survivors, k: int, r: int, missing, parity_avail):
    """survivors (..., n_sur, B) uint8 in `gf.rs_decode_matrix` order ->
    the missing data rows (..., m, B) uint8."""
    coeffs = gf.rs_decode_matrix(k, r, tuple(missing), tuple(parity_avail))
    return gf_matmul_ref(coeffs, survivors)


# f32(1/127): under jit XLA rewrites the reference's `amax / 127.0` into a
# multiply by this reciprocal (0x3C010204), and the reference always runs
# jitted, so the product is the contract (a true division moves ~5 % of
# the block scales by one ulp).
INV127 = float(np.float32(1.0 / 127.0))


def quant_int8_ref(x, block: int = 256):
    """Blockwise absmax int8 quantization over the last axis (N % block ==
    0): scale = amax * f32(1/127), or 1 for an all-zero block; q =
    clip(round_half_even(x / scale), -127, 127) with a true division.
    Returns (q int8 like x, scales f32 (..., N / block))."""
    shape = x.shape
    xb = x.to(torch.float32).reshape(*shape[:-1], shape[-1] // block, block)
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def fma_f32_ref(a, b, c):
    """fma(a, b, c) in float32 with one rounding (IEEE fusedMultiplyAdd),
    for float32 b, c and float32 a holding at most 29 significant bits
    (int8 values here), so a * b is exact in float64.  The float64 sum is
    rounded to odd (TwoSum gives its exact error; an inexact sum with an
    even last bit steps one ulp toward the error), and rounding that to
    float32 is then correctly rounded (53 >= 24 + 2 bits)."""
    prod = a.double() * b.double()
    c64 = c.double()
    s = prod + c64
    bb = s - prod
    err = (prod - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def dequant_int8_ref(q, scale, block: int = 256, dtype=torch.float32,
                     acc=None):
    """q * scale[block] in float32, cast to `dtype`; with `acc` (float32,
    q's shape) the fused fma(q, scale[block], acc), one rounding — what
    XLA makes of the reference's dequantize-then-add."""
    shape = q.shape
    qb = q.to(torch.float32).reshape(*shape[:-1], shape[-1] // block, block)
    sb = scale[..., None]
    if acc is None:
        out = qb * sb
    else:
        out = fma_f32_ref(qb, sb.expand_as(qb), acc.reshape(qb.shape))
    return out.reshape(shape).to(dtype)
