"""Plain PyTorch versions of the fleet flow<->link kernels.

Two families:

  * the oracles of ``repro.kernels.ref`` (fleet half), restated in torch:
    `fleet_offered_load_ref` (one `index_add_` into an (L+1,) buffer),
    `fleet_link_gathers_ref`, and the PathTable pair
    `fleet_pt_offered_load_ref` / `fleet_pt_gathers_ref`;
  * the exact functions the two CUDA kernels compute, on the kernels' own
    operands: `csr_segment_sum_ref` (K1, a segmented sum over a sorted CSR
    entry list) and `row_gathers_ref` (K2, min / 1-prod / sum over the
    hops of each row of an index table, reduced hop by hop in the same
    order as the kernel so the results are bitwise comparable).

The wrappers in `repro_torch.kernels.fleet_cuda` run the K1/K2 plain
versions for tensors on the CPU; the card's kernels are held against them.
"""
from __future__ import annotations

import torch


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


def pack_link_values(scale, clean, delay):
    """(L + 1, 4) f32 table [scale, clean, delay, 0] with the identity row
    (1, 1, 0, 0) at the scratch slot L — K2's per-link operand."""
    n = scale.shape[0]
    packed = torch.zeros((n + 1, 4), dtype=torch.float32,
                         device=scale.device)
    packed[:n, 0] = scale
    packed[:n, 1] = clean
    packed[:n, 2] = delay
    packed[n, 0] = 1.0
    packed[n, 1] = 1.0
    return packed


def row_gathers_ref(idx, packed):
    """K2's function over an (R, h) int32 index table into an (L + 1, 4)
    packed per-link table: (min of column 0, 1 - prod of column 1, sum of
    column 2) over each row's hops, reduced hop 0 first — the kernel's
    order.  Returns three (R,) f32."""
    v = packed[idx.long()]                      # (R, h, 4)
    r, h = idx.shape
    mn = v[:, 0, 0]
    prod = torch.ones(r, dtype=packed.dtype, device=packed.device)
    tot = torch.zeros(r, dtype=packed.dtype, device=packed.device)
    for j in range(h):
        if j:
            mn = torch.minimum(mn, v[:, j, 0])
        prod = prod * v[:, j, 1]
        tot = tot + v[:, j, 2]
    return mn, 1.0 - prod, tot
