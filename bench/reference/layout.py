"""Checks of a compiled route layout against the route tensor, by what it
must mean, not by how it is ordered.

The simulator under test compiles its routes into a by-link CSR (entries
sorted by link, each entry a subflow id) and, where it compresses, a
PathTable: each subflow's hops split into a prefix and a suffix segment
(unique rows of a (U, hseg) table), a stage-1 CSR listing each segment's
subflows and a stage-2 CSR listing each link's segments.  Each function
here counts the entries that disagree with what the routes require (0 when
the structure is sound), comparing sorted (key, id) pairs so that any
order of entries passes.
"""
from __future__ import annotations

import torch


def _r3(routes):
    return routes if routes.dim() == 3 else routes[:, None, :]


def _multiset_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries of one sorted int64 key list that the other lacks."""
    if a.numel() != b.numel():
        return abs(a.numel() - b.numel()) + _multiset_diff(
            a[:min(a.numel(), b.numel())], b[:min(a.numel(), b.numel())])
    return int((torch.sort(a).values != torch.sort(b).values).sum())


def _csr_keys(gather, ptr, n_keys: int, n_ids: int) -> torch.Tensor:
    """key * n_ids + id of every live entry of a blocked CSR."""
    live = int(ptr[n_keys])
    e = torch.arange(live, device=ptr.device)
    key = torch.searchsorted(ptr[:n_keys + 1].long(), e, right=True) - 1
    return key * n_ids + gather.reshape(-1)[:live].long()


def flat_mismatches(routes, n_links: int, pad_idx, path_mask, sort_sub,
                    link_ptr) -> int:
    """The flat layout: the padded hop table, the path mask and the
    by-link CSR of (link, subflow) hop entries."""
    r = _r3(routes)
    n, p, h = r.shape
    bad = int((pad_idx != torch.where(r >= 0, r, n_links)).sum())
    bad += int((path_mask != torch.any(r >= 0, dim=2)).sum())
    real = r >= 0
    sub = torch.arange(n * p, device=r.device).reshape(n, p, 1).expand(n, p, h)
    want = r[real].long() * (n * p) + sub[real]
    got = _csr_keys(sort_sub, link_ptr, n_links, n * p)
    return bad + _multiset_diff(got, want)


def path_table_mismatches(routes, n_links: int, pt) -> int:
    """A PathTable: every subflow's prefix hops then suffix hops are its
    route; stage 1 lists each segment's subflows (both halves, none for
    the all-padding segment); stage 2 lists each link's (segment) hops."""
    r = _r3(routes)
    n, p, h = r.shape
    s = n * p
    seg = pt["seg_idx"].long()
    u, hseg = seg.shape
    pre, suf = pt["pre_id"].reshape(-1).long(), pt["suf_id"].reshape(-1).long()
    # routes rebuilt from the two segments, hops compacted to the front
    halves = torch.cat([seg[pre], seg[suf]], dim=1)          # (S, 2 hseg)
    live = halves < n_links
    pos = torch.cumsum(live.to(torch.int64), dim=1) - 1
    width = max(h, 2 * hseg)
    out = torch.full((s, width + 1), n_links, dtype=torch.long,
                     device=r.device)
    col = torch.where(live, pos, width)
    out.scatter_(1, col, torch.where(live, halves, n_links))
    want = torch.full((s, width), n_links, dtype=torch.long, device=r.device)
    want[:, :h] = torch.where(r >= 0, r, n_links).reshape(s, h)
    bad = int((out[:, :width] != want).sum())
    # stage 1
    sub = torch.arange(s, device=r.device)
    pad_seg = torch.nonzero((seg >= n_links).all(dim=1)).reshape(-1)
    e_seg = torch.cat([pre, suf])
    e_sub = torch.cat([sub, sub])
    if pad_seg.numel():
        keep = e_seg != pad_seg[0]
        e_seg, e_sub = e_seg[keep], e_sub[keep]
    bad += _multiset_diff(_csr_keys(pt["seg_gather"], pt["seg_ptr"], u, s),
                          e_seg * s + e_sub)
    # stage 2
    uu = torch.arange(u, device=r.device)[:, None].expand(u, hseg)
    real = seg < n_links
    bad += _multiset_diff(
        _csr_keys(pt["lcsr_gather"], pt["llink_ptr"], n_links, u),
        seg[real] * u + uu[real])
    return bad
