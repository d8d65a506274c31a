"""Fluid-model topology in torch: links as (n_links,) tensors, routes as a
padded flow -> path -> link hop tensor, and the compiled `RouteLayout` /
`PathTable` that make the per-epoch flow<->link exchange cheap.

The port of ``repro.fleetsim.links``.  The layout and the path table are
built host-side in numpy exactly as the reference builds them (same stable
sorts, same block rounding, the same unique-row factorization), then moved
to the device once, so every index array equals the reference's.  A grid
of cells that share one cell's routes gets its layout tiled from that
cell's on the device (`tile_layout`), equal array for array to the one
`compute_layout` builds over the stacked routes.

Per-link aggregation (`offered_load`) and the link -> flow gathers have
four backends (`backend=`):

  * "reference" — the plain flat path: one `index_add_` into an
    (n_links + 1,) buffer and three (n, p, h) gathers;
  * "pt"        — the plain two-stage PathTable path (`index_add_` by
    unique segment, then the (U, hseg) table into links; gathers once per
    unique segment, composed per subflow);
  * "cuda"      — the flat kernels (`repro_torch.kernels.fleet_cuda`:
    K1 over the layout's by-link CSR, K2 over pad_idx);
  * "pt_cuda"   — the same two kernels over the PathTable (K1 for stage 1
    and stage 2, K2 once per unique segment).

"auto" resolves on a CUDA device to "pt_cuda" when a table is attached,
else "cuda"; on the CPU to "pt" / "reference".  The kernel backends given
CPU tensors run the kernels' plain versions (the wrappers' device rule).

Sharded flow axis (`repro_torch.fleetsim.shard`): `scatter_partial` is a
shard's partial offered load, cut with `halo=B` into a private tile and
the boundary tile of the B trailing (boundary) links — K6 on the kernel
backends, written straight into a row of the exchange buffer — and
`halo_exchange` reduces the boundary tiles across shards (psum or
neighbor exchange; shards stacked in one process, or one per rank of a
`torch.distributed` group).  `link_epoch` = offered load (+ exchange) ->
`link_physics`, the receive half.

Queue model per epoch `dt` (forward-Euler):

  physical:  q' = clip(q + (arrivals - cap)    * dt, 0, qcap)
  phantom:   q' = clip(q + (arrivals - drain)  * dt, 0, vcap)

ECN is the expectation of RED on the marking queue; a subflow's mark
fraction composes across hops as 1 - prod(1 - p_link).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fleet_cuda
from repro_torch.kernels import ref as kref
from repro_torch.trace import traced

GBPS = 0.125               # bytes per ns per Gbit/s
RATE_100G = 100 * GBPS
US = 1_000.0
MS = 1_000_000.0
MIB = 1024 * 1024
_EPS = 1e-9

LOAD_BACKENDS = ("auto", "reference", "pt", "cuda", "pt_cuda")
CSR_BLOCK = 64             # chunk height of the reference's blocked CSR
# a PathTable is attached by `path_table="auto"` only when the flat entry
# count exceeds this multiple of the compressed entry count
PT_MIN_COMPRESS = 2.0


class PathTable(NamedTuple):
    """Unique-path-segment factorization of the route tensor (see the
    reference's `PathTable`).  n = n_flows, p = n_paths, S = n*p,
    U = n_segments, L = n_links."""
    pre_id: torch.Tensor       # (n, p) unique-segment id of each prefix
    suf_id: torch.Tensor       # (n, p) unique-segment id of each suffix
    seg_idx: torch.Tensor      # (U, hseg) hop link ids, -1 -> L (scratch)
    seg_gather: torch.Tensor   # (E1/block, block) subflow ids by segment;
                               # pads -> S
    seg_ptr: torch.Tensor      # (U + 2,) CSR offsets of stage 1
    lcsr_gather: torch.Tensor  # (E2/block, block) segment ids by link;
                               # pads -> U
    llink_ptr: torch.Tensor    # (L + 2,) CSR offsets of stage 2

    @property
    def n_segments(self) -> int:
        return self.seg_idx.shape[0]


class RouteLayout(NamedTuple):
    """Compiled, static per-scenario view of the route tensor: the fields
    of the reference's `RouteLayout` that the port's backends read (its
    `hop_mask`, `sort_link` and `csr_gather` serve backends not ported)."""
    pad_idx: torch.Tensor     # (n, p, h) hop link ids, -1 -> L (scratch)
    path_mask: torch.Tensor   # (n, p) bool: True on real paths
    sort_sub: torch.Tensor    # (E,) subflow id per by-link-sorted entry
    link_ptr: torch.Tensor    # (L + 2,) CSR offsets into the sorted entries
    path_table: Optional[PathTable] = None


class FluidNet(NamedTuple):
    """Topology constants: (n_links,) float32 tensors except `routes`
    (n, p, h) int32 and the 0-d float32 epoch period `dt`."""
    cap: torch.Tensor            # service rate (bytes/ns)
    qcap: torch.Tensor           # physical queue capacity (bytes)
    ecn_lo: torch.Tensor         # RED thresholds on the marking queue
    ecn_hi: torch.Tensor
    drain: torch.Tensor          # phantom drain rate; == cap w/o phantom
    vcap: torch.Tensor           # phantom capacity; == qcap w/o phantom
    use_phantom: torch.Tensor    # bool: mark on phantom vs physical RED
    routes: torch.Tensor         # (n_flows, n_paths, max_hops) int32
    dt: torch.Tensor             # 0-d epoch period (ns)
    layout: Optional[RouteLayout] = None
    p_loss: Optional[torch.Tensor] = None  # (n_links,) random drop prob

    @property
    def n_links(self) -> int:
        return self.cap.shape[0]

    @property
    def n_paths(self) -> int:
        return self.routes.shape[1] if self.routes.dim() == 3 else 1

    @property
    def device(self) -> torch.device:
        return self.cap.device


class LinkEpoch(NamedTuple):
    """Everything one epoch of link physics produces."""
    load: torch.Tensor        # (n_links,) offered load
    q_phys: torch.Tensor      # (n_links,) stepped physical queues
    q_phantom: torch.Tensor   # (n_links,) stepped phantom queues
    p_link: torch.Tensor      # (n_links,) expected mark probability
    sub_scale: torch.Tensor   # (n, p) min over hops of cap/load
    sub_frac: torch.Tensor    # (n, p) 1 - prod(1 - p) over hops
    sub_delay: torch.Tensor   # (n, p) sum of q/cap over hops (ns)
    p_drop: Optional[torch.Tensor] = None    # (n_links,) overflow + p_loss
    sub_loss: Optional[torch.Tensor] = None  # (n, p) composed loss fraction


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _routes3(net: FluidNet) -> torch.Tensor:
    r = net.routes
    return r if r.dim() == 3 else r[:, None, :]


def _pad_idx(net: FluidNet) -> torch.Tensor:
    """Hop indices with -1 redirected to the scratch slot n_links."""
    if net.layout is not None:
        return net.layout.pad_idx
    r = _routes3(net)
    return torch.where(r >= 0, r, net.n_links).to(torch.int32)


# ------------------------------------------------------------ layout build

def _blocked_csr(sort_key: np.ndarray, sort_val: np.ndarray, n_keys: int,
                 key_pad: int, val_pad: int, block: int):
    """Block-round a by-key-sorted entry list into (gather, ptr) CSR form
    (the reference's `_blocked_csr`)."""
    n = sort_key.shape[0]
    n_chunks = max(1, -(-n // block))
    pad = n_chunks * block - n
    sort_key = np.concatenate([sort_key, np.full(pad, key_pad, np.int32)])
    sort_val = np.concatenate([sort_val, np.full(pad, val_pad, np.int32)])
    ptr = np.searchsorted(
        sort_key, np.arange(n_keys + 2, dtype=np.int64)).astype(np.int32)
    return sort_val.reshape(n_chunks, block), ptr


def _unique_rows(rows: np.ndarray, n_links: int):
    """`np.unique(rows, axis=0, return_inverse=True)` of hop-id rows in
    [-1, n_links): the rows in lexicographic order and each row's index
    among them.  Runs of columns are read as int64 numbers in base
    n_links + 1 (hop ids shifted by one, the first hop most significant),
    as many columns a number as fit in 62 bits, so a lexsort of the
    numbers orders the rows lexicographically, many times faster than the
    row-wise unique."""
    n, width = rows.shape
    base = n_links + 1
    per = max(1, int(62 // np.log2(base)))
    keys = []
    for lo in range(0, width, per):
        key = np.zeros(n, np.int64)
        for j in range(lo, min(lo + per, width)):
            key = key * base + (rows[:, j].astype(np.int64) + 1)
        keys.append(key)
    order = np.lexsort(keys[::-1])          # keys[0] the primary key
    new = np.ones(n, bool)
    for key in keys:
        k = key[order]
        new[1:] &= k[1:] == k[:-1]
    new[1:] = ~new[1:]
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(new) - 1
    return rows[order[new]], inv


def _path_table_np(r: np.ndarray, n_links: int, block: int,
                   min_compress: Optional[float],
                   pad_segments_to: Optional[int] = None,
                   pad_entries_to: Optional[int] = None):
    """numpy fields of the PathTable, or None when it does not clear
    `min_compress` (see the reference's `compute_path_table`, whose
    `pad_segments_to` / `pad_entries_to` padding this repeats)."""
    if r.ndim == 2:
        r = r[:, None, :]
    n, p, h = r.shape
    n_sub = n * p
    hseg = max(1, (h + 1) // 2)
    flat = r.reshape(n_sub, h)
    real = flat >= 0
    m = real.sum(axis=1)
    # prefix hop count: the whole path when it fits, else ceil(m/2)
    c = np.where(m <= hseg, m, (m + 1) // 2)
    rank = np.cumsum(real, axis=1) - 1
    pre = np.full((n_sub, hseg), -1, np.int32)
    suf = np.full((n_sub, hseg), -1, np.int32)
    in_pre = real & (rank < c[:, None])
    rows, cols = np.nonzero(in_pre)
    pre[rows, rank[rows, cols]] = flat[rows, cols]
    rows, cols = np.nonzero(real & ~in_pre)
    suf[rows, rank[rows, cols] - c[rows]] = flat[rows, cols]
    seg, inv = _unique_rows(np.concatenate([pre, suf]), n_links)
    u = seg.shape[0]
    pre_id = inv[:n_sub].astype(np.int32)
    suf_id = inv[n_sub:].astype(np.int32)
    # stage 1: each subflow feeds BOTH halves' segments, except entries of
    # the all-padding segment (scratch-only — dropped)
    e_sub = np.tile(np.arange(n_sub, dtype=np.int32), 2)
    e_seg = np.concatenate([pre_id, suf_id])
    pad_row = np.nonzero((seg < 0).all(axis=1))[0]
    if pad_row.size:
        live = e_seg != pad_row[0]
        e_sub, e_seg = e_sub[live], e_seg[live]
    if min_compress is not None and \
            n_sub * h < min_compress * (e_seg.shape[0] + u * hseg):
        return None
    # padding (so per-shard tables share one (U, E1)): empty all-scratch
    # segment rows, and sentinel stage-1 entries past every real segment
    n_seg = u if pad_segments_to is None else int(pad_segments_to)
    if n_seg < u:
        raise ValueError(f"pad_segments_to={n_seg} < {u} unique segments")
    seg_idx = np.where(seg >= 0, seg, n_links).astype(np.int32)
    if n_seg > u:
        seg_idx = np.concatenate(
            [seg_idx, np.full((n_seg - u, hseg), n_links, np.int32)])
    if pad_entries_to is not None:
        extra = int(pad_entries_to) - e_seg.shape[0]
        if extra < 0:
            raise ValueError(f"pad_entries_to={pad_entries_to} < "
                             f"{e_seg.shape[0]} live entries")
        e_sub = np.concatenate([e_sub, np.full(extra, n_sub, np.int32)])
        e_seg = np.concatenate([e_seg, np.full(extra, n_seg, np.int32)])
    order = np.argsort(e_seg, kind="stable")
    seg_gather, seg_ptr = _blocked_csr(
        e_seg[order], e_sub[order], n_seg, n_seg, n_sub, block)
    # stage 2: each (segment, hop) entry carries the segment's rate
    e_lnk = seg_idx.reshape(-1)
    e_sid = np.repeat(np.arange(n_seg, dtype=np.int32), hseg)
    order = np.argsort(e_lnk, kind="stable")
    lcsr_gather, llink_ptr = _blocked_csr(
        e_lnk[order], e_sid[order], n_links, n_links, n_seg, block)
    return dict(pre_id=pre_id.reshape(n, p), suf_id=suf_id.reshape(n, p),
                seg_idx=seg_idx, seg_gather=seg_gather, seg_ptr=seg_ptr,
                lcsr_gather=lcsr_gather, llink_ptr=llink_ptr)


def _device_of(routes, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(routes, torch.Tensor):
        return routes.device
    return resolve_device(None)


def compute_path_table(routes, n_links: int, *, block: int = CSR_BLOCK,
                       min_compress: Optional[float] = None,
                       pad_segments_to: Optional[int] = None,
                       pad_entries_to: Optional[int] = None,
                       device=None) -> Optional[PathTable]:
    """Build the unique-path-segment table host-side and move it to
    `device` (default: the routes' device; cuda for numpy routes).
    `min_compress=r` returns None unless the flat entry count is at least
    r times the compressed one (the auto-attach policy).
    `pad_segments_to` pads the segment axis with empty all-scratch rows and
    `pad_entries_to` pads stage 1 with sentinel entries, so the shards of
    one plan share one (U, E1) — the reference's padded stack."""
    dev = _device_of(routes, device)
    arrs = _path_table_np(_np(routes), n_links, block, min_compress,
                          pad_segments_to, pad_entries_to)
    if arrs is None:
        return None
    return PathTable(**{k: torch.as_tensor(v, device=dev)
                        for k, v in arrs.items()})


def compute_layout(routes, n_links: int, *, block: int = CSR_BLOCK,
                   path_table="auto", device=None) -> RouteLayout:
    """Compile the route tensor into a RouteLayout (host-side numpy, one
    transfer to `device`).  `path_table`: "auto" attaches a table when it
    compresses by at least PT_MIN_COMPRESS; True forces it; False/None
    skips it; a prebuilt PathTable is attached as-is."""
    dev = _device_of(routes, device)
    r = _np(routes).astype(np.int32)
    if r.ndim == 2:
        r = r[:, None, :]
    n, p, h = r.shape
    n_sub = n * p
    pad_idx = np.where(r >= 0, r, n_links).astype(np.int32)
    path_mask = (r >= 0).any(axis=2)
    flat_link = pad_idx.reshape(-1)
    flat_sub = (np.arange(n_sub * h, dtype=np.int32) // h).astype(np.int32)
    order = np.argsort(flat_link, kind="stable")
    sort_link = flat_link[order]
    sort_sub = flat_sub[order]
    keep = flat_link.shape[0]
    n_chunks = max(1, -(-keep // block))
    pad_to = n_chunks * block
    sort_link = np.concatenate(
        [sort_link, np.full(pad_to - keep, n_links, np.int32)])
    sort_sub = np.concatenate(
        [sort_sub, np.full(pad_to - keep, n_sub, np.int32)])
    link_ptr = np.searchsorted(
        sort_link, np.arange(n_links + 2, dtype=np.int32)).astype(np.int32)
    if path_table is None or path_table is False:
        pt = None
    elif isinstance(path_table, PathTable):
        pt = path_table
    elif path_table is True:
        pt = compute_path_table(r, n_links, block=block, device=dev)
    elif path_table == "auto":
        pt = compute_path_table(r, n_links, block=block,
                                min_compress=PT_MIN_COMPRESS, device=dev)
    else:
        raise ValueError(f"path_table={path_table!r}: expected 'auto', "
                         "True, False/None, or a PathTable")

    def t(a):
        return torch.as_tensor(a, device=dev)
    return RouteLayout(pad_idx=t(pad_idx), path_mask=t(path_mask),
                       sort_sub=t(sort_sub), link_ptr=t(link_ptr),
                       path_table=pt)


def _n_blocked(n: int) -> int:
    """Entries of a blocked CSR of `n` live entries, padding included."""
    return max(1, -(-n // CSR_BLOCK)) * CSR_BLOCK


def _padded(parts, total: int, fill: int) -> torch.Tensor:
    """The parts concatenated, then `fill` up to `total` entries."""
    out = torch.cat([x.reshape(-1) for x in parts])
    pad = out.new_full((total - out.numel(),), fill)
    return torch.cat([out, pad])


def _tile_path_table(pt: PathTable, n_cells: int, n_links: int,
                     n_sub: int) -> PathTable:
    """`tile_layout`'s PathTable (see there)."""
    seg = pt.seg_idx
    u, hseg = seg.shape
    dev = seg.device
    empty = (seg >= n_links).all(dim=1)
    has_pad = int(bool(empty[0])) if u else 0
    e1, e2 = int(pt.seg_ptr[u]), int(pt.llink_ptr[n_links])
    if bool(empty[has_pad:].any()) or \
            int(pt.seg_ptr[u + 1]) != _n_blocked(e1) or \
            pt.seg_gather.numel() != _n_blocked(e1) or \
            pt.lcsr_gather.numel() != _n_blocked(u * hseg):
        raise ValueError("tile_layout: the PathTable is padded or blocked "
                         "otherwise than compute_path_table builds it")
    b = torch.arange(n_cells, dtype=torch.int32, device=dev)
    u_real = u - has_pad
    u_all = has_pad + n_cells * u_real

    def seg_ids(ids):
        # the all-padding segment (id 0 when there is one) is shared
        off = (b * u_real).reshape((-1,) + (1,) * ids.dim())
        return torch.where(ids >= has_pad, ids + off, ids)

    lnk = (b * n_links).reshape(-1, 1, 1)
    seg_idx = torch.cat([
        torch.full((has_pad, hseg), n_cells * n_links, dtype=seg.dtype,
                   device=dev),
        torch.where(seg[has_pad:] < n_links, seg[has_pad:] + lnk,
                    n_cells * n_links).reshape(-1, hseg)])
    # stage 1: cell b's segments list cell b's subflows, in the base order
    sub = pt.seg_gather.reshape(-1)[:e1]
    n1 = _n_blocked(n_cells * e1)
    seg_gather = _padded([sub + (b * n_sub)[:, None]], n1,
                         n_cells * n_sub).reshape(-1, CSR_BLOCK)
    seg_ptr = torch.cat([
        pt.seg_ptr[:has_pad],
        (pt.seg_ptr[has_pad:u] + (b * e1)[:, None]).reshape(-1),
        torch.tensor([n_cells * e1, n1], dtype=pt.seg_ptr.dtype,
                     device=dev)])
    # stage 2: real hops by link, cell-major; then the scratch hops in
    # segment order, the shared all-padding segment's first
    flat = pt.lcsr_gather.reshape(-1)
    scratch = flat[e2 + has_pad * hseg:u * hseg]
    n2 = _n_blocked(u_all * hseg)
    lcsr_gather = _padded(
        [flat[:e2] + (b * u_real)[:, None], flat[e2:e2 + has_pad * hseg],
         scratch + (b * u_real)[:, None]], n2, u_all).reshape(-1, CSR_BLOCK)
    llink_ptr = torch.cat([
        (pt.llink_ptr[:n_links] + (b * e2)[:, None]).reshape(-1),
        torch.tensor([n_cells * e2, n2], dtype=pt.llink_ptr.dtype,
                     device=dev)])
    return PathTable(
        pre_id=seg_ids(pt.pre_id).reshape(-1, pt.pre_id.shape[1]),
        suf_id=seg_ids(pt.suf_id).reshape(-1, pt.suf_id.shape[1]),
        seg_idx=seg_idx, seg_gather=seg_gather, seg_ptr=seg_ptr,
        lcsr_gather=lcsr_gather, llink_ptr=llink_ptr)


@traced("fleetsim.tile_layout")
def tile_layout(layout: RouteLayout, n_cells: int,
                n_links: int) -> RouteLayout:
    """The layout of `n_cells` copies of one cell's routes stacked
    block-diagonally (cell b's link ids offset by b·n_links), built on
    the layout's device from the cell's own `layout` (compiled by
    `compute_layout` over `n_links` links) with no pass over the stacked
    routes.  Equal, array for array, to `compute_layout` of the stacked
    routes with the cell's PathTable kept or not:

      * link ids move by b·L, subflow ids by b·S and segment ids by b·U'
        (U' the segments other than the all-padding one, which the cells
        share as segment 0); the scratch index becomes B·L, B·S or the
        stacked segment count;
      * every CSR keeps the base's order within a key, since only cell
        b's entries carry cell b's keys; the scratch-link entries come
        after every real one, cell-major; the blocked CSRs are padded
        once, at the end.

    Raises ValueError when the cell's layout is not one that
    `compute_layout` builds with its default block (a padded PathTable)."""
    n, p, h = layout.pad_idx.shape
    n_sub, dev = n * p, layout.pad_idx.device
    e, real = n_sub * h, int(layout.link_ptr[n_links])
    if layout.sort_sub.numel() != _n_blocked(e) or \
            layout.link_ptr.numel() != n_links + 2:
        raise ValueError("tile_layout: the flat CSR is blocked otherwise "
                         "than compute_layout builds it")
    b = torch.arange(n_cells, dtype=torch.int32, device=dev)
    pad_idx = torch.where(layout.pad_idx < n_links,
                          layout.pad_idx + (b * n_links).reshape(-1, 1, 1, 1),
                          n_cells * n_links).reshape(-1, p, h)
    sub = layout.sort_sub[:e]
    off = (b * n_sub)[:, None]
    n_flat = _n_blocked(n_cells * e)
    sort_sub = _padded([sub[:real] + off, sub[real:] + off], n_flat,
                       n_cells * n_sub)
    link_ptr = torch.cat([
        (layout.link_ptr[:n_links] + (b * real)[:, None]).reshape(-1),
        torch.tensor([n_cells * real, n_flat], dtype=layout.link_ptr.dtype,
                     device=dev)])
    pt = None if layout.path_table is None else _tile_path_table(
        layout.path_table, n_cells, n_links, n_sub)
    return RouteLayout(pad_idx=pad_idx,
                       path_mask=layout.path_mask.repeat(n_cells, 1),
                       sort_sub=sort_sub, link_ptr=link_ptr, path_table=pt)


def with_layout(net: FluidNet, **kw) -> FluidNet:
    """`net` with a freshly compiled layout attached, on net's device."""
    kw.setdefault("device", net.device)
    return net._replace(layout=compute_layout(net.routes, net.n_links, **kw))


def layout_to_arrays(lay: RouteLayout, prefix: str = "lay_") -> dict:
    """RouteLayout -> {name: host numpy array} for an allow_pickle=False
    `np.savez`, under the reference's names: `<prefix><field>`, the
    PathTable's fields under `<prefix>pt_` (absent: a flat layout)."""
    out = {prefix + f: _np(getattr(lay, f))
           for f in RouteLayout._fields if f != "path_table"}
    if lay.path_table is not None:
        out.update({prefix + "pt_" + f: _np(getattr(lay.path_table, f))
                    for f in PathTable._fields})
    return out


def layout_from_arrays(arrays, prefix: str = "lay_",
                       device=None) -> Optional[RouteLayout]:
    """Inverse of `layout_to_arrays` on `device` (default cuda); `arrays`
    is any mapping (an open NpzFile).  None when no layout was written.
    Keys of reference layout fields the port does not hold are ignored,
    so a reference bundle's layout loads too."""
    if prefix + "pad_idx" not in arrays:
        return None
    dev = resolve_device(device)

    def t(k):
        return torch.as_tensor(np.asarray(arrays[prefix + k]), device=dev)
    pt = None
    if prefix + "pt_pre_id" in arrays:
        pt = PathTable(**{f: t("pt_" + f) for f in PathTable._fields})
    return RouteLayout(**{f: t(f) for f in RouteLayout._fields
                          if f != "path_table"}, path_table=pt)


# --------------------------------------------------------------- splits

def path_mask(net: FluidNet) -> torch.Tensor:
    """(n_flows, n_paths) bool: True where the path slot holds a path."""
    if net.layout is not None:
        return net.layout.path_mask
    return torch.any(_routes3(net) >= 0, dim=2)


def uniform_split(net: FluidNet) -> torch.Tensor:
    """(n_flows, n_paths) equal weights over each flow's valid paths."""
    m = path_mask(net).to(torch.float32)
    return m / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)


def normalize_split(w: torch.Tensor, mask: torch.Tensor,
                    w_floor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project weights back onto the simplex over valid paths, keeping a
    `w_floor` (fraction of uniform) probe trickle on every valid path."""
    m = mask.to(w.dtype)
    w = torch.clamp(w, min=0.0) * m
    if w_floor is not None:
        n_valid = torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
        w = torch.maximum(w, (w_floor[:, None] / n_valid) * m)
    s = torch.sum(w, dim=1, keepdim=True)
    uni = m / torch.clamp(torch.sum(m, dim=1, keepdim=True), min=1.0)
    return torch.where(s > _EPS, w / torch.clamp(s, min=_EPS), uni)


def _split_or_uniform(net: FluidNet, split) -> torch.Tensor:
    return uniform_split(net) if split is None else split


# ---------------------------------------------------- flow -> link scatter

def _resolve_backend(net: FluidNet, backend: str) -> str:
    if backend not in LOAD_BACKENDS:
        raise ValueError(f"unknown link-aggregation backend {backend!r}")
    lay = net.layout
    has_pt = lay is not None and lay.path_table is not None
    if backend == "auto":
        if net.device.type == "cuda":
            return "pt_cuda" if has_pt else "cuda"
        return "pt" if has_pt else "reference"
    if backend in ("pt", "pt_cuda") and not has_pt:
        raise ValueError(f"backend {backend!r} needs a PathTable "
                         "(links.with_layout(net, path_table=True))")
    return backend


def _full_buffer(net: FluidNet, rates, split, backend: str, out=None):
    """(n_links + 1,) offered-load buffer, written into `out` if given.
    Real links are the contract; the scratch slot is backend-specific."""
    sub = rates[:, None] * split
    if backend == "cuda":
        lay = net.layout
        csr = None if lay is None else (lay.sort_sub, lay.link_ptr)
        return fleet_cuda.link_scatter(_pad_idx(net), sub, net.n_links,
                                       csr=csr, out=out)
    if backend == "pt_cuda":
        return fleet_cuda.path_table_scatter(net.layout.path_table, sub,
                                             out=out)
    if backend == "pt":
        pt = net.layout.path_table
        buf = kref.fleet_pt_offered_load_ref(pt.pre_id, pt.suf_id,
                                             pt.seg_idx, rates, split,
                                             net.n_links)
    else:
        buf = kref.fleet_offered_load_ref(_routes3(net), rates, split,
                                          net.n_links)
    return buf if out is None else out.copy_(buf)


def scatter_partial(net: FluidNet, rates: torch.Tensor,
                    split: Optional[torch.Tensor] = None, *,
                    backend: str = "auto", halo: Optional[int] = None,
                    out: Optional[torch.Tensor] = None):
    """This shard's partial offered load as `(private, tile)`.

    `tile` is the part a halo exchange reduces across shards, `private`
    the part only this shard's flows load.  Under a locality shard plan
    the link ids are relabeled boundary-last (`scenarios.plan_shards`), so
    with `halo=B`:

      * ``halo is None`` or 0 — no link is shared: `(buffer, None)`;
      * ``0 < halo < n_links`` — the tile pair of the reference's
        `fleet_pallas.link_scatter_tiles`: private (n_links - B,) and
        boundary (B + 1,) with the scratch slot last (K6 on the kernel
        backends; the plain buffer split in two on the plain ones);
      * ``halo == n_links`` — every link is boundary (the contiguous,
        ``locality=False`` plan): `(None, buffer)`.

    `out` receives the tile (row s of an exchange's stacked buffer).
    """
    split = _split_or_uniform(net, split)
    backend = _resolve_backend(net, backend)
    nl = net.n_links
    if halo is not None and not 0 <= halo <= nl:
        raise ValueError(f"halo {halo} out of [0, {nl}]")
    if not halo:
        return _full_buffer(net, rates, split, backend), None
    if halo == nl:
        return None, _full_buffer(net, rates, split, backend, out)
    sub = rates[:, None] * split
    if backend == "cuda":
        lay = net.layout
        csr = None if lay is None else (lay.sort_sub, lay.link_ptr)
        return fleet_cuda.link_scatter_tiles(_pad_idx(net), sub, nl, halo,
                                             csr=csr, bnd_out=out)
    if backend == "pt_cuda":
        return fleet_cuda.path_table_scatter(net.layout.path_table, sub,
                                             n_boundary=halo, bnd_out=out)
    buf = _full_buffer(net, rates, split, backend)
    priv, bnd = buf[:nl - halo], buf[nl - halo:]
    return priv, (bnd if out is None else out.copy_(bnd))


def assemble_load(private, tile, n_links: int) -> torch.Tensor:
    """(n_links,) loads from a `scatter_partial` pair after its exchange."""
    if tile is None:
        return private[:n_links]
    if private is None:
        return tile[:n_links]
    return torch.cat([private, tile[:-1]])


def halo_exchange(tiles: torch.Tensor, *, nbr: Optional[torch.Tensor] = None,
                  group=None) -> torch.Tensor:
    """Cross-shard reduction of the boundary tiles of `scatter_partial`.

    Two implementations behind one interface:

      * stacked (`group=None`): `tiles` is the (S, W) stack of every
        shard's tile, all shards in this process on one device; returns
        the (S, W) exchanged tiles.  The psum is a sum over the shard dim.
      * dist: `tiles` is this rank's (W,) tile and `group` a
        `torch.distributed` process group with one shard per rank; the
        psum is an `all_reduce`, reduced in place.

    `nbr` switches the psum to the NEIGHBOR exchange, legal when every
    boundary link is touched by exactly one ring-adjacent shard pair
    (`shard.neighbor_halo`): (S, 2, P) stacked or this rank's (2, P), in
    TILE positions (link id - (n_links - halo)), padded with the tile's
    scratch position.  Row 0 lists the links shared with the right
    neighbor, row 1 those shared with the left; each shard sends its
    values at row 1 to the left and at row 0 to the right (two rolls of
    the stacked send buffers, or `batch_isend_irecv` between ranks) and
    adds what it receives.  Every touched link then carries the full
    two-shard sum, bitwise equal to the psum because the other shards'
    contributions are exact +0.0; links of other pair groups stay stale,
    and no local flow reads them.
    """
    if group is None:
        if nbr is None:
            return tiles.sum(dim=0, keepdim=True).expand_as(tiles)
        to_left = torch.gather(tiles, 1, nbr[:, 1])
        to_right = torch.gather(tiles, 1, nbr[:, 0])
        out = tiles.scatter_add(1, nbr[:, 0], torch.roll(to_left, -1, 0))
        return out.scatter_add_(1, nbr[:, 1], torch.roll(to_right, 1, 0))
    import torch.distributed as dist
    if nbr is None:
        dist.all_reduce(tiles, group=group)
        return tiles
    n, p = dist.get_world_size(group), dist.get_rank(group)
    left = dist.get_global_rank(group, (p - 1) % n)
    right = dist.get_global_rank(group, (p + 1) % n)
    to_left, to_right = tiles[nbr[1]], tiles[nbr[0]]
    from_right, from_left = torch.empty_like(to_left), \
        torch.empty_like(to_right)
    ops = [dist.P2POp(dist.isend, to_left, left, group, tag=0),
           dist.P2POp(dist.isend, to_right, right, group, tag=1),
           dist.P2POp(dist.irecv, from_right, right, group, tag=0),
           dist.P2POp(dist.irecv, from_left, left, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tiles.index_add_(0, nbr[0], from_right).index_add_(0, nbr[1],
                                                             from_left)


def offered_load(net: FluidNet, rates: torch.Tensor,
                 split: Optional[torch.Tensor] = None, *,
                 backend: str = "auto", halo: Optional[int] = None
                 ) -> torch.Tensor:
    """(n_links,) aggregate arrival rate from per-flow send rates: flow i
    adds rates[i] * split[i, p] to every hop of its p-th path.

    `halo` routes the scatter as `scatter_partial` does (the tile pair,
    K6 on the kernel backends, for ``0 < halo < n_links``) and joins the
    tiles unexchanged: one shard's own partial load.  The sharded runners
    (`repro_torch.fleetsim.shard`) put `halo_exchange` between the two.
    """
    priv, tile = scatter_partial(net, rates, split, backend=backend,
                                 halo=halo)
    return assemble_load(priv, tile, net.n_links)


# ---------------------------------------------------- link -> flow gathers

def _link_scale(net: FluidNet, load):
    return torch.clamp(net.cap / torch.clamp(load, min=_EPS), max=1.0)


def _link_delay(net: FluidNet, q_phys):
    return q_phys / torch.clamp(net.cap, min=_EPS)


def step_queues(net: FluidNet, q_phys: torch.Tensor,
                q_phantom: torch.Tensor, load: torch.Tensor):
    """One forward-Euler epoch of both queue families."""
    q_phys = torch.minimum(torch.clamp(q_phys + (load - net.cap) * net.dt,
                                       min=0.0), net.qcap)
    q_phantom = torch.minimum(
        torch.clamp(q_phantom + (load - net.drain) * net.dt, min=0.0),
        net.vcap)
    return q_phys, q_phantom


def mark_prob(net: FluidNet, q_phys: torch.Tensor,
              q_phantom: torch.Tensor) -> torch.Tensor:
    """(n_links,) expected RED mark probability on the marking queue."""
    q = torch.where(net.use_phantom, q_phantom, q_phys)
    return torch.clamp((q - net.ecn_lo) /
                       torch.clamp(net.ecn_hi - net.ecn_lo, min=_EPS),
                       0.0, 1.0)


def drop_prob(net: FluidNet, q_phys_prev: torch.Tensor,
              load: torch.Tensor) -> torch.Tensor:
    """(n_links,) per-byte drop probability from physical-queue overflow:
    the pre-clip excess of `step_queues` over the bytes that arrived,
    max(q + (load - cap) dt - qcap, 0) / (load dt), clipped to [0, 1];
    exactly 0.0 while the queue stays within capacity."""
    over = q_phys_prev + (load - net.cap) * net.dt - net.qcap
    return torch.clamp(torch.clamp(over, min=0.0) /
                       torch.clamp(load * net.dt, min=_EPS), 0.0, 1.0)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 for an int32 index tensor of any shape (no
    int64 copy of the indices)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def subflow_loss_frac(net: FluidNet, p_drop: torch.Tensor) -> torch.Tensor:
    """(n, p) loss fraction: 1 - prod over hops of (1 - p_drop)."""
    keep = kref.append_identity(1.0 - p_drop, 1.0)
    return 1.0 - torch.prod(take(keep, _pad_idx(net)), dim=2)


def _pt_loss_frac(net: FluidNet, p_drop: torch.Tensor) -> torch.Tensor:
    """`subflow_loss_frac` through the PathTable."""
    pt = net.layout.path_table
    keep = kref.append_identity(1.0 - p_drop, 1.0)
    seg_keep = torch.prod(take(keep, pt.seg_idx), dim=1)
    return 1.0 - kref.compose_clean(pt.pre_id, pt.suf_id, seg_keep)


def link_physics(net: FluidNet, load: torch.Tensor, q_phys: torch.Tensor,
                 q_phantom: torch.Tensor, *, backend: str = "auto",
                 with_loss: bool = False) -> LinkEpoch:
    """The receive half of an epoch of link physics: from the (exchanged)
    loads, the queue step, the mark probabilities and the three link ->
    flow gathers.

    A net with `p_loss` thins `sub_scale` by each subflow's survival
    through its lossy hops.  `with_loss` also gives the reliability
    axis's loss signal: `p_drop` from the PRE-step queues (`drop_prob`,
    with `p_loss` folded in as an independent stage) and its composition
    per subflow, `sub_loss` (a plain gather on every backend, through the
    PathTable where the backend uses one).
    """
    rb = _resolve_backend(net, backend)
    p_drop = drop_prob(net, q_phys, load) if with_loss else None
    q_phys, q_phantom = step_queues(net, q_phys, q_phantom, load)
    p_link = mark_prob(net, q_phys, q_phantom)
    compressed = rb in ("pt", "pt_cuda")
    scale = _link_scale(net, load)
    clean = 1.0 - p_link
    delay = _link_delay(net, q_phys)
    pt = None if net.layout is None else net.layout.path_table
    if rb == "cuda":
        gathers = fleet_cuda.link_gathers(_pad_idx(net), scale, clean, delay)
    elif rb == "pt_cuda":
        gathers = fleet_cuda.path_table_gathers(pt, scale, clean, delay)
    elif rb == "pt":
        gathers = kref.fleet_pt_gathers_ref(pt.pre_id, pt.suf_id, pt.seg_idx,
                                            scale, clean, delay)
    else:
        gathers = kref.fleet_link_gathers_ref(_routes3(net), scale, clean,
                                              delay)
    sub_scale, sub_frac, sub_delay = gathers
    loss_frac = _pt_loss_frac if compressed else subflow_loss_frac
    if net.p_loss is not None:
        sub_scale = sub_scale * (1.0 - loss_frac(net, net.p_loss))
    sub_loss = None
    if with_loss:
        if net.p_loss is not None:
            p_drop = 1.0 - (1.0 - p_drop) * (1.0 - net.p_loss)
        sub_loss = loss_frac(net, p_drop)
    return LinkEpoch(load=load, q_phys=q_phys, q_phantom=q_phantom,
                     p_link=p_link, sub_scale=sub_scale, sub_frac=sub_frac,
                     sub_delay=sub_delay, p_drop=p_drop, sub_loss=sub_loss)


def link_epoch(net: FluidNet, rates: torch.Tensor, split: torch.Tensor,
               q_phys: torch.Tensor, q_phantom: torch.Tensor, *,
               backend: str = "auto", with_loss: bool = False,
               halo: Optional[int] = None) -> LinkEpoch:
    """One epoch of link physics: `offered_load` (with `halo`, one shard's
    own partial load) -> `link_physics`, `with_loss` as there."""
    rb = _resolve_backend(net, backend)
    load = offered_load(net, rates, split, backend=rb, halo=halo)
    return link_physics(net, load, q_phys, q_phantom, backend=rb,
                        with_loss=with_loss)


# -------------------------------------------------------------- builders

def dumbbell(n_intra: int, n_inter: int, *, rate: float = RATE_100G,
             intra_rtt: float = 14 * US, inter_rtt: float = 2 * MS,
             qcap: float = 1 * MIB, n_wan: int = 8, n_bottleneck: int = 1,
             phantom: bool = True, drain_frac: float = 0.9,
             cap_bdps: float = 1.0, min_frac: float = 0.05,
             max_frac: float = 0.35, red_lo_frac: float = 0.25,
             red_hi_frac: float = 0.75, epoch_period_frac: float = 1.0,
             multipath: bool = False, device=None):
    """The inter/intra dumbbell as (FluidNet with its RouteLayout, bdp
    (n_flows,), rtt (n_flows,)) on `device` (default cuda): a thin
    wrapper that builds `scenarios.dumbbell_scenario` and compiles it with
    `scenarios.fleet_arrays`, the reference's quick builder.

    Flows are numbered intra first, then inter; flow i sends to downlink
    i % n_bottleneck.  `multipath=False` aggregates the n_wan border links
    into one WAN pipe and gives every flow one path; `multipath=True`
    keeps them apart and gives each inter flow one path per WAN link.
    Routes are (n_flows, n_paths, 2).
    """
    # imported here: the scenarios package itself imports fleetsim
    from repro_torch.scenarios import dumbbell_scenario, fleet_arrays
    spec = dumbbell_scenario(
        n_intra, n_inter, rate=rate, intra_rtt=intra_rtt,
        inter_rtt=inter_rtt, qcap=qcap, n_wan=n_wan,
        n_bottleneck=n_bottleneck, phantom=phantom, drain_frac=drain_frac,
        cap_bdps=cap_bdps, min_frac=min_frac, max_frac=max_frac,
        red_lo_frac=red_lo_frac, red_hi_frac=red_hi_frac,
        epoch_period_frac=epoch_period_frac, multipath=multipath)
    net, bdp, rtt, _ = fleet_arrays(spec, device)
    return net, bdp, rtt
