"""Fluid-model topology in torch: links as (n_links,) tensors, routes as a
padded flow -> path -> link hop tensor, and the compiled `RouteLayout` /
`PathTable` that make the per-epoch flow<->link exchange cheap.

The port of ``repro.fleetsim.links``.  The layout and the path table are
built host-side in numpy exactly as the reference builds them (same stable
sorts, same block rounding, same np.unique factorization), then moved to
the device once, so every index array equals the reference's.

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


def _path_table_np(r: np.ndarray, n_links: int, block: int,
                   min_compress: Optional[float]):
    """numpy fields of the PathTable, or None when it does not clear
    `min_compress` (see the reference's `compute_path_table`)."""
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
    seg, inv = np.unique(np.concatenate([pre, suf]), axis=0,
                         return_inverse=True)
    inv = inv.reshape(-1)
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
    seg_idx = np.where(seg >= 0, seg, n_links).astype(np.int32)
    order = np.argsort(e_seg, kind="stable")
    seg_gather, seg_ptr = _blocked_csr(
        e_seg[order], e_sub[order], u, u, n_sub, block)
    # stage 2: each (segment, hop) entry carries the segment's rate
    e_lnk = seg_idx.reshape(-1)
    e_sid = np.repeat(np.arange(u, dtype=np.int32), hseg)
    order = np.argsort(e_lnk, kind="stable")
    lcsr_gather, llink_ptr = _blocked_csr(
        e_lnk[order], e_sid[order], n_links, n_links, u, block)
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
                       device=None) -> Optional[PathTable]:
    """Build the unique-path-segment table host-side and move it to
    `device` (default: the routes' device; cuda for numpy routes).
    `min_compress=r` returns None unless the flat entry count is at least
    r times the compressed one (the auto-attach policy)."""
    dev = _device_of(routes, device)
    arrs = _path_table_np(_np(routes), n_links, block, min_compress)
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


def with_layout(net: FluidNet, **kw) -> FluidNet:
    """`net` with a freshly compiled layout attached, on net's device."""
    kw.setdefault("device", net.device)
    return net._replace(layout=compute_layout(net.routes, net.n_links, **kw))


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


def not_yet(**kw):
    """Raise for arguments that belong to slices not ported yet."""
    for name, val in kw.items():
        if val is not None and val is not False:
            raise NotImplementedError(f"{name}= is not ported yet")


def offered_load(net: FluidNet, rates: torch.Tensor,
                 split: Optional[torch.Tensor] = None, *,
                 backend: str = "auto", axis_name=None, halo=None,
                 nbr=None) -> torch.Tensor:
    """(n_links,) aggregate arrival rate from per-flow send rates: flow i
    adds rates[i] * split[i, p] to every hop of its p-th path."""
    not_yet(axis_name=axis_name, halo=halo, nbr=nbr)
    split = _split_or_uniform(net, split)
    backend = _resolve_backend(net, backend)
    sub = rates[:, None] * split
    if backend == "cuda":
        lay = net.layout
        csr = None if lay is None else (lay.sort_sub, lay.link_ptr)
        buf = fleet_cuda.link_scatter(_pad_idx(net), sub, net.n_links,
                                      csr=csr)
    elif backend == "pt_cuda":
        buf = fleet_cuda.path_table_scatter(net.layout.path_table, sub)
    elif backend == "pt":
        pt = net.layout.path_table
        buf = kref.fleet_pt_offered_load_ref(pt.pre_id, pt.suf_id,
                                             pt.seg_idx, rates, split,
                                             net.n_links)
    else:
        buf = kref.fleet_offered_load_ref(_routes3(net), rates, split,
                                          net.n_links)
    return buf[:net.n_links]


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


def subflow_loss_frac(net: FluidNet, p_drop: torch.Tensor) -> torch.Tensor:
    """(n, p) loss fraction: 1 - prod over hops of (1 - p_drop)."""
    keep = kref.append_identity(1.0 - p_drop, 1.0)
    return 1.0 - torch.prod(keep[_pad_idx(net).long()], dim=2)


def _pt_loss_frac(net: FluidNet, p_drop: torch.Tensor) -> torch.Tensor:
    """`subflow_loss_frac` through the PathTable."""
    pt = net.layout.path_table
    keep = kref.append_identity(1.0 - p_drop, 1.0)
    seg_keep = torch.prod(keep[pt.seg_idx.long()], dim=1)
    return 1.0 - kref.compose_clean(pt.pre_id, pt.suf_id, seg_keep)


def link_epoch(net: FluidNet, rates: torch.Tensor, split: torch.Tensor,
               q_phys: torch.Tensor, q_phantom: torch.Tensor, *,
               backend: str = "auto", with_loss: bool = False,
               axis_name=None, halo=None, nbr=None) -> LinkEpoch:
    """One epoch of link physics: offered load -> queue step -> mark
    probabilities -> the three link -> flow gathers.

    A net with `p_loss` thins `sub_scale` by each subflow's survival
    through its lossy hops.  `with_loss`, `axis_name`, `halo` and `nbr`
    belong to slices not ported yet and raise.
    """
    not_yet(with_loss=with_loss, axis_name=axis_name, halo=halo, nbr=nbr)
    rb = _resolve_backend(net, backend)
    load = offered_load(net, rates, split, backend=rb)
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
    if net.p_loss is not None:
        loss_frac = _pt_loss_frac if compressed else subflow_loss_frac
        sub_scale = sub_scale * (1.0 - loss_frac(net, net.p_loss))
    return LinkEpoch(load=load, q_phys=q_phys, q_phantom=q_phantom,
                     p_link=p_link, sub_scale=sub_scale, sub_frac=sub_frac,
                     sub_delay=sub_delay)
