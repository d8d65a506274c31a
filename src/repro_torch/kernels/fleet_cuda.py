"""Wrappers of the hand-written Hopper kernels for the fleetsim flow<->link
exchange (``csrc/fleet_kernels.cu``), replacing the Pallas TPU kernels of
``repro.kernels.fleet_pallas``.

  * `segment_sum` — K1, a deterministic warp-per-segment sum over a
    by-segment-sorted CSR entry list.  `link_scatter` (row-1 contract:
    flow -> link offered load), `path_rates` (PathTable stage 1) and
    `path_table_scatter` (stages 1 + 2) are compositions of it.
  * `row_gathers` — K2, one thread per row of an (R, h) index table:
    min / 1 - prod / sum of the packed per-link values over the row's
    hops.  `link_gathers` (flat, R = n*p rows of max_hops) and
    `path_table_gathers` (R = U unique segments of hseg hops, then the
    per-subflow prefix/suffix composition in torch) run on it.

Device rule: a wrapper given CPU tensors runs its kernel's plain version
(`repro_torch.kernels.ref`); given CUDA tensors it launches the kernel or
raises — there is no fallback.  Each launch adds one to
``LAUNCHES["<kernel>/<use>"]``; nothing else touches the counts.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ------------------------------------------------------------------ K1

def segment_sum(vals_ext: torch.Tensor, gather: torch.Tensor,
                ptr: torch.Tensor, *, use: str = "flat") -> torch.Tensor:
    """(K + 1,) segment totals of the sorted entries vals_ext[gather]:
    out[k] sums entries ptr[k]..ptr[k+1] for the K = len(ptr) - 2 real
    segments; the trailing scratch/sentinel slot out[K] is 0.0.

    vals_ext: (V,) f32; gather: (E,) int32 ids into vals_ext; ptr:
    (K + 2,) int32 offsets.  `use` labels the launch count.
    """
    _check(vals_ext, "vals_ext", torch.float32, 1)
    _check(gather, "gather", torch.int32, 1)
    _check(ptr, "ptr", torch.int32, 1)
    if ptr.shape[0] < 2:
        raise ValueError("ptr needs at least 2 offsets")
    if not _on_cuda(vals_ext, gather, ptr):
        return ref.csr_segment_sum_ref(vals_ext, gather, ptr)
    from repro_torch.kernels import build
    lib = build.load()
    n_seg = ptr.shape[0] - 2
    out = torch.empty(n_seg + 1, dtype=torch.float32, device=vals_ext.device)
    err = lib.uno_link_scatter(vals_ext.data_ptr(), gather.data_ptr(),
                               ptr.data_ptr(), out.data_ptr(), n_seg,
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "uno_link_scatter")
    LAUNCHES["link_scatter/" + use] += 1
    return out


def sub_vals_ext(sub_vals: torch.Tensor) -> torch.Tensor:
    """(S + 1,) flattened subflow rates with the 0.0 sentinel appended."""
    flat = sub_vals.reshape(-1).to(torch.float32)
    return torch.cat([flat, flat.new_zeros(1)])


def csr_from_pad_idx(pad_idx: torch.Tensor, n_links: int):
    """(sort_sub, link_ptr): the by-link-sorted CSR view of a padded hop
    table, as `RouteLayout` stores it (stable sort, pads last)."""
    h = pad_idx.shape[-1]
    flat = pad_idx.reshape(-1).to(torch.int64)
    sort_link, order = torch.sort(flat, stable=True)
    sort_sub = (order // h).to(torch.int32)
    keys = torch.arange(n_links + 2, device=pad_idx.device)
    link_ptr = torch.searchsorted(sort_link, keys).to(torch.int32)
    return sort_sub.contiguous(), link_ptr.contiguous()


def link_scatter(pad_idx: torch.Tensor, sub_vals: torch.Tensor, n_links: int,
                 csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Flow -> link offered load (the contract of fleet_pallas
    .link_scatter): pad_idx (n, p, h) int32 in [0, n_links], sub_vals
    (n, p) f32 -> (n_links + 1,) f32; real links are the contract, the
    scratch slot reads 0.0.  `csr` = the layout's (sort_sub, link_ptr)
    built from this pad_idx; None builds it here."""
    if csr is None:
        csr = csr_from_pad_idx(pad_idx, n_links)
    sort_sub, link_ptr = csr
    return segment_sum(sub_vals_ext(sub_vals), sort_sub, link_ptr,
                       use="flat")


def path_rates(pt, sub_vals: torch.Tensor) -> torch.Tensor:
    """PathTable stage 1: (U + 1,) total subflow rate per unique segment;
    the final (sentinel) slot is 0.0, which stage 2's pad entries read."""
    return segment_sum(sub_vals_ext(sub_vals), pt.seg_gather.reshape(-1),
                       pt.seg_ptr, use="pt_stage1")


def path_table_scatter(pt, sub_vals: torch.Tensor) -> torch.Tensor:
    """PathTable stages 1 + 2: (n_links + 1,) offered load."""
    seg = path_rates(pt, sub_vals)
    return segment_sum(seg, pt.lcsr_gather.reshape(-1), pt.llink_ptr,
                       use="pt_stage2")


# ------------------------------------------------------------------ K2

def row_gathers(idx: torch.Tensor, packed: torch.Tensor, *,
                use: str = "flat"):
    """(min col 0, 1 - prod col 1, sum col 2) over each row of the (R, h)
    int32 index table into the (L + 1, 4) f32 packed per-link table.
    Returns three (R,) f32."""
    _check(idx, "idx", torch.int32, 2)
    _check(packed, "packed", torch.float32, 2)
    if packed.shape[1] != 4:
        raise ValueError(f"packed must be (L + 1, 4), got {tuple(packed.shape)}")
    if idx.shape[1] < 1:
        raise ValueError("index rows need at least one hop")
    if not _on_cuda(idx, packed):
        return ref.row_gathers_ref(idx, packed)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    r, h = idx.shape
    outs = [torch.empty(r, dtype=torch.float32, device=idx.device)
            for _ in range(3)]
    if r == 0:
        return tuple(outs)
    from repro_torch.kernels import build
    lib = build.load()
    err = lib.uno_link_gathers(idx.data_ptr(), packed.data_ptr(),
                               *(o.data_ptr() for o in outs), r, h,
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "uno_link_gathers")
    LAUNCHES["link_gathers/" + use] += 1
    return tuple(outs)


def link_gathers(pad_idx: torch.Tensor, scale, clean, delay):
    """Fused link -> flow pass (the contract of fleet_pallas.link_gathers):
    pad_idx (n, p, h) int32 in [0, L]; scale / clean / delay (L,) f32.
    Returns (sub_scale, sub_frac, sub_delay), each (n, p) f32."""
    n, p, h = pad_idx.shape
    packed = ref.pack_link_values(scale, clean, delay)
    outs = row_gathers(pad_idx.reshape(n * p, h), packed, use="flat")
    return tuple(o.reshape(n, p) for o in outs)


def path_table_gathers(pt, scale, clean, delay):
    """Link -> flow pass through the PathTable: K2 once per unique segment
    over the (U, hseg) table, then two per-subflow takes compose the
    prefix/suffix halves (min of scales, product of the clean
    probabilities, sum of delays).  Same contract as `link_gathers`."""
    packed = ref.pack_link_values(scale, clean, delay)
    seg_scale, seg_frac, seg_delay = row_gathers(pt.seg_idx, packed,
                                                 use="pt_segments")
    return ref.compose_segments(pt.pre_id, pt.suf_id, seg_scale,
                                1.0 - seg_frac, seg_delay)
