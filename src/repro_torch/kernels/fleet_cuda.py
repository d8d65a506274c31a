"""Wrappers of the hand-written Hopper kernels for the fleetsim flow<->link
exchange (``csrc/fleet_kernels.cu``), replacing the Pallas TPU kernels of
``repro.kernels.fleet_pallas``.

  * `segment_sum` — K1, a deterministic segmented sum over a
    by-segment-sorted CSR entry list, balanced by entries: each block owns
    a tile of `ref.SEGSUM_TILE` consecutive entries whatever the segment
    lengths and writes the segments lying inside it; a segment over
    several tiles leaves a piece per tile, and the tile whose piece lands
    last (an atomic ticket) adds them in tile order.  One device kernel
    per call (see the note in ``fleet_kernels.cu``).  It replaces TPU
    rows 1, 3 and 4: `link_scatter` (flow -> link offered load),
    `path_rates` (PathTable stage 1) and `path_table_scatter` (stages
    1 + 2) are compositions of it.  Bound by bytes: the gather ids are
    streamed once, the values gathered from L2.
  * `segment_sum_tiles` — K6 (TPU row 6), the same kernel with the
    output cut at `n_links - n_boundary` into a private tile and a
    boundary tile (scratch slot last), the boundary tile written wherever
    the caller points it (a row of a halo exchange's stacked buffer).
    `link_scatter_tiles` and the tiled branch of `path_table_scatter`
    (stage 2) run on it.  Bitwise equal to K1 on the same CSR.
  * `link_gathers` — K2 (TPU row 2): min / 1 - prod / sum of the three
    per-link vectors (scale, clean, delay) over each subflow's hops of
    the (n, p, h) pad_idx table, the scratch slot reading (1, 1, 0).
  * `path_table_gathers` — K2 over the PathTable (TPU row 5, the whole
    function, `uno_pt_gathers`): the per-segment reductions of the
    (U, hseg) table, then the per-subflow prefix/suffix composition, two
    device kernels a call and no torch work around them.
  * `rel_epoch` — the epoch step's reliability phase
    (`reliability.rel_step`: recovery split, NACK machine, EC ladder,
    goodput split) in one launch.  It replaces no TPU kernel: the
    reference's `reliability.py` is jnp, which XLA fuses.
  * `LbUpdate` — UnoLB's split update (`cc.lb_update_plain`: the per-path
    mark filter, the repath count, the multiplicative weights and the
    simplex projection) in one launch.  It replaces no TPU kernel either:
    the reference's `cc.update_split` is jnp.

Device rule: a wrapper given CPU tensors runs its kernel's plain version
(`repro_torch.kernels.ref`); given CUDA tensors it launches the kernel or
raises — there is no fallback.  Each call that launches adds one to
``LAUNCHES["<kernel>/<use>"]``; nothing else touches the counts.  The
wrappers read no device value on the host (the K1/K6 grid comes from the
tensors' shapes, the live entry count is read on the device), so a step
built on them makes no host sync.
"""
from __future__ import annotations

import ctypes
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


def _on_cuda(*ts: torch.Tensor, meta: bool = False) -> bool:
    """True for operands on one CUDA device, False on the CPU; raises on
    several devices or another device.  ``meta=True`` (the UnoRC custom
    ops, whose fakes take meta tensors) counts meta as the card."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda" and not (meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}")
    return True


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ------------------------------------------------------------------ K1

def _check_out(out: Optional[torch.Tensor], name: str, n: int):
    if out is not None:
        _check(out, name, torch.float32, 1)
        if out.shape[0] != n:
            raise ValueError(f"{name}: expected ({n},), got "
                             f"{tuple(out.shape)}")


def _csr_operands(vals_ext, gather, ptr) -> int:
    """Check K1/K6's CSR operands; returns the real segment count."""
    _check(vals_ext, "vals_ext", torch.float32, 1)
    _check(gather, "gather", torch.int32, 1)
    _check(ptr, "ptr", torch.int32, 1)
    if ptr.shape[0] < 2:
        raise ValueError("ptr needs at least 2 offsets")
    if gather.shape[0] > 2 ** 31 - 1 - 2 * ref.SEGSUM_TILE:
        raise ValueError(f"gather: {gather.shape[0]} entries overflow int32")
    return ptr.shape[0] - 2


_TICKETS: dict = {}     # (device, stream) -> K1/K6's zeroed ticket counters


def _segsum_lib_and_scratch(gather: torch.Tensor):
    """The fleet library, K1/K6's piece scratch (2 words per tile) and the
    stream's ticket counters (1 per tile).  The kernel leaves the tickets
    zeroed, so each stream keeps one buffer, grown when a CSR needs more
    tiles; only that growth launches a memset."""
    from repro_torch.kernels import build
    lib = build.load("fleet")
    if not _TICKETS and lib.uno_segsum_tile() != ref.SEGSUM_TILE:
        raise RuntimeError(f"fleet_kernels.cu tiles {lib.uno_segsum_tile()} "
                           f"entries, ref.SEGSUM_TILE {ref.SEGSUM_TILE}")
    n_tiles = gather.shape[0] // ref.SEGSUM_TILE + 1
    dev = gather.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _TICKETS.get((dev, stream))
    if tickets is None or tickets.shape[0] < n_tiles:
        tickets = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        _TICKETS[(dev, stream)] = tickets
    scratch = torch.empty(2 * n_tiles, dtype=torch.float32, device=dev)
    return lib, scratch, tickets, stream


def segment_sum(vals_ext: torch.Tensor, gather: torch.Tensor,
                ptr: torch.Tensor, *, use: str = "flat",
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K + 1,) segment totals of the sorted entries vals_ext[gather]:
    out[k] sums entries ptr[k]..ptr[k+1] for the K = len(ptr) - 2 real
    segments; the trailing scratch/sentinel slot out[K] is 0.0.

    vals_ext: (V,) f32; gather: (E,) int32 ids into vals_ext; ptr:
    (K + 2,) int32 offsets with ptr[0] = 0 and ptr[K] <= E; entries at
    or past ptr[K] are never read.  `use` labels the launch count; `out`,
    if given, receives the result.
    """
    n_seg = _csr_operands(vals_ext, gather, ptr)
    _check_out(out, "out", n_seg + 1)
    extra = () if out is None else (out,)
    if not _on_cuda(vals_ext, gather, ptr, *extra):
        got = ref.csr_segment_sum_ref(vals_ext, gather, ptr)
        return got if out is None else out.copy_(got)
    lib, scratch, tickets, stream = _segsum_lib_and_scratch(gather)
    if out is None:
        out = torch.empty(n_seg + 1, dtype=torch.float32,
                          device=vals_ext.device)
    err = lib.uno_link_scatter(vals_ext.data_ptr(), gather.data_ptr(),
                               ptr.data_ptr(), out.data_ptr(),
                               scratch.data_ptr(), tickets.data_ptr(), n_seg,
                               gather.shape[0], stream)
    _raise_on(err, "uno_link_scatter")
    LAUNCHES["link_scatter/" + use] += 1
    return out


def segment_sum_tiles(vals_ext: torch.Tensor, gather: torch.Tensor,
                      ptr: torch.Tensor, n_boundary: int, *,
                      use: str = "flat",
                      bnd_out: Optional[torch.Tensor] = None):
    """K6: `segment_sum` cut into (private, boundary) tiles at
    K - n_boundary: private (K - n_boundary,) holds segments below the
    cut, boundary (n_boundary + 1,) the rest with the scratch/sentinel
    slot last, 0.0.  On real segments the two tiles concatenated equal
    `segment_sum` bitwise (the same kernel; only the stores differ).
    `bnd_out`, if given, receives the boundary tile.  Raises outside
    0 < n_boundary < K, as `fleet_pallas.link_scatter_tiles` does."""
    n_seg = _csr_operands(vals_ext, gather, ptr)
    if not 0 < n_boundary < n_seg:
        raise ValueError(f"n_boundary {n_boundary} out of (0, {n_seg})")
    _check_out(bnd_out, "bnd_out", n_boundary + 1)
    extra = () if bnd_out is None else (bnd_out,)
    if not _on_cuda(vals_ext, gather, ptr, *extra):
        priv, bnd = ref.csr_segment_sum_tiles_ref(vals_ext, gather, ptr,
                                                  n_boundary)
        return priv, (bnd if bnd_out is None else bnd_out.copy_(bnd))
    lib, scratch, tickets, stream = _segsum_lib_and_scratch(gather)
    dev = vals_ext.device
    priv = torch.empty(n_seg - n_boundary, dtype=torch.float32, device=dev)
    bnd = bnd_out if bnd_out is not None else \
        torch.empty(n_boundary + 1, dtype=torch.float32, device=dev)
    err = lib.uno_link_scatter_tiles(
        vals_ext.data_ptr(), gather.data_ptr(), ptr.data_ptr(),
        priv.data_ptr(), bnd.data_ptr(), scratch.data_ptr(),
        tickets.data_ptr(), n_seg, n_boundary, gather.shape[0], stream)
    _raise_on(err, "uno_link_scatter_tiles")
    LAUNCHES["link_scatter_tiles/" + use] += 1
    return priv, bnd


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
                 csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flow -> link offered load (the contract of fleet_pallas
    .link_scatter): pad_idx (n, p, h) int32 in [0, n_links], sub_vals
    (n, p) f32 -> (n_links + 1,) f32; real links are the contract, the
    scratch slot reads 0.0.  `csr` = the layout's (sort_sub, link_ptr)
    built from this pad_idx; None builds it here."""
    if csr is None:
        csr = csr_from_pad_idx(pad_idx, n_links)
    sort_sub, link_ptr = csr
    return segment_sum(sub_vals_ext(sub_vals), sort_sub, link_ptr,
                       use="flat", out=out)


def link_scatter_tiles(pad_idx: torch.Tensor, sub_vals: torch.Tensor,
                       n_links: int, n_boundary: int,
                       csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       bnd_out: Optional[torch.Tensor] = None):
    """The per-shard scatter with the boundary links in their own tile
    (the contract of fleet_pallas.link_scatter_tiles): the link ids are
    locality-relabeled, ids below n_links - n_boundary private.  Returns
    (private (n_links - n_boundary,), boundary (n_boundary + 1,)), the
    scratch slot last and 0.0."""
    if csr is None:
        csr = csr_from_pad_idx(pad_idx, n_links)
    sort_sub, link_ptr = csr
    return segment_sum_tiles(sub_vals_ext(sub_vals), sort_sub, link_ptr,
                             n_boundary, use="flat", bnd_out=bnd_out)


def path_rates(pt, sub_vals: torch.Tensor) -> torch.Tensor:
    """PathTable stage 1: (U + 1,) total subflow rate per unique segment;
    the final (sentinel) slot is 0.0, which stage 2's pad entries read."""
    return segment_sum(sub_vals_ext(sub_vals), pt.seg_gather.reshape(-1),
                       pt.seg_ptr, use="pt_stage1")


def path_table_scatter(pt, sub_vals: torch.Tensor,
                       n_boundary: Optional[int] = None,
                       out: Optional[torch.Tensor] = None,
                       bnd_out: Optional[torch.Tensor] = None):
    """PathTable stages 1 + 2: the (n_links + 1,) offered load (K1 twice),
    or with `n_boundary` the (private, boundary) tile pair of
    `link_scatter_tiles` (K1 for stage 1, K6 for stage 2)."""
    seg = path_rates(pt, sub_vals)
    if n_boundary is None:
        return segment_sum(seg, pt.lcsr_gather.reshape(-1), pt.llink_ptr,
                           use="pt_stage2", out=out)
    return segment_sum_tiles(seg, pt.lcsr_gather.reshape(-1), pt.llink_ptr,
                             n_boundary, use="pt_stage2", bnd_out=bnd_out)


# ------------------------------------------------------------------ K2

def _link_values(scale, clean, delay) -> int:
    """Check K2's per-link operands; returns the link count L."""
    for name, t in (("scale", scale), ("clean", clean), ("delay", delay)):
        _check(t, name, torch.float32, 1)
    n = scale.shape[0]
    if clean.shape[0] != n or delay.shape[0] != n:
        raise ValueError(f"scale / clean / delay lengths differ: {n}, "
                         f"{clean.shape[0]}, {delay.shape[0]}")
    return n


def _gather_outputs(n: int, p: int, dev):
    out = torch.empty((3, n, p), dtype=torch.float32, device=dev)
    return out, tuple(out.unbind(0))


def link_gathers(pad_idx: torch.Tensor, scale, clean, delay):
    """Fused link -> flow pass (the contract of fleet_pallas.link_gathers),
    K2 over the flat hop table: pad_idx (n, p, h) int32 in [0, L]; scale /
    clean / delay (L,) f32, the scratch slot L reading (1, 1, 0).
    Returns (sub_scale, sub_frac, sub_delay), each (n, p) f32: min of
    scale, 1 - product of clean and sum of delay over each subflow's hops.
    One launch per call, counted as ``link_gathers/flat``."""
    _check(pad_idx, "pad_idx", torch.int32, 3)
    n, p, h = pad_idx.shape
    if h < 1:
        raise ValueError("hop rows need at least one hop")
    n_links = _link_values(scale, clean, delay)
    if not _on_cuda(pad_idx, scale, clean, delay):
        return ref.link_gathers_ref(pad_idx, scale, clean, delay)
    out, outs = _gather_outputs(n, p, pad_idx.device)
    if out.numel() == 0:
        return outs
    from repro_torch.kernels import build
    lib = build.load("fleet")
    err = lib.uno_link_gathers(pad_idx.data_ptr(), scale.data_ptr(),
                               clean.data_ptr(), delay.data_ptr(), n_links,
                               out.data_ptr(), n * p, h,
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "uno_link_gathers")
    LAUNCHES["link_gathers/flat"] += 1
    return outs


def path_table_gathers(pt, scale, clean, delay):
    """Link -> flow pass through the PathTable (the contract of
    fleet_pallas.path_table_gathers), computed in full by
    ``uno_pt_gathers``: each unique segment's min / product / sum over its
    hseg hops of `pt.seg_idx` into a (U, 4) scratch table, then each
    subflow's `pt.pre_id` / `pt.suf_id` halves composed (min of scales,
    1 - product of the clean products, sum of delays).  Same contract as
    `link_gathers`.  Each call launches that kernel pair once and adds
    one to ``pt_gathers``."""
    pre, suf, seg_idx = pt.pre_id, pt.suf_id, pt.seg_idx
    _check(pre, "pre_id", torch.int32, 2)
    _check(suf, "suf_id", torch.int32, 2)
    _check(seg_idx, "seg_idx", torch.int32, 2)
    if suf.shape != pre.shape:
        raise ValueError(f"pre_id {tuple(pre.shape)} and suf_id "
                         f"{tuple(suf.shape)} differ")
    u, hseg = seg_idx.shape
    if hseg < 1:
        raise ValueError("segments need at least one hop")
    n_links = _link_values(scale, clean, delay)
    if not _on_cuda(pre, suf, seg_idx, scale, clean, delay):
        return ref.pt_gathers_ref(pre, suf, seg_idx, scale, clean, delay)
    n, p = pre.shape
    dev = pre.device
    out, outs = _gather_outputs(n, p, dev)
    if out.numel() == 0:
        return outs
    seg = torch.empty((u, 4), dtype=torch.float32, device=dev)
    from repro_torch.kernels import build
    lib = build.load("fleet")
    err = lib.uno_pt_gathers(pre.data_ptr(), suf.data_ptr(),
                             seg_idx.data_ptr(), scale.data_ptr(),
                             clean.data_ptr(), delay.data_ptr(), n_links,
                             seg.data_ptr(), out.data_ptr(), n * p, u, hseg,
                             torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "uno_pt_gathers")
    LAUNCHES["pt_gathers"] += 1
    return outs


# ------------------------------------------------------------- rel_epoch

# uno_rel_epoch's operands in the order of RelIn / RelOut in
# fleet_kernels.cu: the flow inputs, the RelParams knobs it reads, the
# RelState fields in their order; out, the new RelState, cut and goodput.
_REL_FLOW = ("rate", "rtx", "sc", "rtt", "split", "sub_loss", "dt")
_REL_KNOBS = ("enabled", "adapt_on", "ec_k", "ec_r", "ec_eff", "nack_period",
              "nack_hold", "nack_quantum", "coef", "ladder_k", "ladder_r",
              "ladder_eff", "ladder_coef", "ladder_up", "ladder_down")
_REL_STATE = ("pending", "backlog", "ack_cd", "hold", "md_cd", "rtx_ewma",
              "lat_ewma", "nacks", "rec_bytes", "rtx_bytes", "wire_bytes",
              "lost_bytes", "rung", "loss_ewma", "adapt_cd")
_REL_INT = ("ack_cd", "hold", "rung", "nack_period", "nack_hold")
_REL_BOOL = ("enabled", "adapt_on")
_REL_LADDER_STATE = ("rung", "loss_ewma", "adapt_cd")   # static: passed on


def _rel_cols() -> int:
    from repro_torch.fleetsim.reliability import MAX_R
    return MAX_R + 1


class RelEpoch:
    """``rel_epoch_kernel``'s launch for one RelParams `rel`: its knobs
    are checked and their pointers packed once, here, so that a call
    checks and packs only the state and flow tensors.  The ladder form
    comes from the tables' shapes: 0 none, 1 a shared (L,) ladder, 2 a
    grid's per-cell (cells, L) tables.  Calls as `rel_epoch` without its
    first operand."""

    def __init__(self, rel):
        ladder = rel.ladder_k
        form = 0 if ladder is None else ladder.dim()
        if form not in (0, 1, 2):
            raise ValueError(f"ladder_k: expected 1-d or 2-d, got shape "
                             f"{tuple(ladder.shape)}")
        knobs = [k for k in _REL_KNOBS if form or not k.startswith(
            ("ladder_", "adapt_on"))]
        for name in knobs:
            t = getattr(rel, name)
            if t is None:
                raise ValueError(f"rel.{name} is None with an EC ladder set")
            dtype = torch.int32 if name in _REL_INT else \
                torch.bool if name in _REL_BOOL else torch.float32
            ndim = (form + (name == "ladder_coef")) if name.startswith(
                "ladder_") else 2 if name == "coef" else 1
            _check(t, "rel." + name, dtype, ndim)
        n = rel.enabled.shape[0]
        for name in knobs:
            if not name.startswith("ladder_") and \
                    getattr(rel, name).shape[0] != n:
                raise ValueError(f"rel.{name}: expected {n} rows, got "
                                 f"{getattr(rel, name).shape[0]}")
        if rel.coef.shape[1] != _rel_cols():
            raise ValueError(f"rel.coef: expected {_rel_cols()} columns, "
                             f"got {rel.coef.shape[1]}")
        tab = (1, 1)
        if form:
            tab = tuple(ladder.shape)
            if rel.ladder_coef.shape != (*tab, _rel_cols()) or any(
                    getattr(rel, k).shape != tab for k in _REL_KNOBS[9:]
                    if k != "ladder_coef"):
                raise ValueError("ladder tables disagree in shape")
            if form == 2 and n % tab[0]:
                raise ValueError(f"{n} flows do not split into {tab[0]} "
                                 f"cells")
        self.rel, self.form, self.n = rel, form, n
        self.cell_flows = n // tab[0] if form == 2 else n
        self.n_rungs = tab[-1]
        self.counter = "rel_epoch/" + ("ladder" if form else "static")
        # the state fields it reads and writes; the static form passes the
        # ladder's on as they are
        self.fields = [f for f in _REL_STATE
                       if form or f not in _REL_LADDER_STATE]
        self.ints = [f for f in self.fields if f in _REL_INT]
        self.floats = [f for f in self.fields if f not in _REL_INT]
        _on_cuda(*(getattr(rel, k) for k in knobs))
        self.knob_ptrs = [getattr(rel, k).data_ptr() if k in knobs else None
                          for k in _REL_KNOBS]

    def __call__(self, st, rate: torch.Tensor, rtx: torch.Tensor,
                 split: torch.Tensor, sub_loss: torch.Tensor,
                 sc: torch.Tensor, dt, rtt: torch.Tensor):
        n = self.n
        _check(split, "split", torch.float32, 2)
        _check(sub_loss, "sub_loss", torch.float32, 2)
        n_paths = split.shape[1]
        if split.shape[0] != n or sub_loss.shape != split.shape:
            raise ValueError(f"split, sub_loss: expected ({n}, p), got "
                             f"{tuple(split.shape)}, "
                             f"{tuple(sub_loss.shape)}")
        flow = (rate, rtx, sc, rtt)     # _REL_FLOW's order
        for name, t in zip(_REL_FLOW, flow):
            _check(t, name, torch.float32, 1)
        state = [getattr(st, f) for f in self.fields]
        for f, t in zip(self.fields, state):
            _check(t, "st." + f,
                   torch.int32 if f in _REL_INT else torch.float32, 1)
        for name, t in [*zip(_REL_FLOW, flow), *zip(self.fields, state)]:
            if t.shape[0] != n:
                raise ValueError(f"{name}: expected {n} rows, got "
                                 f"{t.shape[0]}")
        if not _on_cuda(self.rel.enabled, split, sub_loss, *flow, *state):
            from repro_torch.fleetsim.reliability import rel_step_plain
            return rel_step_plain(self.rel, st, rate, rtx, split, sub_loss,
                                  sc, dt, rtt)
        if not (isinstance(dt, torch.Tensor) and dt.device == rate.device
                and dt.dtype == torch.float32 and dt.numel() == 1):
            raise ValueError(f"dt: expected one float32 on {rate.device}, "
                             f"got {dt!r}")
        if n_paths >= 64:
            raise ValueError(f"split: {n_paths} paths, the kernel takes "
                             f"fewer than 64")
        dev = rate.device
        fbuf = torch.empty((len(self.floats), n), dtype=torch.float32,
                           device=dev)
        ibuf = torch.empty((len(self.ints), n), dtype=torch.int32,
                           device=dev)
        new = {f: getattr(st, f) for f in _REL_LADDER_STATE}
        new.update(zip(self.floats, fbuf.unbind(0)))
        new.update(zip(self.ints, ibuf.unbind(0)))
        new = type(st)(**new)
        cut = torch.empty(n, dtype=torch.bool, device=dev)
        goodput = torch.empty(n, dtype=torch.float32, device=dev)
        if n == 0:
            return new, cut, goodput
        from repro_torch.kernels import build
        lib = build.load("fleet")
        ins = [t.data_ptr() for t in (*flow, split, sub_loss)] + \
            [dt.data_ptr()] + self.knob_ptrs + \
            [getattr(st, f).data_ptr() if f in self.fields else None
             for f in _REL_STATE]
        outs = [getattr(new, f).data_ptr() if f in self.fields else None
                for f in _REL_STATE] + [cut.data_ptr(), goodput.data_ptr()]
        ins = (ctypes.c_void_p * len(ins))(*ins)
        outs = (ctypes.c_void_p * len(outs))(*outs)
        err = lib.uno_rel_epoch(
            ctypes.addressof(ins), ctypes.addressof(outs), n, n_paths,
            self.cell_flows, self.n_rungs, self.form,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "uno_rel_epoch")
        LAUNCHES[self.counter] += 1
        return new, cut, goodput


def rel_epoch(rel, st, rate: torch.Tensor, rtx: torch.Tensor,
              split: torch.Tensor, sub_loss: torch.Tensor, sc: torch.Tensor,
              dt, rtt: torch.Tensor):
    """The epoch step's reliability phase (the contract of
    `reliability.rel_step`) in one launch of ``rel_epoch_kernel``: `rel`
    a RelParams, `st` a RelState, all (n,) but `split` / `sub_loss` (n, p)
    f32, p < 64; `dt` the epoch, a 0-d f32 tensor on their device (on
    the CPU the plain version takes a number too).  Returns
    (RelState', cut, goodput): the new state in fresh tensors (the float
    fields rows of one buffer, the int32 ones of another; without a
    ladder `rung`, `loss_ewma` and `adapt_cd` pass on as they are), the
    cut mask and the EC-split goodput, bitwise the plain version's;
    `st` is never written.  Counted as ``rel_epoch/static`` without a
    ladder, else ``rel_epoch/ladder``.  A step that runs it every epoch
    builds `RelEpoch(rel)` once."""
    return RelEpoch(rel)(st, rate, rtx, split, sub_loss, sc, dt, rtt)


# ------------------------------------------------------------- lb_update

# uno_lb_update's operands in the order of LbIn / LbOut in
# fleet_kernels.cu: the (n, p) state rows, then the mask, the filter gain
# and the LbParams it reads; out, the new path_frac, split and bad_count.
_LB_ROWS = ("split", "path_frac", "sub_frac", "bad_count")
_LB_KNOBS = ("fb", "eta", "repath_thresh", "repath_patience", "w_floor")
LB_MAX_PATHS = 8        # fleet_kernels.cu instantiates p = 1 .. 8


def _check_lb_align(t: torch.Tensor, name: str, p: int):
    """Raise unless `t`'s rows of `p` are aligned for `lb_update_kernel`'s
    vector access: float and int32 rows in 16-, 8- or 4-byte pieces (the
    widest that divides the row), the mask row in one p-byte load where p
    is 1, 2, 4 or 8, else byte by byte."""
    if t.dtype == torch.bool:
        align = p if p in (1, 2, 4, 8) else 1
    else:
        align = 4 * (4 if p % 4 == 0 else 2 if p % 2 == 0 else 1)
    if t.data_ptr() % align:
        raise ValueError(f"{name}: rows must be {align}-byte aligned for "
                         f"the kernel's vector access")


class LbUpdate:
    """``lb_update_kernel``'s launch for one LbParams `lb`, filter gain
    `fb` ((n,) f32, the flows' dt / rtt clamped at 1) and path mask ((n,
    p) bool, 1 <= p <= LB_MAX_PATHS): checked and their pointers packed
    once, here, so that a call checks only the four state rows.

    A call takes this epoch's send split, the stored path_frac, the
    epoch's sub_frac ((n, p) f32) and the stored bad_count ((n, p) int32)
    and returns (path_frac', split', bad_count') in fresh tensors, bitwise
    `cc.lb_update_plain`'s on the card; the inputs are never written.
    CPU operands run that plain version; CUDA ones launch the kernel once,
    counted as ``lb_update``, or raise."""

    def __init__(self, lb, fb: torch.Tensor, mask: torch.Tensor):
        _check(mask, "mask", torch.bool, 2)
        n, p = mask.shape
        if not 1 <= p <= LB_MAX_PATHS:
            raise ValueError(f"mask: {p} paths, lb_update_kernel takes 1 to "
                             f"{LB_MAX_PATHS}")
        knobs = (fb, lb.eta, lb.repath_thresh, lb.repath_patience,
                 lb.w_floor)
        for name, t in zip(_LB_KNOBS, knobs):
            _check(t, name, torch.int32 if name == "repath_patience"
                   else torch.float32, 1)
            if t.shape[0] != n:
                raise ValueError(f"{name}: expected {n} rows, got "
                                 f"{t.shape[0]}")
        if _on_cuda(mask, *knobs):
            _check_lb_align(mask, "mask", p)
        self.lb, self.fb, self.mask, self.n, self.p = lb, fb, mask, n, p
        self.in_ptrs = [mask.data_ptr()] + [t.data_ptr() for t in knobs]

    def __call__(self, split: torch.Tensor, path_frac: torch.Tensor,
                 sub_frac: torch.Tensor, bad_count: torch.Tensor):
        n, p = self.n, self.p
        rows = (split, path_frac, sub_frac, bad_count)
        for name, t in zip(_LB_ROWS, rows):
            _check(t, name, torch.int32 if name == "bad_count"
                   else torch.float32, 2)
            if t.shape != (n, p):
                raise ValueError(f"{name}: expected ({n}, {p}), got "
                                 f"{tuple(t.shape)}")
        if not _on_cuda(self.mask, *rows):
            from repro_torch.fleetsim.cc import lb_update_plain
            return lb_update_plain(self.lb, self.fb, self.mask, *rows)
        for name, t in zip(_LB_ROWS, rows):
            _check_lb_align(t, name, p)
        dev = split.device
        out = (torch.empty((n, p), dtype=torch.float32, device=dev),
               torch.empty((n, p), dtype=torch.float32, device=dev),
               torch.empty((n, p), dtype=torch.int32, device=dev))
        if n == 0:
            return out
        from repro_torch.kernels import build
        lib = build.load("fleet")
        ins = [t.data_ptr() for t in rows] + self.in_ptrs
        outs = [t.data_ptr() for t in out]
        ins = (ctypes.c_void_p * len(ins))(*ins)
        outs = (ctypes.c_void_p * len(outs))(*outs)
        err = lib.uno_lb_update(ctypes.addressof(ins), ctypes.addressof(outs),
                                n, p,
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "uno_lb_update")
        LAUNCHES["lb_update"] += 1
        return out
