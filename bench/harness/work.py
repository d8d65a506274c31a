"""The bytes a unit of the epoch's work needs, and the chip's peak.

The formulas are frozen from the kernel table of PERF.md (the port's
rows 1-5): every input read once and every output written once, 4 bytes
a value or index.  They read the compiled layout's shapes only, so they
count the same work whatever kernel does it; `bench/kernel_work/<work>.json`
names the kernels that do it today and the launch counts that confirm
which form ran.

  * a segmented sum over a CSR (K1): the values with their sentinel, the
    live gather ids, the K + 2 offsets and the K + 1 outputs:
    4 (V + E + (K + 2) + (K + 1));
  * `link_scatter` (flow -> link offered load): on a flat layout one sum
    over the by-link CSR (V = S + 1, E = live hop entries, K = L); over a
    PathTable its stage 1 (V = S + 1, E = live stage-1 entries, K = U)
    plus stage 2 (V = U + 1, E = live stage-2 entries, K = L);
  * `link_gathers` (link -> flow min / product / sum): flat 4 S h
    (hop table) + 12 L (three link vectors) + 12 S (three outputs);
    PathTable 4 U hseg + 12 L + 20 S (its two id tables and outputs).

S = n_flows * n_paths subflows, h = max hops, L = links, U = unique
segments, hseg = hops a segment.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth (the card's rate at its 700 W
# limit; the power limit is printed beside every run)
HBM_BYTES_PER_S = 3.35e12


def layout_shapes(net) -> dict:
    """The shapes (and live entry counts) of a compiled FluidNet's
    layout, read once on the host."""
    lay = net.layout
    r = net.routes if net.routes.dim() == 3 else net.routes[:, None, :]
    n, p, h = (int(x) for x in r.shape)
    nl = int(net.cap.shape[0])
    out = dict(n=n, p=p, h=h, S=n * p, L=nl,
               flat_live=int(lay.link_ptr[nl]), pt=None)
    pt = lay.path_table
    if pt is not None:
        u, hseg = (int(x) for x in pt.seg_idx.shape)
        out["pt"] = dict(U=u, hseg=hseg, stage1_live=int(pt.seg_ptr[u]),
                         stage2_live=int(pt.llink_ptr[nl]))
    return out


def segsum_bytes(n_vals: int, live: int, n_seg: int) -> int:
    return 4 * (n_vals + live + (n_seg + 2) + (n_seg + 1))


def link_scatter_bytes(s: dict) -> int:
    pt = s["pt"]
    if pt is None:
        return segsum_bytes(s["S"] + 1, s["flat_live"], s["L"])
    return segsum_bytes(s["S"] + 1, pt["stage1_live"], pt["U"]) + \
        segsum_bytes(pt["U"] + 1, pt["stage2_live"], s["L"])


def link_gathers_bytes(s: dict) -> int:
    pt = s["pt"]
    if pt is None:
        return 4 * s["S"] * s["h"] + 12 * s["L"] + 12 * s["S"]
    return 4 * pt["U"] * pt["hseg"] + 12 * s["L"] + 20 * s["S"]


BYTES = {"link_scatter": link_scatter_bytes,
         "link_gathers": link_gathers_bytes}


def roofline(ctx: dict, work: str):
    """% of the HBM roofline that the kernels doing `work` reached in the
    traced stretch: the bytes the work needs over the peak rate, over the
    device time of the kernels `kernel_work/<work>.json` names.  None
    when nothing was traced, when the launch counts show the layout's
    form did not run once an epoch, or when no named kernel ran."""
    from bench.harness.config import kernel_work
    tr, shapes = ctx.get("trace"), ctx.get("layout")
    if not tr or not shapes:
        return None
    mapping = kernel_work(work)
    form = "flat" if shapes["pt"] is None else "path_table"
    if any(tr["launches"].get(k, 0) != tr["epochs"]
           for k in mapping["launches"][form]):
        return None
    t_us = sum(e - s for name, s, e in tr["kernels"]
               if any(k in name for k in mapping["kernels"]))
    if t_us <= 0:
        return None
    need_s = tr["epochs"] * BYTES[work](shapes) / HBM_BYTES_PER_S
    return 100.0 * need_s / (t_us * 1e-6)
