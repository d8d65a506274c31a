"""Roofline terms for one card (the reference's
``repro.launch.hlo_analysis.roofline_terms``).

`roofline_terms` returns the reference's three terms in seconds and the
dominant one.  `chip` is a dict with the reference's keys (`peak_flops`,
`hbm_bw`, `ici_bw`, `hbm_bytes`); the port's card is `H100_SXM`, NVIDIA's
data sheet for the H100 SXM at its 700 W power limit, dense rates without
sparsity.  Its `peak_by_dtype` prices each dtype's products at their own
rate: with `flops_by_dtype` (the op counter's split, ``launch.op_costs``)
the compute term is sum(flops_d / peak_d).  The port keeps TF32 off, so
its float32 products (the attention's scores and values, the float32 gate
and head products) run at the float32 rate outside the tensor cores, 15x
below bf16: one bf16 peak for all flops, as a single-peak model has it,
would understate those steps' compute term by that much.

The collective term prices a rank's collective bytes (``launch.
collectives``) at NVLink's 450 GB/s each way within a host of 8 cards,
and the bytes of groups that leave the host at `net_bw`, one 400 Gb/s
network port per card.
"""
from __future__ import annotations

H100_SXM = {
    "name": "NVIDIA H100 SXM (data sheet, 700 W)",
    "peak_flops": 989e12,         # bf16 / fp16 dense, tensor cores
    "peak_by_dtype": {
        "bfloat16": 989e12,
        "float16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,         # outside the tensor cores (TF32 off)
    },
    "hbm_bw": 3.35e12,            # bytes/s
    "ici_bw": 450e9,              # NVLink bytes/s each way
    # one 400 Gb/s ConnectX-7 port per card (NVIDIA DGX H100 data sheet:
    # eight single-port ConnectX-7 VPI, 400 Gb/s InfiniBand, per 8 cards)
    "net_bw": 50e9,
    "hbm_bytes": 80e9,
}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, *, chip=H100_SXM,
                   flops_by_dtype=None, off_host_bytes: float = 0.0) -> dict:
    """Three roofline terms in seconds: compute (the flops at the chip's
    one peak, or with `flops_by_dtype` each dtype's at its own), memory
    (HBM bytes over the chip's rate) and collective (bytes over its link
    rate; the `off_host_bytes` among them over the network's), and the
    dominant one.  The counts are per device, as the reference's are, so
    `chips` divides nothing."""
    if flops_by_dtype is None:
        t_compute = flops / chip["peak_flops"]
    else:
        peaks = chip["peak_by_dtype"]
        unknown = set(flops_by_dtype) - set(peaks)
        if unknown:
            raise KeyError(f"no peak rate for {sorted(unknown)} on "
                           f"{chip.get('name', chip)}")
        t_compute = sum(f / peaks[d] for d, f in flops_by_dtype.items())
    t_memory = hbm_bytes / chip["hbm_bw"]
    t_coll = coll_bytes / chip["ici_bw"]
    if off_host_bytes:
        t_coll = ((coll_bytes - off_host_bytes) / chip["ici_bw"]
                  + off_host_bytes / chip["net_bw"])
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}
