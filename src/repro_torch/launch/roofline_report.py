"""The dry run's records as the roofline table (the reference's
``repro.launch.roofline_report``), against one H100.

  PYTHONPATH=src python -m repro_torch.launch.roofline_report [--dir DIR]

Per (arch x shape) cell of ``launch.dryrun``: the three roofline terms
(bounds, not times: the least time the card could take for the counted
work, from NVIDIA's H100 SXM data sheet at 700 W), the dominant term, the
MODEL/counted flops ratio, the roofline fraction (the model's flops at
the card's bf16 peak over the largest term), the peak live bytes and
whether they fit the card's 80 GB; the Uno step's cells (``--uno``) in
a second table with their DCI bytes; the multi-pod cells (``dryrun
--multipod``: rank 0's program on the (2, 16, 16) mesh, baseline and
Uno) in a third with each device's collective and DCI bytes a step; then
the reference's candidate lists.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.roofline import H100_SXM

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(tag: str, results: pathlib.Path = RESULTS_DIR) -> dict:
    out = {}
    for p in sorted(pathlib.Path(results).glob(f"*__{tag}.json")):
        rec = json.loads(p.read_text())
        out[(rec["arch"], rec["shape"])] = rec
    return out


def fraction(rec, chip=H100_SXM) -> float | None:
    """Roofline fraction: ideal compute time / achievable step time where
    ideal = MODEL_FLOPS / (chips * bf16 peak) and achievable = max of the
    3 terms."""
    r = rec.get("roofline")
    if not r or rec.get("skipped"):
        return None
    ideal = rec["model_flops"] / (rec["chips"] * chip["peak_flops"])
    bound = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
    return ideal / bound if bound else None


def row(rec) -> dict:
    r = rec["roofline"]
    c = rec["costs"]
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
        "t_collective_s": r["t_collective_s"], "dominant": r["dominant"],
        "model_flops": rec["model_flops"],
        "useful_ratio": rec.get("useful_flops_ratio"),
        "roofline_fraction": fraction(rec),
        "dci_GB": c.get("dci_bytes", 0.0) / 1e9,
        "collective_GB": c.get("collective_bytes", 0.0) / 1e9,
        "peak_GB": rec["peak_bytes"] / 1e9,
        "fits": rec["fits_one_card"],
    }


def _rows(recs) -> list:
    rows = [row(r) for r in recs.values() if not r.get("skipped")]
    rows.sort(key=lambda x: (x["arch"], SHAPE_ORDER.index(x["shape"])))
    return rows


def table(rows, dci: bool = False, coll: bool = False) -> list:
    hdr = ("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant "
           "| MODEL/counted | roofline frac | peak GB | fits |")
    cols = 10
    if coll:
        hdr += " collective GB/device |"
        cols += 1
    if dci:
        hdr += " DCI GB/pod |" if not coll else " DCI GB/device |"
        cols += 1
    out = [hdr, "|" + "---|" * cols]
    for x in rows:
        line = (f"| {x['arch']} | {x['shape']} | {x['t_compute_s']:.3g} "
                f"| {x['t_memory_s']:.3g} | {x['t_collective_s']:.3g} "
                f"| **{x['dominant']}** | {(x['useful_ratio'] or 0):.2f} | "
                f"{(x['roofline_fraction'] or 0) * 100:.1f}% | "
                f"{x['peak_GB']:.4g} | {'yes' if x['fits'] else 'no'} |")
        if coll:
            line += f" {x['collective_GB']:.4g} |"
        if dci:
            line += f" {x['dci_GB']:.4g} |"
        out.append(line)
    return out


def report(results: pathlib.Path = RESULTS_DIR) -> str:
    card = load("card", results)
    uno = load("card-uno", results)
    multi = {**load("multipod", results), **{
        (a, s + " (uno)"): r for (a, s), r in
        load("multipod-uno", results).items()}}
    rows = _rows(card)
    lines = [f"roofline bounds against {H100_SXM['name']}", *table(rows)]
    if uno:
        lines += ["", "### Uno step, 2 pods on the card", *table(_rows(uno),
                                                                dci=True)]
    if multi:
        mrows = [row(dict(r, shape=s)) for (a, s), r in sorted(multi.items())
                 if not r.get("skipped")]
        lines += ["", "### multi-pod, rank 0 of (2, 16, 16)",
                  *table(mrows, dci=True, coll=True)]
    live = [x for x in rows if x["roofline_fraction"] is not None]
    worst = sorted(live, key=lambda x: x["roofline_fraction"])[:5]
    coll = sorted(live, key=lambda x: -x["t_collective_s"] /
                  max(x["t_compute_s"] + x["t_memory_s"], 1e-12))[:5]
    lines += ["", "### hillclimb candidates",
              "worst roofline fraction: " + str(
                  [(x["arch"], x["shape"],
                    f"{x['roofline_fraction'] * 100:.2f}%") for x in worst]),
              "most collective-bound: " + str(
                  [(x["arch"], x["shape"], f"{x['t_collective_s']:.3g}s coll "
                    f"vs {max(x['t_compute_s'], x['t_memory_s']):.3g}s next")
                   for x in coll]),
              "",
              f"cells costed: {len(rows)} "
              f"(+{sum(1 for r in card.values() if r.get('skipped'))} "
              "documented skips); multipod cells costed: "
              f"{sum(1 for r in multi.values() if not r.get('skipped'))} "
              f"(+{sum(1 for r in multi.values() if r.get('skipped'))} "
              "documented skips)"]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    print(report(pathlib.Path(args.dir)))


if __name__ == "__main__":
    main()
