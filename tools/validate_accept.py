#!/usr/bin/env python3
"""The fluid-vs-packet acceptances at the reference's full depth on the
port: a packet run of the case's spec, the port's fluid half
(`repro_torch.fleetsim.validate`) on `--device`, held at the reference's
own bars.

    PYTHONPATH=src python tools/validate_accept.py CASE [--device cuda]
        [--packet port|reference]

CASE is one of steady_2flow, steady_8flow, multipath, recovery, fault,
adaptive_ec, fat_tree, multi_dc (the reference's acceptance tests:
tests/test_fleetsim.py:264-290, tests/test_reliability.py:317-331,
tests/test_faults.py:386-407, tests/test_fat_tree_scenarios.py:272-273,
tests/test_multi_dc.py:255-257).  `--packet port` (the default) runs the
packet half on the port's netsim and imports nothing of the reference,
so it runs on the card machine; `--packet reference` runs the
reference's netsim on the equal reference spec (where JAX is installed;
the two give the same bits).  Prints one JSON line: the case, pass or
fail with each check, the numbers the checks read, and the seconds of
the packet (host) and the fluid side.  Exits 1 if a check fails.  The
port's fluid run is eager: minutes on a CPU at this depth.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

MS = 1e6
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))
CASES = ("steady_2flow", "steady_8flow", "multipath", "recovery", "fault",
         "adaptive_ec", "fat_tree", "multi_dc")


def to_reference(obj):
    """A port spec as the reference's spec: each NamedTuple rebuilt as
    the reference's class of the same name, field for field."""
    from repro.scenarios import spec as RS
    if hasattr(obj, "_fields"):
        return getattr(RS, type(obj).__name__)(*(to_reference(x)
                                                 for x in obj))
    if isinstance(obj, tuple):
        return tuple(to_reference(x) for x in obj)
    return obj


def reference_recovery_rates(spec, horizon, t0, size=512 * 1024 * 1024):
    """The reference's inline packet run (recovery / adaptive EC) on the
    equal reference spec: per-flow goodput over [t0, horizon) and
    sum(n_retx) / sum(n_sent) after t0."""
    from repro.scenarios import spawn_backlogged, to_netsim
    net = to_netsim(to_reference(spec))
    flows = spawn_backlogged(net, cc_scheme="uno", size=size)
    snap = {}

    def _snapshot():
        snap["sent"] = sum(f.n_sent for f in flows)
        snap["retx"] = sum(f.n_retx for f in flows)

    net.sim.at(t0, _snapshot)
    net.sim.run(until=horizon)
    ns = np.array([sum(b for (t, b) in f.rate_trace if t0 <= t < horizon)
                   / (horizon - t0) for f in flows])
    d_sent = sum(f.n_sent for f in flows) - snap["sent"]
    return ns, (sum(f.n_retx for f in flows) - snap["retx"]) / max(d_sent, 1)


def packet_side(kind: str):
    """(rates(spec, horizon, t0), recovery(spec, horizon, t0)) of the
    `kind` packet simulator ("port" or "reference")."""
    if kind == "port":
        from repro_torch.scenarios import (netsim_recovery_rates,
                                           netsim_scenario_rates)
        return ((lambda spec, horizon, t0: netsim_scenario_rates(
                    spec, horizon=horizon, t0=t0)),
                (lambda spec, horizon, t0: netsim_recovery_rates(
                    spec, horizon=horizon, t0=t0)))
    if kind == "reference":
        from repro.fleetsim.validate import netsim_scenario_rates
        return ((lambda spec, horizon, t0: netsim_scenario_rates(
                    to_reference(spec), horizon=horizon, t0=t0)),
                reference_recovery_rates)
    raise ValueError(f"unknown packet simulator {kind!r}")


def _binomial_split(k, r, q):
    """tests/test_reliability.py's closed form: the parity-recovered and
    NACKed fractions of an RS(k, r) window at loss q."""
    n = k + r
    rec_w = sum(i * math.comb(n, i) * q ** i * (1 - q) ** (n - i)
                for i in range(r + 1))
    return rec_w * k / n ** 2, (n * q - rec_w) * k / n ** 2


def run(case: str, device: str, packet_kind: str = "port") -> dict:
    from repro_torch.fleetsim import validate as V

    t = {}
    rates, recovery = packet_side(packet_kind)

    def packet(spec, horizon, t0):
        t0_ = time.perf_counter()
        ns = rates(spec, horizon, t0)
        t["packet_s"] = time.perf_counter() - t0_
        return ns

    def packet_run(spec, horizon, t0):
        t0_ = time.perf_counter()
        out = recovery(spec, horizon, t0)
        t["packet_s"] = time.perf_counter() - t0_
        return out

    t_start = time.perf_counter()
    if case in ("steady_2flow", "steady_8flow"):
        n_intra, n_inter, horizon, t0 = (1, 1, 45, 15) \
            if case == "steady_2flow" else (8, 0, 80, 10)
        ns = packet(V.steady_state_spec(n_intra, n_inter), horizon * MS,
                    t0 * MS)
        res = V.compare_steady_state(n_intra, n_inter, netsim=ns,
                                     device=device)
        checks = {"max_rel_err < 0.15": res["max_rel_err"] < 0.15,
                  "|util diff| <= 0.06":
                      abs(res["util_fluid"] - res["util_netsim"]) <= 0.06}
    elif case == "multipath":
        ns = packet(V.multipath_spec(2, 2, n_bottleneck=2), 45 * MS,
                    15 * MS)
        res = V.compare_multipath_steady_state(2, 2, n_bottleneck=2,
                                               netsim=ns, device=device)
        checks = {"max_rel_err < 0.15": res["max_rel_err"] < 0.15,
                  "util within 10 %": abs(res["util_fluid"]
                                          - res["util_netsim"])
                  <= 0.10 * res["util_netsim"]}
    elif case == "recovery":
        ns, retx = packet_run(V.recovery_spec(6), 60 * MS, 20 * MS)
        res = V.compare_recovery_steady_state(
            6, netsim=ns, retx_netsim=retx, n_warm=200_000, n_meas=200_000,
            device=device)
        rec, nack = _binomial_split(8, 2, 0.02)
        ratio = res["util_fluid"] / max(res["util_netsim"], 1e-9)
        checks = {"loss_fluid ~ 0.02 (5 %)":
                      abs(res["loss_fluid"] - 0.02) <= 0.05 * 0.02,
                  "rec_fluid ~ binomial (10 %)":
                      abs(res["rec_fluid"] - rec) <= 0.10 * rec,
                  "retx_fluid ~ binomial (50 %)":
                      abs(res["retx_fluid"] - nack) <= 0.50 * nack,
                  "retx_netsim < 2e-3": res["retx_netsim"] < 2e-3,
                  "0.8 < util ratio < 2.5": 0.8 < ratio < 2.5,
                  "max_rel_err < 3.5": res["max_rel_err"] < 3.5}
    elif case == "fault":
        ns = packet(V.fault_spec(), 70 * MS, 45 * MS)
        res = V.compare_fault_recovery(netsim=ns, device=device)
        checks = {"finite": bool(np.isfinite(res["agg_fluid"])
                                 and np.isfinite(res["fluid"]).all()),
                  "agg_netsim > 0": res["agg_netsim"] > 0,
                  "agg_rel_err < 0.10": res["agg_rel_err"] < 0.10}
    elif case == "adaptive_ec":
        def replay(spec):
            return packet_run(spec, 60 * MS, 20 * MS)

        res = V.compare_adaptive_ec(0.02, replay=replay, n_warm=120_000,
                                    device=device, **LADDER)
        ratio = res["util_fluid"] / max(res["util_netsim"], 1e-9)
        checks = {"rung 1": res["rung_fluid"] == 1,
                  "geometry (8, 2)": res["rung_geometry"] == (8, 2),
                  "loss_fluid ~ 0.02 (5 %)":
                      abs(res["loss_fluid"] - 0.02) <= 0.05 * 0.02,
                  "0.8 < util ratio < 2.5": 0.8 < ratio < 2.5,
                  "max_rel_err < 3.5": res["max_rel_err"] < 3.5}
    elif case in ("fat_tree", "multi_dc"):
        spec = V.fat_tree_steady_spec() if case == "fat_tree" \
            else V.multi_dc_steady_spec()
        ns = packet(spec, 45 * MS, 15 * MS)
        cmp = V.compare_fat_tree_steady_state if case == "fat_tree" \
            else V.compare_multi_dc_steady_state
        res = cmp(netsim=ns, device=device)
        checks = {"max_rel_err < 0.35": res["max_rel_err"] < 0.35,
                  "|util diff| < 0.15":
                      abs(res["util_fluid"] - res["util_netsim"]) < 0.15}
    else:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    total = time.perf_counter() - t_start
    numbers = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in res.items() if k != "rel_err"}
    return dict(case=case, ok=all(checks.values()),
                checks={k: bool(v) for k, v in checks.items()},
                packet=packet_kind, device=device,
                packet_s=t.get("packet_s"),
                fluid_s=total - t.get("packet_s", 0.0), total_s=total,
                **numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=CASES)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--packet", choices=("port", "reference"),
                    default="port")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    out = run(args.case, args.device, args.packet)
    print(json.dumps(out, default=str), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
