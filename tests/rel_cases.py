"""Seeded operands of the epoch step's reliability phase
(`reliability.rel_step`), for its CPU tests (test_torch_rel_step.py) and
its kernel's on the card (test_torch_kernels_gpu.py).  Imports no JAX.

Three ladder forms: static EC, one shared ladder, and per-cell ladder
tables as a grid stacks them (fault_sweep128's four padded EC policies,
repeated over the cells).  Every 16 flows hold the edge rows: a flow
with no loss whose pending bytes sit exactly on the NACK quantum, one
whose loss and loss EWMA sit exactly on its rung's step-up threshold and
one on its step-down threshold (both off cooldown); every 4th flow sees
no loss at all; about a tenth of the flows are disabled and, with a
ladder, another tenth do not adapt; the NACK clocks, holdoffs and cut
cooldowns take 0 and 1 among their values."""
import numpy as np
import torch

from repro_torch.fleetsim import reliability as TR
from repro_torch.fleetsim import sweeps as TSW

FORMS = ("static", "shared", "per_cell")
LADDER = dict(ladder=((8, 1), (8, 2), (8, 4)), ladder_up=(0.008, 0.05, 1.0),
              ladder_down=(0.0, 0.004, 0.025))
CELL_LADDERS = (((8, 1), (8, 1), (8, 1)), ((8, 2), (8, 2), (8, 2)),
                ((8, 4), (8, 4), (8, 4)), ((8, 1), (8, 2), (8, 4)))
DT = 14e3


def rel_params(form: str, n: int, cells: int, rng, device, ec=(8, 2)):
    enabled = rng.uniform(size=n) < 0.9
    if form == "static":
        return TR.make_rel_params(n, ec=ec, enabled=enabled,
                                  nack_period=3, nack_hold=1, device=device)
    if form == "shared":
        rel = TR.make_rel_params(n, enabled=enabled, nack_period=3,
                                 nack_hold=1, device=device, **LADDER)
    else:
        f = n // cells
        rel = TSW._stack_rel([TR.make_rel_params(
            f, ladder=CELL_LADDERS[b % 4], enabled=enabled[b * f:(b + 1) * f],
            nack_period=1 + b % 3, nack_hold=b % 2, device=device)
            for b in range(cells)])
    still = torch.as_tensor(rng.uniform(size=n) < 0.1, device=device)
    return rel._replace(adapt_on=rel.adapt_on & ~still)


def rel_inputs(form: str, n_paths: int, n: int, cells: int = 1,
               seed: int = 0, device="cpu", ec=(8, 2)):
    """(rel, st, rate, rtx, split, sub_loss, sc, dt, rtt): `n` flows over
    `n_paths` paths, `cells` cells for the per-cell form, static EC `ec`
    for the static form."""
    rng = np.random.default_rng(seed)
    rel = rel_params(form, n, cells, rng, device, ec)
    n_rungs = 1 if rel.ladder_k is None else rel.ladder_k.shape[-1]
    u = lambda lo, hi, *s: rng.uniform(lo, hi, (n, *s)).astype(np.float32)  # noqa
    i = lambda hi: rng.integers(0, hi, n).astype(np.int32)  # noqa
    st = dict(pending=u(0, 9e3), backlog=u(0, 5e4), ack_cd=i(4), hold=i(3),
              md_cd=u(0, 2e4), rtx_ewma=u(0, 1), lat_ewma=u(0, 1e5),
              nacks=u(0, 9).round(), rec_bytes=u(0, 1e6),
              rtx_bytes=u(0, 1e6), wire_bytes=u(0, 1e8),
              lost_bytes=u(0, 1e6), rung=i(n_rungs), loss_ewma=u(0, 0.06),
              adapt_cd=u(0, 1e4))
    st["md_cd"][::5] = 0.0
    st["adapt_cd"][::3] = 0.0
    split = np.ones((n, 1), np.float32) if n_paths == 1 else \
        rng.dirichlet(np.ones(n_paths), n).astype(np.float32)
    sub_loss = u(0, 0.08, n_paths)
    sub_loss[::4] = 0.0
    # the edge rows
    sub_loss[1::16] = 0.0
    st["pending"][1::16] = rel.nack_quantum.cpu().numpy()[1::16]
    if rel.ladder_k is not None:
        rung = torch.as_tensor(st["rung"], device=device)
        for off, table in ((2, rel.ladder_up), (3, rel.ladder_down)):
            at = TR._rung(rel, table, rung).cpu().numpy()[off::16]
            st["loss_ewma"][off::16] = at
            sub_loss[off::16] = at[:, None]
            split[off::16] = 0.0
            split[off::16, 0] = 1.0
            st["adapt_cd"][off::16] = 0.0
    t = lambda a: torch.as_tensor(a, device=device)  # noqa
    st = TR.RelState(**{k: t(v) for k, v in st.items()})
    rate = t(u(0, 12.5))
    rtt = t(rng.choice([DT, 2e6], n).astype(np.float32))
    rtx = TR.rtx_rate(rel, st, rate, rtt)
    return (rel, st, rate, rtx, t(split), t(sub_loss), t(u(0.3, 1.0)),
            torch.tensor(DT, dtype=torch.float32, device=device), rtt)


def old_composition(rel, st, rate, rtx, split, sub_loss, sc, dt, rtt):
    """The reliability lines of the epoch step's receive half as they
    stood before `rel_step`: the loss fraction, `rel_epoch`, then
    `effective_eff` and the goodput split of `wire * sc`."""
    wire = rate + rtx
    goodput = wire * sc
    lf = split[:, 0] * sub_loss[:, 0] if split.shape[1] == 1 else \
        torch.sum(split * sub_loss, dim=1)
    new, cut, recovered = TR.rel_epoch(rel, st, rate, rtx, wire, lf, dt, rtt)
    eff = TR.effective_eff(rel, st)
    return new, cut, goodput * eff + rtx * sc * (1.0 - eff) + recovered
