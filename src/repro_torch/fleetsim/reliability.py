"""Dynamic EC + NACK loss recovery, vectorized per flow.

The port of ``repro.fleetsim.reliability``: field names, dtypes and the
arithmetic are the reference's, so a reference `RelParams` / `RelState`
flattened to numpy loads field for field (`repro_torch.fleetsim.carry`).

Loss signal: a link's drop probability is its physical queue's overflow
as a fraction of the bytes that arrived (`links.drop_prob`), composed
along each path as 1 - prod(1 - p_drop) and split-weighted per flow
(`links.link_physics(with_loss=True)`).

EC recovery split: a block of k data + r parity packets decodes locally
when X <= r of its n = k + r packets are lost, X ~ Binomial(n, q).  Per
wire byte,

    recovered  = E[X 1(X <= r)] k / n^2    (parity absorbs the loss)
    nack_bytes = E[X 1(X >  r)] k / n^2    (data for the NACK path)

with E[X 1(X > r)] = n q - sum_{i<=r} i P(X = i), so only the r + 1 pmf
terms are needed: `coef[:, i]` = C(n, i) for i <= r, else 0 (MAX_R + 1
columns).  Both are exactly 0.0 at q == 0, which keeps a loss-free step
equal to the static-EC step.

NACK machine per flow: `pending` lost bytes wait for the batch clock
(`ack_cd`, every `nack_period` epochs); a NACK fires when the clock
ticks, the `hold` debounce has run out and pending holds at least
`nack_quantum` bytes, moving pending into the retransmit `backlog`.  The
backlog drains at min(backlog / rtt, rtx_cap * rate) as real wire
traffic (`rtx_rate`), and a fired NACK cuts cwnd by `loss_md` at most
once per flow RTT (`md_cd`).  The optional adaptive-EC ladder steps a
flow's rung up or down on a flow-RTT-clock EWMA of its loss fraction,
with hysteresis and a once-per-RTT cooldown (`rel_epoch`).

The epoch step runs the whole phase through `rel_step`: one hand-written
kernel launch on the card (`kernels.fleet_cuda.rel_epoch`), the same
composition in torch operations on the CPU and on the plain link
backends (`rel_step_plain`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fleet_cuda
from repro_torch.trace import traced

_EPS = 1e-9
MAX_R = 16        # parity window cap: coef tables carry MAX_R + 1 pmf terms


class RelParams(NamedTuple):
    """Per-flow reliability constants: (n_flows,) float32 / int32 / bool,
    `coef` (n_flows, MAX_R + 1).  Flows with `enabled == False` keep
    `ec_eff` as a static goodput factor and bypass the machine.  The
    ladder arrays are rung-indexed and shared by every flow; all None
    means static EC.  A grid of cells whose ladders differ
    (`fleetsim.sweeps`) stacks them to per-cell tables with a leading
    cell axis, (cells, L) and (cells, L, MAX_R + 1); its flows are
    cell-major (cell b's F flows are rows b·F to (b+1)·F - 1), so each
    flow reads its own cell's rungs, and `RelState.rung` stays the
    cell-local rung."""
    enabled: torch.Tensor        # bool: EC+NACK active on this flow
    ec_k: torch.Tensor           # data packets per block
    ec_r: torch.Tensor           # parity packets per block
    ec_eff: torch.Tensor         # goodput efficiency k/(k+r); 1.0 = no EC
    nack_period: torch.Tensor    # int32 epochs between NACK batch ticks
    nack_hold: torch.Tensor      # int32 debounce epochs after a NACK fires
    loss_md: torch.Tensor        # cwnd factor applied when a NACK fires
    rtx_cap: torch.Tensor        # retransmit rate cap, multiple of CC rate
    nack_quantum: torch.Tensor   # min pending bytes for a NACK (~1 packet)
    coef: torch.Tensor           # (n_flows, MAX_R + 1) masked C(n, i)
    adapt_on: Optional[torch.Tensor] = None      # bool (n_flows,)
    ladder_k: Optional[torch.Tensor] = None      # (L,) data pkts per rung
    ladder_r: Optional[torch.Tensor] = None      # (L,) parity pkts per rung
    ladder_eff: Optional[torch.Tensor] = None    # (L,) k/(k+r) per rung
    ladder_coef: Optional[torch.Tensor] = None   # (L, MAX_R + 1) pmf coefs
    ladder_up: Optional[torch.Tensor] = None     # (L,) loss EWMA to step up
    ladder_down: Optional[torch.Tensor] = None   # (L,) loss EWMA to step down


class RelState(NamedTuple):
    """Per-flow recovery state, all (n_flows,): the machine proper, then
    observables (EWMAs and cumulative counters)."""
    pending: torch.Tensor        # lost bytes awaiting a NACK batch
    backlog: torch.Tensor        # NACKed bytes awaiting retransmission
    ack_cd: torch.Tensor         # int32: epochs to the next NACK batch tick
    hold: torch.Tensor           # int32: debounce epochs remaining
    md_cd: torch.Tensor          # ns until the next loss_md cut may fire
    rtx_ewma: torch.Tensor       # EWMA retransmit rate (bytes/ns)
    lat_ewma: torch.Tensor       # EWMA recovery latency estimate (ns)
    nacks: torch.Tensor          # cumulative NACK events
    rec_bytes: torch.Tensor      # cumulative parity-recovered data bytes
    rtx_bytes: torch.Tensor      # cumulative retransmitted bytes
    wire_bytes: torch.Tensor     # cumulative wire bytes sent
    lost_bytes: torch.Tensor     # cumulative wire bytes dropped en route
    rung: torch.Tensor           # int32 current ladder rung (0 = base EC)
    loss_ewma: torch.Tensor      # controller's smoothed loss fraction
    adapt_cd: torch.Tensor       # ns until the next rung move may fire


def binom_coef_row(k: int, r: int, device=None) -> torch.Tensor:
    """(MAX_R + 1,) float32: C(k+r, i) for i <= r, 0.0 past the window."""
    n = k + r
    row = [float(math.comb(n, i)) if i <= r else 0.0
           for i in range(MAX_R + 1)]
    return torch.tensor(row, dtype=torch.float32,
                        device=resolve_device(device))


@traced("fleetsim.make_rel_params")
def make_rel_params(n_flows: int, *, ec: Tuple[int, int] = (8, 2),
                    nack_period: int = 1, nack_hold: int = 0,
                    loss_md: float = 0.5, rtx_cap: float = 1.0,
                    nack_quantum: float = 4096.0,
                    enabled=None, ladder=None, ladder_up=None,
                    ladder_down=None, device=None) -> RelParams:
    """Broadcast scalar reliability knobs to (n_flows,) tensors on
    `device` (default cuda).

    `ec=(k, r)` sets the block geometry (r <= MAX_R).  `nack_period` and
    `nack_hold` are in epochs.  `enabled` masks the machine per flow
    (default all on).  `ladder=((k0, r0), ...)` turns on the adaptive-EC
    controller from rung 0, which replaces `ec`; `ladder_up[i]` is the
    loss EWMA above which rung i steps up, `ladder_down[i]` the one below
    which it steps down (defaults: 0.5 (r+1)/n, and half the previous
    rung's up-threshold).
    """
    dev = resolve_device(device)
    k, r = int(ec[0]), int(ec[1])
    rungs = None
    if ladder is not None:
        rungs = [(int(kk), int(rr)) for kk, rr in ladder]
        if not rungs:
            raise ValueError("ladder needs at least one (k, r) rung")
        k, r = rungs[0]
    if k < 1 or r < 0 or r > MAX_R:
        raise ValueError(f"ec=({k}, {r}) needs k >= 1 and 0 <= r <= "
                         f"{MAX_R}")
    f32 = dict(dtype=torch.float32, device=dev)
    ones = torch.ones(n_flows, **f32)
    if enabled is None:
        enabled = torch.ones(n_flows, dtype=torch.bool, device=dev)
    enabled = torch.as_tensor(enabled, dtype=torch.bool, device=dev)
    en = enabled.to(torch.float32)
    lad = dict(adapt_on=None, ladder_k=None, ladder_r=None,
               ladder_eff=None, ladder_coef=None, ladder_up=None,
               ladder_down=None)
    if rungs is not None:
        for kk, rr in rungs:
            if kk < 1 or rr < 0 or rr > MAX_R:
                raise ValueError(f"ladder rung ({kk}, {rr}) needs k >= 1 "
                                 f"and 0 <= r <= {MAX_R}")
        ks = torch.tensor([kk for kk, _ in rungs], **f32)
        rs = torch.tensor([rr for _, rr in rungs], **f32)
        ns = ks + rs
        if ladder_up is None:
            up = 0.5 * (rs + 1.0) / ns      # top rung's value never fires
        else:
            up = torch.tensor(ladder_up, **f32)
        if ladder_down is None:
            down = torch.cat([torch.zeros(1, **f32), 0.5 * up[:-1]])
        else:
            down = torch.tensor(ladder_down, **f32)
        if up.shape != ks.shape or down.shape != ks.shape:
            raise ValueError("ladder_up/ladder_down must match the ladder "
                             "length")
        lad = dict(
            adapt_on=enabled,
            ladder_k=ks, ladder_r=rs, ladder_eff=ks / ns,
            ladder_coef=torch.stack([binom_coef_row(kk, rr, dev)
                                     for kk, rr in rungs]),
            ladder_up=up, ladder_down=down)
    return RelParams(
        enabled=enabled,
        ec_k=torch.where(enabled, float(k), 1.0),
        ec_r=torch.where(enabled, float(r), 0.0),
        ec_eff=torch.where(enabled, k / (k + r), 1.0),
        nack_period=torch.full((n_flows,), max(int(nack_period), 1),
                               dtype=torch.int32, device=dev),
        nack_hold=torch.full((n_flows,), max(int(nack_hold), 0),
                             dtype=torch.int32, device=dev),
        loss_md=loss_md * ones, rtx_cap=rtx_cap * ones,
        nack_quantum=nack_quantum * ones,
        coef=en[:, None] * binom_coef_row(k, r, dev)[None, :],
        **lad)


LADDER_SHARED = ("ladder_k", "ladder_r", "ladder_eff", "ladder_coef",
                 "ladder_up", "ladder_down")


def stack_rel_params(rows: list) -> RelParams:
    """Concatenate per-group RelParams along the flow axis.  The ladder
    arrays pass through once (every group that has one must have the
    same); groups without one get `adapt_on = False`."""
    out = {}
    for f in RelParams._fields:
        vals = [getattr(r, f) for r in rows]
        if f in LADDER_SHARED:
            present = [v for v in vals if v is not None]
            if not present:
                out[f] = None
                continue
            ref = present[0]
            for v in present[1:]:
                if v.shape != ref.shape or not torch.equal(v, ref):
                    raise ValueError(
                        "stack_rel_params: groups carry differing EC "
                        "ladders; the ladder is shared across the fleet")
            out[f] = ref
        elif f == "adapt_on":
            if all(v is None for v in vals):
                out[f] = None
            else:
                out[f] = torch.cat(
                    [v if v is not None
                     else torch.zeros_like(r.enabled)
                     for v, r in zip(vals, rows)])
        else:
            out[f] = torch.cat(vals)
    return RelParams(**out)


def init_rel_state(rel: RelParams) -> RelState:
    """Clean recovery state: empty pools, batch clock at a full period."""
    z = torch.zeros_like(rel.loss_md)
    return RelState(pending=z, backlog=z, ack_cd=rel.nack_period,
                    hold=torch.zeros_like(rel.nack_hold), md_cd=z,
                    rtx_ewma=z, lat_ewma=z, nacks=z, rec_bytes=z,
                    rtx_bytes=z, wire_bytes=z, lost_bytes=z,
                    rung=torch.zeros_like(rel.nack_period), loss_ewma=z,
                    adapt_cd=z)


def _rung(rel: RelParams, table: torch.Tensor,
          rung: torch.Tensor) -> torch.Tensor:
    """Each flow's row of a rung-indexed ladder table: table[rung], or on
    a grid's per-cell tables (`ladder_k` 2-D) its own cell's row."""
    if rel.ladder_k.dim() == 1:
        return table[rung]
    idx = rung.reshape(rel.ladder_k.shape[0], -1).long()
    if table.dim() == 3:
        idx = idx[..., None].expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, idx).reshape((-1,) + table.shape[2:])


def _effective_geometry(rel: RelParams, st: Optional[RelState]):
    """(ec_k, ec_r, coef) with each adapting flow's ladder rung folded in."""
    ec_k, ec_r, coef = rel.ec_k, rel.ec_r, rel.coef
    if st is not None and rel.ladder_k is not None:
        on = rel.adapt_on
        ec_k = torch.where(on, _rung(rel, rel.ladder_k, st.rung), ec_k)
        ec_r = torch.where(on, _rung(rel, rel.ladder_r, st.rung), ec_r)
        coef = torch.where(on[:, None],
                           _rung(rel, rel.ladder_coef, st.rung), coef)
    return ec_k, ec_r, coef


def effective_eff(rel: RelParams, st: Optional[RelState]) -> torch.Tensor:
    """Current goodput efficiency k/(k+r), ladder rung folded in."""
    if st is None or rel.ladder_eff is None:
        return rel.ec_eff
    return torch.where(rel.adapt_on, _rung(rel, rel.ladder_eff, st.rung),
                       rel.ec_eff)


def recovery_split(rel: RelParams, q: torch.Tensor,
                   st: Optional[RelState] = None):
    """(recovered_frac, nack_frac) of a flow's wire bytes at loss prob `q`:
    expected data bytes per wire byte decoded from parity / bound for the
    NACK path.  They sum to q k/n, are exactly 0.0 at q == 0, and are
    (0, 0) on disabled flows.  `st` evaluates at the current rung."""
    ec_k, ec_r, coef = _effective_geometry(rel, st)
    q = torch.clamp(q, 0.0, 1.0)[:, None]
    n = (ec_k + ec_r)[:, None]
    i = torch.arange(MAX_R + 1, dtype=torch.float32, device=q.device)[None, :]
    # q^i and (1-q)^(n-i) by pow keep the q == 0 column exactly
    # {1, 0, 0, ...}; the exponent clamp guards the masked i > n columns
    p_i = coef * torch.pow(q, i) * \
        torch.pow(1.0 - q, torch.clamp(n - i, min=0.0))
    rec_window = torch.sum(i * p_i, dim=1)        # E[X 1(X <= r)]
    q1, n1 = q[:, 0], n[:, 0]
    nack_window = torch.clamp(n1 * q1 - rec_window, min=0.0)
    scale = torch.where(rel.enabled, ec_k / torch.clamp(n1 * n1, min=1.0),
                        0.0)
    return rec_window * scale, nack_window * scale


def rtx_rate(rel: RelParams, st: RelState, rate: torch.Tensor,
             rtt: torch.Tensor) -> torch.Tensor:
    """Retransmit send rate (bytes/ns) from the NACK backlog: one backlog
    per RTT, capped at `rtx_cap` times the CC rate; exactly 0.0 while the
    backlog is empty."""
    return torch.minimum(st.backlog / torch.clamp(rtt, min=1.0),
                         rel.rtx_cap * rate)


def rel_epoch(rel: RelParams, st: RelState, rate: torch.Tensor,
              rtx: torch.Tensor, wire: torch.Tensor, loss_frac: torch.Tensor,
              dt, rtt: torch.Tensor):
    """One epoch of the recovery machine.

    `rate` is the CC send rate, `rtx` this epoch's retransmit rate (from
    the carried backlog, before the link step), `wire = rate + rtx`,
    `loss_frac` the flow's composed drop fraction.  Returns (RelState',
    cut, recovered_rate): `cut` the loss_md window-cut mask (a NACK fired
    and at least one flow RTT since the last cut), `recovered_rate` the
    parity-recovered data rate credited to goodput.
    """
    g = torch.clamp(dt / rtt, max=1.0)
    q = torch.clamp(loss_frac, 0.0, 1.0)
    rec_frac, nack_frac = recovery_split(rel, q, st)
    recovered_rate = rate * rec_frac
    # fresh unrecoverable losses plus lost retransmits enter the NACK path
    lost_new = rate * nack_frac * dt + rtx * q * dt
    pending = st.pending + lost_new

    tick = st.ack_cd <= 1
    fire = tick & (st.hold <= 0) & (pending >= rel.nack_quantum) \
        & rel.enabled
    backlog = torch.clamp(st.backlog - rtx * dt, min=0.0) + \
        torch.where(fire, pending, 0.0)
    pending = torch.where(fire, 0.0, pending)
    hold = torch.where(fire, rel.nack_hold,
                       torch.clamp(st.hold - 1, min=0))
    ack_cd = torch.where(tick, rel.nack_period, st.ack_cd - 1)
    # one multiplicative cut per RTT, however many NACK batches fire
    cut = fire & (st.md_cd <= 0.0)
    md_cd = torch.where(cut, rtt, torch.clamp(st.md_cd - dt, min=0.0))

    if rel.ladder_k is None:
        rung, loss_ewma, adapt_cd = st.rung, st.loss_ewma, st.adapt_cd
    else:
        n_rungs = rel.ladder_k.shape[-1]
        loss_ewma = st.loss_ewma + \
            torch.clamp(dt / rtt, max=1.0) * (q - st.loss_ewma)
        cd = torch.clamp(st.adapt_cd - dt, min=0.0)
        can = rel.adapt_on & rel.enabled & (cd <= 0.0)
        step_up = can & (loss_ewma > _rung(rel, rel.ladder_up, st.rung)) \
            & (st.rung < n_rungs - 1)
        step_dn = can & (loss_ewma < _rung(rel, rel.ladder_down, st.rung)) \
            & (st.rung > 0)
        rung = st.rung + step_up.to(torch.int32) \
            - step_dn.to(torch.int32)
        adapt_cd = torch.where(step_up | step_dn, rtt, cd)

    # latency estimate: parity recovery within ~1 block RTT; NACKed data
    # waits half a batch period + holdoff, then a retransmit round trip
    lat_nack = 1.5 * rtt + 0.5 * (rel.nack_period + rel.nack_hold) * dt
    vol = recovered_rate + rtx
    inst_lat = (recovered_rate * rtt + rtx * lat_nack) / \
        torch.clamp(vol, min=_EPS)
    lat_ewma = torch.where(vol > 0.0,
                           st.lat_ewma + g * (inst_lat - st.lat_ewma),
                           st.lat_ewma)
    new = RelState(
        pending=pending, backlog=backlog, ack_cd=ack_cd, hold=hold,
        md_cd=md_cd,
        rtx_ewma=st.rtx_ewma + g * (rtx - st.rtx_ewma),
        lat_ewma=lat_ewma,
        nacks=st.nacks + fire.to(torch.float32),
        rec_bytes=st.rec_bytes + recovered_rate * dt,
        rtx_bytes=st.rtx_bytes + rtx * dt,
        wire_bytes=st.wire_bytes + wire * dt,
        lost_bytes=st.lost_bytes + wire * q * dt,
        rung=rung, loss_ewma=loss_ewma, adapt_cd=adapt_cd)
    return new, cut, recovered_rate


def rel_step(rel: RelParams, st: RelState, rate: torch.Tensor,
             rtx: torch.Tensor, split: torch.Tensor, sub_loss: torch.Tensor,
             sc: torch.Tensor, dt, rtt: torch.Tensor, *, plain: bool = False):
    """The receive half's reliability phase in one call: the flow's loss
    fraction (`sub_loss` split-weighted over its paths), `rel_epoch` on
    the wire `rate + rtx`, and the goodput of that wire at the delivered
    scale `sc` split by EC at the flow's current rung (delivered payload,
    retransmitted data without parity, parity-recovered data).  Returns
    (RelState', cut, goodput).  The goodput the congestion control acks,
    `(rate + rtx) * sc`, is the caller's, before the split.

    The hand-written kernel (`fleet_cuda.rel_epoch`, one launch) runs it
    unless `plain`, which runs `rel_step_plain`, the same composition in
    torch operations; on CPU tensors the kernel's wrapper runs that too.
    On the card the two agree bit for bit.  Neither writes into `st`.
    A step that runs it every epoch takes it from `make_rel_step`."""
    return make_rel_step(rel, plain=plain)(st, rate, rtx, split, sub_loss,
                                           sc, dt, rtt)


def make_rel_step(rel: RelParams, *, plain: bool = False):
    """`rel_step` with `rel` bound: a function of (st, rate, rtx, split,
    sub_loss, sc, dt, rtt).  The kernel's form checks `rel` and packs it
    once, here (`fleet_cuda.RelEpoch`)."""
    if plain:
        return functools.partial(rel_step_plain, rel)
    return fleet_cuda.RelEpoch(rel)


def rel_step_plain(rel: RelParams, st: RelState, rate: torch.Tensor,
                   rtx: torch.Tensor, split: torch.Tensor,
                   sub_loss: torch.Tensor, sc: torch.Tensor, dt,
                   rtt: torch.Tensor):
    """`rel_step` in torch operations: `rel_epoch`, `effective_eff` and
    the goodput split, as the epoch step composed them."""
    wire = rate + rtx
    lf = split[:, 0] * sub_loss[:, 0] if split.shape[1] == 1 else \
        torch.sum(split * sub_loss, dim=1)
    new, cut, recovered = rel_epoch(rel, st, rate, rtx, wire, lf, dt, rtt)
    eff = effective_eff(rel, st)
    goodput = wire * sc * eff + rtx * sc * (1.0 - eff) + recovered
    return new, cut, goodput
