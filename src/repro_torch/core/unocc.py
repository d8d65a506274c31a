"""UnoCC control constants and the Algorithm-1 MD arithmetic.

The port's own copy of the shared formulas in ``repro.core.unocc``: every
expression is plain +-*/ on its inputs, and the only order comparisons are
injected through ``minimum``/``maximum`` so the fleet model passes
``torch.minimum``/``torch.maximum`` for (n_flows,) tensors.  `UnoCC` is the
scalar per-flow state machine of Algorithm 1, fed per-ACK events; the
host-side chunk-window scheduler (`core.window_scheduler`) drives it.  It
is plain Python floats in the reference's arithmetic order, so a replayed
event trace gives bitwise the reference's state.
"""
from __future__ import annotations

import dataclasses


def derived_params(bdp, intra_bdp, intra_rtt, *, alpha_frac=0.001,
                   k_frac=1.0 / 7.0, epoch_period_frac=1.0):
    """(alpha, K, epoch_period) from the three path quantities (§4.1.1).

    alpha = alpha_frac * BDP        — AI step per clean RTT
    K     = k_frac * intra-DC BDP   — MD gain knee
    epoch = frac * intra-DC RTT     — ONE granularity for all flows
    """
    return alpha_frac * bdp, k_frac * intra_bdp, epoch_period_frac * intra_rtt


def md_ecn_gain(k_md, bdp):
    """BDP-compensating MD gain 4K/(K+BDP)."""
    return 4.0 * k_md / (k_md + bdp)


def md_factor(ecn_ewma, md_scale, k_md, bdp, md_cap, *, minimum=min):
    """Per-epoch multiplicative-decrease factor on cwnd (Alg 1 l.13),
    capped at md_cap."""
    return 1.0 - minimum(ecn_ewma * md_ecn_gain(k_md, bdp) * md_scale, md_cap)


def gentle_md_scale(md_scale, gentle_scale, gentle_floor, *, maximum=max):
    """Consecutive phantom-only epochs compound the gentle scaling,
    floored so it cannot decay to zero."""
    return maximum(md_scale * gentle_scale, gentle_floor)


@dataclasses.dataclass
class UnoParams:
    """UnoCC knobs; the fleet model reads the defaults of the fractions."""
    bdp: float                      # this flow's path BDP (bytes)
    intra_bdp: float                # intra-DC BDP (bytes) — sets K
    intra_rtt: float                # intra-DC base RTT (ns) — sets epoch
    mtu: int = 4096
    alpha_frac: float = 0.001       # AI factor: alpha = alpha_frac * BDP
    beta: float = 0.5               # QA ratio
    k_frac: float = 1.0 / 7.0       # K = k_frac * intra-DC BDP
    ewma_g: float = 0.2             # EWMA gain for the ECN fraction E
    delay_thresh_frac: float = 0.25 # "delay == 0" if rel delay < frac*rtt
    epoch_period_frac: float = 1.0  # epoch_period = frac * intra_rtt
    gentle_scale: float = 0.3
    gentle_floor: float = 0.09      # floor of the consecutive-epoch decay
    md_cap: float = 0.5             # per-epoch max multiplicative decrease
    cwnd0: float = 0.0              # initial cwnd (0 -> BDP)
    max_cwnd_bdps: float = 1.5      # cwnd cap in BDPs

    @property
    def alpha(self) -> float:
        return self.alpha_frac * self.bdp

    @property
    def k_md(self) -> float:
        return self.k_frac * self.intra_bdp

    @property
    def epoch_period(self) -> float:
        return self.epoch_period_frac * self.intra_rtt


class UnoCC:
    """Per-flow UnoCC sender state (Algorithm 1)."""

    name = "unocc"

    def __init__(self, p: UnoParams):
        self.p = p
        self.cwnd = p.cwnd0 if p.cwnd0 > 0 else p.bdp
        self.min_cwnd = float(p.mtu)
        self.max_cwnd = p.max_cwnd_bdps * p.bdp
        self.pacing_rate = None          # window-based (pacing left to NIC)
        self.rtt_base = float("inf")
        self.rtt_est = 0.0
        # epoch state
        self._t_epoch = None             # activation time (None until 1st ACK)
        self._ep_acked = 0.0
        self._ep_marked = 0.0
        self._ep_min_delay = float("inf")
        self._ecn_ewma = 0.0             # E
        self._md_scale = 1.0
        self._clean_epochs = 0
        self._fi_active = False
        self._fi_ceiling = self.max_cwnd
        # QA state
        self._qa_acked = 0.0
        self._qa_prev_acked = 0.0
        self._qa_deficits = 0
        self._qa_last_tick = None
        self._skip_until = -1.0          # no MD/QA before this time
        # counters (observability)
        self.n_md = 0
        self.n_qa = 0
        self.n_epochs = 0

    # ---------------------------------------------------------------- events

    def on_ack(self, bytes_acked: float, ecn: bool, rtt: float,
               send_time: float, now: float) -> None:
        p = self.p
        if rtt > 0:
            if rtt < self.rtt_base:
                self.rtt_base = rtt
            self.rtt_est = rtt if self.rtt_est == 0 else \
                0.875 * self.rtt_est + 0.125 * rtt

        # --- OnAck: additive increase on unmarked ACKs (Alg 1 l.2-4).
        # Fast increase (SMaRTT-lineage; DESIGN.md §2): after >= 3 fully
        # clean epochs while below BDP, grow exponentially until the first
        # mark — pure alpha-AI recovery from a deep QA collapse would take
        # O(BDP/alpha) = ~1000 RTTs.
        if not ecn:
            inc = p.alpha * bytes_acked / self.cwnd
            if self._fi_active:
                inc = max(inc, float(bytes_acked))
            self.cwnd = min(self.cwnd + inc, self.max_cwnd)
        elif self._fi_active:
            self._fi_active = False
            self._clean_epochs = 0

        # --- epoch bookkeeping
        self._ep_acked += bytes_acked
        if ecn:
            self._ep_marked += bytes_acked
        if rtt > 0 and self.rtt_base < float("inf"):
            delay = rtt - self.rtt_base
            if delay < self._ep_min_delay:
                self._ep_min_delay = delay
        if self._t_epoch is None:
            self._t_epoch = now          # first ACK activates the epoch
        elif send_time >= self._t_epoch:
            self._end_epoch(now)
        self._qa_acked += bytes_acked

    def on_loss_signal(self, now: float) -> None:
        """RTO/NACK: treat as a fully-marked epoch (conservative MD)."""
        if now >= self._skip_until:
            self.cwnd = max(self.cwnd * (1.0 - self.p.md_cap), self.min_cwnd)

    # ---------------------------------------------------------------- phases

    def _end_epoch(self, now: float) -> None:
        p = self.p
        self.n_epochs += 1
        frac = self._ep_marked / self._ep_acked if self._ep_acked else 0.0
        self._ecn_ewma = (1 - p.ewma_g) * self._ecn_ewma + p.ewma_g * frac
        if frac > 0.0 and now >= self._skip_until:      # OnEpoch (Alg 1 l.7-15)
            if self._ep_min_delay < p.delay_thresh_frac * p.intra_rtt:
                # congestion only visible in phantom queues -> gentle
                # reduction; the 0.3x compounding applies across CONSECUTIVE
                # phantom-only epochs and is floored — compounding to zero
                # would let cwnd grow until physical queues fill, defeating
                # the phantom (deviation recorded in DESIGN.md)
                self._md_scale = gentle_md_scale(self._md_scale,
                                                 p.gentle_scale,
                                                 p.gentle_floor)
            else:
                self._md_scale = 1.0
            factor = md_factor(self._ecn_ewma, self._md_scale, p.k_md, p.bdp,
                               p.md_cap)
            self.cwnd = max(self.cwnd * factor, self.min_cwnd)
            self.n_md += 1
        elif frac == 0.0:
            self._md_scale = 1.0        # clean epoch ends the gentle streak
            self._clean_epochs += 1
            # FI engages only well below the last cwnd that saw congestion:
            # re-probing right at the old ceiling just oscillates against
            # the phantom marks (fig 4 regression caught by benchmarks).
            if (self._clean_epochs >= 3
                    and self.cwnd < 0.7 * self._fi_ceiling):
                self._fi_active = True
        if frac > 0.0:
            self._clean_epochs = 0
            self._fi_active = False
            self._fi_ceiling = max(self.cwnd, 4.0 * self.min_cwnd)
        # Re-activate: T_epoch advances BY epoch_period (paper §4.1.1), not
        # to `now` — for long-RTT flows T_epoch then trails the send stream,
        # so every in-flight ACK can terminate the next epoch and epochs
        # tick once per (intra-RTT-derived) period for inter- and intra-DC
        # flows alike.  That equal granularity IS the fairness mechanism.
        self._t_epoch += p.epoch_period
        # Legitimate trailing is ~one flow RTT (ACKs answer packets sent an
        # RTT ago); only clamp backlog beyond that (idle gaps), or the
        # trailing-T_epoch cadence breaks for long-RTT flows.
        limit = (self.rtt_est or p.intra_rtt) + 64 * p.epoch_period
        if now - self._t_epoch > limit:
            self._t_epoch = now - limit
        self._ep_acked = self._ep_marked = 0.0
        self._ep_min_delay = float("inf")

    def on_qa_tick(self, now: float, inflight: float = 0.0) -> bool:
        """Once-per-RTT Quick-Adapt evaluation (Alg 1 OnQA, l.18-22).

        Driven by a TIMER, not by ACK arrival — under extreme congestion the
        ACK stream can dry up entirely, which is exactly when QA must fire.
        Returns True when QA triggered (the transport then treats the stale
        in-flight data as lost and reprobes at the collapsed window).

        Two guards against misfires the byte-granular hardware version never
        sees: (1) the window must actually have been exercised this RTT
        (inflight + acked >= beta*cwnd) — otherwise an application-limited or
        refilling pipe looks like a blackout; (2) cwnd must be >= 4 MTU —
        below that, per-packet ACK quantization makes `acked < beta*cwnd`
        pure noise (RTO owns that regime).
        """
        p = self.p
        triggered = False
        rtt_ref = self.rtt_est or p.intra_rtt
        # scale the expectation by the actual window length (ticks drift)
        w = now - self._qa_last_tick if self._qa_last_tick is not None else rtt_ref
        w_frac = min(max(w / rtt_ref, 0.5), 1.5)
        used = inflight + self._qa_acked >= p.beta * self.cwnd
        deficit = (used and self.cwnd >= 4 * p.mtu
                   and self._qa_acked < self.cwnd * p.beta * w_frac)
        if deficit and self._qa_deficits >= 1 and now >= self._skip_until:
            # two consecutive deficient windows (one can be ACK-clumping
            # aliasing): extremely congested — collapse to the measured
            # instantaneous capacity
            self.cwnd = max(self._qa_acked, self._qa_prev_acked, self.min_cwnd)
            self.n_qa += 1
            # skip MD/QA while the collapsed window refills (1 RTT) and its
            # ACKs return (1 more RTT) — the paper's "skip one RTT" assumes
            # in-flight data survives; ours was reclaimed as lost.
            self._skip_until = now + 2.0 * rtt_ref
            self._qa_deficits = 0
            triggered = True
        else:
            self._qa_deficits = self._qa_deficits + 1 if deficit else 0
        self._qa_prev_acked = self._qa_acked
        self._qa_acked = 0.0
        self._qa_last_tick = now
        return triggered
