"""Baseline congestion controllers with the same event interface as UnoCC:
the port's copy of ``repro.core.baselines`` (plain Python floats in the
reference's order of arithmetic, so a replayed event trace gives bitwise
the reference's state).

  Gemini   — ICNP'19 cross-DC CC: ECN (DCTCP-style EWMA) for intra-DC
             congestion + delay target for the WAN part, window reductions at
             most once per the flow's OWN RTT (the granularity mismatch the
             paper identifies as the cause of slow convergence), AI factor
             identical to UnoCC's so that the comparison isolates granularity.
  MPRDMA   — NSDI'18 multi-path RDMA transport, intra-DC: per-ACK DCTCP-like
             reaction (+1 MSS/RTT AI, halve-fraction on marked ACKs).
  BBRLite  — model-based WAN CC: windowed-max delivery-rate estimate, pacing
             at gain cycles around the estimated bottleneck bandwidth,
             cwnd = 2 * BDP_est.  (BBRv1 control loop, simplified but keeps
             the ProbeBW gain cycling and RTprop tracking that produce BBR's
             characteristic behavior vs loss/queues.)

All times ns, sizes bytes (matches repro_torch.core.unocc and
repro_torch.netsim).
"""
from __future__ import annotations

import dataclasses


# --------------------------------------------------------------------- Gemini

@dataclasses.dataclass
class GeminiParams:
    bdp: float                    # flow path BDP (bytes)
    intra_bdp: float
    intra_rtt: float
    is_inter: bool                # crosses the WAN?
    mtu: int = 4096
    alpha_frac: float = 0.001     # same AI factor as UnoCC (paper §4.1.1)
    k_frac: float = 1.0 / 7.0
    ewma_g: float = 0.2
    delay_target_frac: float = 0.5   # WAN congestion if rel-delay > frac*intra_rtt
    md_cap: float = 0.5
    cwnd0: float = 0.0
    max_cwnd_bdps: float = 1.5


class Gemini:
    """Gemini control loop: per-own-RTT window adjustment.

    Intra-DC flows: DCTCP — EWMA alpha of marked fraction, cwnd *= 1-a/2 on
    congested windows.  Inter-DC flows: ECN for the DCN segment plus an
    RTT-above-target signal for the WAN segment; both applied once per (long)
    inter-DC RTT.  AI mirrors UnoCC so fairness *eventually* converges — the
    experiment shows how slowly (paper Fig 3B).
    """

    name = "gemini"

    def __init__(self, p: GeminiParams):
        self.p = p
        # Gemini is a kernel-TCP derivative: slow-start from IW10, not a
        # NIC-paced line-rate start (that asymmetry vs Uno is real: Uno
        # assumes hardware pacing, §6 "Hardware implementation")
        self.cwnd = p.cwnd0 if p.cwnd0 > 0 else 10.0 * p.mtu
        self._in_slow_start = p.cwnd0 <= 0
        self.min_cwnd = float(p.mtu)
        self.max_cwnd = p.max_cwnd_bdps * p.bdp
        self.pacing_rate = None
        self.rtt_base = float("inf")
        self.rtt_est = 0.0
        self._t_epoch = None          # per-own-RTT window bookkeeping
        self._ep_acked = 0.0
        self._ep_marked = 0.0
        self._ep_max_delay = 0.0
        self._ecn_ewma = 0.0
        self.n_md = 0

    def on_ack(self, bytes_acked, ecn, rtt, send_time, now):
        p = self.p
        if rtt > 0:
            self.rtt_base = min(self.rtt_base, rtt)
            self.rtt_est = rtt if self.rtt_est == 0 else \
                0.875 * self.rtt_est + 0.125 * rtt
        if self._in_slow_start:
            if ecn:
                self._in_slow_start = False
            else:
                self.cwnd = min(self.cwnd + bytes_acked, self.max_cwnd)
        elif not ecn:
            self.cwnd = min(self.cwnd + p.alpha_frac * p.bdp * bytes_acked
                            / self.cwnd, self.max_cwnd)
        self._ep_acked += bytes_acked
        if ecn:
            self._ep_marked += bytes_acked
        if rtt > 0 and self.rtt_base < float("inf"):
            self._ep_max_delay = max(self._ep_max_delay, rtt - self.rtt_base)
        if self._t_epoch is None:
            self._t_epoch = now
        elif send_time >= self._t_epoch:
            self._end_window(now)

    def _end_window(self, now):
        """Gemini reacts at most once per its OWN RTT — the granularity gap."""
        p = self.p
        frac = self._ep_marked / self._ep_acked if self._ep_acked else 0.0
        self._ecn_ewma = (1 - p.ewma_g) * self._ecn_ewma + p.ewma_g * frac
        congested = frac > 0.0
        wan_congested = (p.is_inter and
                         self._ep_max_delay > p.delay_target_frac * p.intra_rtt
                         + (self.rtt_base - p.intra_rtt if p.is_inter else 0.0) * 0.0)
        md = 0.0
        if congested:
            # Gemini scales MD like UnoCC (factors chosen identically, §4.1.1)
            k = p.k_frac * p.intra_bdp
            md = self._ecn_ewma * (4.0 * k / (k + p.bdp))
        if wan_congested:
            md = max(md, 0.5 * min(self._ep_max_delay /
                                   max(self.rtt_base, 1.0), 1.0))
        if md > 0.0:
            self.cwnd = max(self.cwnd * (1.0 - min(md, p.md_cap)),
                            self.min_cwnd)
            self.n_md += 1
        # next reaction one OWN-RTT later: epoch period = flow RTT
        self._t_epoch = now + (self.rtt_est or p.intra_rtt)
        self._ep_acked = self._ep_marked = 0.0
        self._ep_max_delay = 0.0

    def on_loss_signal(self, now):
        self.cwnd = max(self.cwnd * 0.5, self.min_cwnd)


# -------------------------------------------------------------------- MPRDMA

class MPRDMA:
    """MPRDMA's per-ACK ECN control (NSDI'18): DCTCP-like but reacting at ACK
    granularity — AI of one MSS per RTT on unmarked ACKs, a half-MSS decrease
    per marked ACK (fraction-proportional overall)."""

    name = "mprdma"

    def __init__(self, bdp: float, mtu: int = 4096, cwnd0: float = 0.0):
        self.bdp = bdp
        self.mtu = mtu
        self.cwnd = cwnd0 if cwnd0 > 0 else bdp
        self.min_cwnd = float(mtu)
        self.max_cwnd = 1.5 * bdp
        self.pacing_rate = None
        self.rtt_base = float("inf")
        self.rtt_est = 0.0

    def on_ack(self, bytes_acked, ecn, rtt, send_time, now):
        if rtt > 0:
            self.rtt_base = min(self.rtt_base, rtt)
            self.rtt_est = rtt if self.rtt_est == 0 else \
                0.875 * self.rtt_est + 0.125 * rtt
        if ecn:
            self.cwnd = max(self.cwnd - 0.5 * bytes_acked, self.min_cwnd)
        else:
            self.cwnd = min(self.cwnd + self.mtu * bytes_acked / self.cwnd,
                            self.max_cwnd)

    def on_loss_signal(self, now):
        self.cwnd = max(self.cwnd * 0.5, self.min_cwnd)


# -------------------------------------------------------------------- BBRLite

class BBRLite:
    """Simplified BBRv1: windowed-max bandwidth filter, min-RTT filter,
    ProbeBW pacing-gain cycle, cwnd = cwnd_gain * BDP_est.

    Delivery-rate samples come from ACK arrivals: rate = bytes_acked over the
    inter-ACK interval, filtered by a windowed max (10 RTT).  STARTUP doubles
    until the bandwidth estimate plateaus, then DRAIN, then ProbeBW cycles
    [1.25, 0.75, 1 x6].
    """

    name = "bbr"
    GAIN_CYCLE = (1.25, 0.75, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)

    def __init__(self, bdp: float, mtu: int = 4096, cwnd0: float = 0.0):
        self.bdp = bdp
        self.mtu = mtu
        # TCP-style STARTUP from IW10 (BBR doubles per RTT until the
        # bandwidth filter plateaus)
        self.cwnd = cwnd0 if cwnd0 > 0 else 10.0 * mtu
        self.min_cwnd = 4.0 * mtu
        self.pacing_rate = None          # set after first RTT sample
        self.rtt_base = float("inf")
        self.rtt_est = 0.0
        self._bw_samples: list = []      # (t, rate)
        self._bw_max = 0.0
        self._last_ack_t = None
        self._acked_since = 0.0
        self._mode = "startup"
        self._full_bw = 0.0
        self._full_bw_cnt = 0
        self._cycle_i = 0
        self._cycle_t = 0.0

    def _update_bw(self, rate, now):
        self._bw_samples.append((now, rate))
        win = 10 * (self.rtt_est or 1.0)
        self._bw_samples = [(t, r) for (t, r) in self._bw_samples
                            if now - t <= win]
        self._bw_max = max(r for _, r in self._bw_samples)

    def on_ack(self, bytes_acked, ecn, rtt, send_time, now):
        if rtt > 0:
            self.rtt_base = min(self.rtt_base, rtt)
            self.rtt_est = rtt if self.rtt_est == 0 else \
                0.875 * self.rtt_est + 0.125 * rtt
        if self._last_ack_t is not None and now > self._last_ack_t:
            self._acked_since += bytes_acked
            dt = now - self._last_ack_t
            if dt > 0.02 * (self.rtt_est or 1.0):
                self._update_bw(self._acked_since / dt, now)
                self._acked_since = 0.0
                self._last_ack_t = now
        else:
            self._last_ack_t = now

        if self._bw_max <= 0 or self.rtt_base == float("inf"):
            self.cwnd = min(self.cwnd + bytes_acked, 2 * self.bdp)  # slow start
            return
        bdp_est = self._bw_max * self.rtt_base

        if self._mode == "startup":
            self.cwnd = min(self.cwnd + bytes_acked, 3 * bdp_est)
            self.pacing_rate = 2.77 * self._bw_max
            if self._bw_max > 1.25 * self._full_bw:
                self._full_bw = self._bw_max
                self._full_bw_cnt = 0
            else:
                self._full_bw_cnt += 1
                if self._full_bw_cnt >= 3:
                    self._mode = "drain"
        elif self._mode == "drain":
            self.pacing_rate = self._bw_max / 2.77
            self.cwnd = 2.0 * bdp_est
            self._mode = "probe_bw"
            self._cycle_t = now
        else:  # probe_bw
            if now - self._cycle_t > (self.rtt_est or 1.0):
                self._cycle_i = (self._cycle_i + 1) % len(self.GAIN_CYCLE)
                self._cycle_t = now
            gain = self.GAIN_CYCLE[self._cycle_i]
            self.pacing_rate = gain * self._bw_max
            self.cwnd = max(2.0 * bdp_est, self.min_cwnd)

    def on_loss_signal(self, now):
        pass  # BBR ignores individual losses by design


# ------------------------------------------------------------------- factory

def make_cc(scheme: str, *, bdp: float, intra_bdp: float, intra_rtt: float,
            is_inter: bool, mtu: int = 4096, **kw):
    """Build the per-flow CC for `scheme`.

    'uno'         -> UnoCC everywhere (the paper)
    'gemini'      -> Gemini everywhere
    'mprdma+bbr'  -> BBR on inter-DC flows, MPRDMA on intra-DC flows
    """
    from repro_torch.core.unocc import UnoCC, UnoParams
    if scheme == "uno":
        return UnoCC(UnoParams(bdp=bdp, intra_bdp=intra_bdp,
                               intra_rtt=intra_rtt, mtu=mtu, **kw))
    if scheme == "gemini":
        return Gemini(GeminiParams(bdp=bdp, intra_bdp=intra_bdp,
                                   intra_rtt=intra_rtt, is_inter=is_inter,
                                   mtu=mtu))
    if scheme == "mprdma+bbr":
        return BBRLite(bdp, mtu) if is_inter else MPRDMA(bdp, mtu)
    if scheme == "mprdma":
        return MPRDMA(bdp, mtu)
    if scheme == "bbr":
        return BBRLite(bdp, mtu)
    raise ValueError(f"unknown CC scheme {scheme!r}")
