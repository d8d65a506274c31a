"""Host-side AIMD/QA window scheduler for cross-pod chunk streams.

The same UnoCC control law (`core.unocc.UnoCC`), re-used one level up: the
"packets" are DCI gradient chunks, the "cwnd" is the in-flight chunk byte
budget, and the congestion signals come from measured chunk latencies:

  ECN analogue     : chunk latency above 1.25x the EWMA baseline — the
                     phantom-queue idea (signal *early*, before the DCI hop
                     stalls the step) applied to the only telemetry a host
                     sees;
  delay==0 analogue: latency inflation without queue growth on the pod link
                     (baseline drift) -> gentle MD;
  Quick Adapt      : a sharp drop in completed chunks per window (pod
                     straggler, DCI flap) collapses the window and triggers
                     a subflow re-route — Algorithm 2's onNackOrTimeout at
                     chunk granularity (the runtime rotates the collective
                     channel assignment at the next step boundary).

Synchronous note: inside one training step the chunk schedule is static;
this controller adapts *across* steps (choose `uno_chunks` / in-flight depth
for step N+1 from step N's telemetry).  In an async runtime it would run in
the dispatch loop; the control law is identical.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.unocc import UnoCC, UnoParams


@dataclasses.dataclass
class SchedulerConfig:
    chunk_bytes: float              # payload bytes per chunk
    dci_bandwidth: float = 25e9     # bytes/s across the pod hop
    base_latency_s: float = 2e-3    # DCI base RTT
    min_chunks: int = 1
    max_chunks: int = 64
    ecn_ratio: float = 1.25         # latency/EWMA ratio treated as "marked"


class ChunkWindowScheduler:
    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        bdp = cfg.dci_bandwidth * cfg.base_latency_s
        self.cc = UnoCC(UnoParams(
            bdp=bdp, intra_bdp=bdp / 128.0, intra_rtt=cfg.base_latency_s,
            mtu=int(cfg.chunk_bytes), alpha_frac=0.01,
            cwnd0=min(bdp, cfg.max_chunks * cfg.chunk_bytes)))
        self._lat_ewma = None
        self._t = 0.0
        self.n_reroutes = 0
        self.window_log: list[dict] = []

    @property
    def n_chunks(self) -> int:
        c = int(self.cc.cwnd // self.cfg.chunk_bytes)
        return max(self.cfg.min_chunks, min(self.cfg.max_chunks, c))

    def on_step(self, chunk_latencies_s: list[float]) -> dict:
        """Feed one training step's per-chunk DCI latencies; returns the
        schedule decision for the next step."""
        cfg = self.cfg
        completed = 0
        for lat in chunk_latencies_s:
            if lat is None:                      # chunk never completed
                continue
            completed += 1
            if self._lat_ewma is None:
                self._lat_ewma = lat
            marked = lat > cfg.ecn_ratio * self._lat_ewma
            self._lat_ewma = 0.9 * self._lat_ewma + 0.1 * lat
            self._t += lat
            self.cc.on_ack(bytes_acked=cfg.chunk_bytes, ecn=marked,
                           rtt=lat, send_time=self._t - lat, now=self._t)
        # QA window per step: straggler/flap detection.  The effective
        # window cannot exceed what the step actually offered — otherwise a
        # BDP-sized cwnd makes every step look idle and QA's "pipe was
        # exercised" guard never engages.
        inflight = cfg.chunk_bytes * len(chunk_latencies_s)
        self.cc.cwnd = min(self.cc.cwnd, 2.0 * max(inflight, cfg.chunk_bytes))
        self._t += cfg.base_latency_s
        qa = self.cc.on_qa_tick(self._t, inflight=inflight)
        reroute = qa or completed < len(chunk_latencies_s)
        if reroute:
            self.n_reroutes += 1
        decision = {"n_chunks": self.n_chunks, "reroute": reroute,
                    "cwnd_bytes": self.cc.cwnd, "qa": qa,
                    "lat_ewma_s": self._lat_ewma}
        self.window_log.append(decision)
        return decision
