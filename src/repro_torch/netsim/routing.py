"""Per-flow routing / load-balancing modules.

`path_for(pkt_idx, block) -> (path, subflow_id)` picks the directed-link path
for the next packet.  Routers also receive ACK / NACK-or-timeout feedback.

  ECMP   — one hashed path per flow, forever (collision-prone baseline).
  RPS    — uniform random path per packet (packet spraying).
  PLB    — one path at a time; repath after K consecutive congested rounds
           (ECN-fraction per round >= thresh), as in PLB (SIGCOMM'22).
  UnoLB  — Algorithm 2: n subflows, each pinned to its own path; packets
           round-robin across subflows (so each EC block is spread over all
           subflows); on NACK/timeout, re-route — rate-limited to once per
           base RTT — onto a fresh path, biased to paths of subflows that
           received ACKs recently (avoid re-picking failed/congested paths).
"""
from __future__ import annotations

import random
from typing import Sequence


def fmix32(h: int) -> int:
    """MurmurHash3 finalizer: deterministic 32-bit avalanche mix.  Unlike
    Python's `hash`, this is independent of PYTHONHASHSEED, so ECMP
    collision patterns reproduce across runs."""
    h &= 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


class EcmpRouter:
    name = "ecmp"

    def __init__(self, paths: Sequence, flow_id: int, rng=None):
        self.path = paths[fmix32(flow_id ^ 0x9E3779B9) % len(paths)]

    def path_for(self, pkt_idx, block):
        return self.path, 0

    def on_ack(self, subflow, now):
        pass

    def on_nack_or_timeout(self, now):
        pass  # ECMP is failure-oblivious (paper §5.2.3 excludes it for that)


class RpsRouter:
    name = "rps"

    def __init__(self, paths: Sequence, flow_id: int, rng=None):
        self.paths = paths
        self.rng = rng or random.Random(flow_id)

    def path_for(self, pkt_idx, block):
        i = self.rng.randrange(len(self.paths))
        return self.paths[i], i

    def on_ack(self, subflow, now):
        pass

    def on_nack_or_timeout(self, now):
        pass


class PlbRouter:
    """Protective Load Balancing: repath when consecutive rounds look congested.

    The flow feeds per-ACK ECN via on_ecn_sample (wired by the workload
    generator); a "round" closes once per base RTT.
    """

    name = "plb"
    K_ROUNDS = 3
    ECN_THRESH = 0.5

    def __init__(self, paths: Sequence, flow_id: int, rng=None,
                 base_rtt: float = 0.0):
        self.paths = paths
        self.rng = rng or random.Random(flow_id ^ 0x5bd1e995)
        self.idx = self.rng.randrange(len(paths))
        self.base_rtt = base_rtt
        self._round_start = 0.0
        self._acked = 0
        self._marked = 0
        self._bad_rounds = 0

    def path_for(self, pkt_idx, block):
        return self.paths[self.idx], self.idx

    def on_ecn_sample(self, ecn: bool, now: float):
        self._acked += 1
        self._marked += int(ecn)
        if now - self._round_start >= max(self.base_rtt, 1.0):
            frac = self._marked / self._acked if self._acked else 0.0
            self._bad_rounds = self._bad_rounds + 1 if frac >= self.ECN_THRESH else 0
            if self._bad_rounds >= self.K_ROUNDS:
                self.idx = self.rng.randrange(len(self.paths))
                self._bad_rounds = 0
            self._round_start = now
            self._acked = self._marked = 0

    def on_ack(self, subflow, now):
        pass

    def on_nack_or_timeout(self, now):
        # PLB also repaths on RTO (its "last resort" signal)
        self.idx = self.rng.randrange(len(self.paths))
        self._bad_rounds = 0


class UnoLBRouter:
    """UnoLB (paper Algorithm 2)."""

    name = "unolb"

    def __init__(self, paths: Sequence, flow_id: int, rng=None,
                 n_subflows: int = 8, base_rtt: float = 0.0):
        self.paths = list(paths)
        self.rng = rng or random.Random(flow_id ^ 0xC2B2AE35)
        n = min(n_subflows, len(self.paths))
        pick = self.rng.sample(range(len(self.paths)), n)
        self.sub_paths = [self.paths[i] for i in pick]       # subflow -> path
        self.n = n
        self.rr = 0
        self.base_rtt = base_rtt
        self.last_ack = [0.0] * n
        self.last_sent = [0.0] * n
        self.last_reroute = -1e18
        self.n_reroutes = 0
        self.suspect = set()        # ids of paths implicated by a timeout

    def path_for(self, pkt_idx, block):
        # onSend: round-robin the subflows; EC-block packets therefore spread
        # across all n subflows (<= ceil(n_pkts/n) per subflow per block).
        i = self.rr
        self.rr = (self.rr + 1) % self.n
        return self.sub_paths[i], i

    def on_ack(self, subflow, now):
        self.last_ack[subflow] = now
        # an ACK is the "recently ACKed" proof-of-life: the subflow's path
        # is no longer suspect (an abandoned path sends nothing, so a dead
        # path stays suspect until repair traffic reaches it again)
        self.suspect.discard(id(self.sub_paths[subflow]))

    def on_nack_or_timeout(self, now):
        # onNackOrTimeout: rate-limited to once per base RTT
        if now - self.last_reroute <= self.base_rtt:
            return
        self.last_reroute = now
        # the implicated subflow = stalest ACK among the subflows
        bad = min(range(self.n), key=lambda i: self.last_ack[i])
        # choose a new path not currently used by any subflow ("recently
        # ACKed" bias: surviving subflows keep their proven paths; the failed
        # one moves off the shared failure domain); never keep the current
        # one, and avoid paths still suspect from an earlier timeout — a
        # hard-down link otherwise re-enters the candidate pool as soon as
        # its subflow drains off it, and the flow ping-pongs back onto the
        # blackhole forever (transient congestion timeouts clear on the
        # next ACK, so suspicion only persists for paths that stay silent)
        cur = self.sub_paths[bad]
        self.suspect.add(id(cur))
        cands = [p for p in self.paths
                 if p is not cur and p not in self.sub_paths
                 and id(p) not in self.suspect]
        if not cands:
            cands = [p for p in self.paths
                     if p is not cur and id(p) not in self.suspect]
        if not cands:
            cands = [p for p in self.paths if p is not cur]
        if cands:
            self.sub_paths[bad] = self.rng.choice(cands)
            self.last_ack[bad] = now        # fresh start for the new path
            self.n_reroutes += 1


ROUTERS = {
    "ecmp": EcmpRouter,
    "rps": RpsRouter,
    "plb": PlbRouter,
    "unolb": UnoLBRouter,
}


def make_router(kind: str, paths, flow_id: int, *, rng=None,
                base_rtt: float = 0.0, n_subflows: int = 8):
    if kind == "ecmp":
        return EcmpRouter(paths, flow_id, rng)
    if kind == "rps":
        return RpsRouter(paths, flow_id, rng)
    if kind == "plb":
        return PlbRouter(paths, flow_id, rng, base_rtt=base_rtt)
    if kind == "unolb":
        return UnoLBRouter(paths, flow_id, rng, n_subflows=n_subflows,
                           base_rtt=base_rtt)
    raise ValueError(f"unknown router {kind!r}")
