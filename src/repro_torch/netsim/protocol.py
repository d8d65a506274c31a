"""Flows, packets, ACK/NACK plumbing and UnoRC erasure-coding framing: the
port's copy of ``repro.netsim.protocol``, driving the port's `UnoCC`.

One `Flow` = one message (htsim convention).  Senders are window-based with
NIC pacing (paper §6: "Uno uses hardware pacing"): a pacer event sends the
next packet when `inflight < cwnd`, at rate `cwnd/RTT_base` (or the CC's
explicit pacing rate, e.g. BBR).  Data packets traverse the topology hop by
hop through `Link.enqueue`; ACK/NACKs are delivered after the reverse-path
propagation delay without queuing events (64 B ACKs at <2% of data load,
a simplification of the model).

UnoRC (paper §4.2): inter-DC flows are framed into blocks of x data + y
parity packets (MDS — any x of x+y reconstruct the block).  The receiver
starts a timer on the first packet of a block; if the block is still
unrecoverable when it fires, it NACKs the missing packets.  Packets of one
block are spread across UnoLB subflows by the router.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Optional

from repro_torch.netsim.engine import Simulator, Link

ACK_SIZE = 64


class Packet:
    __slots__ = ("flow", "seq", "size", "ecn", "send_time", "path", "hop",
                 "block", "is_parity", "subflow", "retx")

    def __init__(self, flow, seq, size, path, subflow, block=-1,
                 is_parity=False, retx=0):
        self.flow = flow
        self.seq = seq
        self.size = size
        self.ecn = False
        self.send_time = 0.0
        self.path = path
        self.hop = 0
        self.block = block
        self.is_parity = is_parity
        self.subflow = subflow
        self.retx = retx


def forward(pkt: Packet) -> None:
    """Per-hop arrival: push onto the next link or deliver to the receiver."""
    pkt.hop += 1
    path = pkt.path
    if pkt.hop < len(path):
        path[pkt.hop].enqueue(pkt, pkt.flow.sim.now)
    else:
        pkt.flow.receiver.receive(pkt, pkt.flow.sim.now)


class FlowReceiver:
    """Receiver side: dedup, per-block EC state, ACK/NACK generation."""

    __slots__ = ("flow", "got", "n_got", "blocks", "block_done", "complete_t",
                 "nacked_at", "backoff")

    def __init__(self, flow: "Flow"):
        self.flow = flow
        self.got = bytearray(flow.n_pkts)        # per-seq received flag
        self.n_got = 0
        # per-block: count of received packets (data+parity)
        self.blocks = [0] * flow.n_blocks if flow.ec else None
        self.block_done = bytearray(flow.n_blocks) if flow.ec else None
        self.complete_t = None
        self.nacked_at = [0.0] * flow.n_blocks if flow.ec else None
        self.backoff = [1] * flow.n_blocks if flow.ec else None

    def receive(self, pkt: Packet, now: float) -> None:
        f = self.flow
        f.sim.delivered += 1
        dup = self.got[pkt.seq]
        if not dup:
            self.got[pkt.seq] = 1
            self.n_got += 1
        # per-packet ACK (even for dups: sender needs the signal)
        f.sim.at(now + f.ack_delay, f.on_ack_pkt,
                 pkt.seq, pkt.size, pkt.ecn, pkt.send_time, pkt.subflow)
        if f.ec is None:
            if not dup and self.n_got == f.n_pkts and self.complete_t is None:
                self._complete(now)
            return
        # ---- erasure-coded path
        b = pkt.block
        if dup or self.block_done[b]:
            return
        if self.blocks[b] == 0:
            # first packet of the block: arm the recovery timer (paper §4.2)
            f.sim.at(now + f.nack_timeout, self._block_timer, b)
        self.blocks[b] += 1
        need = f.block_data(b)                   # any `x` of the block suffice
        if self.blocks[b] >= need:
            self.block_done[b] = 1
            missing = [s for s in f.block_seqs(b) if not self.got[s]]
            if missing:
                # decoded without them: tell the sender to stop resending
                f.sim.at(now + f.ack_delay, f.on_block_recovered, tuple(missing))
                for s in missing:
                    self.got[s] = 1
                    self.n_got += 1
            if all(self.block_done) and self.complete_t is None:
                self._complete(now)

    def _block_timer(self, b: int) -> None:
        f = self.flow
        now = f.sim.now
        if self.block_done[b] or self.complete_t is not None:
            return
        self.nacked_at[b] = now
        missing = tuple(s for s in f.block_seqs(b) if not self.got[s])
        if missing:
            f.sim.at(now + f.ack_delay, f.on_nack, b, missing)
        # exponential backoff: a window-blocked sender legitimately spreads a
        # block over many timeouts — don't NACK-storm it
        self.backoff[b] = min(self.backoff[b] * 2, 16)
        f.sim.at(now + f.nack_timeout * self.backoff[b], self._block_timer, b)

    def _complete(self, now: float) -> None:
        f = self.flow
        self.complete_t = now
        # paper FCT: first send -> last ACK received
        f.finish(now + f.ack_delay)


class Flow:
    """Window-based paced sender for one message."""

    _next_id = 0

    def __init__(self, sim: Simulator, net, src: int, dst: int,
                 size_bytes: int, cc, router, *, mtu: int = 4096,
                 ec: Optional[tuple[int, int]] = None,
                 start_t: float = 0.0, base_rtt: float = 0.0,
                 nack_timeout: Optional[float] = None,
                 on_done: Optional[Callable] = None, is_inter: bool = False):
        self.id = Flow._next_id
        Flow._next_id += 1
        self.sim = sim
        self.net = net
        self.src, self.dst = src, dst
        self.size = size_bytes
        self.mtu = mtu
        self.cc = cc
        self.router = router
        self.ec = ec
        self.is_inter = is_inter
        self.on_done = on_done
        self.start_t = start_t
        self.base_rtt = base_rtt
        self.ack_delay = base_rtt / 2.0

        self.n_data = max(1, math.ceil(size_bytes / mtu))
        if ec:
            x, y = ec
            self.n_blocks = math.ceil(self.n_data / x)
            self.n_parity = self.n_blocks * y
            # interleaved layout: the short tail packet is the last DATA
            # seq of the last block, not seq n_data - 1
            self._last_data_seq = ((self.n_blocks - 1) * (x + y)
                                   + self.block_data(self.n_blocks - 1) - 1)
        else:
            self.n_blocks = 1
            self.n_parity = 0
            self._last_data_seq = self.n_data - 1
        self.n_pkts = self.n_data + self.n_parity
        self.nack_timeout = (nack_timeout if nack_timeout is not None
                             else max(0.25 * base_rtt, 100_000.0))

        self.receiver = FlowReceiver(self)
        self.unacked: dict[int, tuple] = {}      # seq -> (send_t, size, subflow)
        self.inflight = 0.0
        self.next_seq = 0
        self.retx_queue: deque[int] = deque()    # seqs to retransmit first
        self.acked_seq = bytearray(self.n_pkts)
        self.n_sent = 0
        self.n_retx = 0
        self.fct = None
        self.done = False
        self._pace_pending = False
        self._rto_pending = False
        self.rate_trace: Optional[list] = None   # [(t, acked_bytes)] if enabled
        self._router_ecn = getattr(router, "on_ecn_sample", None)  # PLB hook
        self._last_loss_sig = -1e18

        sim.at(start_t, self._start)

    # ------------------------------------------------------------- framing

    # Interleaved per-block layout (UnoRC, paper §4.2): block b occupies
    # the CONTIGUOUS seq range [b*(x+y), ...) — its x data packets first,
    # its y parity packets right behind them.  The in-order sender then
    # emits every block's parity together with its data, so the receiver
    # can decode a lossy block one block-serialization after it started —
    # appending all parity at the flow tail (the previous layout) made
    # mid-stream recovery impossible for long flows: every block with one
    # data loss sat on the NACK timer instead of its parity.

    def block_of(self, seq: int) -> int:
        if self.ec is None:
            return -1
        x, y = self.ec
        return seq // (x + y)

    def block_seqs(self, b: int):
        """All seqs (data + parity) of block b."""
        _, y = self.ec
        lo = b * (self.ec[0] + y)
        return list(range(lo, lo + self.block_data(b) + y))

    def block_data(self, b: int) -> int:
        """Number of packets needed to decode block b (its data count)."""
        x, _ = self.ec
        lo = b * x
        return min(lo + x, self.n_data) - lo

    def is_parity_seq(self, seq: int) -> bool:
        if self.ec is None:
            return False
        x, y = self.ec
        b = seq // (x + y)
        return seq - b * (x + y) >= self.block_data(b)

    def _pkt_size(self, seq: int) -> int:
        if seq == self._last_data_seq and self.size % self.mtu:
            return self.size % self.mtu
        return self.mtu

    # ------------------------------------------------------------- sending

    def _start(self) -> None:
        self._pace()
        self._arm_rto()
        if hasattr(self.cc, "on_qa_tick"):
            # QA runs on a once-per-RTT timer (it must fire even when the ACK
            # stream has dried up completely — that IS the extreme-congestion
            # signal it looks for).  First evaluation at 2.5 RTT: the first
            # window's ACKs only exist after one full RTT + serialization.
            self.sim.after(2.5 * self.base_rtt, self._qa_tick)

    def _qa_tick(self) -> None:
        if self.done:
            return
        now = self.sim.now
        if self.cc.on_qa_tick(now, self.inflight):
            # QA: un-ACKed data older than one RTT is considered lost; reclaim
            # it so the collapsed window can immediately re-probe.
            self._expire_older_than(now - (self.cc.rtt_est or self.base_rtt))
            self._kick()
        # +-10% jitter: avoid phase-locking the sampling window to the
        # RTT-periodic ACK clumps of a window-limited flow
        gap = max(self.cc.rtt_est, self.base_rtt)
        self.sim.after(gap * (0.9 + 0.2 * self.sim.rng.random()), self._qa_tick)

    def _pace(self) -> None:
        self._pace_pending = False
        if self.done:
            return
        seq = self._next_to_send()
        if seq is None:
            return
        size = self._pkt_size(seq)
        if self.inflight + size > self.cc.cwnd:
            if seq != self.next_seq:
                self.retx_queue.appendleft(seq)   # un-pop the retx candidate
            # window-blocked: ACKs restart the pacer; a slow self-check guards
            # against full in-flight loss (all ACKs gone)
            self.sim.after(self.base_rtt / 2, self._pace)
            self._pace_pending = True
            return
        self._send(seq, size)
        rate = self.cc.pacing_rate or (
            self.cc.cwnd / max(self.base_rtt, 1.0))
        gap = size / max(rate, 1e-9)
        # +-3% jitter de-phases identical senders (hardware pacers drift too)
        gap *= 0.97 + 0.06 * self.sim.rng.random()
        self.sim.after(gap, self._pace)
        self._pace_pending = True

    def _next_to_send(self) -> Optional[int]:
        while self.retx_queue:
            s = self.retx_queue.popleft()
            if not self.acked_seq[s] and s not in self.unacked:
                return s
        if self.next_seq < self.n_pkts:
            return self.next_seq
        return None

    def _send(self, seq: int, size: int) -> None:
        retx = seq != self.next_seq
        if seq == self.next_seq:
            self.next_seq += 1
        b = self.block_of(seq)
        path, subflow = self.router.path_for(self.n_sent, b)
        pkt = Packet(self, seq, size, path, subflow, b,
                     is_parity=self.is_parity_seq(seq), retx=int(retx))
        pkt.send_time = self.sim.now
        if seq not in self.unacked:
            self.inflight += size
        self.unacked[seq] = (self.sim.now, size, subflow)
        self.n_sent += 1
        if retx:
            self.n_retx += 1
        path[0].enqueue(pkt, self.sim.now)

    def _kick(self) -> None:
        if not self._pace_pending and not self.done:
            self._pace()

    # ------------------------------------------------------------- feedback

    def on_ack_pkt(self, seq, size, ecn, send_time, subflow) -> None:
        if self.done:
            return
        now = self.sim.now
        if seq in self.unacked:
            del self.unacked[seq]
            self.inflight = max(0.0, self.inflight - size)
        if not self.acked_seq[seq]:
            self.acked_seq[seq] = 1
            if self.rate_trace is not None:
                self.rate_trace.append((now, size))
        self.cc.on_ack(size, ecn, now - send_time, send_time, now)
        self.router.on_ack(subflow, now)
        if self._router_ecn is not None:
            self._router_ecn(ecn, now)
        self._kick()

    def _expire_older_than(self, cutoff: float) -> None:
        expired = [s for s, (t, _, _) in self.unacked.items() if t < cutoff]
        for s in expired:
            _, size, _ = self.unacked.pop(s)
            self.inflight = max(0.0, self.inflight - size)
            self.retx_queue.append(s)

    def on_block_recovered(self, seqs) -> None:
        """Receiver decoded the block without these packets (EC win)."""
        for s in seqs:
            if s in self.unacked:
                _, size, _ = self.unacked.pop(s)
                self.inflight = max(0.0, self.inflight - size)
            self.acked_seq[s] = 1
        self._kick()

    def on_nack(self, block, missing) -> None:
        """Unrecoverable block: re-route the subflow, retransmit the missing."""
        if self.done:
            return
        now = self.sim.now
        self.router.on_nack_or_timeout(now)
        # at most one multiplicative loss reaction per RTT — a NACK storm is
        # one congestion event, not hundreds
        if now - self._last_loss_sig > (self.cc.rtt_est or self.base_rtt):
            self._last_loss_sig = now
            self.cc.on_loss_signal(now)
        for s in missing:
            if not self.acked_seq[s]:
                if s in self.unacked:       # lost in flight: release window
                    _, size, _ = self.unacked.pop(s)
                    self.inflight = max(0.0, self.inflight - size)
                self.retx_queue.append(s)
        self._kick()

    # ------------------------------------------------------------- timers

    def _arm_rto(self) -> None:
        if self.done or self._rto_pending:
            return
        self._rto_pending = True
        self.sim.after(self._rto() / 2, self._rto_check)

    def _rto(self) -> float:
        return max(2.0 * (self.cc.rtt_est or self.base_rtt), 3.0 * self.base_rtt)

    def _rto_check(self) -> None:
        self._rto_pending = False
        if self.done:
            return
        now = self.sim.now
        rto = self._rto()
        expired = [s for s, (t, _, _) in self.unacked.items() if now - t > rto]
        if expired:
            self.router.on_nack_or_timeout(now)
            # at most one multiplicative loss reaction per RTT
            if now - self._last_loss_sig > (self.cc.rtt_est or self.base_rtt):
                self._last_loss_sig = now
                self.cc.on_loss_signal(now)
            for s in sorted(expired):
                _, size, _ = self.unacked.pop(s)
                self.inflight = max(0.0, self.inflight - size)
                self.retx_queue.append(s)
            self._kick()
        if self.unacked or self.next_seq < self.n_pkts or self.retx_queue:
            self._arm_rto()

    # ------------------------------------------------------------- drops

    def on_drop(self, pkt, now) -> None:
        pass  # loss is discovered via EC/NACK/RTO; counted by the link

    def finish(self, t: float) -> None:
        if self.done:
            return
        self.done = True
        self.fct = t - self.start_t
        if self.on_done is not None:
            self.on_done(self)
