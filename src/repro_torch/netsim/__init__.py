"""The packet-level network simulator: the port's copy of ``repro.netsim``,
a heap of per-packet events in plain Python on the host.

`engine` (Simulator, Link with RED marking on the physical or a phantom
queue), `protocol` (packets, flows with UnoRC EC framing, NACKs and
retransmits, driven by `core.unocc.UnoCC` or a `core.baselines`
controller), `routing` (ECMP, RPS, PLB, UnoLB), `topology` (Dumbbell, the
multi-DC fat tree, Gilbert-Elliott loss, link faults) and `workloads`
(flow factory, incast / permutation / Poisson mixes, FCT and rate
metrics).  A run is bitwise the reference's; it uses no tensors and no
device.  A `Scenario` compiles to it through `scenarios.to_netsim`.
"""
