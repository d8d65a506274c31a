"""repro_torch — the PyTorch / CUDA port of the Uno reproduction: the fluid
fleet simulator, UnoRC and the cross-pod training path.

A second package beside the JAX reference ``repro``; it imports torch and
numpy, never jax and nothing of ``repro``.  A `Scenario` (dumbbell, two-DC
fat tree, N-DC mesh) compiles through `scenarios.to_fleetsim` into a
`FluidNet` with its `RouteLayout` / `PathTable` and the `FleetParams`, and
`fleetsim.steady_state` steps it epoch by epoch (with churn, reliability,
faults, sweeps, shards and the sweep service around it).  The flow<->link
exchange runs on hand-written Hopper kernels (`kernels.fleet_cuda`).
UnoRC's protected cross-pod gradient sync
(`core.uno_collectives.make_uno_grad_sync`: int8 quantization plus
RS(8, 2) parity on every hop) runs on three more (`kernels.unorc_cuda`).
The dense-family LLM training path — `models` (the decoder-only LM),
`optim`, `train` (the baseline step, and the Uno step whose per-pod
gradients go through that sync), `data`, `ckpt` (the reference's
checkpoint format), `ft` (checkpoint / restart supervisor, straggler QA
into the chunk-window scheduler `core.window_scheduler`) and the CLIs
`launch.train` and `launch.cross_pod` — trains smollm-135m on the card.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
