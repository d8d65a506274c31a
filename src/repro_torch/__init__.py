"""repro_torch — the PyTorch / CUDA port of the Uno fluid fleet simulator.

A second package beside the JAX reference ``repro``; it imports torch and
numpy, never jax and nothing of ``repro``.  This slice covers the
steady-state path: a `Scenario` (dumbbell or two-DC fat tree) compiles
through `scenarios.to_fleetsim` into a `FluidNet` with its `RouteLayout` /
`PathTable` and the `FleetParams`, and `fleetsim.steady_state` steps it
epoch by epoch.  The flow<->link exchange runs on hand-written Hopper
kernels (`kernels.fleet_cuda`).  UnoRC's protected cross-pod gradient
sync (`core.uno_collectives.make_uno_grad_sync`: int8 quantization plus
RS(8, 2) parity on every hop) runs on three more (`kernels.unorc_cuda`).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
