"""Hand-written Hopper kernels (`fleet_cuda`, `unorc_cuda`, built by
`build`), the UnoRC RS/quant API (`ops`, with the GF(2^8) host algebra in
`gf`) and the plain PyTorch versions (`ref`)."""
