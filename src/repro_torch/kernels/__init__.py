"""Hand-written Hopper kernels (`fleet_cuda`, built by `build`) and their
plain PyTorch versions (`ref`)."""
