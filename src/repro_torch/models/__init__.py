"""Model parameter shapes (`params.param_defs`, dense family) and the
pytree helpers the gradient sync flattens with."""
