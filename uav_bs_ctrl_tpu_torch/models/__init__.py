"""Neural modules of the port; parameters keep the JAX layout ([in, out] weights)."""
