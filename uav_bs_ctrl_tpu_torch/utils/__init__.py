"""Checkpoint reading and writing, JAX/torch parameter conversion, run logging."""
