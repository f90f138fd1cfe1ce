"""Checkpoint loading and JAX-to-torch parameter conversion."""
