"""Serving-side rollout: layout pools, world resets and test episodes."""
