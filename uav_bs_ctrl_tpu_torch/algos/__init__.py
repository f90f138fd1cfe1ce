"""Rollouts, replay, the recurrent Q-learning update and the fused trainer."""
