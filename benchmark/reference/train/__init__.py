"""The reference PPO learner (see `benchmark.reference`)."""
