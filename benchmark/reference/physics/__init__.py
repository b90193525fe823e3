"""The reference physics engine (see `benchmark.reference`)."""
