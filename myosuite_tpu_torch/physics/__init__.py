"""Batched musculoskeletal physics in PyTorch (MuJoCo semantics)."""
