"""Small vector helpers (the JAX package's `utils.vector_math`)."""

from __future__ import annotations

import torch


def calculate_cosine(vec1: torch.Tensor, vec2: torch.Tensor
                     ) -> torch.Tensor:
  """Cosine similarity along the last axis; 0 where either norm is 0."""
  n1 = torch.linalg.vector_norm(vec1, dim=-1)
  n2 = torch.linalg.vector_norm(vec2, dim=-1)
  dot = (vec1 * vec2).sum(-1)
  denom = n1 * n2
  return torch.where(denom > 0, dot / torch.where(denom > 0, denom, 1.0),
                     torch.zeros_like(denom))
