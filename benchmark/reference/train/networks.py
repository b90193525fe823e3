"""Policy and value networks of the trainers, and the squashed-Gaussian math.

Sizes follow the JAX package's networks: 3x64 swish MLPs for policy and
value. The policy is a tanh-squashed diagonal Gaussian over [-1, 1]^nu
(envs map actions into muscle space with the sigmoid projection,
`MyoEnv.norm_actions`). Weights start as flax's `lecun_normal` (a normal cut
at two standard deviations, of variance 1 / fan_in) and biases at zero, so
the port trains from the distribution the JAX package starts from.

The trainer holds the parameters as state dicts and runs these modules
through `torch.func.functional_call`; the modules only fix the layout.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_LOG_STD_MIN = -5.0
_LOG_STD_MAX = 2.0
_LOG_2PI = math.log(2 * math.pi)
_LOG_2 = math.log(2.0)
# stddev of the standard normal cut at +-2, which lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
  """flax's lecun_normal on a (out, in) weight: a normal of stddev
  sqrt(1 / fan_in) / 0.8796 cut at +-2 of that stddev."""
  std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
  with torch.no_grad():
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class MLP(nn.Module):
  """Dense layers of widths `features` with swish (SiLU) between them."""

  def __init__(self, in_dim: int, features: Sequence[int]):
    super().__init__()
    dims = (in_dim, *features)
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

  def reset_parameters(self, generator: torch.Generator) -> None:
    for layer in self.layers:
      lecun_normal_(layer.weight, generator)
      with torch.no_grad():
        layer.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for layer in self.layers[:-1]:
      x = F.silu(layer(x))
    return self.layers[-1](x)


class PolicyNet(nn.Module):
  """obs -> (mean, log_std) of the pre-squash Gaussian; log_std clipped to
  [-5, 2]."""

  def __init__(self, obs_dim: int, action_size: int,
               hidden: Sequence[int] = (64, 64, 64)):
    super().__init__()
    self.mlp = MLP(obs_dim, (*hidden, 2 * action_size))

  def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, log_std = self.mlp(obs).chunk(2, dim=-1)
    return mean, log_std.clamp(_LOG_STD_MIN, _LOG_STD_MAX)


class ValueNet(nn.Module):
  def __init__(self, obs_dim: int, hidden: Sequence[int] = (64, 64, 64)):
    super().__init__()
    self.mlp = MLP(obs_dim, (*hidden, 1))

  def forward(self, obs: torch.Tensor) -> torch.Tensor:
    return self.mlp(obs).squeeze(-1)


def flat_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
  """A parameter dict as one vector, in the dict's order (so that an
  optimizer's arithmetic is a few launches, not a few per tensor)."""
  return torch.cat([p.reshape(-1) for p in params.values()])


def param_views(flat: torch.Tensor, like: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
  """`flat` as views shaped like the dict `like` (the inverse of
  `flat_params`)."""
  shapes = [v.shape for v in like.values()]
  return {k: x.view(s) for k, x, s in zip(
      like, flat.split([s.numel() for s in shapes]), shapes)}


def sample_action_raw(mean: torch.Tensor, log_std: torch.Tensor,
                      generator: torch.Generator = None,
                      noise: torch.Tensor = None):
  """(action, raw, log_prob). Store RAW for PPO: atanh(tanh(raw)) clips at
  ~7.25 in float32, so a raw reconstructed from the action diverges from
  the sampled one exactly when the policy saturates. `noise` (standard
  normal, the shape of mean) replaces the draw from `generator`."""
  if noise is None:
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
  raw = mean + torch.exp(log_std) * noise
  return torch.tanh(raw), raw, gaussian_tanh_log_prob(mean, log_std, raw)


def sample_action(mean, log_std, generator=None, noise=None):
  """(action, log_prob) of a tanh-squashed sample."""
  action, _, logp = sample_action_raw(mean, log_std, generator, noise)
  return action, logp


def gaussian_tanh_log_prob(mean: torch.Tensor, log_std: torch.Tensor,
                           raw: torch.Tensor) -> torch.Tensor:
  """log-density of tanh(raw) under the squashed Gaussian, summed over the
  action axis. softplus is logaddexp(x, 0), as jax.nn.softplus computes it
  (exact for large arguments)."""
  std = torch.exp(log_std)
  base = -0.5 * (((raw - mean) / std) ** 2 + 2 * log_std + _LOG_2PI)
  # tanh change of variables
  corr = 2.0 * (_LOG_2 - raw - torch.logaddexp(-2.0 * raw,
                                               torch.zeros_like(raw)))
  return torch.sum(base + corr, dim=-1)


def entropy_estimate(mean: torch.Tensor, log_std: torch.Tensor,
                     raw: torch.Tensor) -> torch.Tensor:
  """Entropy of the pre-squash Gaussian, the quantity the PPO bonus
  maximizes. The tanh-corrected sample estimate grows linearly in |raw|, so
  as a bonus it would reward saturating the policy."""
  del mean, raw
  return torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)


def deterministic_action(mean: torch.Tensor) -> torch.Tensor:
  return torch.tanh(mean)
