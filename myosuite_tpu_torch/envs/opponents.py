"""Scripted opponents of the MyoChallenge envs, batched: the ChaseTag
opponent and the Soccer goalkeeper.

Each opponent is a pure function over a small state with a leading env
axis, carried in the env's info dict. A policy code is drawn per episode
(static, random, chase or evade for the opponent; stationary, random or
block-ball for the keeper); every policy's command is computed and the
episode's is selected with `torch.where`, so no env diverges on the host.
The random policy reads its commands from a colored-noise table drawn
for the whole episode at reset (white noise scaled by f^(-beta/2) in the
frequency domain, then an inverse real FFT).

Each reset is draws (uniform on [0, 1), normal, categorical) followed by
a transform of them (the `*_from_draws` functions, the JAX package's
formulas), so that a test can give both packages the same draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

# opponent policy codes
STATIC = 0
RANDOM = 1
CHASE = 2   # chases the agent (the agent evades)
EVADE = 3   # flees the agent (the agent chases)


def colored_noise(re: torch.Tensor, im: torch.Tensor, n_steps: int,
                  beta: float = 1.0) -> torch.Tensor:
  """(B, n_steps, n_dim) noise with a 1/f^beta spectrum and unit variance
  along the steps, from the standard normal draws re and im, each
  (B, n_steps // 2 + 1, n_dim), of the spectrum's real and imaginary
  parts. The imaginary parts of the DC bin (and of the Nyquist bin at an
  even n_steps) are dropped, as the JAX package's inverse real FFT drops
  them; here they are zeroed first, so that every FFT backend sees a
  Hermitian spectrum."""
  nfreq = n_steps // 2 + 1
  f = torch.arange(1, nfreq + 1, dtype=torch.float32, device=re.device)
  scale = (f ** (-beta / 2.0))[:, None]
  keep = torch.ones(nfreq, 1, device=re.device)
  keep[0] = 0.0
  if n_steps % 2 == 0:
    keep[-1] = 0.0
  spec = torch.complex(re * scale, im * scale * keep)
  x = torch.fft.irfft(spec, n=n_steps, dim=1)
  return x / torch.clamp(torch.std(x, dim=1, keepdim=True, correction=0),
                         min=1e-8)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
  """Draws in [0, 1) -> [lo, hi), as jax.random.uniform scales them (the
  width hi - lo taken in float32)."""
  return u * float(np.float32(hi) - np.float32(lo)) + lo


def _categorical(generator: torch.Generator, probs, batch: int
                 ) -> torch.Tensor:
  p = torch.as_tensor(probs, dtype=torch.float32, device=generator.device)
  return torch.multinomial(p / p.sum(), batch, replacement=True,
                           generator=generator)


def _normals(generator: torch.Generator, batch: int, n_steps: int,
             n_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
  shape = (batch, n_steps // 2 + 1, n_dim)
  dev = generator.device
  return (torch.randn(shape, generator=generator, device=dev),
          torch.randn(shape, generator=generator, device=dev))


@dataclasses.dataclass
class OpponentState:
  """The ChaseTag opponent of each env."""
  pose: torch.Tensor      # (B, 3) x, y, heading
  vel: torch.Tensor       # (B, 2) linear, angular speed commands
  policy: torch.Tensor    # (B,) int32 policy code
  noise: torch.Tensor     # (B, horizon, 2) colored-noise command table
  t: torch.Tensor         # (B,) int32 step index into the noise table

  def replace(self, **kw) -> "OpponentState":
    return dataclasses.replace(self, **kw)


def draw_opponent(generator: torch.Generator, batch: int, horizon: int
                  ) -> Dict[str, torch.Tensor]:
  """The draws of `reset_opponent`: spawn xy (B, 2) and heading (B,)
  uniforms, the policy's categorical choice (B,) over (static, random,
  chase-or-evade), and the noise table's normals."""
  dev = generator.device
  xy = torch.rand(batch, 2, generator=generator, device=dev)
  heading = torch.rand(batch, generator=generator, device=dev)
  choice = _categorical(generator, (0.1, 0.45, 0.45), batch)
  re, im = _normals(generator, batch, horizon, 2)
  return dict(xy=xy, heading=heading, choice=choice, re=re, im=im)


def opponent_from_draws(draws: Dict[str, torch.Tensor], horizon: int,
                        arena_half: float = 6.0, mode: int = CHASE
                        ) -> OpponentState:
  """A fresh opponent per env: spawn in +-0.8 arena_half, heading in
  +-pi, policy static / random / `mode` by the choice, its noise table."""
  xy = _uniform(draws["xy"], -arena_half * 0.8, arena_half * 0.8)
  heading = _uniform(draws["heading"], -math.pi, math.pi)
  choice = draws["choice"]
  policy = torch.where(choice == 0, STATIC,
                       torch.where(choice == 1, RANDOM, mode)).to(torch.int32)
  batch = xy.shape[0]
  return OpponentState(
      pose=torch.cat([xy, heading[:, None]], -1),
      vel=torch.zeros(batch, 2, device=xy.device), policy=policy,
      noise=colored_noise(draws["re"], draws["im"], horizon),
      t=torch.zeros(batch, dtype=torch.int32, device=xy.device))


def reset_opponent(generator: torch.Generator, batch: int, horizon: int,
                   arena_half: float = 6.0, mode: int = CHASE
                   ) -> OpponentState:
  return opponent_from_draws(draw_opponent(generator, batch, horizon),
                             horizon, arena_half, mode)


def _row(noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """(B, dim) row t (clipped to the table) of each env's noise table."""
  i = torch.clamp(t.long(), 0, noise.shape[1] - 1)
  return noise[torch.arange(noise.shape[0], device=noise.device), i]


def _wrap(a: torch.Tensor) -> torch.Tensor:
  return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def step_opponent(opp: OpponentState, agent_xy: torch.Tensor, dt: float,
                  arena_half: float = 6.0, max_lin: float = 2.0,
                  max_ang: float = 4.0, chase_speed: float = 1.2
                  ) -> OpponentState:
  """Advance every env's opponent one control step."""
  x, y, th = opp.pose[:, 0], opp.pose[:, 1], opp.pose[:, 2]
  # random policy: the colored-noise command of this step
  ncmd = _row(opp.noise, opp.t)
  lin_rand = torch.clamp(ncmd[:, 0], -1.0, 1.0) * max_lin
  ang_rand = torch.clamp(ncmd[:, 1], -1.0, 1.0) * max_ang
  # chase: steer toward the agent at chase_speed
  to_agent = agent_xy - opp.pose[:, :2]
  des_th = torch.atan2(to_agent[:, 1], to_agent[:, 0])
  rate = max(dt, 1e-6)
  ang_chase = torch.clamp(_wrap(des_th - th) / rate, -max_ang, max_ang)
  lin_chase = torch.full_like(x, chase_speed)
  # evade: steer away from the agent
  des_th_e = torch.atan2(-to_agent[:, 1], -to_agent[:, 0])
  ang_evade = torch.clamp(_wrap(des_th_e - th) / rate, -max_ang, max_ang)

  p = opp.policy
  zero = torch.zeros_like(x)
  lin = torch.where(p == STATIC, zero, torch.where(
      p == RANDOM, lin_rand, lin_chase))
  ang = torch.where(p == STATIC, zero, torch.where(
      p == RANDOM, ang_rand, torch.where(p == CHASE, ang_chase, ang_evade)))
  th_new = th + ang * dt
  x_new = torch.clamp(x + lin * torch.cos(th_new) * dt, -arena_half,
                      arena_half)
  y_new = torch.clamp(y + lin * torch.sin(th_new) * dt, -arena_half,
                      arena_half)
  return opp.replace(pose=torch.stack([x_new, y_new, th_new], -1),
                     vel=torch.stack([lin, ang], -1), t=opp.t + 1)


@dataclasses.dataclass
class KeeperState:
  """The Soccer goalkeeper of each env, moving along the goal line."""
  pose: torch.Tensor      # (B, 2) y on the goal line, its speed
  policy: torch.Tensor    # (B,) int32: 0 stationary, 1 random, 2 block-ball
  noise: torch.Tensor     # (B, horizon, 1)
  t: torch.Tensor         # (B,) int32

  def replace(self, **kw) -> "KeeperState":
    return dataclasses.replace(self, **kw)


def draw_keeper(generator: torch.Generator, batch: int, horizon: int,
                probs=(0.2, 0.3, 0.5)) -> Dict[str, torch.Tensor]:
  """The draws of `reset_keeper`: the start y's uniform (B,), the policy's
  categorical choice (B,) and the noise table's normals."""
  y = torch.rand(batch, generator=generator, device=generator.device)
  choice = _categorical(generator, probs, batch)
  re, im = _normals(generator, batch, horizon, 1)
  return dict(y=y, choice=choice, re=re, im=im)


def keeper_from_draws(draws: Dict[str, torch.Tensor], horizon: int
                      ) -> KeeperState:
  y0 = _uniform(draws["y"], -0.8, 0.8)
  return KeeperState(pose=torch.stack([y0, torch.zeros_like(y0)], -1),
                     policy=draws["choice"].to(torch.int32),
                     noise=colored_noise(draws["re"], draws["im"], horizon),
                     t=torch.zeros(y0.shape[0], dtype=torch.int32,
                                   device=y0.device))


def reset_keeper(generator: torch.Generator, batch: int, horizon: int,
                 probs=(0.2, 0.3, 0.5)) -> KeeperState:
  return keeper_from_draws(draw_keeper(generator, batch, horizon, probs),
                           horizon)


def step_keeper(kp: KeeperState, ball_xy: torch.Tensor, dt: float,
                goal_half_width: float = 1.0, max_speed: float = 2.0
                ) -> KeeperState:
  """Advance every env's keeper one control step."""
  y = kp.pose[:, 0]
  ncmd = _row(kp.noise, kp.t)[:, 0]
  v_rand = torch.clamp(ncmd, -1.0, 1.0) * max_speed
  v_block = torch.clamp((ball_xy[:, 1] - y) / max(dt, 1e-6), -max_speed,
                        max_speed)
  v = torch.where(kp.policy == 0, torch.zeros_like(y),
                  torch.where(kp.policy == 1, v_rand, v_block))
  y_new = torch.clamp(y + v * dt, -goal_half_width, goal_half_width)
  return kp.replace(pose=torch.stack([y_new, v], -1), t=kp.t + 1)
