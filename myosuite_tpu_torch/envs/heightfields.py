"""Procedural terrain and egocentric heightmap observations, batched.

Terrain is a (B, H, W) height grid in `Data.hfield_data`, one per env,
drawn anew at each reset. Each generator is uniform [0, 1) draws followed
by a deterministic transform of them (the JAX package's formulas), so a
test can give both packages the same draws. The families: FLAT, ROUGH
(3x3 box-blurred noise), HILLY (a sinusoid with a random phase), STAIRS
(up, then down, with a random step height).
"""

from __future__ import annotations

import enum
import math
from typing import Tuple

import torch
import torch.nn.functional as F


class TerrainType(enum.IntEnum):
  FLAT = 0
  ROUGH = 1
  HILLY = 2
  STAIRS = 3


def flat(batch: int, shape: Tuple[int, int], device=None) -> torch.Tensor:
  return torch.zeros((batch,) + tuple(shape), device=device)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
  """Draws in [0, 1) -> [lo, hi), as jax.random.uniform scales them."""
  return u * (hi - lo) + lo


def rough(u: torch.Tensor, amplitude: float = 0.05) -> torch.Tensor:
  """u (B, H, W) -> uniform noise in [0, amplitude), 3x3 box-blurred with
  zero padding (convolve2d "same"). The blur sums nine shifted copies in
  float32; a convolution would run in cuDNN, where PyTorch allows TF32 by
  default."""
  noise = F.pad(_uniform(u, 0.0, amplitude), (1, 1, 1, 1))
  h, w = u.shape[1], u.shape[2]
  return sum(noise[:, i:i + h, j:j + w] * (1.0 / 9.0)
             for i in range(3) for j in range(3))


def hilly(u: torch.Tensor, shape: Tuple[int, int], amplitude: float = 0.15,
          wavelength: float = 12.0) -> torch.Tensor:
  """u (B,) -> sinusoidal hills along the columns, phase in [0, 2 pi)."""
  phase = _uniform(u, 0.0, 2 * math.pi)
  x = torch.arange(shape[1], dtype=torch.float32, device=u.device)
  prof = 0.5 * amplitude * (1.0 - torch.cos(2 * math.pi * x / wavelength
                                            + phase[:, None]))
  return prof[:, None, :].expand(-1, shape[0], -1)


def stairs(u: torch.Tensor, shape: Tuple[int, int], step_height: float = 0.08,
           step_len: int = 6) -> torch.Tensor:
  """u (B,) -> an up-then-down staircase, step height in
  [0.5, 1) * step_height."""
  h = step_height * _uniform(u, 0.5, 1.0)
  x = torch.arange(shape[1], device=u.device)
  up = (x // step_len).to(torch.float32)
  down = ((shape[1] - 1 - x) // step_len).to(torch.float32)
  prof = h[:, None] * torch.minimum(up, down)
  return prof[:, None, :].expand(-1, shape[0], -1)


def draws(generator: torch.Generator, batch: int, shape: Tuple[int, int]):
  """The uniform draws of `generate`: (grid (B, H, W), scalar (B,))."""
  dev = generator.device
  return (torch.rand((batch,) + tuple(shape), generator=generator,
                     device=dev),
          torch.rand(batch, generator=generator, device=dev))


def from_draws(codes: torch.Tensor, grid_u: torch.Tensor,
               scalar_u: torch.Tensor) -> torch.Tensor:
  """Terrain (B, H, W) of per-env type codes (TerrainType) from draws."""
  shape = tuple(grid_u.shape[1:])
  out = torch.zeros_like(grid_u)
  for code, terrain in ((TerrainType.ROUGH, lambda: rough(grid_u)),
                        (TerrainType.HILLY, lambda: hilly(scalar_u, shape)),
                        (TerrainType.STAIRS, lambda: stairs(scalar_u, shape))):
    out = torch.where((codes == code)[:, None, None], terrain(), out)
  return out


def generate(generator: torch.Generator, codes: torch.Tensor,
             shape: Tuple[int, int]) -> torch.Tensor:
  """Terrain (B, H, W) for per-env type codes, on the generator's device."""
  return from_draws(codes, *draws(generator, codes.shape[0], shape))


def arena_draws(generator: torch.Generator, batch: int,
                shape: Tuple[int, int], patches: int = 2):
  """The draws of `chasetag_arena`: per (env, patch) a type code in
  {FLAT, ROUGH, HILLY} (B, P * P), the patch's grid (B, P * P, h, w) and
  scalar (B, P * P) uniforms, for patches of h, w = shape // P."""
  dev, n = generator.device, patches * patches
  ph, pw = shape[0] // patches, shape[1] // patches
  return (torch.randint(0, 3, (batch, n), generator=generator, device=dev),
          torch.rand((batch, n, ph, pw), generator=generator, device=dev),
          torch.rand((batch, n), generator=generator, device=dev))


def arena_from_draws(codes: torch.Tensor, grid_u: torch.Tensor,
                     scalar_u: torch.Tensor, shape: Tuple[int, int],
                     patches: int = 2) -> torch.Tensor:
  """The ChaseTag arena (B, H, W): a patches x patches grid, each patch
  flat, rough or hilly by its own code and made from its own draws (row
  by row, column by column), padded to `shape` with edge values."""
  B = codes.shape[0]
  tiles = [from_draws(codes[:, k], grid_u[:, k], scalar_u[:, k])
           for k in range(patches * patches)]
  arena = torch.cat([torch.cat(tiles[i * patches:(i + 1) * patches], 2)
                     for i in range(patches)], 1)
  rows = torch.clamp(torch.arange(shape[0], device=codes.device),
                     max=arena.shape[1] - 1)
  cols = torch.clamp(torch.arange(shape[1], device=codes.device),
                     max=arena.shape[2] - 1)
  return arena[:, rows][:, :, cols].reshape(B, shape[0], shape[1])


def chasetag_arena(generator: torch.Generator, batch: int,
                   shape: Tuple[int, int], patches: int = 2) -> torch.Tensor:
  return arena_from_draws(*arena_draws(generator, batch, shape, patches),
                          shape, patches)


def sample_height(hfield: torch.Tensor, xy: torch.Tensor,
                  extent: Tuple[float, float],
                  base: Tuple[float, float] = (0.0, 0.0)) -> torch.Tensor:
  """Bilinear height of each env's field at world (x, y).

  hfield (B, H, W); xy (B, ..., 2); the field spans `extent` centred at
  `base`. Returns (B, ...).
  """
  B, h, w = hfield.shape
  u = (xy[..., 0] - base[0]) / extent[0] + 0.5    # [0, 1] across columns
  v = (xy[..., 1] - base[1]) / extent[1] + 0.5    # [0, 1] across rows
  cx = torch.clamp(u * (w - 1), 0.0, float(w - 1))
  cy = torch.clamp(v * (h - 1), 0.0, float(h - 1))
  x0 = torch.clamp(torch.floor(cx).long(), 0, w - 2)
  y0 = torch.clamp(torch.floor(cy).long(), 0, h - 2)
  fx = cx - x0
  fy = cy - y0
  flat_h = hfield.reshape(B, -1)
  at = lambda r, c: torch.gather(flat_h, 1, (r * w + c).reshape(B, -1)
                                 ).reshape(cx.shape)
  h00 = at(y0, x0)
  h01 = at(y0, x0 + 1)
  h10 = at(y0 + 1, x0)
  h11 = at(y0 + 1, x0 + 1)
  return ((1 - fy) * ((1 - fx) * h00 + fx * h01)
          + fy * ((1 - fx) * h10 + fx * h11))


def egocentric_heightmap(hfield: torch.Tensor, root_xy: torch.Tensor,
                         root_yaw: torch.Tensor,
                         extent: Tuple[float, float], grid: int = 10,
                         span: float = 1.0,
                         base: Tuple[float, float] = (0.0, 0.0)
                         ) -> torch.Tensor:
  """(B, grid, grid) heights of a probe grid around each env's root,
  rotated by its yaw: root_xy (B, 2), root_yaw (B,)."""
  lin = torch.linspace(-span / 2, span / 2, grid, device=hfield.device)
  gy, gx = torch.meshgrid(lin, lin, indexing="ij")
  px, py = gx.reshape(-1), gy.reshape(-1)                  # (grid * grid,)
  c, s = torch.cos(root_yaw)[:, None], torch.sin(root_yaw)[:, None]
  world = torch.stack([c * px - s * py + root_xy[:, :1],
                       s * px + c * py + root_xy[:, 1:]], -1)
  return sample_height(hfield, world, extent, base).reshape(-1, grid, grid)
