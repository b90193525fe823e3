"""ResNet feature trunks for visual observations.

The JAX package's flax `ResNetTrunk` (myosuite_tpu/envs/visual_nets.py):
ResNet-18 or -34 topology with GroupNorm(8) in place of BatchNorm, a 7x7
stride-2 stem, a 3x3 stride-2 max-pool, stages of BasicBlocks and global
mean pooling to 512 features, no head. Here it is an `nn.Module` over
batches: (B, H, W, 3) uint8 -> (B, 512) float32.

The JAX trunk's default weights are its init at PRNGKey(0), which torch
cannot reproduce; the port's default trunk is drawn from a torch
Generator seeded 0 (the flax initializers' laws: LeCun-normal kernels,
unit GroupNorm scales, zero biases). Either is a fixed random feature
extractor, not ImageNet-pretrained. `train.convert.trunk_state_dict_from_flax`
loads a flax trunk's parameters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GROUPS = 8
GN_EPS = 1e-6           # flax GroupNorm's epsilon
STAGES = {"18": (2, 2, 2, 2), "34": (3, 4, 6, 3)}


def _conv(cin, cout, k, stride, pad):
  return nn.Conv2d(cin, cout, k, stride, pad, bias=False)


def _norm(c):
  return nn.GroupNorm(GROUPS, c, eps=GN_EPS)


class BasicBlock(nn.Module):
  """conv3x3 - GN - relu - conv3x3 - GN, plus the input (through a 1x1
  conv and GN where the shape changes), relu."""

  def __init__(self, cin: int, cout: int, stride: int):
    super().__init__()
    self.conv0, self.norm0 = _conv(cin, cout, 3, stride, 1), _norm(cout)
    self.conv1, self.norm1 = _conv(cout, cout, 3, 1, 1), _norm(cout)
    self.proj = None
    if stride != 1 or cin != cout:
      self.proj = nn.Sequential(_conv(cin, cout, 1, stride, 0), _norm(cout))

  def forward(self, x):
    y = torch.relu(self.norm0(self.conv0(x)))
    y = self.norm1(self.conv1(y))
    return torch.relu(y + (x if self.proj is None else self.proj(x)))


class ResNetTrunk(nn.Module):
  """(B, H, W, 3) images (uint8, or float in [0, 255]) -> (B, 512)."""

  def __init__(self, stage_sizes: Sequence[int] = STAGES["18"]):
    super().__init__()
    self.stage_sizes = tuple(stage_sizes)
    self.stem = _conv(3, 64, 7, 2, 3)
    self.stem_norm = _norm(64)
    self.pool = nn.MaxPool2d(3, 2, 1)
    blocks, cin = [], 64
    for i, n in enumerate(self.stage_sizes):
      cout = 64 * 2 ** i
      for j in range(n):
        blocks.append(BasicBlock(cin, cout, 2 if (i > 0 and j == 0) else 1))
        cin = cout
    self.blocks = nn.ModuleList(blocks)
    self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                         persistent=False)
    self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

  def forward(self, img: torch.Tensor) -> torch.Tensor:
    x = img.to(torch.float32) / 255.0
    x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
    x = self.pool(torch.relu(self.stem_norm(self.stem(x))))
    for b in self.blocks:
      x = b(x)
    return x.mean((2, 3))


def init_trunk(trunk: ResNetTrunk, seed: int = 0) -> ResNetTrunk:
  """Draw `trunk`'s weights from a CPU torch.Generator seeded `seed`, so
  every device gets the same trunk: convolution kernels from a normal of
  variance 1 / fan_in truncated at two standard deviations (flax's
  lecun_normal), GroupNorm scales 1 and biases 0."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for mod in trunk.modules():
      if isinstance(mod, nn.Conv2d):
        w = mod.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        # flax's truncated normal: the std of a unit normal truncated at
        # +-2 is 0.87962566
        std = float(np.sqrt(1.0 / fan_in) / 0.87962566103423978)
        draw = torch.empty(w.shape).normal_(generator=gen)
        while bool((draw.abs() > 2.0).any()):
          bad = draw.abs() > 2.0
          draw[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
        w.copy_(draw * std)
      elif isinstance(mod, nn.GroupNorm):
        mod.weight.fill_(1.0)
        mod.bias.zero_()
  return trunk


def make_resnet_encoder(name: str, device=None, state_dict=None
                        ) -> ResNetTrunk:
  """The frozen trunk of encoder `name` (resnet18 / rrl18: ResNet-18;
  resnet34 / rrl34: ResNet-34) on `device`, in eval mode: `state_dict`'s
  weights, or the seed-0 draw."""
  trunk = ResNetTrunk(STAGES["18" if "18" in name else "34"])
  if state_dict is None:
    init_trunk(trunk)
  else:
    trunk.load_state_dict(state_dict)
  trunk = trunk.to(device).eval()
  trunk.requires_grad_(False)
  return trunk
