"""Visual observations: camera frames of a batch and their encodings.

The JAX package's `envs.visual`: visual keys are "rgb:<cam>:<H>x<W>:<enc>"
(or "d:..." for depth) strings; `1d` flattens a frame, `2d` passes it
through, and resnet18 / resnet34 / rrl18 / rrl34 embed it with a ResNet
trunk. Here every frame is drawn by the port's ray caster
(`renderer.Renderer`) for the whole batch at once on the device, and each
encoding comes out batch-first: 1d (B, H*W*C), 2d (B, H, W, C) (depth
with C = 1), the trunks (B, 512).

The trunks are the flax topology's (`visual_nets.ResNetTrunk`) at a fixed
seed-0 draw, not ImageNet-pretrained. The JAX package takes torchvision's
pretrained resnets when torchvision imports; the port has no torchvision
branch (their weights are a download). r3m and vc1 need external
checkpoints and raise; any callable on batched tensors can be passed in
`custom_encoders` instead.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import torch

TRUNKS = ("rrl18", "rrl34", "resnet18", "resnet34")


def parse_visual_key(key: str):
  """"rgb:view_1:224x224:r3m18" -> (channel, cam, (H, W), encoder)."""
  parts = key.split(":")
  assert len(parts) == 4, f"bad visual key {key!r}"
  channel, cam, hw, encoder = parts
  h, w = hw.lower().split("x")
  return channel, cam, (int(h), int(w)), encoder


def make_encoder(name: str, device=None) -> Callable:
  """The encoder `name` as a callable on (B, H, W, C) frames."""
  if name == "1d":
    return lambda img: img.reshape(img.shape[0], -1)
  if name == "2d":
    return lambda img: img
  if name in TRUNKS:
    warnings.warn(
        f"visual encoder {name!r} is an untrained fixed-seed ResNet trunk "
        "(random features, NOT ImageNet-pretrained). Pass a "
        "custom_encoders entry for pretrained features.", RuntimeWarning)
    from myosuite_tpu_torch.envs.visual_nets import make_resnet_encoder
    trunk = make_resnet_encoder(name, device)

    def encode(img: torch.Tensor) -> torch.Tensor:
      if img.shape[-1] != 3:
        raise ValueError(f"encoder {name!r} takes rgb frames, got "
                         f"{tuple(img.shape)}")
      with torch.no_grad():
        return trunk(img)
    return encode
  if name.startswith(("r3m", "vc1")):
    raise ValueError(
        f"encoder {name!r} needs external pretrained checkpoints "
        "(the reference downloads them); pass a custom_encoders entry "
        "instead")
  raise ValueError(f"unknown visual encoder {name!r}")


class VisualObs:
  """Render-and-encode pipeline over an env's model, batch-first."""

  def __init__(self, env, visual_keys: List[str],
               custom_encoders: Optional[Dict[str, Callable]] = None):
    self._env = env
    self._keys = [(k,) + parse_visual_key(k) for k in visual_keys]
    self._renderers: Dict[tuple, object] = {}
    custom = custom_encoders or {}
    self._encoders: Dict[str, Callable] = dict(custom)
    for _, _, _, _, enc in self._keys:
      if enc not in self._encoders:
        self._encoders[enc] = make_encoder(enc, env.model.device)

  def get_visuals(self, data) -> Dict[str, torch.Tensor]:
    """Every visual key's encoding for the whole batch of `data`, on its
    device; each (H, W) is posed once, each (H, W, camera, channel) drawn
    once."""
    from myosuite_tpu_torch.renderer import Renderer
    out, frames = {}, {}
    for key, channel, cam, hw, enc in self._keys:
      if hw not in self._renderers:
        h, w = hw
        self._renderers[hw] = Renderer(self._env, width=w, height=h)
      camera = None if cam in ("default", "-1") else cam
      view = (hw, camera, channel)
      if view not in frames:
        img = self._renderers[hw].render(data, camera=camera,
                                         depth=channel == "d")
        frames[view] = img[..., None] if channel == "d" else img
      out[key] = self._encoders[enc](frames[view])
    return out

  def close(self):
    self._renderers.clear()
