"""render_cams CLI: offscreen snapshots of every camera of an env.

The JAX package's `utils.render_cams`: render every (or the named) camera
of an env's reset state (the free camera when the model has none) to
PNGs, and optionally a side-by-side composite. Frames come from the
port's ray caster (`renderer.Renderer`) on the device.

Usage:
  python -m myosuite_tpu_torch.utils.render_cams -e MtxHandReachRandom-v0 \\
      -o cams [-c cam1 cam2] [--tile] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def render_all_cams(env, cameras=None, width: int = 400, height: int = 300
                    ):
  """{camera name, or "free": (H, W, 3) uint8 numpy} of one reset state
  (seed 0); every camera of the model when `cameras` is None."""
  from myosuite_tpu_torch.renderer import Renderer
  from myosuite_tpu_torch.renderer.renderer import camera_names
  if cameras is None:
    cameras = camera_names(env.model) or [None]
  state = env.reset(torch.Generator(env.device).manual_seed(0), 1)
  r = Renderer(env, width=width, height=height)
  return {cam or "free": r.render(state.data, camera=cam)[0].cpu().numpy()
          for cam in cameras}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("-e", "--env_name", required=True)
  parser.add_argument("-c", "--cameras", nargs="*", default=None)
  parser.add_argument("-o", "--output", default="./cams")
  parser.add_argument("--tile", action="store_true",
                      help="also write a side-by-side composite")
  parser.add_argument("--device", default="cuda",
                      help="torch device to render on (default cuda)")
  args = parser.parse_args(argv)

  import imageio

  import myosuite_tpu_torch

  env = myosuite_tpu_torch.make(args.env_name, device=args.device)
  frames = render_all_cams(env, args.cameras)
  os.makedirs(args.output, exist_ok=True)
  for cam, img in frames.items():
    path = os.path.join(args.output, f"{cam}.png")
    imageio.imwrite(path, img)
    print(f"saved {path}")
  if args.tile and len(frames) > 1:
    path = os.path.join(args.output, "tiled.png")
    imageio.imwrite(path, np.concatenate(list(frames.values()), axis=1))
    print(f"saved {path}")


if __name__ == "__main__":
  main()
