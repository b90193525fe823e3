"""examine_logs CLI: print a saved rollout trace, or replay it.

The JAX package's `logger.examine_logs`: load a Trace (.h5, .pkl or .mtp),
print its structure, and in playback mode recompute each logged step's
rewards by settling the logged qpos / qvel through the env's physics and
its reward function. The port settles every step of a group as one batch.
--mode render (or --video) draws the first group's qpos sequence with the
port's ray caster as one batch (`renderer.render_qpos_sequence`).

Usage:
  python -m myosuite_tpu_torch.logger.examine_logs -t rollouts.mtp \\
      [-e <env id> --mode playback|render] [--video out.mp4] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from myosuite_tpu_torch.parallel.mesh import take_rows
from myosuite_tpu_torch.physics import forward
from myosuite_tpu_torch.physics import io as physics_io


def playback(env, trace, group: str) -> List[Dict[str, float]]:
  """Each logged step's rewards, {name: value} per step, recomputed from
  the group's qpos and qvel (T, n) with the task info of one reset
  (seed 0), as the JAX package replays them."""
  dev = env.device
  qpos = torch.as_tensor(np.asarray(trace[group]["qpos"]),
                         dtype=torch.float32, device=dev)
  qvel = torch.as_tensor(np.asarray(trace[group]["qvel"]),
                         dtype=torch.float32, device=dev)
  steps = qpos.shape[0]
  m = env.model
  d = physics_io.make_data(m, steps).replace(qpos=qpos, qvel=qvel)
  d = forward.fwd_velocity(m, forward.fwd_position(m, d))
  state = env.reset(torch.Generator(dev).manual_seed(0), 1)
  info = take_rows(state.info, torch.zeros(steps, dtype=torch.long,
                                           device=dev), 1)
  rewards = {k: v.expand(steps).tolist()
             for k, v in env._get_rewards(d, info).items()}
  return [{k: v[t] for k, v in rewards.items()} for t in range(steps)]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("-t", "--trace", required=True)
  parser.add_argument("-e", "--env_name", default=None)
  parser.add_argument("--mode", default="print",
                      choices=["print", "playback", "render"])
  parser.add_argument("--video", default=None)
  parser.add_argument("--device", default="cuda",
                      help="torch device of the playback (default cuda)")
  args = parser.parse_args(argv)

  from myosuite_tpu_torch.logger.trace import Trace

  tr = Trace.load(args.trace)
  print(tr)
  if args.mode == "playback":
    if not args.env_name:
      parser.error("--env_name is required for playback")
    import myosuite_tpu_torch
    env = myosuite_tpu_torch.make(args.env_name, device=args.device)
    for group in tr.keys():
      if "qpos" not in tr[group]:
        print(f"{group}: no qpos stream, skipping")
        continue
      rewards = playback(env, tr, group)
      total = sum(sum(r.values()) for r in rewards)
      print(f"{group}: {len(rewards)} steps, recomputed reward sum "
            f"{total:.3f}")

  if args.mode == "render" or args.video:
    if not args.env_name:
      parser.error("--env_name is required for render")
    import myosuite_tpu_torch
    from myosuite_tpu_torch.renderer import render_qpos_sequence
    env = myosuite_tpu_torch.make(args.env_name, device=args.device)
    group = next(iter(tr.keys()))
    out = args.video or "examine_logs.mp4"
    render_qpos_sequence(env, np.asarray(tr[group]["qpos"]), out,
                         fps=int(round(1.0 / env.dt)))
    print(f"saved video: {out}")


if __name__ == "__main__":
  main()
