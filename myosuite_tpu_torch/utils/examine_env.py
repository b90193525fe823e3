"""examine_env CLI: roll out a policy on an env, report success%, save a
trace.

The JAX package's `utils.examine_env`: load an env and a policy (a PPO
checkpoint directory, or uniform random actions), run N episodes, print
success% (an episode succeeds when `solved` holds for more than 5 steps,
counted up to and including its first done) and the mean return, and save
the episodes as a Trace (.h5, .pkl or .mtp by the path's extension). The
JAX CLI runs the episodes one after another; the port runs all N as one
batch on the device and cuts each episode at its first done afterwards.
--video draws every episode's steps, one after another, with the port's
ray caster (`renderer`) as one batch and writes them with imageio (an mp4
needs imageio's ffmpeg, a .gif only pillow). --render onscreen shows the
first episode (row 0 of the batch) step by step in MuJoCo's passive viewer
(`renderer.PassiveViewer`); where it cannot open (no display, no MuJoCo)
it prints why and runs headless, as the JAX CLI does: only the viewer is
given up, never the device.

Usage:
  python -m myosuite_tpu_torch.utils.examine_env -e MtxElbowPoseRandom-v0 \\
      -n 64 [-p <ppo checkpoint step dir>] [--trace out.mtp] \\
      [--video out.mp4] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import numpy as np
import torch

MIN_SOLVED_STEPS = 5


POSE_FIELDS = ("qpos", "mocap_pos", "mocap_quat")


def rollout_episodes(env, policy_fn: Callable, num_episodes: int,
                     horizon: int, generator: torch.Generator,
                     poses: bool = False,
                     viewer=None) -> Dict[str, torch.Tensor]:
  """`horizon` control steps of `num_episodes` fresh episodes as one batch
  of the plain env, actions policy_fn(obs, generator): the stacked
  (T, B, ...) obs, reward, solved and done after each step; with `poses`
  also the POSE_FIELDS after each step and the reset's heightfields
  ("hfield", (B, nrow, ncol)), which a rendering reads. A `viewer`
  (`renderer.PassiveViewer`) shows row 0 after each step while its window
  is open."""
  rec = {"obs": [], "reward": [], "solved": [], "done": []}
  if poses:
    rec.update({k: [] for k in POSE_FIELDS})
  with torch.no_grad():
    state = env.reset(generator, num_episodes)
    hfield = state.data.hfield_data
    for _ in range(horizon):
      state = env.step(state, policy_fn(state.obs["state"], generator))
      rec["obs"].append(state.obs["state"])
      rec["reward"].append(state.reward)
      rec["solved"].append(state.metrics.get(
          "solved", torch.zeros_like(state.reward)))
      rec["done"].append(state.done)
      if viewer is not None and viewer.is_running():
        viewer.sync(state.data)
      if poses:
        for k in POSE_FIELDS:
          rec[k].append(getattr(state.data, k))
  out = {k: torch.stack(v) for k, v in rec.items()}
  if poses:
    out["hfield"] = hfield
  return out


def episode_frames(env, rec: Dict[str, torch.Tensor], camera=None,
                   width: int = 640, height: int = 480) -> torch.Tensor:
  """rgb frames (F, H, W, 3) uint8 of every episode's steps up to its
  length, episode after episode, drawn as one batch from a
  `rollout_episodes(..., poses=True)` record."""
  from myosuite_tpu_torch.renderer import Renderer
  from myosuite_tpu_torch.renderer.renderer import pose_data
  lengths = episode_lengths(rec["done"]).tolist()
  dev = rec["qpos"].device
  ep = torch.cat([torch.full((n,), i, dtype=torch.long, device=dev)
                  for i, n in enumerate(lengths)])
  t = torch.cat([torch.arange(n, device=dev) for n in lengths])
  d = pose_data(env.model, rec["qpos"][t, ep], rec["mocap_pos"][t, ep],
                rec["mocap_quat"][t, ep], rec["hfield"][ep])
  return Renderer(env, width=width, height=height).render(d, camera=camera)


def episode_lengths(done: torch.Tensor) -> torch.Tensor:
  """(B,) steps of each episode: up to and including its first done, the
  whole horizon when it has none."""
  before = torch.cumsum((done > 0).to(torch.int64), 0) - (done > 0).to(
      torch.int64)
  return (before == 0).sum(0)


def successes(solved: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
  """(B,) bool: more than MIN_SOLVED_STEPS solved steps within each
  episode's length."""
  t = torch.arange(solved.shape[0], device=solved.device)[:, None]
  inside = t < episode_lengths(done)[None, :]
  return ((solved > 0) & inside).sum(0) > MIN_SOLVED_STEPS


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("-e", "--env_name", required=True)
  parser.add_argument("-p", "--policy_path", default=None,
                      help="PPO checkpoint step directory (none: uniform "
                      "random actions)")
  parser.add_argument("-n", "--num_episodes", type=int, default=3)
  parser.add_argument("--horizon", type=int, default=None)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--trace", default=None,
                      help="save the episodes here (.h5, .pkl or .mtp)")
  parser.add_argument("--video", default=None, help="save an mp4 here")
  parser.add_argument("--render", default="none",
                      choices=["none", "onscreen"])
  parser.add_argument("--device", default="cuda",
                      help="torch device to run on (default cuda)")
  args = parser.parse_args(argv)

  import myosuite_tpu_torch

  env = myosuite_tpu_torch.make(args.env_name, device=args.device)
  viewer = None
  if args.render == "onscreen":
    from myosuite_tpu_torch.renderer import PassiveViewer
    try:
      viewer = PassiveViewer(env)
    except Exception as e:   # headless box: report and run headless
      print(f"onscreen viewer unavailable ({e}); running headless")
  horizon = args.horizon or env.max_episode_steps
  if args.policy_path:
    from myosuite_tpu_torch.agents import pretrained
    trainer, ts = pretrained.load_path(args.policy_path, env)
    pol = trainer.make_policy_fn(deterministic=True)
    policy_fn = lambda obs, gen: pol(ts, obs)
  else:
    policy_fn = lambda obs, gen: 2.0 * torch.rand(
        obs.shape[0], env.action_size, generator=gen,
        device=obs.device) - 1.0

  gen = torch.Generator(env.device).manual_seed(args.seed)
  rec = rollout_episodes(env, policy_fn, args.num_episodes, horizon, gen,
                         poses=bool(args.video), viewer=viewer)
  if viewer is not None:
    viewer.close()
  lengths = episode_lengths(rec["done"]).tolist()
  won = successes(rec["solved"], rec["done"])
  host = {k: v.cpu().numpy() for k, v in rec.items()}
  returns = [float(host["reward"][:n, i].sum())
             for i, n in enumerate(lengths)]
  print(f"episodes: {args.num_episodes}  success%: "
        f"{100 * float(won.float().mean()):.1f}  mean return: "
        f"{np.mean(returns):.2f}")

  if args.trace:
    from myosuite_tpu_torch.logger.trace import Trace
    tr = Trace("rollouts")
    for i, n in enumerate(lengths):
      g = f"rollout{i}"
      tr.create_group(g)
      tr.trace[g]["observations"] = host["obs"][:n, i]
      tr.trace[g]["rewards"] = host["reward"][:n, i]
      tr.trace[g]["solved"] = host["solved"][:n, i]
    tr.save(args.trace)
    print(f"saved trace: {args.trace}")

  if args.video:
    from myosuite_tpu_torch.renderer.renderer import save_video
    frames = episode_frames(env, rec).cpu().numpy()
    save_video(args.video, frames, int(round(1.0 / env.dt)))
    print(f"saved video: {args.video} ({len(frames)} frames)")


if __name__ == "__main__":
  main()
