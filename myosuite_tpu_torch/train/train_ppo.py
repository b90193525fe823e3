"""Training CLI: PPO on a registered env, with checkpointing.

The JAX package's launcher with the same flags and output lines, plus
--device (default cuda; without CUDA it raises unless --device cpu is
given). The "[jit Ns]" line reports the first iteration's time, which on
the card includes building the CUDA kernel.

With --mesh the env batch is split over the ranks of a process group
(`parallel.mesh`): --num_envs is the global batch and must divide by the
world size; rank 0 alone prints and writes --ckpt, as a learner-only
checkpoint (the env state lives in pieces on the ranks). Without a group
in the environment --mesh trains at world size 1.

Usage:
  python -m myosuite_tpu_torch.train.train_ppo -e MtxHandReachRandom-v0 \\
      --num_timesteps 5000000 --num_envs 4096 [--ckpt DIR]
  torchrun --nproc_per_node=N -m myosuite_tpu_torch.train.train_ppo --mesh \\
      -e MtxHandReachRandom-v0 --num_envs 4096
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("-e", "--env_name", default="MtxElbowPoseRandom-v0")
  parser.add_argument("--num_timesteps", type=int, default=50_000_000)
  parser.add_argument("--num_envs", type=int, default=4096)
  parser.add_argument("--unroll_length", type=int, default=10)
  parser.add_argument("--num_minibatches", type=int, default=32)
  parser.add_argument("--learning_rate", type=float, default=3e-4)
  parser.add_argument("--num_evals", type=int, default=16)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--ckpt", default=None, help="checkpoint dir")
  parser.add_argument("--mesh", action="store_true",
                      help="shard env axis over all devices")
  parser.add_argument("--device", default="cuda",
                      help="torch device to train on (default cuda; with "
                      "--mesh, cuda is each rank's card cuda:$LOCAL_RANK)")
  parser.add_argument("--init_method", default=None,
                      help="--mesh rendezvous URL (default env://, which "
                      "torchrun fills in)")
  args = parser.parse_args(argv)

  import torch
  import torch.distributed as dist

  import myosuite_tpu_torch
  from myosuite_tpu_torch.parallel import mesh as mesh_mod
  from myosuite_tpu_torch.train import checkpoint
  from myosuite_tpu_torch.train import ppo as ppo_mod

  mesh = None
  joined = dist.is_initialized()     # a group of the caller's is kept
  if args.mesh:
    mesh_mod.initialize_distributed(init_method=args.init_method,
                                    device=args.device)
    mesh = mesh_mod.make_mesh(args.device)
    mesh_mod.local_env_slice(mesh, args.num_envs)   # raises if uneven
    if mesh.group is None:
      mesh = None        # no group: the single-rank path
  rank0 = mesh is None or mesh.rank == 0
  device = args.device if mesh is None else mesh.device

  env = myosuite_tpu_torch.make(args.env_name, device=device)
  cfg = ppo_mod.default_config()
  cfg.num_timesteps = args.num_timesteps
  cfg.num_envs = args.num_envs
  cfg.unroll_length = args.unroll_length
  cfg.num_minibatches = args.num_minibatches
  cfg.learning_rate = args.learning_rate
  cfg.num_evals = args.num_evals
  cfg.seed = args.seed

  ppo = ppo_mod.PPO(env, cfg)
  ts = ppo.init(torch.Generator(device=env.device).manual_seed(cfg.seed))
  steps_per_call = max(1, cfg.num_timesteps // (
      cfg.num_evals * cfg.unroll_length * cfg.num_envs))
  if mesh is None:
    train_fn = ppo.make_training_fn(steps_per_call)
  else:
    ts = mesh_mod.place(ts, ppo, mesh)
    train_fn = mesh_mod.make_distributed_training_fn(ppo, ts, mesh,
                                                     steps_per_call)
  say = (lambda line: print(line, flush=True)) if rank0 else (
      lambda line: None)

  say(f"training {args.env_name}: {cfg.num_timesteps:,} steps, "
      f"{cfg.num_envs} envs, {1 if mesh is None else mesh.world_size} "
      "device(s)")
  t0 = time.time()
  compile_done = None
  for it in range(cfg.num_evals):
    ts, metrics = train_fn(ts)
    m = {k: float(v) for k, v in metrics.items()}   # waits for the device
    if compile_done is None:
      compile_done = time.time()
      say(f"[jit {compile_done - t0:.0f}s]")
    sps = ts.env_steps / max(time.time() - compile_done, 1e-9)
    say(f"steps={ts.env_steps:,} ep_return={m['episode_return']:.2f} "
        f"reward/step={m['reward_per_step']:.3f} "
        f"entropy={m['entropy']:.2f} ({sps:,.0f} steps/s)")
    if args.ckpt and rank0:
      checkpoint.save(args.ckpt, ts, step=ts.env_steps,
                      learner_only=mesh is not None)

  wall = time.time() - t0
  say(json.dumps({"env": args.env_name, "steps": ts.env_steps,
                  "wall_clock_s": round(wall, 1)}))
  if mesh is not None and not joined:
    dist.destroy_process_group()


if __name__ == "__main__":
  main()
