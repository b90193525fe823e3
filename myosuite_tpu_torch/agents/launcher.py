"""Training sweep launcher: envs x seeds, one output directory per job.

The JAX package's launcher with the same flags, files and printed JSON,
plus --device (default cuda; without CUDA it raises unless --device cpu
is given). Each job writes config.json, metrics.jsonl and result.json and
a final checkpoint under final/; a PPO job also writes train.log and
periodic checkpoints under ckpt/. Jobs run one after another on the
device.

Usage:
  python -m myosuite_tpu_torch.agents.launcher --envs MtxElbowPoseRandom-v0 \\
      MtxFingerPoseRandom-v0 --seeds 0 1 2 --num_timesteps 2000000 \\
      --output_dir sweep_output
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def _progress_writer(path: str):
  def progress(steps, m):
    with open(path, "a") as f:
      f.write(json.dumps({"steps": steps,
                          **{k: float(v) for k, v in m.items()}}) + "\n")
  return progress


def run_job(env_name: str, seed: int, out_dir: str, num_timesteps: int,
            num_envs: int, num_evals: int, algo: str = "ppo",
            device: str = "cuda") -> dict:
  import myosuite_tpu_torch
  from myosuite_tpu_torch.train import callbacks as cb
  from myosuite_tpu_torch.train import checkpoint

  os.makedirs(out_dir, exist_ok=True)
  env = myosuite_tpu_torch.make(env_name, device=device)
  if algo in ("sac", "npg"):
    from myosuite_tpu_torch.train import npg as npg_mod
    from myosuite_tpu_torch.train import sac as sac_mod
    mod = sac_mod if algo == "sac" else npg_mod
  else:
    from myosuite_tpu_torch.train import ppo as mod
  cfg = mod.default_config()
  cfg.num_timesteps = num_timesteps
  cfg.num_envs = num_envs
  cfg.num_evals = num_evals
  cfg.seed = seed
  head = {"env": env_name, "seed": seed}
  if algo != "ppo":
    head["algo"] = algo
  with open(os.path.join(out_dir, "config.json"), "w") as f:
    json.dump({**head, **dataclasses.asdict(cfg)}, f, indent=2)
  progress = _progress_writer(os.path.join(out_dir, "metrics.jsonl"))

  if algo != "ppo":
    _, ts = mod.train(env, cfg, progress_fn=progress)
    checkpoint.save(os.path.join(out_dir, "final"), ts, step=ts.env_steps)
    result = {**head, "steps": ts.env_steps}
  else:
    eval_cb = cb.EvalCallback(env, num_episodes=8,
                              every=max(num_evals // 5, 1))
    cbs = [cb.InfoCallback(log_file=os.path.join(out_dir, "train.log")),
           cb.FallbackCheckpoint(os.path.join(out_dir, "ckpt"),
                                 every=max(num_evals // 3, 1)),
           eval_cb]
    _, ts, stats = mod.train(env, cfg, progress_fn=progress, callbacks=cbs)
    checkpoint.save(os.path.join(out_dir, "final"), ts, step=stats["steps"])
    result = {**stats, **head, "eval_history": eval_cb.history}
  with open(os.path.join(out_dir, "result.json"), "w") as f:
    json.dump(result, f, indent=2)
  return result


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--envs", nargs="+", required=True)
  parser.add_argument("--seeds", nargs="+", type=int, default=[0])
  parser.add_argument("--num_timesteps", type=int, default=5_000_000)
  parser.add_argument("--num_envs", type=int, default=2048)
  parser.add_argument("--num_evals", type=int, default=20)
  parser.add_argument("--output_dir", default="./sweep_output")
  parser.add_argument("--algo", choices=("ppo", "sac", "npg"),
                      default="ppo")
  parser.add_argument("--device", default="cuda",
                      help="torch device to train on (default cuda)")
  args = parser.parse_args(argv)

  results = []
  for env_name in args.envs:
    for seed in args.seeds:
      out = os.path.join(args.output_dir,
                         f"{env_name.replace('-', '_')}_seed{seed}")
      print(f"=== {env_name} seed {seed} -> {out}")
      results.append(run_job(env_name, seed, out, args.num_timesteps,
                             args.num_envs, args.num_evals, args.algo,
                             args.device))
  print(json.dumps([{k: v for k, v in r.items() if k != "eval_history"}
                    for r in results], indent=2))
  return results


if __name__ == "__main__":
  main()
