"""Training callbacks: info logging, fallback checkpoints, periodic eval.

The JAX package's callbacks, in the role of the reference's SB3 callbacks:
InfoCallback (metric logging), FallbackCheckpoint (periodic saves to resume
a crashed run), EvalCallback (deterministic rollouts reporting success %),
SaveSuccesses (a checkpoint when eval success crosses a threshold) and
TensorBoardCallback.

Callbacks receive (iteration, env_steps, metrics, ppo, train_state) after
every outer training iteration; metrics are floats.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch


class Callback:
  def on_iteration(self, it: int, env_steps: int, metrics: Dict,
                   ppo, ts) -> None:
    ...


class InfoCallback(Callback):
  """Print training metrics every `every` iterations."""

  def __init__(self, every: int = 1, log_file: Optional[str] = None):
    self._every = every
    self._log = log_file
    self._t0 = time.time()

  def on_iteration(self, it, env_steps, metrics, ppo, ts):
    if it % self._every:
      return
    sps = env_steps / max(time.time() - self._t0, 1e-9)
    line = (f"iter {it}  steps {env_steps:,}  {sps:,.0f} steps/s  "
            + "  ".join(f"{k}={float(v):.4g}" for k, v in
                        sorted(metrics.items())))
    print(line, flush=True)
    if self._log:
      with open(self._log, "a") as f:
        f.write(line + "\n")


class FallbackCheckpoint(Callback):
  """Save the train state every `every` iterations, so that a crashed run
  resumes."""

  def __init__(self, ckpt_dir: str, every: int = 10,
               learner_only: bool = False):
    self._dir = ckpt_dir
    self._every = every
    self._learner_only = learner_only

  def on_iteration(self, it, env_steps, metrics, ppo, ts):
    if it % self._every:
      return
    from myosuite_tpu_torch.train import checkpoint
    checkpoint.save(self._dir, ts, step=env_steps,
                    learner_only=self._learner_only)


def deterministic_rollout(env, policy_fn, ts, generator: torch.Generator,
                          batch: int, horizon: int, on_step=None):
  """`horizon` control steps of `batch` fresh episodes of the plain `env`
  under `policy_fn(ts, obs)`: (returns (B,), solved flags (B, horizon)).
  Steps after an episode's first done count neither reward nor solved
  steps. `on_step(i, state)` sees the state after each step."""
  with torch.no_grad():
    st = env.reset(generator, batch)
    alive = torch.ones(batch, device=env.device)
    total = torch.zeros(batch, device=env.device)
    solved = []
    for i in range(horizon):
      st = env.step(st, policy_fn(ts, st.obs["state"]))
      if on_step is not None:
        on_step(i, st)
      is_solved = st.metrics.get("solved", torch.zeros_like(alive)) > 0
      solved.append(alive * is_solved)
      total = total + st.reward * alive
      alive = alive * (1.0 - st.done)
  return total, torch.stack(solved, 1)


class EvalCallback(Callback):
  """Deterministic eval episodes, all `num_episodes` as one batch of `env`,
  reporting the mean return and success % (an episode with more than 5
  solved steps succeeds). Steps after an episode's done count neither
  reward nor solved steps."""

  def __init__(self, env, num_episodes: int = 8, every: int = 5):
    self._env = env
    self._n = num_episodes
    self._every = every
    self.history: List[Dict] = []

  def evaluate(self, ppo, ts, generator: torch.Generator):
    """(mean return, success rate) as device tensors."""
    returns, solved = deterministic_rollout(
        self._env, ppo.make_policy_fn(deterministic=True), ts, generator,
        self._n, self._env.max_episode_steps)
    return returns.mean(), (solved.sum(1) > 5).to(torch.float32).mean()

  def on_iteration(self, it, env_steps, metrics, ppo, ts):
    if it % self._every:
      return
    gen = torch.Generator(device=self._env.device).manual_seed(it)
    ret, succ = self.evaluate(ppo, ts, gen)
    entry = {"iteration": it, "env_steps": env_steps,
             "eval_return": float(ret), "success_rate": float(succ)}
    self.history.append(entry)
    print(f"  eval@{env_steps:,}: return {entry['eval_return']:.2f}  "
          f"success {100 * entry['success_rate']:.0f}%", flush=True)


class SaveSuccesses(Callback):
  """Save a checkpoint whenever eval success reaches `threshold` and beats
  the best so far."""

  def __init__(self, eval_cb: EvalCallback, ckpt_dir: str,
               threshold: float = 0.8):
    self._eval = eval_cb
    self._dir = ckpt_dir
    self._th = threshold
    self._best = 0.0

  def on_iteration(self, it, env_steps, metrics, ppo, ts):
    if not self._eval.history:
      return
    succ = self._eval.history[-1]["success_rate"]
    if succ >= self._th and succ > self._best:
      self._best = succ
      from myosuite_tpu_torch.train import checkpoint
      path = checkpoint.save(
          os.path.join(self._dir, f"success_{int(100 * succ)}"), ts,
          step=env_steps)
      print(f"  saved success checkpoint ({100 * succ:.0f}%): {path}",
            flush=True)


class TensorBoardCallback(Callback):
  """Stream training metrics to TensorBoard event files; warns and does
  nothing if tensorboard cannot be imported."""

  def __init__(self, log_dir: str):
    try:
      from torch.utils.tensorboard import SummaryWriter
      self._writer = SummaryWriter(log_dir)
    except ImportError as e:
      import warnings
      warnings.warn(f"tensorboard unavailable ({e}); metrics not streamed")
      self._writer = None

  def on_iteration(self, it, env_steps, metrics, ppo, ts):
    if self._writer is None:
      return
    for k, v in metrics.items():
      self._writer.add_scalar(f"train/{k}", float(v), env_steps)
    self._writer.flush()

  def close(self):
    if self._writer is not None:
      self._writer.close()
