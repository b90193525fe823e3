"""SAC trainer: off-policy soft actor-critic with a replay buffer on the
device.

The JAX package's SAC with its hyperparameters (SB3's: tau 0.005,
discount 0.99, lr 3e-4, batch 256, an entropy temperature tuned to a
target entropy). Where the JAX package jits one epoch (collection, then
`grad_updates_per_epoch` updates, each with a soft target update), the port
runs the same epoch as eager PyTorch on the env's device; nothing on that
path reads a value back to the host. Like the port's PPO, the updates wait
for `learning_starts` on the host's count of env steps (the JAX package
tests it inside the jitted epoch).

Three plain Adam optimizers (policy, critics, temperature), without the
clip and the non-finite guard of PPO's. The critics' target carries no
gradient; the actor's loss reads the critics after this update's critic
step and its gradient reaches only the policy; the temperature's gradient
is written out, with SB3's sign: alpha falls while the policy's entropy is
above the target.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from myosuite_tpu_torch.envs.base import State
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.train import networks, running_stats
from myosuite_tpu_torch.train.ppo import (AdamState, adam_update,
                                          check_generator, init_adam)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(slots=True)
class Config:
  """SAC hyperparameters; fields of the JAX package's default_config."""
  num_timesteps: int = 2_000_000
  num_envs: int = 256               # parallel collectors
  unroll_length: int = 4            # env steps per epoch (per env)
  learning_rate: float = 3e-4
  discounting: float = 0.99
  tau: float = 0.005                # soft target-update rate
  batch_size: int = 256
  grad_updates_per_epoch: int = 8
  replay_capacity: int = 2 ** 18
  learning_starts: int = 10_000     # env steps before updates begin
  reward_scaling: float = 1.0
  normalize_observations: bool = True
  policy_hidden: Tuple[int, ...] = (256, 256)
  q_hidden: Tuple[int, ...] = (256, 256)
  init_alpha: float = 1.0
  # target entropy = -action_size * target_entropy_scale
  target_entropy_scale: float = 0.5
  num_evals: int = 10
  seed: int = 0


def default_config() -> Config:
  return Config()


class QNet(nn.Module):
  """Twin Q(s, a) critics: two swish MLPs on [obs, action], their outputs
  stacked as (2, ...)."""

  def __init__(self, obs_dim: int, action_size: int,
               hidden=(256, 256)):
    super().__init__()
    self.critics = nn.ModuleList(
        networks.MLP(obs_dim + action_size, (*hidden, 1)) for _ in range(2))

  def reset_parameters(self, generator: torch.Generator) -> None:
    for c in self.critics:
      c.reset_parameters(generator)

  def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    x = torch.cat([obs, action], dim=-1)
    return torch.stack([c(x).squeeze(-1) for c in self.critics])


@dataclasses.dataclass
class ReplayBuffer:
  """Fixed-capacity ring of transitions on the device. Rows go in as
  aligned blocks of unroll_length * num_envs, so the capacity is a multiple
  of the block; `ptr` counts blocks, `size` valid rows (host ints)."""
  obs: torch.Tensor        # (C, obs_dim)
  action: torch.Tensor     # (C, act_dim)
  reward: torch.Tensor     # (C,)
  next_obs: torch.Tensor   # (C, obs_dim)
  done: torch.Tensor       # (C,) terminal (excludes truncation)
  ptr: int
  size: int

  @property
  def nbytes(self) -> int:
    return sum(t.numel() * t.element_size() for t in
               (self.obs, self.action, self.reward, self.next_obs,
                self.done))


@dataclasses.dataclass
class SACState:
  policy_params: Params
  q_params: Params
  q_target_params: Params
  log_alpha: torch.Tensor       # () float32
  policy_opt: AdamState
  q_opt: AdamState
  alpha_opt: AdamState
  obs_stats: running_stats.RunningStats
  buffer: ReplayBuffer
  env_state: State
  generator: torch.Generator
  env_steps: int

  def replace(self, **kw) -> "SACState":
    return dataclasses.replace(self, **kw)


class SAC:
  """Collection and updates of SAC for one env."""

  def __init__(self, env, config: Optional[Config] = None):
    self.cfg = config or default_config()
    cfg = self.cfg
    if cfg.replay_capacity % (cfg.unroll_length * cfg.num_envs):
      raise ValueError("replay_capacity must be a multiple of "
                       "unroll_length * num_envs")
    self.env = AutoResetWrapper(env)
    self.device = env.device
    self.target_entropy = -float(env.action_size) * cfg.target_entropy_scale
    self.policy = self.q = None   # built by init(), which knows obs_dim

  # -- init ---------------------------------------------------------------
  def build_networks(self, obs_dim: int) -> None:
    cfg, act = self.cfg, self.env.action_size
    self.policy = networks.PolicyNet(obs_dim, act, tuple(
        cfg.policy_hidden)).to(self.device)
    self.q = QNet(obs_dim, act, tuple(cfg.q_hidden)).to(self.device)

  def init(self, generator: torch.Generator) -> SACState:
    """Reset the envs, then draw the policy's and the critics' weights,
    all from `generator` (on the env's device)."""
    cfg = self.cfg
    check_generator(generator, self.device)
    env_state = self.env.reset(generator, cfg.num_envs)
    obs_dim = env_state.obs["state"].shape[-1]
    act_dim = self.env.action_size
    self.build_networks(obs_dim)
    self.policy.mlp.reset_parameters(generator)
    self.q.reset_parameters(generator)
    pp, qp = [{k: v.detach().clone() for k, v in net.state_dict().items()}
              for net in (self.policy, self.q)]
    cap, dev = cfg.replay_capacity, self.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    buffer = ReplayBuffer(obs=zeros(cap, obs_dim), action=zeros(cap, act_dim),
                          reward=zeros(cap), next_obs=zeros(cap, obs_dim),
                          done=zeros(cap), ptr=0, size=0)
    log_alpha = torch.log(torch.tensor(cfg.init_alpha, dtype=torch.float32,
                                       device=dev))
    return SACState(
        policy_params=pp, q_params=qp,
        q_target_params={k: v.clone() for k, v in qp.items()},
        log_alpha=log_alpha,
        policy_opt=init_adam([networks.flat_params(pp)]),
        q_opt=init_adam([networks.flat_params(qp)]),
        alpha_opt=init_adam([log_alpha]),
        obs_stats=running_stats.init(obs_dim, dev), buffer=buffer,
        env_state=env_state, generator=generator, env_steps=0)

  # -- networks -----------------------------------------------------------
  def _norm_obs(self, stats, obs):
    if not self.cfg.normalize_observations:
      return obs
    return running_stats.normalize(stats, obs)

  def apply_policy(self, params: Params, nobs: torch.Tensor):
    return functional_call(self.policy, params, (nobs,))

  def apply_q(self, params: Params, nobs: torch.Tensor,
              action: torch.Tensor) -> torch.Tensor:
    return functional_call(self.q, params, (nobs, action))

  # -- collection ---------------------------------------------------------
  def _collect(self, ts: SACState) -> SACState:
    """`unroll_length` env steps under the stochastic policy, written as
    one block at the ring's pointer (in place: the ring's tensors are
    shared with `ts`, not copied)."""
    cfg = self.cfg
    check_generator(ts.generator, self.device)
    env_state, rows = ts.env_state, []
    with torch.no_grad():
      for _ in range(cfg.unroll_length):
        obs = env_state.obs["state"]
        mean, log_std = self.apply_policy(ts.policy_params,
                                          self._norm_obs(ts.obs_stats, obs))
        action, _ = networks.sample_action(mean, log_std, ts.generator)
        env_state = self.env.step(env_state, action)
        rows.append((obs, action, env_state.reward * cfg.reward_scaling,
                     env_state.info["terminal_obs"],
                     env_state.done * (1.0 - env_state.info["truncation"])))
      cols = [torch.stack(c) for c in zip(*rows)]     # (T, B, ...)
      block = cfg.unroll_length * cfg.num_envs
      buf = ts.buffer
      start = buf.ptr * block
      fields = ("obs", "action", "reward", "next_obs", "done")
      for name, c in zip(fields, cols):
        getattr(buf, name)[start:start + block] = c.reshape(
            (block,) + c.shape[2:])
      buffer = dataclasses.replace(
          buf, ptr=(buf.ptr + 1) % (cfg.replay_capacity // block),
          size=min(buf.size + block, cfg.replay_capacity))
      stats = ts.obs_stats
      if cfg.normalize_observations:
        stats = running_stats.update(stats, cols[0])
    return ts.replace(env_state=env_state, buffer=buffer, obs_stats=stats,
                      env_steps=ts.env_steps + block)

  # -- losses -------------------------------------------------------------
  def _critic_loss(self, q_params: Params, ts: SACState, batch,
                   noise: torch.Tensor) -> torch.Tensor:
    """Twin-critic TD loss; the target (target critics, policy, alpha)
    carries no gradient. `noise`: the normals of the next action."""
    obs, action, reward, next_obs, done = batch
    nobs = self._norm_obs(ts.obs_stats, obs)
    n_next = self._norm_obs(ts.obs_stats, next_obs)
    with torch.no_grad():
      mean, log_std = self.apply_policy(ts.policy_params, n_next)
      next_a, next_logp = networks.sample_action(mean, log_std, noise=noise)
      q_next = self.apply_q(ts.q_target_params, n_next, next_a).amin(0)
      alpha = torch.exp(ts.log_alpha)
      target = reward + self.cfg.discounting * (1.0 - done) * (
          q_next - alpha * next_logp)
    q_pred = self.apply_q(q_params, nobs, action)   # (2, batch)
    return torch.mean((q_pred - target[None]) ** 2)

  def _actor_loss(self, policy_params: Params, ts: SACState, batch,
                  noise: torch.Tensor):
    """(mean(alpha logp - min Q), mean logp); the critics are constants
    here (the gradient reaches only `policy_params`)."""
    nobs = self._norm_obs(ts.obs_stats, batch[0])
    mean, log_std = self.apply_policy(policy_params, nobs)
    action, logp = networks.sample_action(mean, log_std, noise=noise)
    q_params = {k: v.detach() for k, v in ts.q_params.items()}
    q = self.apply_q(q_params, nobs, action).amin(0)
    alpha = torch.exp(ts.log_alpha).detach()
    return torch.mean(alpha * logp - q), torch.mean(logp)

  # -- update -------------------------------------------------------------
  def draws(self, ts: SACState):
    """The random draws of one update: the batch's row indices and the
    normals of the critic's and the actor's sampled actions."""
    cfg, g, dev = self.cfg, ts.generator, self.device
    idx = torch.randint(0, max(ts.buffer.size, 1), (cfg.batch_size,),
                        generator=g, device=dev)
    shape = (cfg.batch_size, self.env.action_size)
    return (idx, torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))

  def _one_update(self, ts: SACState, draws=None
                  ) -> Tuple[SACState, Dict[str, torch.Tensor]]:
    """Critic step, actor step (on the new critics), temperature step and
    soft target update on one minibatch. `draws`: (idx, critic normals,
    actor normals), else drawn from ts.generator."""
    cfg = self.cfg
    idx, noise_q, noise_pi = draws if draws is not None else self.draws(ts)
    buf = ts.buffer
    batch = (buf.obs[idx], buf.action[idx], buf.reward[idx],
             buf.next_obs[idx], buf.done[idx])

    flat_q = networks.flat_params(ts.q_params).requires_grad_()
    q_loss = self._critic_loss(networks.param_views(flat_q, ts.q_params), ts,
                               batch, noise_q)
    q_grad, = torch.autograd.grad(q_loss, [flat_q])
    (flat_q,), q_opt = adam_update([flat_q.detach()], [q_grad], ts.q_opt,
                                   cfg.learning_rate)
    q_params = networks.param_views(flat_q, ts.q_params)
    ts = ts.replace(q_params=q_params, q_opt=q_opt)

    flat_pi = networks.flat_params(ts.policy_params).requires_grad_()
    pi_loss, mean_logp = self._actor_loss(
        networks.param_views(flat_pi, ts.policy_params), ts, batch, noise_pi)
    pi_grad, = torch.autograd.grad(pi_loss, [flat_pi])
    (flat_pi,), policy_opt = adam_update([flat_pi.detach()], [pi_grad],
                                         ts.policy_opt, cfg.learning_rate)
    mean_logp = mean_logp.detach()

    # temperature: minimize alpha * (-logp - target_entropy) in log_alpha;
    # d/dlog_alpha = alpha * (-logp - target): entropy above the target
    # gives a positive gradient, and descent lowers alpha
    alpha_grad = torch.exp(ts.log_alpha) * (-mean_logp - self.target_entropy)
    (log_alpha,), alpha_opt = adam_update([ts.log_alpha], [alpha_grad],
                                          ts.alpha_opt, cfg.learning_rate)
    with torch.no_grad():
      q_target = {k: t * (1.0 - cfg.tau) + q_params[k] * cfg.tau
                  for k, t in ts.q_target_params.items()}
    ts = ts.replace(policy_params=networks.param_views(flat_pi,
                                                       ts.policy_params),
                    policy_opt=policy_opt, log_alpha=log_alpha,
                    alpha_opt=alpha_opt, q_target_params=q_target)
    metrics = {"q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(),
               "alpha": torch.exp(log_alpha), "entropy": -mean_logp}
    return ts, metrics

  # -- epoch --------------------------------------------------------------
  def training_step(self, ts: SACState
                    ) -> Tuple[SACState, Dict[str, Any]]:
    """Collect one block, then `grad_updates_per_epoch` updates once
    `learning_starts` env steps are in; the last update's metrics."""
    cfg = self.cfg
    ts = self._collect(ts)
    if ts.env_steps >= cfg.learning_starts:
      for _ in range(cfg.grad_updates_per_epoch):
        ts, metrics = self._one_update(ts)
    else:
      zero = torch.zeros((), device=self.device)
      metrics = {"q_loss": zero, "pi_loss": zero,
                 "alpha": torch.exp(ts.log_alpha), "entropy": zero}
    metrics["buffer_size"] = ts.buffer.size
    metrics["mean_return"] = torch.mean(
        ts.env_state.info["returned_episode_return"])
    return ts, metrics

  def make_training_fn(self, epochs_per_call: int) -> Callable:
    def run(ts):
      for _ in range(epochs_per_call):
        ts, metrics = self.training_step(ts)
      return ts, metrics
    return run

  def make_policy_fn(self, deterministic: bool = True) -> Callable:
    def policy_fn(ts: SACState, obs, generator=None):
      with torch.no_grad():
        mean, log_std = self.apply_policy(ts.policy_params,
                                          self._norm_obs(ts.obs_stats, obs))
        if deterministic:
          return networks.deterministic_action(mean)
        return networks.sample_action(mean, log_std, generator)[0]
    return policy_fn


def train(env, config: Optional[Config] = None,
          progress_fn: Optional[Callable[[int, Dict], None]] = None,
          checkpoint_dir: Optional[str] = None):
  """Epochs until num_timesteps, in `num_evals` calls, each followed by
  progress_fn(env_steps, metrics as floats) and, with `checkpoint_dir`, a
  checkpoint. Returns (sac, state)."""
  cfg = config or default_config()
  sac = SAC(env, cfg)
  ts = sac.init(torch.Generator(device=env.device).manual_seed(cfg.seed))
  total_epochs = max(1, cfg.num_timesteps // (cfg.unroll_length
                                              * cfg.num_envs))
  evals = max(1, cfg.num_evals)
  run = sac.make_training_fn(max(1, total_epochs // evals))
  t0 = time.time()
  for _ in range(evals):
    ts, metrics = run(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["wall_clock"] = time.time() - t0
    if progress_fn is not None:
      progress_fn(ts.env_steps, metrics)
    if checkpoint_dir is not None:
      from myosuite_tpu_torch.train import checkpoint
      checkpoint.save(checkpoint_dir, ts, step=ts.env_steps)
  return sac, ts
