"""NPG trainer: natural policy gradient with conjugate-gradient Fisher
solves.

The JAX package's NPG (itself after MJRL's: 96 trajectories an iteration,
a (32, 32) policy, a KL-normalized step of 0.1). One iteration is a
rollout, GAE with advantages normalized over the batch, the vanilla
gradient of the surrogate, a conjugate-gradient solve of F x = g, the step
params + sqrt(2 delta / x^T F x) x, and a regression of the value function
with Adam. As in the JAX package the advantages, the step and the value
fit all normalize observations with the statistics from before the
rollout.

The Fisher-vector product is the Hessian-vector product of the mean KL
between the old and the new pre-tanh Gaussians at the current parameters
(the JAX package takes it forward-over-reverse, `jvp` of `grad`); here it
is a double backward through the KL's gradient, which is built once per
iteration and kept for every product. The policy's parameters are one flat
vector in the order of its state dict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from myosuite_tpu_torch.envs.base import State
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.train import networks, running_stats
from myosuite_tpu_torch.train.ppo import (AdamState, adam_update,
                                          check_generator, init_adam)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(slots=True)
class Config:
  """NPG hyperparameters; fields of the JAX package's default_config."""
  num_timesteps: int = 5_000_000
  num_envs: int = 96               # mjrl's 96 trajectories an iteration
  unroll_length: int = 50          # horizon chunk per iteration
  discounting: float = 0.995
  gae_lambda: float = 0.97
  normalized_step_size: float = 0.1   # delta: the KL-normalized step
  cg_iters: int = 10
  cg_damping: float = 1e-4
  value_lr: float = 1e-3
  value_epochs: int = 2
  value_batches: int = 4
  normalize_observations: bool = True
  policy_hidden: Tuple[int, ...] = (32, 32)
  value_hidden: Tuple[int, ...] = (128, 128)
  num_evals: int = 10
  seed: int = 0


def default_config() -> Config:
  return Config()


@dataclasses.dataclass
class NPGState:
  policy_params: Params
  value_params: Params
  value_opt: AdamState
  obs_stats: running_stats.RunningStats
  env_state: State
  generator: torch.Generator
  env_steps: int

  def replace(self, **kw) -> "NPGState":
    return dataclasses.replace(self, **kw)


class Trajectory(NamedTuple):
  """(T, B, ...) tensors of one rollout."""
  obs: torch.Tensor
  raw: torch.Tensor        # pre-tanh actions
  reward: torch.Tensor
  done: torch.Tensor       # terminal (not truncation)
  trunc: torch.Tensor
  term_obs: torch.Tensor   # obs before any auto-reset


class NPG:
  """Rollouts, natural-gradient steps and value fits for one env."""

  def __init__(self, env, config: Optional[Config] = None):
    self.cfg = config or default_config()
    self.env = AutoResetWrapper(env)
    self.device = env.device
    self.policy = self.value = None   # built by init(), which knows obs_dim

  def build_networks(self, obs_dim: int) -> None:
    cfg = self.cfg
    self.policy = networks.PolicyNet(obs_dim, self.env.action_size, tuple(
        cfg.policy_hidden)).to(self.device)
    self.value = networks.ValueNet(obs_dim, tuple(cfg.value_hidden)).to(
        self.device)

  def init(self, generator: torch.Generator) -> NPGState:
    """Reset the envs, then draw the policy's and the value's weights, all
    from `generator` (on the env's device)."""
    check_generator(generator, self.device)
    env_state = self.env.reset(generator, self.cfg.num_envs)
    obs_dim = env_state.obs["state"].shape[-1]
    self.build_networks(obs_dim)
    params = []
    for net in (self.policy, self.value):
      net.mlp.reset_parameters(generator)
      params.append({k: v.detach().clone()
                     for k, v in net.state_dict().items()})
    return NPGState(
        policy_params=params[0], value_params=params[1],
        value_opt=init_adam([networks.flat_params(params[1])]),
        obs_stats=running_stats.init(obs_dim, self.device),
        env_state=env_state, generator=generator, env_steps=0)

  def _norm_obs(self, stats, obs):
    if not self.cfg.normalize_observations:
      return obs
    return running_stats.normalize(stats, obs)

  def apply_policy(self, params: Params, nobs: torch.Tensor):
    return functional_call(self.policy, params, (nobs,))

  def apply_value(self, params: Params, nobs: torch.Tensor):
    return functional_call(self.value, params, (nobs,))

  # -- rollout + GAE ------------------------------------------------------
  def _rollout(self, ts: NPGState) -> Tuple[NPGState, Trajectory]:
    cfg = self.cfg
    check_generator(ts.generator, self.device)
    env_state, steps = ts.env_state, []
    with torch.no_grad():
      for _ in range(cfg.unroll_length):
        obs = env_state.obs["state"]
        mean, log_std = self.apply_policy(ts.policy_params,
                                          self._norm_obs(ts.obs_stats, obs))
        action, raw, _ = networks.sample_action_raw(mean, log_std,
                                                    ts.generator)
        env_state = self.env.step(env_state, action)
        trunc = env_state.info["truncation"]
        steps.append((obs, raw, env_state.reward,
                      env_state.done * (1.0 - trunc), trunc,
                      env_state.info["terminal_obs"]))
    traj = Trajectory(*[torch.stack(x) for x in zip(*steps)])
    stats = ts.obs_stats
    if cfg.normalize_observations:
      stats = running_stats.update(stats, traj.obs)
    return ts.replace(env_state=env_state, obs_stats=stats,
                      env_steps=ts.env_steps
                      + cfg.unroll_length * cfg.num_envs), traj

  def _gae(self, ts: NPGState, traj: Trajectory, stats):
    """(advantages normalized over the batch, returns), each (T, B)."""
    cfg = self.cfg
    with torch.no_grad():
      vf = lambda o: self.apply_value(ts.value_params,
                                      self._norm_obs(stats, o))
      values, term_values = vf(traj.obs), vf(traj.term_obs)
      gae = torch.zeros_like(values[0])
      advs = [None] * values.shape[0]
      for t in reversed(range(len(advs))):
        d, tr = traj.done[t], traj.trunc[t]
        boundary = torch.maximum(d, tr)
        delta = (traj.reward[t] + cfg.discounting * term_values[t] * (1.0 - d)
                 - values[t])
        gae = delta + cfg.discounting * cfg.gae_lambda * (1.0 - boundary) * gae
        advs[t] = gae
      adv = torch.stack(advs)
      returns = adv + values
      adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-6)
    return adv, returns

  # -- natural gradient ---------------------------------------------------
  def _natural_step(self, ts: NPGState, traj: Trajectory, adv, stats):
    """The KL-normalized natural-gradient step of the policy; (ts with the
    new policy, {"surrogate", "kl_after", "grad_norm"})."""
    cfg = self.cfg
    nobs = self._norm_obs(stats, traj.obs)
    flat_obs = nobs.reshape(-1, nobs.shape[-1])
    flat_raw = traj.raw.reshape(-1, traj.raw.shape[-1])
    flat_adv = adv.reshape(-1)
    like = ts.policy_params
    params0 = networks.flat_params(like).detach()
    with torch.no_grad():
      old_mean, old_log_std = self.apply_policy(like, flat_obs)
      old_logp = networks.gaussian_tanh_log_prob(old_mean, old_log_std,
                                                 flat_raw)

    def surrogate(flat):
      mean, log_std = self.apply_policy(networks.param_views(flat, like),
                                        flat_obs)
      logp = networks.gaussian_tanh_log_prob(mean, log_std, flat_raw)
      return torch.mean(torch.exp(logp - old_logp) * flat_adv)

    def mean_kl(flat):
      # KL(old || new) of diagonal Gaussians over the pre-tanh variable
      mean, log_std = self.apply_policy(networks.param_views(flat, like),
                                        flat_obs)
      var0 = torch.exp(2.0 * old_log_std)
      var1 = torch.exp(2.0 * log_std)
      kl = (log_std - old_log_std
            + (var0 + (old_mean - mean) ** 2) / (2.0 * var1) - 0.5)
      return torch.mean(torch.sum(kl, dim=-1))

    p = params0.clone().requires_grad_()
    g, = torch.autograd.grad(surrogate(p), [p])
    p = params0.clone().requires_grad_()
    grad_kl, = torch.autograd.grad(mean_kl(p), [p], create_graph=True)
    fvp = self.fisher_product(p, grad_kl)

    # conjugate gradient for F x = g
    x = torch.zeros_like(g)
    r, d = g.clone(), g.clone()
    rs = torch.dot(g, g)
    for _ in range(cfg.cg_iters):
      fd = fvp(d)
      alpha = rs / (torch.dot(d, fd) + 1e-12)
      x = x + alpha * d
      r = r - alpha * fd
      rs_new = torch.dot(r, r)
      d = r + (rs_new / (rs + 1e-12)) * d
      rs = rs_new

    # normalized step: sqrt(2 delta / (x^T F x))
    xfx = torch.dot(x, fvp(x))
    scale = torch.sqrt(2.0 * cfg.normalized_step_size
                       / torch.clamp(xfx, min=1e-12))
    new = params0 + scale * x
    with torch.no_grad():
      metrics = {"surrogate": surrogate(params0), "kl_after": mean_kl(new),
                 "grad_norm": torch.linalg.vector_norm(g)}
    return ts.replace(policy_params=networks.param_views(new, like)), metrics

  def fisher_product(self, p: torch.Tensor, grad_kl: torch.Tensor
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> (H v + damping v), H the Hessian of the mean KL at `p`, from
    its gradient `grad_kl` (built with create_graph at `p`)."""
    damping = self.cfg.cg_damping

    def fvp(v: torch.Tensor) -> torch.Tensor:
      hv, = torch.autograd.grad(grad_kl, [p], grad_outputs=v,
                                retain_graph=True)
      return hv + damping * v
    return fvp

  def _fit_value(self, ts: NPGState, traj: Trajectory, returns, stats,
                 perms: Optional[Sequence[torch.Tensor]] = None):
    """`value_epochs` passes of `value_batches` Adam steps on the squared
    error to the returns, each pass over one permutation (`perms`, else
    drawn from ts.generator); (ts, the last pass's mean loss)."""
    cfg = self.cfg
    nobs = self._norm_obs(stats, traj.obs).reshape(-1, traj.obs.shape[-1])
    tgt = returns.reshape(-1)
    n = nobs.shape[0]
    mb = n // cfg.value_batches
    params, opt = ts.value_params, ts.value_opt
    for e in range(cfg.value_epochs):
      perm = perms[e] if perms is not None else torch.randperm(
          n, generator=ts.generator, device=self.device)
      losses = []
      for i in range(cfg.value_batches):
        idx = perm[i * mb:(i + 1) * mb]
        flat = networks.flat_params(params).requires_grad_()
        value = self.apply_value(networks.param_views(flat, params),
                                 nobs[idx])
        loss = torch.mean((value - tgt[idx]) ** 2)
        grad, = torch.autograd.grad(loss, [flat])
        (flat,), opt = adam_update([flat.detach()], [grad], opt,
                                   cfg.value_lr)
        params = networks.param_views(flat, params)
        losses.append(loss.detach())
    return (ts.replace(value_params=params, value_opt=opt),
            torch.stack(losses).mean())

  # -- iteration ----------------------------------------------------------
  def training_step(self, ts: NPGState):
    """One rollout, natural step and value fit; (ts, metrics as device
    tensors)."""
    stats0 = ts.obs_stats   # normalize with the pre-rollout stats
    ts, traj = self._rollout(ts)
    adv, returns = self._gae(ts, traj, stats0)
    ts, metrics = self._natural_step(ts, traj, adv, stats0)
    ts, vloss = self._fit_value(ts, traj, returns, stats0)
    metrics["value_loss"] = vloss
    metrics["reward_per_step"] = traj.reward.mean()
    metrics["mean_return"] = torch.mean(
        ts.env_state.info["returned_episode_return"])
    return ts, metrics

  def make_training_fn(self, iters_per_call: int) -> Callable:
    def run(ts):
      for _ in range(iters_per_call):
        ts, metrics = self.training_step(ts)
      return ts, metrics
    return run

  def make_policy_fn(self, deterministic: bool = True) -> Callable:
    def policy_fn(ts: NPGState, obs, generator=None):
      with torch.no_grad():
        mean, log_std = self.apply_policy(ts.policy_params,
                                          self._norm_obs(ts.obs_stats, obs))
        if deterministic:
          return networks.deterministic_action(mean)
        return networks.sample_action(mean, log_std, generator)[0]
    return policy_fn


def train(env, config: Optional[Config] = None,
          progress_fn: Optional[Callable[[int, Dict], None]] = None):
  """Iterations until num_timesteps, in `num_evals` calls, each followed
  by progress_fn(env_steps, metrics as floats). Returns (npg, state)."""
  cfg = config or default_config()
  npg = NPG(env, cfg)
  ts = npg.init(torch.Generator(device=env.device).manual_seed(cfg.seed))
  total_iters = max(1, cfg.num_timesteps // (cfg.unroll_length
                                             * cfg.num_envs))
  evals = max(1, cfg.num_evals)
  run = npg.make_training_fn(max(1, total_iters // evals))
  t0 = time.time()
  for _ in range(evals):
    ts, metrics = run(ts)
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["wall_clock"] = time.time() - t0
    if progress_fn is not None:
      progress_fn(ts.env_steps, metrics)
  return npg, ts
