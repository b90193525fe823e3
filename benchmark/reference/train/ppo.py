"""PPO trainer: rollouts of the batched env, GAE, clipped surrogate.

The JAX package's PPO (itself a replacement for the Brax PPO of the
reference), with its anchored hyperparameters: 50M steps, 4096 envs, lr
3e-4, discount 0.97, GAE 0.95, entropy 1e-3, clip 0.3, unroll 10, 32
minibatches, 8 update passes, 3x64 MLPs, observation normalization.

Where the JAX package jits one training epoch, the port runs eager PyTorch:
`training_step` is a Python loop of `unroll_length` env steps, then
`num_updates_per_batch` x `num_minibatches` optimizer steps. Nothing on
that path reads a value back to the host: randomness comes from
`torch.Generator`s on the env's device, a non-finite gradient is skipped by
a `torch.where` select, and metrics stay device tensors until `train` logs
them.

The optimizer is optax's `apply_if_finite(chain(clip_by_global_norm,
adam))` written as functions on tensors (`init_opt_state`, `apply_update`):
one joint global norm over the policy and value gradients, scaled by
max_norm / norm only when norm > max_norm; Adam's mu_hat / (sqrt(nu_hat) +
eps); and a non-finite gradient leaves params and Adam's state as they were
unless it is the 101st in a row.

On a mesh of ranks (`parallel.mesh`), `training_step(ts, mesh)` steps this
rank's env rows, gathers the trajectory onto every rank with one
all-reduce, and runs the single-rank learner on the gathered batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from benchmark.reference.envs.base import State
from benchmark.reference.envs.wrappers import AutoResetWrapper
from benchmark.reference import parallel as mesh_mod
from benchmark.reference.train import networks, running_stats

Params = Dict[str, torch.Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass(slots=True)
class Config:
  """PPO hyperparameters; fields of the JAX package's default_config."""
  num_timesteps: int = 50_000_000
  num_envs: int = 4096
  learning_rate: float = 3e-4
  discounting: float = 0.97
  gae_lambda: float = 0.95
  entropy_cost: float = 1e-3
  clipping_epsilon: float = 0.3
  max_grad_norm: float = 1.0
  value_loss_coef: float = 0.5
  unroll_length: int = 10
  num_minibatches: int = 32
  num_updates_per_batch: int = 8
  reward_scaling: float = 1.0
  # "constant" or "cosine" (decays to lr_final_scale * learning_rate over
  # the whole num_timesteps budget)
  lr_schedule: str = "constant"
  lr_final_scale: float = 0.05
  normalize_observations: bool = True
  policy_hidden: Tuple[int, ...] = (64, 64, 64)
  value_hidden: Tuple[int, ...] = (64, 64, 64)
  num_evals: int = 10
  seed: int = 0


def default_config() -> Config:
  return Config()


@dataclasses.dataclass
class OptState:
  """State of apply_if_finite(chain(clip_by_global_norm, adam)); mu and nu
  are one tensor per parameter tensor it was made for (the trainer passes
  one: every parameter, flat, in the order of `PPO.flat_params`)."""
  count: torch.Tensor            # () int32: Adam's (and the lr schedule's)
  mu: List[torch.Tensor]
  nu: List[torch.Tensor]
  notfinite_count: torch.Tensor  # () int32: non-finite gradients in a row
  last_finite: torch.Tensor      # () bool
  total_notfinite: torch.Tensor  # () int32


@dataclasses.dataclass
class TrainState:
  policy_params: Params
  value_params: Params
  opt_state: OptState
  obs_stats: running_stats.RunningStats
  env_state: State
  generator: torch.Generator
  env_steps: int
  # on a mesh, this rank's own stream for the rollout's action noise
  # (`mesh.place`); `generator` then draws only the replicated
  # permutations. None: the rollout draws from `generator`.
  rollout_generator: Optional[torch.Generator] = None

  def replace(self, **kw) -> "TrainState":
    return dataclasses.replace(self, **kw)


class Transition(NamedTuple):
  obs: torch.Tensor           # (T, B, obs)
  action: torch.Tensor        # tanh action in [-1, 1]
  raw_action: torch.Tensor    # pre-tanh
  log_prob: torch.Tensor
  reward: torch.Tensor
  done: torch.Tensor          # terminal (not truncation)
  truncation: torch.Tensor
  terminal_obs: torch.Tensor  # obs before any auto-reset


def check_generator(generator: torch.Generator, device: torch.device):
  """Randomness is drawn on the device it is used on; a generator of
  another device is an error, never a fallback."""
  if torch.device(generator.device).type != torch.device(device).type:
    raise ValueError(f"the generator is on {generator.device}, the env on "
                     f"{device}: pass torch.Generator(device={str(device)!r})")


# -- the optimizer ----------------------------------------------------------

def init_opt_state(params: Sequence[torch.Tensor]) -> OptState:
  dev = params[0].device
  i32 = lambda: torch.zeros((), dtype=torch.int32, device=dev)
  return OptState(count=i32(), mu=[torch.zeros_like(p) for p in params],
                  nu=[torch.zeros_like(p) for p in params],
                  notfinite_count=i32(),
                  last_finite=torch.ones((), dtype=torch.bool, device=dev),
                  total_notfinite=i32())


def cosine_decay(init_value: float, decay_steps: int, alpha: float
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
  """optax.cosine_decay_schedule(init_value, decay_steps, alpha)."""
  if not decay_steps > 0:
    raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

  def schedule(count: torch.Tensor) -> torch.Tensor:
    count = torch.clamp(count.to(torch.float32), max=float(decay_steps))
    decay = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
    return init_value * ((1 - alpha) * decay + alpha)
  return schedule


def adam_moments(grads: Sequence[torch.Tensor], count: torch.Tensor,
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 learning_rate):
  """optax.adam(learning_rate) on its state (count, mu, nu): (count + 1,
  the new mu and nu, the updates). `learning_rate` is a float or a
  schedule of the old count."""
  lr = learning_rate(count) if callable(learning_rate) else learning_rate
  count = count + 1
  mu = [(1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, mu)]
  nu = [(1 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, nu)]
  c = count.to(torch.float32)
  bc1 = 1 - torch.pow(ADAM_B1, c)
  bc2 = 1 - torch.pow(ADAM_B2, c)
  step = [-lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
          for m, v in zip(mu, nu)]
  return count, mu, nu, step


@dataclasses.dataclass
class AdamState:
  """State of a plain optax.adam (the SAC and NPG optimizers)."""
  count: torch.Tensor            # () int32
  mu: List[torch.Tensor]
  nu: List[torch.Tensor]


def init_adam(params: Sequence[torch.Tensor]) -> AdamState:
  return AdamState(
      count=torch.zeros((), dtype=torch.int32, device=params[0].device),
      mu=[torch.zeros_like(p) for p in params],
      nu=[torch.zeros_like(p) for p in params])


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], opt: AdamState,
                learning_rate: float
                ) -> Tuple[List[torch.Tensor], AdamState]:
  """One step of optax.adam(learning_rate) then apply_updates: no clip,
  no non-finite guard."""
  with torch.no_grad():
    count, mu, nu, step = adam_moments(grads, opt.count, opt.mu, opt.nu,
                                       learning_rate)
    return ([p + u for p, u in zip(params, step)],
            AdamState(count=count, mu=mu, nu=nu))


def apply_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], opt: OptState,
                 learning_rate, max_grad_norm: float
                 ) -> Tuple[List[torch.Tensor], OptState]:
  """One step of apply_if_finite(chain(clip_by_global_norm(max_grad_norm),
  adam(learning_rate)), max_consecutive_errors=100), on the device with no
  host read. `learning_rate` is a float or a schedule of Adam's count."""
  with torch.no_grad():
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    notfinite_count = torch.where(finite, torch.zeros_like(
        opt.notfinite_count), opt.notfinite_count + 1)
    take = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)

    # clip_by_global_norm, one norm over every gradient
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_grad_norm
    grads = [torch.where(keep, g, (g / norm) * max_grad_norm) for g in grads]

    count, mu, nu, step = adam_moments(grads, opt.count, opt.mu, opt.nu,
                                       learning_rate)
    sel = lambda new, old: torch.where(take, new, old)
    new_params = [sel(p + u, p) for p, u in zip(params, step)]
    new_opt = OptState(
        count=sel(count, opt.count),
        mu=[sel(a, b) for a, b in zip(mu, opt.mu)],
        nu=[sel(a, b) for a, b in zip(nu, opt.nu)],
        notfinite_count=notfinite_count, last_finite=finite,
        total_notfinite=torch.where(finite, opt.total_notfinite,
                                    opt.total_notfinite + 1))
  return new_params, new_opt


# -- PPO --------------------------------------------------------------------

class PPO:
  """Rollouts, advantages and updates for one env."""

  def __init__(self, env, config: Optional[Config] = None):
    self.env = AutoResetWrapper(env)
    self.cfg = config or default_config()
    self.device = env.device
    cfg = self.cfg
    if cfg.lr_schedule == "cosine":
      # one optimizer step per minibatch; total over the step budget
      updates_total = max(1, (
          cfg.num_timesteps // (cfg.unroll_length * cfg.num_envs)
          * cfg.num_updates_per_batch * cfg.num_minibatches))
      self.learning_rate = cosine_decay(cfg.learning_rate, updates_total,
                                        cfg.lr_final_scale)
    elif cfg.lr_schedule == "constant":
      self.learning_rate = cfg.learning_rate
    else:
      raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    self.policy = self.value = None   # built by init(), which knows obs_dim

  # -- initialization -----------------------------------------------------
  def build_networks(self, obs_dim: int) -> None:
    cfg = self.cfg
    self.policy = networks.PolicyNet(obs_dim, self.env.action_size,
                                     tuple(cfg.policy_hidden)).to(self.device)
    self.value = networks.ValueNet(obs_dim, tuple(cfg.value_hidden)).to(
        self.device)

  def init(self, generator: torch.Generator) -> TrainState:
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
    return TrainState(
        policy_params=params[0], value_params=params[1],
        opt_state=init_opt_state([self._flatten(*params)]),
        obs_stats=running_stats.init(obs_dim, self.device),
        env_state=env_state, generator=generator, env_steps=0)

  @staticmethod
  def flat_params(policy_params: Params, value_params: Params
                  ) -> List[torch.Tensor]:
    """Policy then value tensors: the optimizer's order."""
    return [*policy_params.values(), *value_params.values()]

  @staticmethod
  def _flatten(policy_params: Params, value_params: Params
               ) -> torch.Tensor:
    """Every parameter in one vector, policy then value."""
    return torch.cat([networks.flat_params(policy_params),
                      networks.flat_params(value_params)])

  @staticmethod
  def _unflatten(flat: torch.Tensor, policy_params: Params,
                 value_params: Params) -> Tuple[Params, Params]:
    """`flat` as views shaped like the two dicts."""
    n = sum(p.numel() for p in policy_params.values())
    return (networks.param_views(flat[:n], policy_params),
            networks.param_views(flat[n:], value_params))

  # -- networks -----------------------------------------------------------
  def _norm_obs(self, stats, obs):
    if not self.cfg.normalize_observations:
      return obs
    return running_stats.normalize(stats, obs)

  def apply_policy(self, params: Params, nobs: torch.Tensor):
    return functional_call(self.policy, params, (nobs,))

  def apply_value(self, params: Params, nobs: torch.Tensor):
    return functional_call(self.value, params, (nobs,))

  # -- rollout ------------------------------------------------------------
  def _rollout(self, ts: TrainState) -> Tuple[TrainState, Transition]:
    """`unroll_length` env steps under the behaviour policy, then the
    observation statistics updated from them."""
    ts, traj = self._unroll(ts)
    return self._update_stats(ts, traj), traj

  def _update_stats(self, ts: TrainState, traj: Transition) -> TrainState:
    if not self.cfg.normalize_observations:
      return ts
    return ts.replace(obs_stats=running_stats.update(ts.obs_stats,
                                                     traj.obs))

  def _unroll(self, ts: TrainState) -> Tuple[TrainState, Transition]:
    """`unroll_length` env steps under the behaviour policy, its noise
    drawn from ts.rollout_generator (ts.generator if None); env_steps
    counts the global batch, cfg.num_envs."""
    cfg = self.cfg
    gen = (ts.generator if ts.rollout_generator is None
           else ts.rollout_generator)
    check_generator(gen, self.device)
    env_state, steps = ts.env_state, []
    with torch.no_grad():
      for _ in range(cfg.unroll_length):
        obs = env_state.obs["state"]
        mean, log_std = self.apply_policy(
            ts.policy_params, self._norm_obs(ts.obs_stats, obs))
        action, raw, logp = networks.sample_action_raw(mean, log_std, gen)
        env_state = self.env.step(env_state, action)
        trunc = env_state.info["truncation"]
        steps.append(Transition(
            obs=obs, action=action, raw_action=raw, log_prob=logp,
            reward=env_state.reward * cfg.reward_scaling,
            done=env_state.done * (1.0 - trunc), truncation=trunc,
            terminal_obs=env_state.info["terminal_obs"]))
    traj = Transition(*[torch.stack(x) for x in zip(*steps)])
    return ts.replace(env_state=env_state, env_steps=ts.env_steps
                      + cfg.unroll_length * cfg.num_envs), traj

  @staticmethod
  def _gather(traj: Transition, last_obs: torch.Tensor,
              episode_return: torch.Tensor, mesh) -> Tuple[
                  Transition, torch.Tensor, torch.Tensor]:
    """Every rank's trajectory, last observation and returned episode
    returns, assembled in env order on every rank by one collective: each
    env's values packed into one row. The tanh action is not sent (the
    learner reads the raw one); it is recomputed from it, bit for bit."""
    names = [k for k in Transition._fields if k != "action"]
    fields = [getattr(traj, k) for k in names]
    t, b = traj.reward.shape
    cols = [x.transpose(0, 1).reshape(b, -1) for x in fields]
    cols += [last_obs, episode_return[:, None]]
    widths = [c.shape[1] for c in cols]
    rows = mesh_mod.gather_env_rows(torch.cat(cols, 1), mesh)
    parts = torch.split(rows, widths, 1)
    n = rows.shape[0]
    out = {k: p.reshape((n, t) + x.shape[2:]).transpose(0, 1).contiguous()
           for k, p, x in zip(names, parts, fields)}
    out["action"] = torch.tanh(out["raw_action"])
    return (Transition(**out), parts[-2].contiguous(),
            parts[-1].reshape(n).contiguous())

  # -- advantage ----------------------------------------------------------
  def _gae(self, ts: TrainState, traj: Transition, stats,
           last_obs: Optional[torch.Tensor] = None):
    """(advantages, returns), each (T, B); the bootstrap value is that of
    `last_obs` (default: the observation of ts.env_state)."""
    cfg = self.cfg
    if last_obs is None:
      last_obs = ts.env_state.obs["state"]
    with torch.no_grad():
      vf = lambda obs: self.apply_value(ts.value_params,
                                        self._norm_obs(stats, obs))
      values = vf(traj.obs)
      # bootstrap: value of the state the env reached (before any reset)
      term_values = vf(traj.terminal_obs)
      value_next = vf(last_obs)
      gae = torch.zeros_like(value_next)
      advs = [None] * traj.reward.shape[0]
      for t in reversed(range(len(advs))):
        done, trunc = traj.done[t], traj.truncation[t]
        # at a truncation boundary, bootstrap from the terminal obs value
        v_next = torch.where(torch.maximum(done, trunc) > 0, term_values[t],
                             value_next)
        nonterminal = 1.0 - done
        delta = (traj.reward[t] + cfg.discounting * v_next * nonterminal
                 - values[t])
        gae = delta + (cfg.discounting * cfg.gae_lambda * nonterminal
                       * (1.0 - trunc) * gae)
        advs[t] = gae
        value_next = values[t]
      advs = torch.stack(advs)
    return advs, advs + values

  # -- update -------------------------------------------------------------
  def _loss(self, params: Tuple[Params, Params], batch, obs_stats):
    cfg = self.cfg
    policy_params, value_params = params
    obs, raw_action, old_logp, adv, ret = batch
    nobs = self._norm_obs(obs_stats, obs)
    mean, log_std = self.apply_policy(policy_params, nobs)
    logp = networks.gaussian_tanh_log_prob(mean, log_std, raw_action)
    # clamp the log-ratio: off-policy samples of a sharpened policy reach
    # |logp - old_logp| > 80, exp() overflows, and inf * 0 is NaN
    ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surrogate = -torch.minimum(
        ratio * adv_n,
        torch.clamp(ratio, 1 - cfg.clipping_epsilon,
                    1 + cfg.clipping_epsilon) * adv_n)
    v = self.apply_value(value_params, nobs)
    v_loss = 0.5 * torch.mean((ret - v) ** 2)
    entropy = torch.mean(networks.entropy_estimate(mean, log_std,
                                                   raw_action))
    policy_loss = torch.mean(surrogate)
    total = (policy_loss + cfg.value_loss_coef * v_loss
             - cfg.entropy_cost * entropy)
    return total, {"policy_loss": policy_loss, "value_loss": v_loss,
                   "entropy": entropy}

  def _update_epoch(self, ts: TrainState, traj: Transition, stats,
                    perms: Optional[Sequence[torch.Tensor]] = None,
                    last_obs: Optional[torch.Tensor] = None):
    """`num_updates_per_batch` passes of `num_minibatches` optimizer steps
    over the shuffled trajectory. `perms`, if given, are the passes'
    permutations (else drawn from ts.generator); `last_obs` as in `_gae`.
    Returns (ts, mean aux)."""
    cfg = self.cfg
    advs, rets = self._gae(ts, traj, stats, last_obs)
    t, b = traj.reward.shape
    n = t * b
    flat = lambda x: x.reshape((n,) + x.shape[2:])
    dataset = [flat(traj.obs), flat(traj.raw_action), flat(traj.log_prob),
               flat(advs), flat(rets)]
    mb = n // cfg.num_minibatches
    sums: Dict[str, torch.Tensor] = {}
    for u in range(cfg.num_updates_per_batch):
      perm = perms[u] if perms is not None else torch.randperm(
          n, generator=ts.generator, device=self.device)
      shuffled = [x[perm] for x in dataset]
      for i in range(cfg.num_minibatches):
        ts, aux = self._minibatch_step(
            ts, [x[i * mb:(i + 1) * mb] for x in shuffled], stats)
        for k, v in aux.items():
          sums[k] = sums.get(k, 0.0) + v
    steps = cfg.num_updates_per_batch * cfg.num_minibatches
    return ts, {k: v / steps for k, v in sums.items()}

  def _minibatch_step(self, ts: TrainState, batch, stats):
    """One optimizer step on a minibatch (obs, raw_action, old log_prob,
    advantage, return); returns (ts with new params and opt state, aux)."""
    flat = self._flatten(ts.policy_params, ts.value_params).requires_grad_()
    loss, aux = self._loss(
        self._unflatten(flat, ts.policy_params, ts.value_params), batch,
        stats)
    grad, = torch.autograd.grad(loss, [flat])
    (flat,), opt = apply_update([flat.detach()], [grad], ts.opt_state,
                                self.learning_rate, self.cfg.max_grad_norm)
    pol, val = self._unflatten(flat, ts.policy_params, ts.value_params)
    return ts.replace(policy_params=pol, value_params=val, opt_state=opt), \
        {k: v.detach() for k, v in aux.items()}

  # -- public API ---------------------------------------------------------
  def training_step(self, ts: TrainState, mesh=None):
    """One rollout and one PPO update; (ts, metrics as device tensors).
    With a `mesh` (and a TrainState from `mesh.place`) the rollout is this
    rank's env rows and the update, the statistics and the metrics are
    those of the gathered global batch, the same on every rank."""
    # old_logp was computed under the behaviour-time normalizer, so the
    # update renormalizes the stored obs with those same stats (else the
    # ratio measures the normalizer's shift, not the policy's); the freshly
    # updated stats apply from the next rollout
    behavior_stats = ts.obs_stats
    ts, traj = self._unroll(ts)
    last_obs = ts.env_state.obs["state"]
    returns = ts.env_state.info["returned_episode_return"]
    if mesh is not None:
      traj, last_obs, returns = self._gather(traj, last_obs, returns, mesh)
    ts = self._update_stats(ts, traj)
    ts, aux = self._update_epoch(ts, traj, behavior_stats, last_obs=last_obs)
    metrics = {
        **aux,
        "reward_per_step": traj.reward.mean(),
        "episode_return": returns.mean(),
    }
    return ts, metrics

  def make_training_fn(self, steps_per_call: int) -> Callable:
    """A function advancing `steps_per_call` training steps; it returns the
    last step's metrics."""
    def run(ts):
      for _ in range(steps_per_call):
        ts, metrics = self.training_step(ts)
      return ts, metrics
    return run

  def make_policy_fn(self, deterministic: bool = True) -> Callable:
    def policy_fn(ts: TrainState, obs, generator=None):
      with torch.no_grad():
        mean, log_std = self.apply_policy(
            ts.policy_params, self._norm_obs(ts.obs_stats, obs))
        if deterministic:
          return networks.deterministic_action(mean)
        return networks.sample_action(mean, log_std, generator)[0]
    return policy_fn
