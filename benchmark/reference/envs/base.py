"""Environment base: the `State` of a batch of envs and `MyoEnv`.

An env holds a `Model` and a plain config dict and steps a `State` whose
tensors all lead with the env axis. Episode bookkeeping (truncation,
boundaries) happens on the device with no host round trip. Two muscle
conditions live here: sarcopenia, which weakens the model's muscles when
the config asks for it, and `ReafferentationWrapper`, which sends one
actuator's command to another. """

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional

import torch

from benchmark.reference.physics import forward as physics_forward
from benchmark.reference.physics import io as physics_io
from benchmark.reference.physics.types import Data, GainType, Model


@dataclasses.dataclass
class State:
  """Physics data and RL signals of a batch of envs."""
  data: Data
  obs: Dict[str, torch.Tensor]
  reward: torch.Tensor          # (B,)
  done: torch.Tensor            # (B,) float 0/1
  metrics: Dict[str, torch.Tensor]
  info: Dict[str, Any]

  def replace(self, **kw) -> "State":
    return dataclasses.replace(self, **kw)


def _apply_sarcopenia(model: Model, weakness: float) -> Model:
  """The model with its muscles' maximum force scaled by `weakness` (the
  JAX package's sarcopenia): gainprm[:, 2] where it is > 0, else the scale
  gainprm[:, 3] that MuJoCo turns into a force through acc0; biasprm the
  same, since the bias uses the same maximum force."""
  is_muscle = torch.as_tensor(
      model.actuator_gaintype == int(GainType.MUSCLE), device=model.device)

  def weaken(prm):
    force, scale = prm[:, 2], prm[:, 3]
    prm = prm.clone()
    prm[:, 2] = torch.where(is_muscle & (force > 0), force * weakness, force)
    prm[:, 3] = torch.where(is_muscle & (force <= 0), scale * weakness,
                            scale)
    return prm

  params = dict(model.params,
                actuator_gainprm=weaken(model.actuator_gainprm),
                actuator_biasprm=weaken(model.actuator_biasprm))
  return dataclasses.replace(model, params=params)


class ReafferentationWrapper:
  """Tendon-transfer fault: actuator `src`'s command drives actuator `dst`
  and `src` gets 0, before the env normalizes the actions (so `src`'s
  muscle control is norm_actions(0))."""

  def __init__(self, env, src: int, dst: int):
    self._env = env
    self._src, self._dst = src, dst

  def __getattr__(self, name):
    return getattr(self._env, name)

  def reset(self, generator: torch.Generator, batch: int) -> State:
    return self._env.reset(generator, batch)

  def step(self, state: State, action: torch.Tensor) -> State:
    action = action.clone()
    action[:, self._dst] = action[:, self._src]
    action[:, self._src] = 0.0
    return self._env.step(state, action)


class MyoEnv(abc.ABC):
  """Musculoskeletal env over the PyTorch physics engine.

  Subclasses implement reset() plus the obs/reward/done/metrics/info
  hooks; step() composes them in the JAX package's stage order.
  """

  def __init__(self, model: Model, config: Dict[str, Any]):
    self._config = dict(config)
    # the configured sim timestep, whatever the model file says
    self._model = dataclasses.replace(model, opt=dataclasses.replace(
        model.opt, timestep=float(config["sim_dt"])))
    self._n_substeps = int(round(config["ctrl_dt"] / config["sim_dt"]))
    if config.get("muscle_condition") == "sarcopenia":
      self._model = _apply_sarcopenia(
          self._model, config.get("sarcopenia_weakness", 0.5))

  # Rows of a larger batch that this env stands for (None: its own batch).
  # Set by the benchmark's check, which replays a sample of the rows of a
  # batch: each draw is then made at the full batch size, as the program
  # made it, and the sampled rows kept.
  sample_rows = None
  sample_of = None

  def rand(self, generator: torch.Generator, batch: int, *shape
           ) -> torch.Tensor:
    """torch.rand((batch,) + shape) on the env's device, or the sampled
    rows of a draw of (sample_of,) + shape."""
    if self.sample_rows is None:
      return torch.rand((batch,) + tuple(shape), generator=generator,
                        device=self.device)
    full = torch.rand((self.sample_of,) + tuple(shape), generator=generator,
                      device=self.device)
    return full[self.sample_rows]

  @property
  def model(self) -> Model:
    return self._model

  @property
  def device(self) -> torch.device:
    return self._model.device

  @property
  def action_size(self) -> int:
    return self._model.nu

  @property
  def dt(self) -> float:
    return float(self._config["ctrl_dt"])

  @property
  def max_episode_steps(self) -> int:
    return int(self._config["max_episode_steps"])

  @property
  def config(self) -> Dict[str, Any]:
    return self._config

  @staticmethod
  def norm_actions(action: torch.Tensor) -> torch.Tensor:
    """Sigmoid projection of policy actions into (0, 1) muscle space:
    1/(1+exp(-5(a-0.5)))."""
    return 1.0 / (1.0 + torch.exp(-5.0 * (action - 0.5)))

  @abc.abstractmethod
  def reset(self, generator: torch.Generator, batch: int) -> State:
    ...

  def step(self, state: State, action: torch.Tensor) -> State:
    ctrl = action
    if self._config.get("norm_actions", True):
      ctrl = self.norm_actions(action)
    return self.step_ctrl(state, ctrl)

  def step_ctrl(self, state: State, ctrl: torch.Tensor) -> State:
    """Step with already-normalized muscle controls."""
    state = self._step_simulation(state, ctrl)
    state = state.replace(obs=self._get_obs(state.data, state.info))
    rewards = self._get_rewards(state.data, state.info)
    state = state.replace(reward=self._sum_rewards(rewards))
    state = state.replace(done=self._get_done(state))
    state = state.replace(
        metrics={**state.metrics, **self._get_metrics(state, rewards)})
    return state.replace(info=self._get_info(state))

  def _model_for_step(self, info: Dict[str, Any]) -> Model:
    """The model the next control step simulates. Envs that randomize
    masses, inertias, geom sizes or frictions per episode return a per-env
    model (`types.per_env_model`) built from their info, so each env of
    the batch steps its own physics."""
    return self._model

  def _step_simulation(self, state: State, ctrl: torch.Tensor) -> State:
    data = state.data.replace(ctrl=ctrl)
    data = physics_forward.step_n(self._model_for_step(state.info), data,
                                  self._n_substeps)
    info = {**state.info, "step_count": state.info["step_count"] + 1}
    return state.replace(data=data, info=info)

  def _sum_rewards(self, rewards: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dense = sum of weight * reward, in the rewards' order."""
    weights = self._config["reward_weights"]
    total = torch.zeros((), dtype=torch.float32, device=self.device)
    for k, r in rewards.items():
      total = total + float(weights.get(k, 1.0)) * r
    return total

  def _make_data(self, qpos: torch.Tensor, qvel: torch.Tensor,
                 hfield: Optional[torch.Tensor] = None) -> Data:
    d = physics_io.make_data(self._model, qpos.shape[0])
    d = d.replace(qpos=qpos, qvel=qvel)
    if hfield is not None:
      d = d.replace(hfield_data=hfield)
    # settle derived quantities so obs at reset are valid
    d = physics_forward.fwd_position(self._model, d)
    return physics_forward.fwd_velocity(self._model, d)

  @abc.abstractmethod
  def _get_obs(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    ...

  @abc.abstractmethod
  def _get_rewards(self, data: Data, info: Dict) -> Dict[str, torch.Tensor]:
    ...

  def _get_done(self, state: State) -> torch.Tensor:
    return torch.zeros_like(state.reward)

  def _get_metrics(self, state: State, rewards: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    return {}

  def _get_info(self, state: State) -> Dict[str, Any]:
    return state.info

  def _episode_boundary(self, state: State):
    """(truncation, boundary) per env."""
    done = state.done
    truncation = torch.where(
        state.info["step_count"] >= self.max_episode_steps,
        1.0 - done, torch.zeros_like(done))
    boundary = (done != 0) | (truncation != 0)
    return truncation, boundary
