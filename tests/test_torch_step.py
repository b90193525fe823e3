"""Port step and env against MuJoCo and the JAX package, and the golden
trajectory.

Multi-substep trajectories of the port's `step_n` are held against MuJoCo
(as tests/test_step_parity.py holds the JAX package) and against the JAX
package's `step_n`, and the port's ReachEnv against the JAX ReachEnv given
the same targets and actions. The models use the main path's solver
settings (6 x 6 iterations) and no contacts (tests/torch_common.py).

The golden trajectory (myosuite_tpu_torch/assets/hand_reach_golden.npz) is
MtxHandReachFixed-v0 stepped by the JAX package; `chip_smoke.py` replays it
through the port on the card. Regenerate it with

  JAX_PLATFORMS=cpu python -m tests.test_torch_step
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from myosuite_tpu.envs.reach import ReachEnv as JaxReachEnv
from myosuite_tpu.envs.registry import reach_config
from myosuite_tpu.physics import forward as jax_forward
from myosuite_tpu.physics import io as jax_io
from myosuite_tpu_torch.envs.reach import ReachEnv
from myosuite_tpu_torch.envs.registry import ASSETS
from myosuite_tpu_torch.physics import forward, io
from tests.torch_common import LIMIT6_XML, MUSCLE_NOCON_XML

GOLDEN = os.path.join(ASSETS, "hand_reach_golden.npz")
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")

# float32 trajectories of two implementations that sum in different orders
# drift apart by rounding; over 100 substeps of these damped systems the
# measured gap is below 1e-5, so 1e-4 leaves a 10x margin.
TRAJ_ATOL = 1e-4


def _rollout_both(xml, qpos, qvel, ctrls, substeps):
  """Both packages from the same (B, ...) numpy states, one ctrl row per
  segment of `substeps` substeps; returns per-segment (qpos, qvel, act)."""
  mj = mujoco.MjModel.from_xml_string(xml)
  jm, tm = jax_io.put_model(mj), io.put_model(mj, "cpu")
  run = jax.jit(jax.vmap(lambda d: jax_forward.step_n(jm, d, substeps)))
  B = qpos.shape[0]
  jd = jax.vmap(lambda q, v: jax_io.make_data(jm).replace(qpos=q, qvel=v))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  td = io.make_data(tm, B, "cpu").replace(qpos=torch.from_numpy(qpos),
                                          qvel=torch.from_numpy(qvel))
  out = []
  for ctrl in ctrls:
    jd = run(jd.replace(ctrl=jnp.asarray(ctrl)))
    td = forward.step_n(tm, td.replace(ctrl=torch.from_numpy(ctrl)),
                        substeps)
    for name in ("qpos", "qvel", "act"):
      out.append((name, getattr(td, name).numpy(),
                  np.asarray(getattr(jd, name))))
  return out


def _rollout_vs_mujoco(xml, nsteps, ctrl_fn=None, qpos0=None, qvel0=None):
  """The port (batch 1, CPU) and MuJoCo side by side, as
  tests/test_step_parity.py::_rollout drives the JAX package."""
  mj = mujoco.MjModel.from_xml_string(xml)
  mjd = mujoco.MjData(mj)
  if qpos0 is not None:
    mjd.qpos[:] = qpos0
  if qvel0 is not None:
    mjd.qvel[:] = qvel0
  m = io.put_model(mj, "cpu")
  f = lambda x: torch.tensor(np.asarray(x, dtype=np.float32)[None])
  d = io.make_data(m, 1, "cpu").replace(qpos=f(mjd.qpos), qvel=f(mjd.qvel))
  ours, ref = [], []
  for i in range(nsteps):
    if ctrl_fn is not None:
      mjd.ctrl[:] = ctrl_fn(i)
      d = d.replace(ctrl=f(mjd.ctrl))
    d = forward.step(m, d)
    mujoco.mj_step(mj, mjd)
    ours.append(d.qpos[0].numpy())
    ref.append(mjd.qpos.copy())
  return np.stack(ours), np.stack(ref), d, mjd


def test_muscle_arm_trajectory_vs_mujoco():
  """Muscle arm under sinusoidal excitation; tolerances of
  tests/test_step_parity.py::test_muscle_arm_trajectory."""
  ctrl = lambda i: np.array([0.5 + 0.5 * np.sin(0.02 * i), 0.3])
  ours, ref, d, mjd = _rollout_vs_mujoco(MUSCLE_NOCON_XML, 300, ctrl)
  np.testing.assert_allclose(ours[-1], ref[-1], atol=5e-3)
  np.testing.assert_allclose(d.act[0].numpy(), mjd.act, atol=5e-3)


def test_joint_limit_and_frictionloss_vs_mujoco():
  """Swing into the joint limit with frictionloss; tolerances of
  tests/test_step_parity.py::test_joint_limit_and_frictionloss."""
  ours, ref, _, _ = _rollout_vs_mujoco(LIMIT6_XML, 400, qpos0=[0.0],
                                       qvel0=[3.0])
  np.testing.assert_allclose(ours[-1], ref[-1], atol=5e-3)
  assert np.all(ours[:, 0] < 0.45)


def test_step_n_muscle_arm():
  rng = np.random.default_rng(0)
  B = 3
  qpos = rng.uniform(0.2, 2.0, (B, 1)).astype(np.float32)
  qvel = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
  ctrls = [rng.uniform(0, 1, (B, 2)).astype(np.float32) for _ in range(5)]
  for name, ours, ref in _rollout_both(MUSCLE_NOCON_XML, qpos, qvel, ctrls,
                                       20):
    np.testing.assert_allclose(ours, ref, atol=TRAJ_ATOL, err_msg=name)


def test_step_n_joint_limit_and_frictionloss():
  B = 3
  qpos = np.array([[0.0], [0.3], [-0.35]], dtype=np.float32)
  qvel = np.array([[3.0], [1.0], [-2.0]], dtype=np.float32)
  ctrls = [np.zeros((B, 0), dtype=np.float32)] * 4
  for name, ours, ref in _rollout_both(LIMIT6_XML, qpos, qvel, ctrls, 25):
    np.testing.assert_allclose(ours, ref, atol=TRAJ_ATOL, err_msg=name)


def test_reach_env_matches_jax():
  """The slice as a whole: ReachEnv over the muscle arm, target site
  "handle", same targets and actions, 3 control steps. Tolerance: obs,
  reward and metrics to 1e-4 (TRAJ_ATOL: 30 substeps of float32 drift,
  measured below 1e-5); done and the bonus/solved flags exactly."""
  B = 4
  mj = mujoco.MjModel.from_xml_string(MUSCLE_NOCON_XML)
  mujoco.mj_forward(mj, d0 := mujoco.MjData(mj))
  sid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SITE, "handle")
  span = np.array([0.05, 0.04, 0.05])
  lo, hi = d0.site_xpos[sid] - span, d0.site_xpos[sid] + span
  cfg = reach_config(MUSCLE_NOCON_XML, ["handle"], lo, hi)
  jenv = JaxReachEnv(cfg)
  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(0), B))
  jstep = jax.jit(jax.vmap(jenv.step))

  tenv = ReachEnv(io.put_model(mj, "cpu"), dict(
      tip_sids=[sid], target_lo=lo, target_hi=hi, ctrl_dt=cfg.ctrl_dt,
      sim_dt=cfg.sim_dt, max_episode_steps=cfg.max_episode_steps,
      far_th=cfg.far_th, fixed_target=False,
      reward_weights=dict(cfg.reward_weights)))
  targets = torch.from_numpy(np.array(jstate.info["targets"]))
  tenv._sample_targets = lambda generator, batch: targets.clone()
  tstate = tenv.reset(torch.Generator().manual_seed(0), B)

  def compare(j, t):
    np.testing.assert_allclose(t.obs["state"].numpy(), j.obs["state"],
                               atol=TRAJ_ATOL, err_msg="obs")
    np.testing.assert_allclose(t.reward.numpy(), j.reward, atol=TRAJ_ATOL,
                               err_msg="reward")
    np.testing.assert_array_equal(t.done.numpy(), j.done)
    for k, v in j.metrics.items():
      np.testing.assert_allclose(t.metrics[k].numpy(), v, atol=TRAJ_ATOL,
                                 err_msg=k)
    np.testing.assert_array_equal(t.info["step_count"].numpy(),
                                  j.info["step_count"])

  compare(jstate, tstate)
  rng = np.random.default_rng(1)
  for _ in range(3):
    a = rng.uniform(0, 1, (B, mj.nu)).astype(np.float32)
    jstate = jstep(jstate, jnp.asarray(a))
    tstate = tenv.step(tstate, torch.from_numpy(a))
    compare(jstate, tstate)


# ---------------------------------------------------------------------------
# golden trajectory of the full hand
# ---------------------------------------------------------------------------

GOLDEN_BATCH, GOLDEN_STEPS = 4, 3


def golden_actions():
  rng = np.random.default_rng(2024)
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, 39)).astype(
      np.float32)


def jax_golden():
  """MtxHandReachFixed-v0 in the JAX package: batch 4, 3 control steps of
  numpy actions; obs, reward, done, qpos, qvel and act after each step."""
  import myosuite_tpu
  env = myosuite_tpu.make("MtxHandReachFixed-v0")
  state = jax.vmap(env.reset)(
      jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH))
  step = jax.jit(jax.vmap(env.step))
  actions = golden_actions()
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in actions:
    state = step(state, jnp.asarray(a))
    for k, v in (("obs", state.obs["state"]), ("reward", state.reward),
                 ("done", state.done), ("qpos", state.data.qpos),
                 ("qvel", state.data.qvel), ("act", state.data.act)):
      rec[k].append(np.asarray(v))
  return dict(actions=actions, **{k: np.stack(v) for k, v in rec.items()})


def port_replay(golden, device):
  """The golden actions through the port's MtxHandReachFixed-v0; returns
  the same fields (numpy)."""
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make("MtxHandReachFixed-v0", device=device)
  state = env.reset(torch.Generator(device).manual_seed(0), GOLDEN_BATCH)
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in golden["actions"]:
    state = env.step(state, torch.from_numpy(a).to(device))
    for k, v in (("obs", state.obs["state"]), ("reward", state.reward),
                 ("done", state.done), ("qpos", state.data.qpos),
                 ("qvel", state.data.qvel), ("act", state.data.act)):
      rec[k].append(v.cpu().numpy())
  return {k: np.stack(v) for k, v in rec.items()}


def test_port_replays_golden():
  """The committed golden trajectory, replayed through the port on the CPU,
  within the tolerances stored beside it (which chip_smoke.py also uses)."""
  with np.load(GOLDEN) as z:
    golden = {k: z[k] for k in z.files}
  ours = port_replay(golden, "cpu")
  for k in GOLDEN_FIELDS:
    np.testing.assert_allclose(ours[k], golden[k], rtol=0,
                               atol=float(golden["atol_" + k]), err_msg=k)


@pytest.mark.slow
def test_golden_in_sync_with_jax():
  with np.load(GOLDEN) as z:
    golden = {k: z[k] for k in z.files}
  fresh = jax_golden()
  for k, v in fresh.items():
    np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-6,
                               err_msg=k)


def write_golden():
  """Write the golden file: the JAX trajectory plus, per field, the
  tolerance the port is held to: 10x the largest gap measured between the
  port (CPU) and the JAX package, and at least 1e-4 of the field's scale."""
  golden = jax_golden()
  ours = port_replay(golden, "cpu")
  tols = {}
  for k in GOLDEN_FIELDS:
    gap = float(np.abs(ours[k] - golden[k]).max())
    scale = float(np.abs(golden[k]).max())
    tols["atol_" + k] = np.float64(max(10 * gap, 1e-4 * max(scale, 1.0)))
    print(f"{k}: max gap {gap:.3e}, scale {scale:.3e}, "
          f"tolerance {tols['atol_' + k]:.3e}")
  np.savez(GOLDEN, **golden, **tols)
  print("wrote", GOLDEN)


if __name__ == "__main__":
  write_golden()
