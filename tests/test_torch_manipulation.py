"""The port's in-hand manipulation envs against the JAX package.

Each env's obs, rewards, done and solved are held against the JAX methods
on the same supplied `Data` fields and `info` (no physics step compiled);
each goal draw against the JAX package fed the same uniforms; the
registry's ids, the committed model files and the auto-reset of the task
info are checked on the CPU. The golden file (myosuite_tpu_torch/assets/
hand_manip_golden.npz) holds 3 control steps of each env at its fixed
goal, stepped by the JAX package at batch 2; tier-1 replays it through the
port with no JAX compile, and `chip_smoke.py` replays it on the card.
Regenerate it and the five model files with

  JAX_PLATFORMS=cpu python -m tests.test_torch_manipulation
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myosuite_tpu
from myosuite_tpu.envs.base import State as JaxState
from myosuite_tpu.physics import io as jax_io
from myosuite_tpu.physics import math as jmath
from myosuite_tpu_torch.envs import manipulation, registry
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.physics import io as tio
from myosuite_tpu_torch.physics import math as tmath
from tests.test_torch_io import _assert_committed_matches_fresh_export
from tests.test_torch_locomotion import _jax_with_draws
from tests.torch_common import EXPORTS, MANIP_IDS, assert_close

OBJS = tuple(MANIP_IDS)
GOLDEN = os.path.join(registry.ASSETS, "hand_manip_golden.npz")
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")
GOLDEN_BATCH, GOLDEN_STEPS = 2, 3
# each object's env at a fixed goal: a Fixed id, or fixed_target=True
GOLDEN_ENVS = {"hold": ("MtxHandObjHoldFixed-v0", None),
               "die": ("MtxHandDieReorient-v0", {"fixed_target": True}),
               "pen": ("MtxHandPenTwirlFixed-v0", None),
               "baoding": ("MtxHandBaoding-v0", {"fixed_target": True}),
               "key": ("MtxHandKeyTurnFixed-v0", None)}
# the info entries that each task keeps and draws
GOAL_KEYS = {"hold": ("goal_pos",), "die": ("goal_quat", "goal_pos"),
             "pen": ("goal_dir", "goal_pos"), "baoding": ("phase",),
             "key": ("init_key",)}
ATOL = 1e-5


def test_euler_to_quat_matches_jax():
  rng = np.random.default_rng(0)
  euler = rng.uniform(-3.2, 3.2, (16, 3)).astype(np.float32)
  euler[0] = 0.0
  got = tmath.euler_to_quat(torch.from_numpy(euler))
  want = jax.vmap(jmath.euler_to_quat)(jnp.asarray(euler))
  assert_close("euler_to_quat", got, want, atol=1e-6)


@pytest.mark.parametrize("obj", OBJS)
def test_goal_draws_match_jax(obj, monkeypatch):
  """A reset and a resample at an episode boundary of one env, with the
  same uniform draws fed to the JAX env and to the port's transform."""
  jenv = myosuite_tpu.make(MANIP_IDS[obj])
  env = registry.make(MANIP_IDS[obj], device="cpu")
  n = {"hold": 3, "die": 3, "pen": 2, "baoding": 1, "key": 1}[obj]
  rng = np.random.default_rng(3)
  for u in rng.uniform(0, 1, (2, n)).astype(np.float32):
    _jax_with_draws(monkeypatch, u)
    # the JAX reset with its physics left out: only the info is compared
    monkeypatch.setattr(jenv, "_make_data", lambda *a, **k: None)
    monkeypatch.setattr(jenv, "_get_obs", lambda d, i: {})
    jstate = jenv.reset(jax.random.PRNGKey(0))
    draw = lambda gen, *shape: torch.from_numpy(u).reshape(shape)
    monkeypatch.setattr(env, "_draw", draw)
    state = env.reset(torch.Generator().manual_seed(0), 1)
    for k in GOAL_KEYS[obj]:
      assert_close(f"{obj} reset {k}", state.info[k][0], jstate.info[k],
                   atol=1e-6)
    # an episode boundary: the task redraws its goal (the key keeps its
    # initial angle)
    jinfo = jenv._get_info(jstate.replace(done=jnp.float32(1.0)))
    info = env._get_info(state.replace(done=torch.ones(1)))
    for k in GOAL_KEYS[obj]:
      assert_close(f"{obj} resample {k}", info[k][0], jinfo[k], atol=1e-6)
    assert int(info["step_count"][0]) == int(jinfo["step_count"]) == 0


def _supplied(obj, env, batch=6, seed=0):
  """Numpy Data fields and info for `batch` envs near the task's goal:
  some objects dropped, some goals met, some keys turned."""
  m = env.model
  rng = np.random.default_rng(seed)
  center = np.asarray(env.config["goal_center"], np.float32)
  f32 = lambda x: np.asarray(x, np.float32)
  sx = center + rng.normal(0, 0.02, (batch, m.nsite, 3))
  sx[1::3, :, 2] -= 0.3                                    # dropped
  qpos = rng.normal(0, 0.5, (batch, m.nq))
  fields = dict(qpos=f32(qpos), qvel=f32(rng.normal(0, 2.0, (batch, m.nv))),
                act=f32(rng.uniform(0, 1, (batch, m.na))))
  info = {}
  if obj in ("hold", "die", "pen"):
    info["goal_pos"] = f32(center + rng.normal(0, 0.01, (batch, 3)))
    sx[::2, env._site["object_site"]] = info["goal_pos"][::2] + 0.005
  if obj == "die":
    q = rng.normal(0, 1, (batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qa = env._qadr["object_free"]
    q[::2] = qpos[::2, qa + 3:qa + 7] / np.linalg.norm(
        qpos[::2, qa + 3:qa + 7], axis=1, keepdims=True)
    q[::2, 1] += 0.05
    info["goal_quat"] = f32(q)
  if obj == "pen":
    top, site = env._site["object_top"], env._site["object_site"]
    sx[:, top] = sx[:, site] + rng.normal(0, 0.1, (batch, 3))
    d = rng.normal(0, 1, (batch, 3))
    d[::2] = sx[::2, top] - sx[::2, site]
    info["goal_dir"] = f32(d / np.linalg.norm(d, axis=1, keepdims=True))
  if obj == "baoding":
    info["phase"] = f32(rng.uniform(0, 7, batch))
    ph = info["phase"][::2].astype(np.float64)
    for s, sign in (("ball1_site", 1.0), ("ball2_site", -1.0)):
      sx[::2, env._site[s]] = center + np.stack(
          [0.022 * sign * np.cos(ph), 0.028 * sign * np.sin(ph),
           0 * ph], -1) + 0.01
  if obj == "key":
    key = qpos[:, env._qadr["key_joint"]]
    info["init_key"] = f32(key + np.array([0.0, 3.5, 7.0] * (batch // 3)))
  fields["site_xpos"] = f32(sx)
  return fields, info


@pytest.mark.parametrize("obj", OBJS)
def test_env_signals_match_jax(obj):
  """obs, every reward term, the weighted reward, done and solved of the
  port against the JAX methods on the same supplied states."""
  jenv = myosuite_tpu.make(MANIP_IDS[obj])
  env = registry.make(MANIP_IDS[obj], device="cpu")
  fields, info = _supplied(obj, env)
  batch = fields["qpos"].shape[0]

  def jax_signals(fields, info):
    d = jax_io.make_data(jenv.model).replace(**fields)
    rewards = jenv._get_rewards(d, info)
    state = JaxState(d, {}, jnp.float32(0.0), jnp.float32(0.0), {}, info)
    return (jenv._get_obs(d, info)["state"], rewards,
            jenv._sum_rewards(rewards), jenv._get_done(state),
            jenv._solved(state))

  want = jax.jit(jax.vmap(jax_signals))(fields, info)
  d = tio.make_data(env.model, batch, "cpu").replace(
      **{k: torch.from_numpy(v) for k, v in fields.items()})
  tinfo = {k: torch.from_numpy(v) for k, v in info.items()}
  rewards = env._get_rewards(d, tinfo)
  state = manipulation.State(d, {}, torch.zeros(batch), torch.zeros(batch),
                             {}, tinfo)
  got = (env._get_obs(d, tinfo)["state"], rewards,
         env._sum_rewards(rewards), env._get_done(state), env._solved(state))
  assert_close(f"{obj} obs", got[0], want[0], atol=ATOL)
  assert sorted(got[1]) == sorted(want[1])
  for k in got[1]:
    assert_close(f"{obj} reward {k}", got[1][k], want[1][k], atol=ATOL)
  for name, g, w in zip(("reward", "done", "solved"), got[2:], want[2:]):
    assert_close(f"{obj} {name}", g, w, atol=ATOL)
  # the supplied states reach both sides of the task's thresholds
  assert 0 < float(rewards[next(iter(rewards))].std())
  if obj != "key":
    assert 0 < float(got[3].sum()) < batch


_IDS = {"MtxHandObjHoldRandom-v0": ("hold", ("myoHandObjHoldRandom-v0",)),
        "MtxHandObjHoldFixed-v0": ("hold", ("myoHandObjHoldFixed-v0",)),
        "MtxHandDieReorient-v0": ("die", ("myoChallengeDieReorientP1-v0",
                                          "myoHandReorient-v0")),
        "MtxHandPenTwirlRandom-v0": ("pen", ("myoHandPenTwirlRandom-v0",)),
        "MtxHandPenTwirlFixed-v0": ("pen", ("myoHandPenTwirlFixed-v0",)),
        "MtxHandBaoding-v0": ("baoding", ("myoChallengeBaodingP1-v1",
                                          "myoHandBaodingRandom-v0")),
        "MtxHandKeyTurnRandom-v0": ("key", ("myoHandKeyTurnRandom-v0",)),
        "MtxHandKeyTurnFixed-v0": ("key", ("myoHandKeyTurnFixed-v0",))}
# (nv, nefc, contact slots) of each model
_SHAPES = {"hold": (29, 83, 15), "die": (29, 151, 32), "pen": (29, 87, 16),
           "baoding": (35, 147, 31), "key": (24, 168, 36)}


def test_registry_manip_ids_and_aliases():
  for name, (obj, aliases) in _IDS.items():
    assert name in registry.registered_envs()
    for a in aliases:
      assert registry.resolve(a) == name
    env = registry.make(aliases[0], device="cpu")
    assert type(env) is manipulation.ENVS[obj] and env.action_size == 39
    m = env.model
    assert (m.nv, m.plan["constraint"].nefc, m.ncon_max) == _SHAPES[obj]
    assert env.config["fixed_target"] == name.endswith("Fixed-v0")
  assert registry.make("MtxHandBaoding-v0", "cpu").max_episode_steps == 200
  assert registry.make("MtxHandDieReorient-v0", "cpu",
                       {"max_episode_steps": 7}).max_episode_steps == 7


def test_manip_make_needs_cuda_unless_cpu_is_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for name in _IDS:
    with pytest.raises(RuntimeError, match="CUDA is not available"):
      registry.make(name)
  assert registry.make("MtxHandBaoding-v0", "cpu").device.type == "cpu"


_ISOLATION = """
import sys
sys.modules["jax"] = None
sys.modules["mujoco"] = None
import torch
import myosuite_tpu_torch
from myosuite_tpu_torch.envs import manipulation
for name in ("MtxHandObjHoldRandom-v0", "MtxHandDieReorient-v0",
             "MtxHandPenTwirlRandom-v0", "MtxHandBaoding-v0",
             "MtxHandKeyTurnRandom-v0"):
  env = myosuite_tpu_torch.make(name, device="cpu")
  state = env.reset(torch.Generator().manual_seed(0), batch=1)
  assert torch.isfinite(state.obs["state"]).all(), name
bad = [k for k in sys.modules
       if k.split(".")[0] in ("myosuite_tpu", "jax", "flax", "mujoco",
                              "ml_collections")
       and sys.modules[k] is not None]
assert not bad, bad
print("ok")
"""


def test_manip_models_load_without_jax_or_mujoco():
  """With jax and mujoco unimportable, the port loads the five committed
  models and resets each env, and loads no module of the JAX package."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=repo,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("obj", OBJS)
def test_committed_manip_npz_matches_fresh_export(obj):
  _assert_committed_matches_fresh_export(f"myohand_{obj}.npz")


@pytest.mark.parametrize("obj", ["hold", "key"])
def test_autoreset_carries_task_info_where_done(obj, monkeypatch):
  """A batch in which envs 1 and 3 are done: they take the reset branch's
  physics, obs and task info (goal_pos, init_key), the others keep the
  stepped ones."""
  env = registry.make(MANIP_IDS[obj], device="cpu")
  B = 4
  done = torch.tensor([0.0, 1.0, 0.0, 1.0])
  monkeypatch.setattr(env, "_get_done", lambda state: done)
  wrapped = AutoResetWrapper(env)
  state = wrapped.reset(torch.Generator().manual_seed(0), B)
  # distinct per-env task info, so that a pick shows
  k = GOAL_KEYS[obj][0]
  state.info[k] = state.info[k] + torch.arange(1.0, B + 1).view(
      (B,) + (1,) * (state.info[k].dim() - 1))
  action = torch.rand(B, env.action_size,
                      generator=torch.Generator().manual_seed(1))
  # the wrapper's fresh reset, from a copy of its own stream
  copy = torch.Generator()
  copy.set_state(state.info["reset_generator"].get_state())
  fresh = env.reset(copy, B)
  stepped = env.step(state, action)
  out = wrapped.step(state, action)
  keep, took = [0, 2], [1, 3]
  assert torch.equal(out.info[k][keep], stepped.info[k][keep])
  assert torch.equal(out.info[k][took], fresh.info[k][took])
  assert not torch.equal(out.info[k][took], stepped.info[k][took])
  assert torch.equal(out.data.qpos[took], fresh.data.qpos[took])
  assert torch.equal(out.data.qpos[keep], stepped.data.qpos[keep])
  assert torch.equal(out.obs["state"][took], fresh.obs["state"][took])
  assert torch.equal(out.data.contact.dist[keep],
                     stepped.data.contact.dist[keep])
  assert torch.equal(out.data.contact.dist[took],
                     fresh.data.contact.dist[took])
  assert out.data.contact.geom1 is state.data.contact.geom1


# ---------------------------------------------------------------------------
# the golden file
# ---------------------------------------------------------------------------


def golden_actions(nu=39):
  rng = np.random.default_rng(2026)
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, nu)).astype(
      np.float32)


def _record(rec, state):
  d = state.data
  for k, v in zip(GOLDEN_FIELDS, (state.obs["state"], state.reward,
                                  state.done, d.qpos, d.qvel, d.act)):
    rec[k].append(np.asarray(v.cpu() if hasattr(v, "cpu") else v))


def jax_golden():
  """Every env in the JAX package at its fixed goal: batch 2, 3 control
  steps of numpy actions; obs, reward, done, qpos, qvel and act after each
  step."""
  out = {"actions": golden_actions()}
  for obj, (name, overrides) in GOLDEN_ENVS.items():
    env = myosuite_tpu.make(name, overrides)
    keys = jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH)
    state = jax.vmap(env.reset)(keys)
    step = jax.jit(jax.vmap(env.step))
    rec = {k: [] for k in GOLDEN_FIELDS}
    for a in out["actions"]:
      state = step(state, jnp.asarray(a))
      _record(rec, state)
    out.update({f"{obj}_{k}": np.stack(v) for k, v in rec.items()})
  return out


def port_replay(golden, device, obj):
  """The golden actions through the port's env of `obj`; returns the
  fields (numpy)."""
  name, overrides = GOLDEN_ENVS[obj]
  env = registry.make(name, device=device, overrides=overrides)
  state = env.reset(torch.Generator(device).manual_seed(0), GOLDEN_BATCH)
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in golden["actions"]:
    state = env.step(state, torch.from_numpy(a).to(device))
    _record(rec, state)
  return {k: np.stack(v) for k, v in rec.items()}


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("obj", OBJS)
def test_port_replays_manip_golden(obj):
  """The committed JAX trajectory, replayed through the port on the CPU,
  within the tolerances stored beside it (chip_smoke.py uses them too)."""
  golden = _golden()
  ours = port_replay(golden, "cpu", obj)
  for k in GOLDEN_FIELDS:
    assert_close(f"{obj} {k}", ours[k], golden[f"{obj}_{k}"],
                 atol=float(golden[f"atol_{obj}_{k}"]))


@pytest.mark.slow
def test_manip_golden_in_sync_with_jax():
  """The JAX package still produces the committed trajectories (tens of
  seconds of JAX compile per env on a CPU, hence slow)."""
  golden = _golden()
  for k, v in jax_golden().items():
    np.testing.assert_allclose(golden[k], v, rtol=1e-6, atol=1e-6,
                               err_msg=k)


def write_golden():
  """Write the golden file: the JAX trajectories plus, per env and field,
  the tolerance the port is held to: 10x the largest gap measured between
  the port (CPU) and the JAX package, and at least 1e-4 of the field's
  scale."""
  golden = jax_golden()
  tols = {}
  for obj in GOLDEN_ENVS:
    ours = port_replay(golden, "cpu", obj)
    for k in GOLDEN_FIELDS:
      ref = golden[f"{obj}_{k}"]
      gap = float(np.abs(ours[k] - ref).max())
      scale = float(np.abs(ref).max())
      tol = max(10 * gap, 1e-4 * max(scale, 1.0))
      tols[f"atol_{obj}_{k}"] = np.float64(tol)
      print(f"{obj} {k}: max gap {gap:.3e}, scale {scale:.3e}, "
            f"tolerance {tol:.3e}")
  np.savez(GOLDEN, **golden, **tols)
  print("wrote", GOLDEN)


def write_manip_npz():
  for obj in OBJS:
    name = f"myohand_{obj}.npz"
    fields, extra = EXPORTS[name]()
    path = os.path.join(registry.ASSETS, name)
    tio.save_model(path, fields, **extra)
    print("wrote", path)


if __name__ == "__main__":
  write_manip_npz()
  write_golden()
