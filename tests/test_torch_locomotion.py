"""The port's myoLeg envs and terrain against the JAX package.

Heightfield sampling, the egocentric heightmap and each terrain
generator's transform are held against the JAX package on the same inputs
and the same uniform draws; the registry's leg ids, the committed leg
model files, and the auto-reset's pick of the contact set are checked on
the CPU. The leg golden file (myosuite_tpu_torch/assets/
leg_walk_golden.npz) holds 3 control steps of MtxLegWalk-v0 (reset
"init") and MtxLegWalkRough-v0 (on one supplied terrain) stepped by the
JAX package; tier-1 replays it through the port with no JAX compile, and
`chip_smoke.py` replays it on the card. Regenerate it and the leg model
files with

  JAX_PLATFORMS=cpu python -m tests.test_torch_locomotion
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_tpu.envs import heightfields as jhf
from myosuite_tpu_torch.envs import heightfields as thf
from myosuite_tpu_torch.envs import locomotion, registry
from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
from myosuite_tpu_torch.physics import io as tio
from tests.torch_common import EXPORTS, assert_close

GOLDEN = os.path.join(registry.ASSETS, "leg_walk_golden.npz")
GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")
GOLDEN_ENVS = {"walk": "MtxLegWalk-v0", "rough": "MtxLegWalkRough-v0"}
GOLDEN_BATCH, GOLDEN_STEPS = 4, 3
LEG_NPZ = ("myoleg.npz", "myoleg_terrain.npz")


def _field(seed, nrow=12, ncol=16):
  rng = np.random.default_rng(seed)
  return rng.uniform(-0.1, 0.2, (nrow, ncol)).astype(np.float32)


def test_sample_height_matches_jax():
  """Bilinear lookups on one field, inside it, on its border and beyond
  it (clamped)."""
  hf = _field(0)
  extent, base = (4.0, 2.0), (0.5, -0.25)
  rng = np.random.default_rng(1)
  xy = rng.uniform(-3.0, 3.0, (40, 2)).astype(np.float32)
  xy[:4] = [[0.5, -0.25], [-1.5, -1.25], [2.5, 0.75], [100.0, -100.0]]
  got = thf.sample_height(torch.from_numpy(hf)[None],
                          torch.from_numpy(xy)[None], extent, base)[0]
  want = jax.vmap(lambda p: jhf.sample_height(jnp.asarray(hf), p, extent,
                                              base))(jnp.asarray(xy))
  assert_close("sample_height", got, want, atol=1e-6)


def test_egocentric_heightmap_matches_jax():
  """Three envs, each with its own field, root position and yaw."""
  hfs = np.stack([_field(s) for s in range(3)])
  root = np.array([[0.1, 0.2], [-1.0, 0.4], [1.7, -0.8]], dtype=np.float32)
  yaw = np.array([0.0, 0.7, -2.5], dtype=np.float32)
  extent, base = (4.0, 2.0), (0.5, -0.25)
  got = thf.egocentric_heightmap(torch.from_numpy(hfs),
                                 torch.from_numpy(root),
                                 torch.from_numpy(yaw), extent, base=base)
  for b in range(3):
    want = jhf.egocentric_heightmap(jnp.asarray(hfs[b]), jnp.asarray(root[b]),
                                    jnp.asarray(yaw[b]), extent, base=base)
    assert_close(f"egocentric_heightmap env {b}", got[b], want, atol=1e-5)


def _jax_with_draws(monkeypatch, u):
  """jax.random.uniform returning the supplied [0, 1) draws, scaled to
  [minval, maxval) as jax.random.uniform scales its own."""
  def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
    return jnp.asarray(u, dtype).reshape(shape) * (maxval - minval) + minval
  monkeypatch.setattr(jax.random, "uniform", uniform)


@pytest.mark.parametrize("kind", ["rough", "hilly", "stairs"])
def test_generator_transform_matches_jax(kind, monkeypatch):
  """The port's transform of uniform draws against the JAX generator fed
  the same draws, for two envs."""
  shape = (8, 30)
  rng = np.random.default_rng(2)
  grid_u = rng.uniform(0, 1, (2,) + shape).astype(np.float32)
  scalar_u = rng.uniform(0, 1, 2).astype(np.float32)
  code = int(thf.TerrainType[kind.upper()])
  got = thf.from_draws(torch.full((2,), code), torch.from_numpy(grid_u),
                       torch.from_numpy(scalar_u))
  for b in range(2):
    _jax_with_draws(monkeypatch, grid_u[b] if kind == "rough"
                    else scalar_u[b])
    want = getattr(jhf, kind)(jax.random.PRNGKey(0), shape)
    assert_close(f"{kind} env {b}", got[b], want, atol=1e-6)


def test_generators_deterministic_shapes_ranges():
  shape = (16, 32)
  codes = torch.tensor([0, 1, 2, 3, 1, 2, 3])
  a = thf.generate(torch.Generator().manual_seed(3), codes, shape)
  b = thf.generate(torch.Generator().manual_seed(3), codes, shape)
  assert a.shape == (7,) + shape and a.dtype == torch.float32
  assert torch.equal(a, b)
  assert float(a[0].abs().max()) == 0.0                      # flat
  for i in range(1, 7):
    assert float(a[i].std()) > 0                             # non-flat
  assert 0.0 <= float(a[[1, 4]].min()) and float(a[[1, 4]].max()) <= 0.05
  assert 0.0 <= float(a[[2, 5]].min()) and float(a[[2, 5]].max()) <= 0.15
  # stairs: up then down in steps of one height, at most 0.08 each
  prof = a[3, 0]
  steps = prof.diff()
  assert float(steps.abs().max()) <= 0.08
  assert float(prof[0]) == 0.0 and float(prof[-1]) == 0.0
  c = thf.generate(torch.Generator().manual_seed(4), codes, shape)
  assert not torch.equal(a[1], c[1])


def test_registry_leg_ids_and_aliases():
  ids = {"MtxLegWalk-v0": (locomotion.WalkEnv, ("myoLegWalk-v0",)),
         "MtxLegStand-v0": (locomotion.StandEnv,
                            ("myoLegReachFixed-v0", "myoLegStand-v0")),
         "MtxLegWalkRough-v0": (locomotion.TerrainWalkEnv,
                                ("myoLegRoughTerrainWalk-v0",)),
         "MtxLegWalkHilly-v0": (locomotion.TerrainWalkEnv,
                                ("myoLegHillyTerrainWalk-v0",)),
         "MtxLegWalkStairs-v0": (locomotion.TerrainWalkEnv,
                                 ("myoLegStairTerrainWalk-v0",))}
  for name, (cls, aliases) in ids.items():
    assert name in registry.registered_envs()
    for a in aliases:
      assert registry.resolve(a) == name
    env = registry.make(aliases[0], device="cpu")
    assert type(env) is cls and env.action_size == 80
    assert env.model.ncon_max == 10 and env.model.nv == 20
    assert env.model.plan["constraint"].nefc == 54
  terrain = registry.make("MtxLegWalkHilly-v0", device="cpu")
  assert terrain.config["terrain_type"] == "hilly"
  assert terrain.model.hfield_nrow == 48 and terrain.model.hfield_ncol == 192
  assert registry.make("myoLegStand-v0", "cpu").max_episode_steps == 300


_ISOLATION = """
import sys
sys.modules["jax"] = None
sys.modules["mujoco"] = None
import torch
import myosuite_tpu_torch
from myosuite_tpu_torch.envs import heightfields, locomotion, wrappers
from myosuite_tpu_torch.physics import collision
env = wrappers.AutoResetWrapper(
    myosuite_tpu_torch.make("myoLegHillyTerrainWalk-v0", device="cpu"))
state = env.reset(torch.Generator().manual_seed(0), batch=1)
state = env.step(state, torch.full((1, env.action_size), 0.5))
assert torch.isfinite(state.obs["state"]).all()
bad = [k for k in sys.modules
       if k.split(".")[0] in ("myosuite_tpu", "jax", "flax", "mujoco",
                              "ml_collections")
       and sys.modules[k] is not None]
assert not bad, bad
print("ok")
"""


def test_leg_runs_without_jax_or_mujoco():
  """With jax and mujoco unimportable, the port loads the committed
  terrain leg and steps it through the auto-reset wrapper, and loads no
  module of the JAX package."""
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=repo,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("ok")


def test_leg_make_needs_cuda_unless_cpu_is_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    registry.make("MtxLegWalk-v0")
  assert registry.make("MtxLegWalk-v0", device="cpu").device.type == "cpu"


def _committed_matches_fresh_export(name):
  fields, extra = EXPORTS[name]()
  fresh = {**fields, **extra}
  with np.load(os.path.join(registry.ASSETS, name)) as z:
    committed = {k: z[k] for k in z.files}
  assert sorted(committed) == sorted(fresh)
  for k, v in fresh.items():
    c = committed[k]
    assert c.dtype == v.dtype and c.shape == v.shape, k
    assert np.array_equal(c, v), k   # bit-equal floats, exact ints


@pytest.mark.parametrize("name", LEG_NPZ)
def test_committed_leg_npz_matches_fresh_export(name):
  _committed_matches_fresh_export(name)


def test_autoreset_takes_reset_contacts_where_done(monkeypatch):
  """A leg batch on terrain in which envs 1 and 3 are done: they take the
  reset branch's contact set and terrain, the others keep the stepped
  ones; the static per-slot tables pass through."""
  env = registry.make("MtxLegWalkRough-v0", device="cpu",
                      overrides={"reset_type": "none"})
  B = 4
  done = torch.tensor([0.0, 1.0, 0.0, 1.0])
  monkeypatch.setattr(env, "_get_done", lambda state: done)
  wrapped = AutoResetWrapper(env)
  state = wrapped.reset(torch.Generator().manual_seed(0), B)
  action = torch.rand(B, env.action_size,
                      generator=torch.Generator().manual_seed(1))
  stepped = env.step(state, action)            # what the wrapper steps to
  out = wrapped.step(state, action)
  # the wrapper's fresh reset comes from its own generator
  fresh = env.reset(torch.Generator().manual_seed(0), B)
  keep, took = [0, 2], [1, 3]
  for f in ("dist", "pos", "frame", "includemargin", "friction", "solref",
            "solimp"):
    got = getattr(out.data.contact, f)
    assert torch.equal(got[keep], getattr(stepped.data.contact, f)[keep]), f
    # reset_type "none": the stance at qpos0 on the flat spawn pad,
    # whatever terrain the wrapper's generator drew
    assert torch.equal(got[took], getattr(fresh.data.contact, f)[took]), f
  assert torch.equal(out.data.ncon_active[keep],
                     stepped.data.ncon_active[keep])
  assert torch.equal(out.data.contact_force[keep],
                     stepped.data.contact_force[keep])
  assert float(out.data.contact_force[took].abs().max()) == 0.0
  assert torch.equal(out.data.hfield_data[keep],
                     stepped.data.hfield_data[keep])
  assert not torch.equal(out.data.hfield_data[took],
                         stepped.data.hfield_data[took])
  for f in ("geom1", "geom2", "dim"):
    assert getattr(out.data.contact, f) is getattr(state.data.contact, f)
  assert torch.isfinite(out.obs["state"]).all()


# ---------------------------------------------------------------------------
# the leg golden file
# ---------------------------------------------------------------------------


def golden_actions(nu=80):
  rng = np.random.default_rng(2025)
  return rng.uniform(0, 1, (GOLDEN_STEPS, GOLDEN_BATCH, nu)).astype(
      np.float32)


def golden_terrain(nrow=48, ncol=192):
  """The supplied terrain: 3x3-blurred uniform noise of up to 1 cm over
  the whole field, so the feet stand on bumps from the first substep."""
  rng = np.random.default_rng(7)
  noise = np.pad(rng.uniform(0, 0.01, (nrow, ncol)), 1)
  blur = sum(noise[i:i + nrow, j:j + ncol] for i in range(3)
             for j in range(3)) / 9.0
  return blur.astype(np.float32)


def _record(rec, obs, reward, done, qpos, qvel, act):
  for k, v in zip(GOLDEN_FIELDS, (obs, reward, done, qpos, qvel, act)):
    rec[k].append(np.asarray(v.cpu() if hasattr(v, "cpu") else v))


def jax_golden():
  """Both envs in the JAX package: batch 4, 3 control steps of numpy
  actions; obs, reward, done, qpos, qvel and act after each step."""
  import myosuite_tpu
  out = {"actions": golden_actions(), "hfield": golden_terrain()}
  for tag, name in GOLDEN_ENVS.items():
    env = myosuite_tpu.make(name, {"reset_type": "init"} if tag == "walk"
                            else None)
    keys = jax.random.split(jax.random.PRNGKey(0), GOLDEN_BATCH)
    state = jax.vmap(env.reset)(keys)
    if tag == "rough":
      hf = jnp.asarray(out["hfield"])

      def supply(s):
        data = env._make_data(s.data.qpos, s.data.qvel, hfield=hf)
        return s.replace(data=data, obs=env._get_obs(data, s.info))
      state = jax.vmap(supply)(state)
    step = jax.jit(jax.vmap(env.step))
    rec = {k: [] for k in GOLDEN_FIELDS}
    for a in out["actions"]:
      state = step(state, jnp.asarray(a))
      _record(rec, state.obs["state"], state.reward, state.done,
              state.data.qpos, state.data.qvel, state.data.act)
    out.update({f"{tag}_{k}": np.stack(v) for k, v in rec.items()})
  return out


def port_replay(golden, device, tag):
  """The golden actions through the port's env `tag`; returns the fields
  (numpy)."""
  overrides = {"reset_type": "init"} if tag == "walk" else None
  env = registry.make(GOLDEN_ENVS[tag], device=device, overrides=overrides)
  gen = torch.Generator(device).manual_seed(0)
  if tag == "rough":
    hf = torch.from_numpy(golden["hfield"]).to(device)
    state = env.reset(gen, GOLDEN_BATCH,
                      hfield=hf.expand(GOLDEN_BATCH, -1, -1).clone())
  else:
    state = env.reset(gen, GOLDEN_BATCH)
  rec = {k: [] for k in GOLDEN_FIELDS}
  for a in golden["actions"]:
    state = env.step(state, torch.from_numpy(a).to(device))
    _record(rec, state.obs["state"], state.reward, state.done,
            state.data.qpos, state.data.qvel, state.data.act)
  return {k: np.stack(v) for k, v in rec.items()}


def _golden():
  with np.load(GOLDEN) as z:
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("tag", list(GOLDEN_ENVS))
def test_port_replays_leg_golden(tag):
  """The committed JAX trajectory, replayed through the port on the CPU,
  within the tolerances stored beside it (chip_smoke.py uses them too)."""
  golden = _golden()
  ours = port_replay(golden, "cpu", tag)
  for k in GOLDEN_FIELDS:
    assert_close(f"{tag} {k}", ours[k], golden[f"{tag}_{k}"],
                 atol=float(golden[f"atol_{tag}_{k}"]))


@pytest.mark.slow
def test_leg_golden_in_sync_with_jax():
  """The JAX package still produces the committed trajectories (~25 s of
  JAX compile per env on a CPU, hence slow)."""
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
  for tag in GOLDEN_ENVS:
    ours = port_replay(golden, "cpu", tag)
    for k in GOLDEN_FIELDS:
      ref = golden[f"{tag}_{k}"]
      gap = float(np.abs(ours[k] - ref).max())
      scale = float(np.abs(ref).max())
      tol = max(10 * gap, 1e-4 * max(scale, 1.0))
      tols[f"atol_{tag}_{k}"] = np.float64(tol)
      print(f"{tag} {k}: max gap {gap:.3e}, scale {scale:.3e}, "
            f"tolerance {tol:.3e}")
  np.savez(GOLDEN, **golden, **tols)
  print("wrote", GOLDEN)


def write_leg_npz():
  for name in LEG_NPZ:
    fields, extra = EXPORTS[name]()
    path = os.path.join(registry.ASSETS, name)
    tio.save_model(path, fields, **extra)
    print("wrote", path)


if __name__ == "__main__":
  write_leg_npz()
  write_golden()
