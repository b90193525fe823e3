"""Port model loading against the JAX package, and the port's isolation.

Run as a script to regenerate the port's model files in
myosuite_tpu_torch/assets/ (myohand_reach.npz: the myoHand and its reach
task; myoelbow.npz: the elbow and its pose task; myofinger.npz: the finger
and its pose and reach tasks), compiled by MuJoCo here so that the port
loads them without MuJoCo:

  JAX_PLATFORMS=cpu python -m tests.test_torch_io
"""

import os
import subprocess
import sys

import mujoco
import numpy as np
import pytest
import torch

from myosuite_tpu.physics import io as jax_io
from myosuite_tpu_torch.envs import registry as torch_registry
from myosuite_tpu_torch.physics import io as torch_io
from myosuite_tpu_torch.physics import types as torch_types
from tests.common import CHAIN_XML, MUSCLE_XML
from tests.test_actuation_parity import WRAP_XML
from tests.torch_common import EXPORTS, jax_fields, write_export

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_models_equal(a, b):
  assert a.sizes == b.sizes
  assert a.body_tree == b.body_tree
  for k in torch_types.STRUCT_FIELDS:
    x, y = np.asarray(a.struct[k]), np.asarray(b.struct[k])
    assert x.shape == y.shape and np.array_equal(x, y), k
  for k in torch_types.PARAM_FIELDS:
    assert a.params[k].dtype == torch.float32, k
    assert torch.equal(a.params[k], b.params[k]), k
  for k in torch_types.OPTION_STATIC:
    assert getattr(a.opt, k) == getattr(b.opt, k), k
  for k in torch_types.OPTION_PARAMS:
    assert torch.equal(getattr(a.opt, k), getattr(b.opt, k)), k


@pytest.mark.parametrize("xml", [CHAIN_XML, MUSCLE_XML, WRAP_XML],
                         ids=["chain", "muscle", "wrap"])
def test_model_from_jax_fields_matches_put_model(xml, tmp_path):
  mj = mujoco.MjModel.from_xml_string(xml)
  from_jax = torch_io.model_from_numpy(jax_fields(jax_io.put_model(mj)),
                                       device="cpu")
  ours = torch_io.put_model(mj, device="cpu")
  _assert_models_equal(from_jax, ours)
  # and through the .npz round trip
  path = str(tmp_path / "model.npz")
  torch_io.save_model(path, torch_io.model_fields(mj), cfg_x=np.arange(3))
  loaded, extra = torch_io.load_model(path, "cpu")
  _assert_models_equal(ours, loaded)
  assert list(extra) == ["cfg_x"]


def _assert_committed_matches_fresh_export(name):
  fields, extra = EXPORTS[name]()
  fresh = {**fields, **extra}
  with np.load(os.path.join(torch_registry.ASSETS, name)) as z:
    committed = {k: z[k] for k in z.files}
  assert sorted(committed) == sorted(fresh)
  for k, v in fresh.items():
    c = committed[k]
    assert c.dtype == v.dtype and c.shape == v.shape, k
    assert np.array_equal(c, v), k   # bit-equal floats, exact ints


def test_committed_hand_npz_matches_fresh_export():
  _assert_committed_matches_fresh_export("myohand_reach.npz")


def test_committed_elbow_npz_matches_fresh_export():
  _assert_committed_matches_fresh_export("myoelbow.npz")


def test_committed_finger_npz_matches_fresh_export():
  _assert_committed_matches_fresh_export("myofinger.npz")


_ISOLATION = """
import sys
sys.modules["jax"] = None
sys.modules["mujoco"] = None
sys.modules["gymnasium"] = None
sys.modules["h5py"] = None
import torch
import myosuite_tpu_torch
from myosuite_tpu_torch.physics import forward, newton_kernel, solver
from myosuite_tpu_torch.envs import fatigue, pose, wrappers
from myosuite_tpu_torch.train import (callbacks, checkpoint, convert,
                                      networks, ppo, running_stats,
                                      train_ppo)
env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device="cpu")
state = env.reset(torch.Generator().manual_seed(0), batch=2)
state = env.step(state, torch.full((2, env.action_size), 0.5))
assert torch.isfinite(state.obs["state"]).all()
from myosuite_tpu_torch.envs import myodm, sar, tracking
from myosuite_tpu_torch.logger import reference_motion
for name in ("MtxFatiArmReachFixed-v0", "MtxSarcTorsoPoseFixed-v0",
             "MtxReafHandPoseRandom-v0", "MtxHandReorient8-v0",
             "MtxElbowPoseExoRandom-v0", "MtxHandMugLift-v0"):
  env = myosuite_tpu_torch.make(name, device="cpu")
  state = env.step(env.reset(torch.Generator().manual_seed(0), batch=1),
                   torch.full((1, env.action_size), 0.5))
  assert torch.isfinite(state.obs["state"]).all(), name
cfg = ppo.default_config()
cfg.num_envs, cfg.unroll_length, cfg.num_minibatches = 2, 1, 1
cfg.num_updates_per_batch = 1
trainer = ppo.PPO(myosuite_tpu_torch.make("MtxFingerPoseRandom-v0",
                                          device="cpu"), cfg)
ts, metrics = trainer.training_step(
    trainer.init(torch.Generator().manual_seed(0)))
assert all(torch.isfinite(v) for v in metrics.values())
from myosuite_tpu_torch.train import npg, sac
from myosuite_tpu_torch.agents import launcher, pretrained, reflex
from myosuite_tpu_torch.envs import gym_adapter, obs_vec
assert gym_adapter.gym is None
elbow = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
trainer, learner = pretrained.load("MtxElbowPoseRandom-v0", env=elbow)
out = pretrained.evaluate(trainer, learner, torch.Generator().manual_seed(0),
                          batch=2, horizon=1)
assert torch.isfinite(out["returns"]).all()
cfg = sac.default_config()
cfg.num_envs, cfg.unroll_length, cfg.replay_capacity = 2, 1, 4
cfg.learning_starts, cfg.batch_size, cfg.grad_updates_per_epoch = 0, 2, 1
cfg.policy_hidden = cfg.q_hidden = (8,)
trainer = sac.SAC(elbow, cfg)
ts, metrics = trainer.training_step(trainer.init(torch.Generator()))
assert float(metrics["q_loss"]) > 0
cfg = npg.default_config()
cfg.num_envs, cfg.unroll_length, cfg.cg_iters = 2, 1, 2
cfg.value_batches, cfg.policy_hidden, cfg.value_hidden = 1, (8,), (8,)
trainer = npg.NPG(elbow, cfg)
ts, metrics = trainer.training_step(trainer.init(torch.Generator()))
assert all(torch.isfinite(v) for v in metrics.values())
from myosuite_tpu_torch.parallel import mesh
from myosuite_tpu_torch.robot import robot
from myosuite_tpu_torch.utils import (curriculum, examine_env,
                                      inverse_kinematics, quat_math,
                                      trajectories, vector_math)
from myosuite_tpu_torch.logger import examine_logs, roboset, trace
from myosuite_tpu_torch import native
from myosuite_tpu_torch.renderer import Renderer, renderer
from myosuite_tpu_torch.envs import visual, visual_nets
from myosuite_tpu_torch.utils import examine_sim, html, render_cams
frame = Renderer(elbow, 16, 12).render(elbow.reset(
    torch.Generator().manual_seed(0), 2).data)
assert frame.shape == (2, 12, 16, 3) and bool(frame.any())
from myosuite_tpu_torch import mjcf
from myosuite_tpu_torch.mjcf import builder, editor, export, hand, leg, sweep
from myosuite_tpu_torch.mjcf import torso
from myosuite_tpu_torch.utils import (dict_utils, paths_utils, prompt_utils,
                                      tensor_utils, xml_utils)
assert hand.build_hand().count("<muscle ") == 39
assert export.SOURCES["myoleg.npz"]() == leg.build_leg()
try:
  myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu",
                          overrides={"model_xml": builder.build_elbow()})
  raise AssertionError("model_xml compiled without MuJoCo")
except ImportError as e:
  assert "MuJoCo" in str(e), e
ik = inverse_kinematics.qpos_from_site_pose(
    elbow.model, elbow.reset(torch.Generator().manual_seed(0), 2).data, 0,
    torch.zeros(2, 3), max_steps=2)
assert ik.steps.tolist() == [2, 2]
bad = [k for k in sys.modules
       if k.split(".")[0] in ("myosuite_tpu", "jax", "flax", "mujoco",
                              "ml_collections", "optax", "orbax",
                              "gymnasium", "h5py")
       and sys.modules[k] is not None]
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax_and_no_myosuite_tpu():
  """With jax, mujoco and gymnasium unimportable, the port imports every
  module, steps the committed hand model, the Fati arm reach, the Sarc
  torso, the Reaf hand, SAR's Reorient8 and ElbowPoseExoRandom (per-env
  models) and a MyoDM id, takes a PPO training step on the finger,
  restores the committed elbow policy, takes one SAC and one NPG step at a
  tiny config on the elbow, imports the mesh, robot, utils, logger,
  native, renderer and visual modules, draws the elbow, runs two IK
  iterations, imports the MJCF builders, the exporter, the sweep and the
  host helpers, builds the hand's MJCF string, sees the model_xml route
  raise the MuJoCo ImportError, and loads no module of the JAX package,
  flax, optax, orbax, gymnasium or h5py."""
  proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=_REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().endswith("ok")


def test_make_needs_cuda_unless_cpu_is_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    torch_registry.make("MtxHandReachRandom-v0")
  env = torch_registry.make("myoHandReachFixed-v0", device="cpu")
  assert env.device.type == "cpu" and env.action_size == 39


def _write_npz_files():
  for name in EXPORTS:
    write_export(name)


if __name__ == "__main__":
  _write_npz_files()
