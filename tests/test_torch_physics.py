"""Port physics stages against the JAX package, stage by stage.

The same MuJoCo-randomized states go through the JAX functions (jitted, one
env at a time) and through the port (one batch). Tolerances are those of
tests/test_smooth_parity.py and tests/test_actuation_parity.py.
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from myosuite_tpu.physics import actuation as jax_actuation
from myosuite_tpu.physics import constraint as jax_constraint
from myosuite_tpu.physics import forward as jax_forward
from myosuite_tpu.physics import io as jax_io
from myosuite_tpu.physics import kinematics as jax_kinematics
from myosuite_tpu.physics import smooth as jax_smooth
from myosuite_tpu.physics import tendon as jax_tendon
from myosuite_tpu_torch.physics import (actuation, constraint, forward, io,
                                        kinematics, linalg, smooth, tendon)
from tests.common import CHAIN_XML, MUSCLE_XML, jitted_pipeline
from tests.common import randomize_state
from tests.test_actuation_parity import WRAP_XML
from tests.test_step_parity import LIMIT_XML
from tests.torch_common import TENDON_LIMIT_XML

SEEDS = (0, 1, 2)
_MODELS = {}


def _models(xml):
  if xml not in _MODELS:
    mj = mujoco.MjModel.from_xml_string(xml)
    _MODELS[xml] = (mj, jax_io.put_model(mj), io.put_model(mj, "cpu"))
  return _MODELS[xml]


def _states(mj):
  """Numpy (qpos, qvel, ctrl, act), one row per seed."""
  rows = []
  for seed in SEEDS:
    d = randomize_state(mj, seed=seed)
    rng = np.random.RandomState(seed + 100)
    ctrl = rng.uniform(0, 1, mj.nu)
    act = rng.uniform(0.1, 0.9, mj.na)
    rows.append((d.qpos.copy(), d.qvel.copy(), ctrl, act))
  return [np.stack(x).astype(np.float32) for x in zip(*rows)]


def _run_both(xml, jax_stages, torch_stages):
  mj, jm, tm = _models(xml)
  qpos, qvel, ctrl, act = _states(mj)
  run = jitted_pipeline(jm, *jax_stages)
  jax_out = []
  for i in range(len(SEEDS)):
    d = jax_io.make_data(jm).replace(
        qpos=jnp.asarray(qpos[i]), qvel=jnp.asarray(qvel[i]),
        ctrl=jnp.asarray(ctrl[i]), act=jnp.asarray(act[i]))
    jax_out.append(run(d))
  t = lambda x: torch.from_numpy(x)
  d = io.make_data(tm, len(SEEDS), "cpu").replace(
      qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl), act=t(act))
  for f in torch_stages:
    d = f(tm, d)
  return jm, tm, jax_out, d


def _check(jax_out, d, fields, **tol):
  for name in fields:
    ref = np.stack([np.asarray(getattr(o, name)) for o in jax_out])
    np.testing.assert_allclose(getattr(d, name).numpy(), ref,
                               err_msg=name, **tol)


_JAX_POS = (jax_kinematics.kinematics, jax_kinematics.com_pos,
            jax_kinematics.com_vel)
_TORCH_POS = (kinematics.kinematics, kinematics.com_pos, kinematics.com_vel)


@pytest.mark.parametrize("xml", [CHAIN_XML, MUSCLE_XML, WRAP_XML],
                         ids=["chain", "muscle", "wrap"])
def test_kinematics(xml):
  _, _, jax_out, d = _run_both(xml, _JAX_POS, _TORCH_POS)
  _check(jax_out, d, ["xpos", "xmat", "xipos", "ximat", "xanchor", "xaxis",
                      "geom_xpos", "geom_xmat", "site_xpos", "site_xmat",
                      "subtree_com", "cdof"], atol=1e-5)
  ours = d.xquat.numpy()
  ref = np.stack([np.asarray(o.xquat) for o in jax_out])
  sign = np.sign(np.sum(ours * ref, axis=-1, keepdims=True))
  np.testing.assert_allclose(ours * sign, ref, atol=1e-5)
  _check(jax_out, d, ["cinert", "cvel", "cdof_dot"], atol=1e-4)


@pytest.mark.parametrize("xml", [MUSCLE_XML, WRAP_XML],
                         ids=["muscle", "wrap"])
def test_tendon_and_wrap(xml):
  _, _, jax_out, d = _run_both(
      xml, _JAX_POS + (jax_tendon.tendon, jax_tendon.tendon_velocity),
      _TORCH_POS + (tendon.tendon, tendon.tendon_velocity))
  _check(jax_out, d, ["ten_length"], atol=1e-5)
  _check(jax_out, d, ["ten_J", "ten_velocity"], atol=1e-4)


@pytest.mark.parametrize("xml", [MUSCLE_XML, WRAP_XML],
                         ids=["muscle", "wrap"])
def test_actuation(xml):
  _, _, jax_out, d = _run_both(
      xml, _JAX_POS + (jax_tendon.tendon, jax_tendon.tendon_velocity,
                       jax_actuation.transmission,
                       jax_actuation.actuator_velocity,
                       jax_actuation.actuation),
      _TORCH_POS + (tendon.tendon, tendon.tendon_velocity,
                    actuation.transmission, actuation.actuator_velocity,
                    actuation.actuation))
  _check(jax_out, d, ["actuator_length"], atol=1e-5)
  _check(jax_out, d, ["actuator_moment", "actuator_velocity"], atol=1e-4)
  _check(jax_out, d, ["act_dot"], atol=1e-3)
  _check(jax_out, d, ["actuator_force", "qfrc_actuator"], rtol=2e-3,
         atol=1e-3)


@pytest.mark.parametrize("xml", [CHAIN_XML, MUSCLE_XML],
                         ids=["chain", "muscle"])
def test_crb_rne_passive(xml):
  jax_stages = _JAX_POS + (jax_tendon.tendon, jax_tendon.tendon_velocity,
                           jax_smooth.crb, jax_smooth.rne,
                           jax_smooth.passive)
  torch_stages = _TORCH_POS + (tendon.tendon, tendon.tendon_velocity,
                               smooth.crb, smooth.rne, smooth.passive)
  _, tm, jax_out, d = _run_both(xml, jax_stages, torch_stages)
  _check(jax_out, d, ["qM", "qfrc_bias"], atol=1e-4)
  _check(jax_out, d, ["qfrc_passive"], atol=1e-5)
  # factor + solve round trip (linalg semantics)
  y = torch.from_numpy(np.random.RandomState(0).randn(
      len(SEEDS), tm.nv).astype(np.float32))
  x = linalg.solve_pd(d.qM, y)
  np.testing.assert_allclose(torch.matmul(d.qM, x[..., None])[..., 0], y,
                             atol=1e-3)


@pytest.mark.parametrize("xml", [LIMIT_XML, TENDON_LIMIT_XML],
                         ids=["friction_and_joint_limit", "tendon_limit"])
def test_make_efc(xml):
  stages = _JAX_POS + (jax_tendon.tendon,)
  jm, tm, jax_out, d = _run_both(
      xml, stages, _TORCH_POS + (tendon.tendon,))
  efc = constraint.make_efc(tm, d)
  refs = [jax_constraint.make_efc(jm, o) for o in jax_out]
  assert efc.n_friction == int(np.asarray(refs[0].is_friction).sum())
  assert not np.asarray(refs[0].is_friction)[efc.n_friction:].any()
  for name in ("J", "aref", "R", "floss", "active"):
    ref = np.stack([np.asarray(getattr(r, name)) for r in refs])
    ours = getattr(efc, name).numpy()
    assert ours.shape == ref.shape, name
    if name == "active":
      np.testing.assert_array_equal(ours, ref)
    else:
      np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4,
                                 err_msg=name)


def test_make_efc_contact_rows_of_elbow():
  """make_efc gives the elbow contact's pyramidal rows after the limit
  row."""
  _, _, tm = _models(MUSCLE_XML)   # its arm capsules have a contact slot
  d = io.make_data(tm, 1, "cpu")
  efc = constraint.make_efc(tm, d)
  plan = tm.plan["constraint"]
  assert (plan.n_jlim, plan.n_con, plan.nefc) == (1, 4, 5)
  assert efc.J.shape == (1, 5, 1)
  assert plan.con_slots.tolist() == [-1, 0, 0, 0, 0]


def test_integrate_qpos_free_ball_hinge_slide():
  """Position integration on CHAIN_XML (free, ball, hinge and slide
  joints): the quaternion entries stay on the manifold as in JAX."""
  mj, jm, tm = _models(CHAIN_XML)
  qpos, qvel, _, _ = _states(mj)
  qvel = qvel * 20.0   # large enough to turn the quaternions visibly
  ours = forward._integrate_qpos(tm, torch.from_numpy(qpos),
                                 torch.from_numpy(qvel), 0.002)
  ref = np.stack([np.asarray(jax_forward._integrate_qpos(
      jm, jnp.asarray(q), jnp.asarray(v), 0.002)) for q, v in zip(qpos, qvel)])
  np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_xfrc_projection():
  mj, jm, tm = _models(CHAIN_XML)
  xfrc = np.random.default_rng(0).standard_normal(
      (len(SEEDS), mj.nbody, 6)).astype(np.float32)
  xfrc[:, 0] = 0.0
  _, _, jax_out, d = _run_both(CHAIN_XML, _JAX_POS, _TORCH_POS)
  ours = forward.xfrc_projection(tm, d.replace(
      xfrc_applied=torch.from_numpy(xfrc)))
  ref = np.stack([np.asarray(jax_forward.xfrc_projection(
      jm, o.replace(xfrc_applied=jnp.asarray(x))))
      for o, x in zip(jax_out, xfrc)])
  np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
