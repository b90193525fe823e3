"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs: a JAX `Model`'s fields become the port's
field dict, and states, actions and targets are made with numpy.
"""

import dataclasses
import functools

import jax
import mujoco
import numpy as np

from tests.common import MUSCLE_XML
from tests.test_step_parity import LIMIT_XML


def solver_6x6(xml):
  """The model with the main path's solver settings (6 Newton iterations of
  6 line-search steps, as the myo models set): MuJoCo's defaults of 100 x 50
  make the JAX step take minutes to compile on a CPU."""
  return xml.replace('<option timestep="0.002"/>',
                     '<option timestep="0.002" iterations="6" '
                     'ls_iterations="6"/>')


# The full muscle arm: its two capsules touch at the elbow, a contact slot.
MUSCLE_XML6 = solver_6x6(MUSCLE_XML)
# The arm with geom collisions switched off, for the tests that step it
# without contacts.
MUSCLE_NOCON_XML = MUSCLE_XML6.replace(
    "<worldbody>",
    '<default><geom contype="0" conaffinity="0"/></default>\n  <worldbody>')
LIMIT6_XML = solver_6x6(LIMIT_XML)

# The same arm with a limited tendon, for tendon-limit constraint rows.
TENDON_LIMIT_XML = MUSCLE_NOCON_XML.replace(
    '<spatial name="ext">', '<spatial name="ext" limited="true" '
    'range="0.30 0.36">')


def assert_close(name, ours, ref, atol=0.0, rtol=0.0):
  """assert_allclose of a port result (tensor or array) against the JAX
  package's, printing the measured gap (`pytest -s` shows it)."""
  ours = np.asarray(ours.detach().cpu() if hasattr(ours, "detach") else ours,
                    dtype=np.float64)
  ref = np.asarray(ref, dtype=np.float64)
  gap = float(np.abs(ours - ref).max()) if ours.size else 0.0
  print(f"parity gap {name}: {gap:.3e} (atol {atol:g}, rtol {rtol:g})")
  np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol, err_msg=name)


def jax_fields(m):
  """A JAX `Model`'s fields through `jax.device_get`, as the field dict the
  port's `io.model_from_numpy` takes (options under "opt_<name>")."""
  out = {}
  for f in dataclasses.fields(m):
    v = getattr(m, f.name)
    if f.name == "opt":
      for g in dataclasses.fields(v):
        out["opt_" + g.name] = np.asarray(jax.device_get(getattr(v, g.name)))
    elif f.name == "body_tree":
      continue   # derived by the port
    elif f.name in ("mesh_vert", "mesh_face"):
      for i, table in enumerate(v):          # the port's numbered keys
        out[f"{f.name}_{i}"] = np.asarray(table.arr)
    else:
      out[f.name] = np.asarray(jax.device_get(v))
  return out


def _episode_cfg(cfg, p):
  return {p + "ctrl_dt": np.asarray(cfg.ctrl_dt, dtype=np.float64),
          p + "sim_dt": np.asarray(cfg.sim_dt, dtype=np.float64),
          p + "max_episode_steps": np.asarray(cfg.max_episode_steps,
                                              dtype=np.int32),
          p + "far_th": np.asarray(cfg.far_th, dtype=np.float64)}


def _reach_cfg(env, p):
  """A JAX ReachEnv's config as the "<p>*" arrays of a model file."""
  from myosuite_tpu_torch.envs.registry import REACH_REWARDS
  cfg = env.config
  return dict(
      {p + "tip_sids": np.asarray(env._tip_sids, dtype=np.int32),
       p + "target_lo": np.asarray(cfg.target_lo, dtype=np.float32),
       p + "target_hi": np.asarray(cfg.target_hi, dtype=np.float32)},
      **_episode_cfg(cfg, p),
      **{p + "reward_weights": np.asarray(
          [cfg.reward_weights[k] for k in REACH_REWARDS], dtype=np.float64)})


def _pose_cfg(env, p="cfg_pose_", named=False):
  """A JAX PoseEnv's config as the "<p>*" arrays of a model file; the
  reward weights in POSE_REWARDS order, or `named` with every weight of
  the config and its name (sorted)."""
  from myosuite_tpu_torch.envs.registry import POSE_REWARDS
  cfg = env.config
  names = sorted(cfg.reward_weights.keys()) if named else POSE_REWARDS
  out = dict(
      {p + "target_jnt_lo": np.asarray(cfg.target_jnt_lo, dtype=np.float32),
       p + "target_jnt_hi": np.asarray(cfg.target_jnt_hi, dtype=np.float32),
       p + "pose_thd": np.asarray(cfg.pose_thd, dtype=np.float64),
       p + "reset_type": np.asarray(cfg.reset_type)},
      **_episode_cfg(cfg, p),
      **{p + "reward_weights": np.asarray(
          [cfg.reward_weights[k] for k in names], dtype=np.float64)})
  if named:
    out[p + "reward_names"] = np.asarray(names)
  return out


def _names(mj):
  """The joint and actuator names of a MuJoCo model, as string arrays."""
  name = lambda obj, i: mujoco.mj_id2name(mj, obj, i)
  return {"jnt_names": np.asarray([name(mujoco.mjtObj.mjOBJ_JOINT, j)
                                   for j in range(mj.njnt)]),
          "actuator_names": np.asarray([name(mujoco.mjtObj.mjOBJ_ACTUATOR, i)
                                        for i in range(mj.nu)])}


def _named_export(env_id, task_cfg):
  """Field dict, task config (`task_cfg` of the env) and joint and
  actuator names of the JAX package's env `env_id`."""
  import myosuite_tpu
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make(env_id)
  return (torch_io.model_fields(env.mj_model),
          dict(task_cfg(env), **_names(env.mj_model)))


def hand_reach_export():
  """Field dict, reach config and joint and actuator names of the JAX
  package's MtxHandReachRandom-v0, in the layout of
  myosuite_tpu_torch/assets/myohand_reach.npz."""
  return _named_export("MtxHandReachRandom-v0",
                       lambda env: _reach_cfg(env, "cfg_"))


def _body_names(mj):
  """The body names of a MuJoCo model, as a string array."""
  return {"body_names": np.asarray([
      mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_BODY, b)
      for b in range(mj.nbody)])}


def elbow_export():
  """Field dict, pose config and body names (the exo task's payload body)
  of the JAX package's MtxElbowPoseRandom-v0
  (myosuite_tpu_torch/assets/myoelbow.npz)."""
  import myosuite_tpu
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make("MtxElbowPoseRandom-v0")
  return (torch_io.model_fields(env.mj_model),
          dict(_pose_cfg(env), **_body_names(env.mj_model)))


def finger_export():
  """Field dict, pose config (MtxFingerPoseRandom-v0) and reach config
  (MtxFingerReachRandom-v0, under "cfg_reach_") of the JAX package's finger
  (myosuite_tpu_torch/assets/myofinger.npz)."""
  import myosuite_tpu
  from myosuite_tpu_torch.physics import io as torch_io

  pose = myosuite_tpu.make("MtxFingerPoseRandom-v0")
  reach = myosuite_tpu.make("MtxFingerReachRandom-v0")
  assert pose.config.model_xml == reach.config.model_xml
  return (torch_io.model_fields(pose.mj_model),
          dict(_pose_cfg(pose), **_reach_cfg(reach, "cfg_reach_")))


def _walk_cfg(env, p="cfg_walk_"):
  """A JAX WalkEnv's config, site ids, hip addresses and gait keyframes
  (and a TerrainWalkEnv's heightfield base and extent) as the "<p>*"
  arrays of a model file."""
  from myosuite_tpu_torch.envs.registry import WALK_IDS, WALK_SCALARS
  cfg = env.config
  out = {p + k: np.asarray(cfg[k], dtype=np.float64) for k in WALK_SCALARS}
  out[p + "max_episode_steps"] = np.asarray(cfg.max_episode_steps,
                                            dtype=np.int32)
  ids = dict(pelvis_site=env._pelvis_site, torso_site=env._torso_site,
             rfoot_site=env._rfoot_site, lfoot_site=env._lfoot_site,
             rhip_adr=env._rhip_adr, lhip_adr=env._lhip_adr)
  out.update({p + k: np.asarray(ids[k], dtype=np.int32) for k in WALK_IDS})
  names = sorted(cfg.reward_weights.keys())
  out.update({
      p + "reset_type": np.asarray(cfg.reset_type),
      p + "reward_names": np.asarray(names),
      p + "reward_weights": np.asarray([cfg.reward_weights[k] for k in names],
                                       dtype=np.float64),
      p + "gait_qpos": np.asarray(env._gait_qpos, dtype=np.float32),
      p + "gait_qvel": np.asarray(env._gait_qvel, dtype=np.float32)})
  if hasattr(env, "_hf_base"):
    out[p + "hf_base"] = np.asarray(env._hf_base, dtype=np.float64)
    out[p + "hf_extent"] = np.asarray(env._hf_extent, dtype=np.float64)
  return out


def _reflex_cfg(env, fields, p="cfg_reflex_"):
  """The tables the JAX package's ReflexController reads from a leg env
  with MuJoCo, as the "<p>*" arrays of a model file: the actuator masks
  per side and group, the feet's contact-slot masks (built by the port's
  `challenge.contact_slot_mask` from the geoms MuJoCo names), the
  hip-flexion qpos addresses and the body weight."""
  from myosuite_tpu.agents import reflex as jreflex
  from myosuite_tpu.envs.challenge import _geom_ids
  from myosuite_tpu_torch.agents.reflex import FOOT_GEOMS, GROUPS, SIDES
  from myosuite_tpu_torch.envs.challenge import contact_slot_mask
  from myosuite_tpu_torch.physics import io as torch_io

  ctl = jreflex.ReflexController(env)
  model = torch_io.model_from_numpy(fields, device="cpu")
  grf = [contact_slot_mask(model, _geom_ids(
      env.mj_model, [f"{s}_{g}" for g in FOOT_GEOMS])).numpy()
         for s in SIDES]
  return {
      p + "group_names": np.asarray(list(GROUPS)),
      p + "masks": np.asarray([[np.asarray(ctl._masks[s][g]) for g in GROUPS]
                               for s in SIDES], dtype=np.float32),
      p + "grf": np.asarray(grf, dtype=np.float32),
      p + "hip_qadr": np.asarray([ctl._hip_qadr[s] for s in SIDES],
                                 dtype=np.int32),
      p + "weight": np.asarray(ctl._weight, dtype=np.float64)}


def leg_export():
  """Field dict, walk config and reflex tables of the JAX package's
  MtxLegWalk-v0 (myosuite_tpu_torch/assets/myoleg.npz)."""
  import myosuite_tpu
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make("MtxLegWalk-v0")
  fields = torch_io.model_fields(env.mj_model)
  return fields, {**_walk_cfg(env), **_reflex_cfg(env, fields)}


def leg_terrain_export():
  """Field dict, walk config and reflex tables of the JAX package's
  MtxLegWalkRough-v0, whose leg walks on a heightfield
  (myosuite_tpu_torch/assets/myoleg_terrain.npz)."""
  import myosuite_tpu
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make("MtxLegWalkRough-v0")
  fields = torch_io.model_fields(env.mj_model)
  return fields, {**_walk_cfg(env), **_reflex_cfg(env, fields)}


# the JAX package's env whose model and task config each manipulation
# model file holds
MANIP_IDS = {"hold": "MtxHandObjHoldRandom-v0",
             "die": "MtxHandDieReorient-v0",
             "pen": "MtxHandPenTwirlRandom-v0", "baoding": "MtxHandBaoding-v0",
             "key": "MtxHandKeyTurnRandom-v0"}
# config entries that are not stored (the model itself, and what the port's
# registry sets per id)
_MANIP_SKIP = ("model_xml", "reward_weights", "fixed_target", "norm_actions",
               "reset_type")


def manip_cfg(env, cls, p="cfg_manip_"):
  """A JAX manipulation env's task config as the "<p>*" arrays of a model
  file: every scalar and vector entry, the reward names and weights, and
  the site ids and joint qpos / dof addresses of the port class `cls`'s
  SITES and JOINTS, looked up with MuJoCo as the JAX env does."""
  cfg, mj = env.config, env.mj_model
  out = {}
  for k in sorted(cfg.keys()):
    if k in _MANIP_SKIP:
      continue
    out[p + k] = np.asarray(cfg[k], dtype=np.int32 if k ==
                            "max_episode_steps" else np.float64)
  for name in cls.SITES:
    sid = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SITE, name)
    assert sid >= 0, name
    out[p + "site_" + name] = np.asarray(sid, dtype=np.int32)
  for name in cls.JOINTS:
    j = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_JOINT, name)
    assert j >= 0, name
    out[p + "qadr_" + name] = np.asarray(mj.jnt_qposadr[j], dtype=np.int32)
    out[p + "dadr_" + name] = np.asarray(mj.jnt_dofadr[j], dtype=np.int32)
  names = sorted(cfg.reward_weights.keys())
  out[p + "reward_names"] = np.asarray(names)
  out[p + "reward_weights"] = np.asarray(
      [cfg.reward_weights[k] for k in names], dtype=np.float64)
  return out


def manip_export(obj):
  """Field dict and task config of the JAX package's manipulation env of
  `obj` (myosuite_tpu_torch/assets/myohand_<obj>.npz)."""
  import myosuite_tpu
  from myosuite_tpu_torch.envs.manipulation import ENVS
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make(MANIP_IDS[obj])
  return torch_io.model_fields(env.mj_model), manip_cfg(env, ENVS[obj])


def myodm_export(obj):
  """Field dict of the JAX package's MyoDM scene of the GRAB object `obj`
  (the palm-up myoHand and the object's proxy), its object site's id and
  its (nv, nefc, ncon_max), after checking that the Newton kernel takes
  the scene's nv (myosuite_tpu_torch/assets/myodm/<obj>.npz; the card
  test test_kernel_takes_every_myodm_scene checks its shared memory)."""
  from myosuite_tpu.envs import myodm as jax_myodm
  from myosuite_tpu_torch.physics import io as torch_io
  from myosuite_tpu_torch.physics import newton_kernel

  mj = mujoco.MjModel.from_xml_string(jax_myodm.scene_xml(obj))
  fields = torch_io.model_fields(mj)
  model = torch_io.model_from_numpy(fields, "cpu")
  nv, nefc = model.nv, model.plan["constraint"].nefc
  assert nv <= newton_kernel.MAX_NV, (obj, nv)
  site = mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_SITE, "object_site")
  assert site >= 0
  i32 = lambda x: np.asarray(x, dtype=np.int32)
  return fields, {"cfg_myodm_object_site": i32(site), "myodm_nv": i32(nv),
                  "myodm_nefc": i32(nefc),
                  "myodm_ncon_max": i32(model.ncon_max)}


def _grab_objects():
  from myosuite_tpu_torch.envs.myodm import GRAB_OBJECTS
  return tuple(GRAB_OBJECTS)


# the JAX package's MyoChallenge env whose model and task config each
# challenge model file holds
CHALLENGE_IDS = {"myoleg_chasetag.npz": "MtxChaseTag-v0",
                 "myoleg_soccer.npz": "MtxSoccer-v0",
                 "myoleg_osl.npz": "MtxRunTrack-v0",
                 "myoarm_relocate.npz": "MtxRelocate-v0",
                 "myoarm_bimanual.npz": "MtxBimanual-v0",
                 "myoarm_tabletennis.npz": "MtxTableTennis-v0"}
# config entries that are not stored (the model itself, the walk config's
# own keys, and the role the port's registry sets per id)
_CHAL_SKIP = ("model_xml", "reward_weights", "norm_actions", "agent_role")


def _mj_id(mj, obj, name):
  i = mujoco.mj_name2id(mj, obj, name)
  assert i >= 0, name
  return i


def _challenge_ids(env):
  """The ids a JAX challenge env looks up with MuJoCo at __init__ (site,
  body, geom ids, joint qpos / dof addresses, the geom groups of its
  contact masks), by name."""
  from myosuite_tpu.envs import challenge as jc
  mj = env.mj_model
  geom = lambda n: _mj_id(mj, mujoco.mjtObj.mjOBJ_GEOM, n)
  ids = {}
  if isinstance(env, jc._LegChallengeEnv):
    ids["grf_r_geoms"] = [geom(n) for n in ("r_heel_geom", "r_foot_geom",
                                            "r_toes_geom")]
    ids["grf_l_geoms"] = [geom(n) for n in ("l_heel_geom", "l_foot_geom",
                                            "l_toes_geom")]
  if isinstance(env, jc.SoccerEnv):
    ids.update(ball_qadr=env._ball_qadr, ball_dadr=env._ball_dadr)
  if isinstance(env, jc.RunTrackEnv):
    ids.update(knee_qadr=env._knee_q, knee_dadr=env._knee_d,
               ankle_qadr=env._ankle_q, ankle_dadr=env._ankle_d)
  if isinstance(env, jc.RelocateEnv):
    ids.update(obj_site=env._obj_site, obj_geom=env._obj_geom,
               obj_body=env._obj_body, obj_qadr=env._obj_qadr,
               obj_dadr=env._obj_dadr)
  if isinstance(env, jc.BimanualEnv):
    obj = geom("object_geom")
    names = [mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_GEOM, g) or ""
             for g in range(mj.ngeom)]
    pros = [g for g, n in enumerate(names) if n.startswith("pros_")]
    start, goal = [geom("start_pillar")], [geom("goal_pillar")]
    other = [g for g in range(mj.ngeom)
             if g != obj and g not in pros + start + goal]
    ids.update(
        rpalm_site=env._rpalm_site, obj_site=env._obj_site,
        fin_sites=list(env._fin_sites), palm_body=env._palm_body,
        obj_qadr=env._obj_qadr, obj_dadr=env._obj_dadr,
        pros_qadr=env._pros_qadr, pros_dadr=env._pros_dadr, obj_geom=obj,
        touch_myo=[g for g in other if int(mj.geom_bodyid[g]) != 0],
        touch_pros=pros, touch_start=start, touch_goal=goal,
        touch_env=[g for g in other if int(mj.geom_bodyid[g]) == 0])
  if isinstance(env, jc.TableTennisEnv):
    ids.update(paddle_site=env._paddle_site, ball_site=env._ball_site,
               palm_body=env._palm_body, thorax_body=env._thorax_body,
               ball_qadr=env._ball_qadr, ball_dadr=env._ball_dadr,
               paddle_geom=geom("paddle_geom"), table_geom=geom("table_geom"),
               ball_geom=geom("ball_geom"))
  return ids


def challenge_cfg(env, p="cfg_chal_"):
  """A JAX challenge env's task config as the "<p>*" arrays of a model
  file: every scalar, vector and string entry, the reward names and
  weights, the ids of `_challenge_ids` (int32) and the model's total body
  mass (float64, the body weight's and the OSL thresholds' source)."""
  cfg = env.config
  out = {}
  for k in sorted(cfg.keys()):
    if k in _CHAL_SKIP:
      continue
    v = cfg[k]
    if isinstance(v, str):
      out[p + k] = np.asarray(v)
    else:
      out[p + k] = np.asarray(v, dtype=np.int32 if k == "max_episode_steps"
                              else np.float64)
  for k, v in _challenge_ids(env).items():
    out[p + k] = np.asarray(v, dtype=np.int32)
  out[p + "body_mass"] = np.asarray(float(np.sum(env.mj_model.body_mass)),
                                    dtype=np.float64)
  names = sorted(cfg.reward_weights.keys())
  out[p + "reward_names"] = np.asarray(names)
  out[p + "reward_weights"] = np.asarray(
      [cfg.reward_weights[k] for k in names], dtype=np.float64)
  return out


def challenge_export(name):
  """Field dict and task config (with the walk config for the leg envs,
  and the joint and actuator names) of the JAX package's challenge env of
  the model file `name` (myosuite_tpu_torch/assets/<name>)."""
  import myosuite_tpu
  from myosuite_tpu.envs import challenge as jc
  from myosuite_tpu_torch.physics import io as torch_io

  env = myosuite_tpu.make(CHALLENGE_IDS[name])
  mj = env.mj_model
  name_of = lambda obj, i: mujoco.mj_id2name(mj, obj, i) or ""
  extra = dict(challenge_cfg(env), jnt_names=np.asarray(
      [name_of(mujoco.mjtObj.mjOBJ_JOINT, j) for j in range(mj.njnt)]),
      actuator_names=np.asarray([name_of(mujoco.mjtObj.mjOBJ_ACTUATOR, i)
                                 for i in range(mj.nu)]))
  if isinstance(env, jc._LegChallengeEnv):
    extra.update(_walk_cfg(env))
  return torch_io.model_fields(env.mj_model), extra


# committed model file -> the function that exports it afresh
EXPORTS = {"myohand_reach.npz": hand_reach_export,
           "myoelbow.npz": elbow_export, "myofinger.npz": finger_export,
           "myoleg.npz": leg_export, "myoleg_terrain.npz": leg_terrain_export,
           **{f"myohand_{obj}.npz": functools.partial(manip_export, obj)
              for obj in MANIP_IDS},
           # the pose models store their reward names (the torso's
           # weights hold a "done" weight that PoseEnv never returns)
           "myotorso.npz": functools.partial(
               _named_export, "MtxTorsoPoseRandom-v0",
               functools.partial(_pose_cfg, named=True)),
           "myoarm_reach.npz": functools.partial(
               _named_export, "MtxArmReachRandom-v0",
               lambda env: _reach_cfg(env, "cfg_")),
           "myoarm.npz": functools.partial(
               _named_export, "MtxArmPoseRandom-v0",
               functools.partial(_pose_cfg, named=True)),
           # the MyoDM scenes, one file per GRAB object
           **{f"myodm/{obj}.npz": functools.partial(myodm_export, obj)
              for obj in _grab_objects()},
           # the MyoChallenge scenes
           **{name: functools.partial(challenge_export, name)
              for name in CHALLENGE_IDS}}


def write_export(name):
  """Export the model file `name` of EXPORTS afresh into the port's
  assets."""
  import os
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import io as torch_io

  fields, extra = EXPORTS[name]()
  path = os.path.join(ASSETS, name)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  torch_io.save_model(path, fields, **extra)
  print("wrote", path)
