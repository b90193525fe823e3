"""Model export without JAX: the MJCF and the model file of every committed
model, from the port's own builders.

Each committed model file (`myosuite_tpu_torch/assets/<name>`) is the
compiled fields of one MJCF (`io.model_fields`) and the task config its
env reads, stored beside them as "cfg_*" arrays. `SOURCES` names the
builder call of every file, `EDITS` the two files that `editor` edits
after their muscles' length ranges are swept. `export(name)` compiles the
file's MJCF with the host MuJoCo and returns `(fields, extra)`, equal to
the committed file key by key, dtype by dtype and bit by bit; `write(name)`
writes it:

  python -m myosuite_tpu_torch.mjcf.export myoelbow.npz [...]   # or --all
      [--out DIR]

An entry of `extra` is either a task constant (targets, weights,
thresholds: the JAX package's registry configs, some drawn from the
default model, as the hand's tip boxes) or a model entry (site, geom and
body ids, joint addresses, names, gait keyframes, reflex tables: what a
JAX env looks up in its compiled model). `load_xml` serves
`make(..., overrides={"model_xml": xml})`: it compiles a user's MJCF,
keeps the committed file's task constants and derives the model entries
from the user's model with the same code; where MuJoCo cannot be
imported, it takes the compiled copy of that very MJCF that
`write_compiled` keeps under assets/compiled/, if there is one.

Compiling needs MuJoCo, imported inside the functions that compile; this
module and every builder string import without it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from myosuite_tpu_torch.envs import myodm
from myosuite_tpu_torch.envs.registry import (ASSETS, POSE_DEFAULTS,
                                              POSE_REWARDS, REACH_REWARDS,
                                              WALK_IDS, WALK_SCALARS)
from myosuite_tpu_torch.mjcf import builder, editor, hand, leg, torso
from myosuite_tpu_torch.physics import io as physics_io

Entries = Dict[str, np.ndarray]

# The challenge scenes' extra bodies and actuators (the JAX package's
# registry).
OPPONENT_BODY = """
    <body name="opponent" mocap="true" pos="2 2 0.5">
      <geom name="opponent_geom" type="cylinder" size="0.18 0.5"
            contype="0" conaffinity="0" mass="1"/>
    </body>"""

SOCCER_SCENE = """
    <body name="ball" pos="0.6 0 0.12">
      <freejoint name="ball_free"/>
      <geom name="ball_geom" type="sphere" size="0.11" mass="0.43"
            contype="2" conaffinity="7" friction="0.8 0.01 0.0005"
            solref="0.02 1" condim="3"/>
      <site name="ball_site" size="0.01"/>
    </body>
    <geom name="post_l" type="capsule" fromto="5 -1.22 0 5 -1.22 1.2"
          size="0.05" contype="4" conaffinity="3"/>
    <geom name="post_r" type="capsule" fromto="5 1.22 0 5 1.22 1.2"
          size="0.05" contype="4" conaffinity="3"/>
    <body name="keeper" mocap="true" pos="4.7 0 0.9">
      <geom name="keeper_geom" type="cylinder" size="0.18 0.9"
            contype="0" conaffinity="0" mass="1"/>
    </body>"""

BIMANUAL_SCENE = """
    <geom name="start_pillar" type="box" pos="-0.38 -0.10 0.5"
          size="0.09 0.09 0.5" contype="4" conaffinity="2"/>
    <geom name="goal_pillar" type="box" pos="-0.38 0.35 0.5"
          size="0.09 0.09 0.5" contype="4" conaffinity="2"/>
    <body name="pros_base" pos="-0.38 0.62 1.1">
      <joint name="pros_x" type="slide" axis="1 0 0" range="-0.25 0.25"
             damping="8"/>
      <joint name="pros_y" type="slide" axis="0 1 0" range="-0.45 0.1"
             damping="8"/>
      <joint name="pros_z" type="slide" axis="0 0 1" range="-0.2 0.2"
             damping="8"/>
      <geom name="pros_palm_geom" type="box" size="0.012 0.04 0.05"
            mass="0.5" contype="1" conaffinity="2"/>
      <site name="pros_palm" pos="0 -0.055 0" size="0.005"/>
      <body name="pros_fin1" pos="0 -0.055 0.05">
        <joint name="pros_grip1" type="slide" axis="0 0 -1"
               range="0 0.045" damping="3"/>
        <geom name="pros_pad1_geom" type="box" size="0.012 0.03 0.008"
              mass="0.05" contype="1" conaffinity="2"
              friction="1.2 0.01 0.0005"/>
      </body>
      <body name="pros_fin2" pos="0 -0.055 -0.05">
        <joint name="pros_grip2" type="slide" axis="0 0 1"
               range="0 0.045" damping="3"/>
        <geom name="pros_pad2_geom" type="box" size="0.012 0.03 0.008"
              mass="0.05" contype="1" conaffinity="2"
              friction="1.2 0.01 0.0005"/>
      </body>
    </body>
    <body name="object" pos="-0.38 -0.10 1.028">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="box" size="0.027 0.027 0.027"
            mass="0.1" contype="2" conaffinity="7"
            friction="1 0.01 0.0005" solref="0.015 1" condim="3"/>
      <site name="object_site" size="0.005"/>
    </body>"""

BIMANUAL_ACTS = """
    <position name="pros_x_act" joint="pros_x" kp="300"
              ctrlrange="-0.25 0.25"/>
    <position name="pros_y_act" joint="pros_y" kp="300"
              ctrlrange="-0.45 0.1"/>
    <position name="pros_z_act" joint="pros_z" kp="300"
              ctrlrange="-0.2 0.2"/>
    <position name="pros_grip1_act" joint="pros_grip1" kp="120"
              ctrlrange="0 0.045"/>
    <position name="pros_grip2_act" joint="pros_grip2" kp="120"
              ctrlrange="0 0.045"/>"""


MANIP_OBJECTS = ("hold", "die", "pen", "baoding", "key")

# The builders' MJCF string of every committed model file, before its
# muscles' length ranges are swept (the JAX package's registry's calls).
SOURCES: Dict[str, Callable[[], str]] = {
    "myohand_reach.npz": hand.build_hand,
    "myoelbow.npz": builder.build_elbow,
    "myofinger.npz": builder.build_finger,
    "myoleg.npz": leg.build_leg,
    "myoleg_terrain.npz": functools.partial(leg.build_leg, terrain=True),
    **{f"myohand_{obj}.npz": functools.partial(
        hand.build_hand, palm_up=obj != "key", obj=obj)
       for obj in MANIP_OBJECTS},
    "myotorso.npz": torso.build_torso,
    "myoarm_reach.npz": functools.partial(hand.build_hand, arm=True),
    "myoarm.npz": functools.partial(hand.build_hand, arm=True),
    **{f"myodm/{obj}.npz": functools.partial(myodm.scene_builder_xml, obj)
       for obj in myodm.GRAB_OBJECTS},
    "myoleg_chasetag.npz": functools.partial(
        leg.build_leg, terrain=True, terrain_nrow=64, terrain_ncol=64,
        terrain_extent=(6.0, 6.0), terrain_center=(0.0, 0.0),
        extra_worldbody=OPPONENT_BODY),
    "myoleg_soccer.npz": functools.partial(leg.build_leg,
                                           extra_worldbody=SOCCER_SCENE),
    "myoleg_osl.npz": functools.partial(leg.build_leg, osl=True),
    "myoarm_relocate.npz": functools.partial(hand.build_hand, arm=True,
                                             obj="relocate"),
    "myoarm_bimanual.npz": functools.partial(
        hand.build_hand, arm=True, extra_worldbody=BIMANUAL_SCENE,
        extra_actuators=BIMANUAL_ACTS),
    "myoarm_tabletennis.npz": functools.partial(hand.build_hand, arm=True),
}
# The files whose finalized MJCF goes through an MjSpec edit.
EDITS = {"myoarm_reach.npz": editor.edit_fn_arm_reaching,
         "myoarm_tabletennis.npz": editor.edit_fn_tabletennis}


def model_xml(name: str) -> str:
  """The MJCF of the committed model file `name` (needs MuJoCo): its
  builder string with the muscles' length ranges, edited where EDITS says
  so."""
  xml = builder.finalize_muscles(SOURCES[name]())
  if name in EDITS:
    xml = editor.ModelEditor(xml).edit(EDITS[name]).to_xml()
  return xml


# ---------------------------------------------------------------------------
# name lookups
# ---------------------------------------------------------------------------


def _id(mj, kind: str, name: str) -> int:
  """The id of the `kind` ("SITE", "JOINT", ...) named `name`; a model
  without it (a user's MJCF) raises KeyError."""
  mujoco = physics_io.import_mujoco()
  i = mujoco.mj_name2id(mj, getattr(mujoco.mjtObj, "mjOBJ_" + kind), name)
  if i < 0:
    raise KeyError(f"the model has no {kind.lower()} named {name!r}")
  return int(i)


def _names(mj, kind: str, n: int):
  mujoco = physics_io.import_mujoco()
  obj = getattr(mujoco.mjtObj, "mjOBJ_" + kind)
  return [mujoco.mj_id2name(mj, obj, i) for i in range(n)]


def _i32(x) -> np.ndarray:
  return np.asarray(x, dtype=np.int32)


def _f64(x) -> np.ndarray:
  return np.asarray(x, dtype=np.float64)


def _weights(p: str, weights: Dict[str, float], order=None) -> Entries:
  """The reward weights (f64) in `order`, or sorted with their names."""
  if order is not None:
    return {p + "reward_weights": _f64([weights[k] for k in order])}
  names = sorted(weights)
  return {p + "reward_names": np.asarray(names),
          p + "reward_weights": _f64([weights[k] for k in names])}


def joint_actuator_names(mj, fields=None) -> Entries:
  """The joint and actuator names ("" for an unnamed one)."""
  name = lambda kind, n: np.asarray([s or "" for s in _names(mj, kind, n)])
  return {"jnt_names": name("JOINT", mj.njnt),
          "actuator_names": name("ACTUATOR", mj.nu)}


def body_names(mj, fields=None) -> Entries:
  return {"body_names": np.asarray(_names(mj, "BODY", mj.nbody))}


# ---------------------------------------------------------------------------
# task constants (the JAX package's registry configs)
# ---------------------------------------------------------------------------

EPISODE = {k: POSE_DEFAULTS[k] for k in ("ctrl_dt", "sim_dt",
                                        "max_episode_steps")}
REACH_WEIGHTS = dict(reach=1.0, bonus=4.0, penalty=50.0)
HAND_TIPS = ("THtip", "IFtip", "MFtip", "RFtip", "LFtip")


def _episode(p: str, far_th: float, max_episode_steps: int = 100
             ) -> Entries:
  return {p + "ctrl_dt": _f64(EPISODE["ctrl_dt"]),
          p + "sim_dt": _f64(EPISODE["sim_dt"]),
          p + "max_episode_steps": _i32(max_episode_steps),
          p + "far_th": _f64(far_th)}


def pose_task(lo, hi, pose_thd: float, far_th: float = float(4 * np.pi / 2),
              p: str = "cfg_pose_", extra_weights=None,
              named: bool = False) -> Callable:
  """A PoseEnv config: targets in [lo, hi] (the model's own joint ranges
  where `lo` is None), the weights in registry order or, `named`, sorted
  with their names."""
  def entries(mj, fields=None) -> Entries:
    jlo = mj.jnt_range[:, 0].tolist() if lo is None else lo
    jhi = mj.jnt_range[:, 1].tolist() if hi is None else hi
    weights = dict(POSE_DEFAULTS["reward_weights"], **(extra_weights or {}))
    return {p + "target_jnt_lo": np.asarray(jlo, dtype=np.float32),
            p + "target_jnt_hi": np.asarray(jhi, dtype=np.float32),
            p + "pose_thd": _f64(pose_thd), p + "reset_type": np.asarray(
                "random"), **_episode(p, far_th),
            **_weights(p, weights, None if named else POSE_REWARDS)}
  return entries


def _site_positions(mj, sites) -> np.ndarray:
  """(n, 3) positions of `sites` after a host mj_forward at qpos0."""
  mujoco = physics_io.import_mujoco()
  d = mujoco.MjData(mj)
  mujoco.mj_forward(mj, d)
  return np.stack([d.site_xpos[_id(mj, "SITE", s)] for s in sites])


def reach_task(p: str, sites=None, lo=None, hi=None, span=None,
               far_th: float = 0.35) -> Callable:
  """A ReachEnv config: the target box [lo, hi], or `sites`' positions at
  qpos0 of the model +- `span`."""
  def entries(mj, fields=None) -> Entries:
    if lo is None:
      tip0 = _site_positions(mj, sites)
      box_lo, box_hi = tip0 - np.asarray(span), tip0 + np.asarray(span)
    else:
      box_lo, box_hi = np.atleast_2d(lo), np.atleast_2d(hi)
    return {p + "target_lo": np.asarray(box_lo, dtype=np.float32),
            p + "target_hi": np.asarray(box_hi, dtype=np.float32),
            **_episode(p, far_th), **_weights(p, REACH_WEIGHTS,
                                              REACH_REWARDS)}
  return entries


def reach_sites(p: str, sites) -> Callable:
  """The reach targets' site ids."""
  return lambda mj, fields=None: {
      p + "tip_sids": _i32([_id(mj, "SITE", s) for s in sites])}


def _config_entries(p: str, cfg: Dict[str, Any], skip=()) -> Entries:
  """Every entry of a JAX config but `skip`, sorted: strings as strings,
  max_episode_steps int32, the rest float64; then the reward weights with
  their names."""
  out = {}
  for k in sorted(cfg):
    if k in skip or k in ("reward_weights", "norm_actions"):
      continue
    v = cfg[k]
    out[p + k] = (np.asarray(v) if isinstance(v, str) else
                  np.asarray(v, dtype=np.int32 if k == "max_episode_steps"
                             else np.float64))
  out.update(_weights(p, cfg["reward_weights"]))
  return out


BASE = dict(EPISODE, norm_actions=True, reset_type="random")
WALK = dict(BASE, max_episode_steps=1000, target_velocity=1.2,
            gait_period=1.0, hip_amplitude=0.8, min_height=0.7, max_rot=0.8,
            stand_height=0.93, reset_type="none", reward_weights=dict(
                vel_reward=5.0, done=100.0, cyclic_hip=-10.0, ref_rot=10.0,
                joint_angle_rew=5.0, act_reg=1.0, progress=0.0))


def _manip(weights, **kw) -> Dict[str, Any]:
  return {**BASE, "drop_th": 1.05, "goal_center": (-0.15, 0.0, 1.25),
          "reward_weights": weights, **kw}


# The manipulation envs' configs (fixed_target and reset_type are set per
# id by the port's registry, not stored).
MANIP_CONFIGS = {
    "hold": _manip(dict(goal_dist=100.0, bonus=4.0, penalty=10.0),
                   goal_span=(0.02, 0.02, 0.02)),
    "die": _manip(dict(pos_dist=100.0, rot_dist=1.0, bonus=0.0, penalty=0.0),
                  goal_center=(-0.15, 0.0, 1.235), goal_rot_limit=1.57),
    "pen": _manip(dict(pos_align=1.0, rot_align=1.0, act_reg=5.0, drop=5.0,
                       bonus=10.0),
                  goal_center=(-0.15, 0.0, 1.17), goal_pitch_limit=1.0),
    "baoding": _manip(dict(pos_dist_1=5.0, pos_dist_2=5.0, drop=0.0),
                      goal_center=(-0.15, 0.0, 1.235), goal_radius_x=0.022,
                      goal_radius_y=0.028, goal_speed=0.025,
                      max_episode_steps=200),
    "key": _manip(dict(key_turn=1.0, IFtip_approach=10.0,
                       THtip_approach=10.0, act_reg=1.0, bonus=4.0,
                       penalty=25.0), max_episode_steps=200),
}
_LEG_CHAL = dict(min_height=0.7, max_rot=0.8, gait_period=1.0,
                 hip_amplitude=0.4, target_velocity=1.2, stand_height=0.93,
                 reset_type="init")
# The MyoChallenge envs' configs, by model file (agent_role is set per id
# by the registry, not stored).
CHALLENGE_CONFIGS = {
    "myoleg_chasetag.npz": dict(
        {**BASE, **_LEG_CHAL}, max_episode_steps=1000, arena_half=6.0,
        tag_radius=0.35, reward_weights=dict(distance=-0.1, lose=1000.0,
                                             act_reg=1.0)),
    "myoleg_soccer.npz": dict(
        {**BASE, **_LEG_CHAL}, max_episode_steps=1000, goal_x=5.0,
        goal_half_width=1.22, keeper_reach=0.3, reward_weights=dict(
            goal_scored=1000.0, time_cost=0.01, act_reg=100.0, pain=10.0,
            ball_dist=1.0, goal_dist=1.0)),
    "myoleg_osl.npz": dict(
        {**BASE, **_LEG_CHAL}, max_episode_steps=2000, min_velocity=0.3,
        finish_x=20.0, reward_weights=dict(sparse=1.0, solved=10.0,
                                           act_reg=1.0, pain=10.0,
                                           vel_reward=2.0)),
    "myoarm_relocate.npz": dict(
        BASE, max_episode_steps=150, goal_center=(0.2, 0.1, 1.3),
        goal_span=(0.1, 0.1, 0.1), obj_scale_range=(0.7, 1.2), lift_th=1.05,
        drop_th=0.6, reward_weights=dict(pos_dist=100.0, lift_bonus=4.0,
                                         bonus=4.0, act_reg=1.0)),
    "myoarm_bimanual.npz": dict(
        BASE, max_episode_steps=250, proximity_th=0.17, drop_th=0.9,
        lift_th=1.07, goal_center=(-0.38, 0.35, 1.05), reward_weights=dict(
            reach_dist=-0.1, act=0.0, fin_dis=-0.5, pass_err=-1.0)),
    "myoarm_tabletennis.npz": dict(
        BASE, max_episode_steps=150, reward_weights=dict(
            reach_dist=1.0, palm_dist=1.0, paddle_quat=2.0, act_reg=0.5,
            torso_up=2.0, sparse=100.0, solved=1000.0, done_pen=10.0)),
}


def config_task(p: str, cfg: Dict[str, Any], skip=()) -> Callable:
  return lambda mj, fields=None: _config_entries(p, cfg, skip)


def walk_task(cfg: Dict[str, Any], p: str = "cfg_walk_") -> Callable:
  """A WalkEnv's scalars, reset type and reward weights."""
  def entries(mj, fields=None) -> Entries:
    out = {p + k: _f64(cfg[k]) for k in WALK_SCALARS}
    out[p + "max_episode_steps"] = _i32(cfg["max_episode_steps"])
    out[p + "reset_type"] = np.asarray(cfg["reset_type"])
    out.update(_weights(p, cfg["reward_weights"]))
    return out
  return entries


# ---------------------------------------------------------------------------
# model entries (what a JAX env looks up in its compiled model)
# ---------------------------------------------------------------------------


def gait_keyframes(mj, target_velocity: float):
  """The walk env's two mid-gait keyframes (right, then left leg in
  swing) with forward velocity, each frame's pelvis height set so that its
  lowest foot site stands where qpos0 puts it (host forward kinematics)."""
  mujoco = physics_io.import_mujoco()
  qadr = lambda n: int(mj.jnt_qposadr[_id(mj, "JOINT", n)])
  dadr = lambda n: int(mj.jnt_dofadr[_id(mj, "JOINT", n)])
  qpos = np.array(mj.qpos0, dtype=np.float64)
  qvel = np.zeros(mj.nv)
  qvel[0] = float(target_velocity)
  frames_q, frames_v = [], []
  for swing, stance in (("r", "l"), ("l", "r")):
    q = qpos.copy()
    q[qadr(f"{swing}_hip_flexion")] = -0.30
    q[qadr(f"{swing}_knee")] = -0.25
    q[qadr(f"{swing}_ankle")] = 0.05
    q[qadr(f"{stance}_hip_flexion")] = 0.18
    q[qadr(f"{stance}_knee")] = -0.05
    q[qadr(f"{stance}_ankle")] = -0.08
    v = qvel.copy()
    v[dadr(f"{swing}_hip_flexion")] = -2.0
    v[dadr(f"{stance}_hip_flexion")] = 2.0
    frames_q.append(q)
    frames_v.append(v)
  d = mujoco.MjData(mj)

  def lowest_foot(q):
    d.qpos[:] = q
    mujoco.mj_forward(mj, d)
    return min(float(d.site_xpos[_id(mj, "SITE", n)][2])
               for n in ("r_foot_site", "l_foot_site"))
  z_ref = lowest_foot(qpos)
  for q in frames_q:
    q[2] -= lowest_foot(q) - z_ref
  return np.stack(frames_q), np.stack(frames_v)


def walk_model(target_velocity: float, p: str = "cfg_walk_") -> Callable:
  """A WalkEnv's site ids, hip addresses and gait keyframes, and where the
  model has a heightfield its base and extent."""
  def entries(mj, fields=None) -> Entries:
    site = lambda n: _id(mj, "SITE", n)
    qadr = lambda n: int(mj.jnt_qposadr[_id(mj, "JOINT", n)])
    ids = dict(pelvis_site=site("pelvis_site"), torso_site=site("torso_site"),
               rfoot_site=site("r_foot_site"), lfoot_site=site("l_foot_site"),
               rhip_adr=qadr("r_hip_flexion"), lhip_adr=qadr("l_hip_flexion"))
    out = {p + k: _i32(ids[k]) for k in WALK_IDS}
    gq, gv = gait_keyframes(mj, target_velocity)
    out[p + "gait_qpos"] = gq.astype(np.float32)
    out[p + "gait_qvel"] = gv.astype(np.float32)
    hfield = [g for g in range(mj.ngeom)
              if int(mj.geom_type[g]) == int(
                  physics_io.import_mujoco().mjtGeom.mjGEOM_HFIELD)]
    if hfield:
      sz = np.asarray(mj.hfield_size[0], dtype=float)
      out[p + "hf_base"] = _f64(mj.geom_pos[hfield[0]][:2])
      out[p + "hf_extent"] = _f64((2.0 * sz[0], 2.0 * sz[1]))
    return out
  return entries


def reflex_model(mj, fields, p: str = "cfg_reflex_") -> Entries:
  """The reflex controller's tables: the actuator masks per side and
  group, the feet's contact-slot masks, the hip-flexion qpos addresses and
  the body weight."""
  from myosuite_tpu_torch.agents.reflex import FOOT_GEOMS, GROUPS, SIDES
  from myosuite_tpu_torch.envs.challenge import contact_slot_mask
  names = _names(mj, "ACTUATOR", mj.nu)
  masks = [[[1.0 if n and n.startswith(f"{s}_") and n[2:] in GROUPS[g]
             else 0.0 for n in names] for g in GROUPS] for s in SIDES]
  model = physics_io.model_from_numpy(fields, device="cpu")
  grf = [contact_slot_mask(model, [_id(mj, "GEOM", f"{s}_{g}")
                                   for g in FOOT_GEOMS]).numpy()
         for s in SIDES]
  mujoco = physics_io.import_mujoco()
  hips = [mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_JOINT, f"{s}_hip_flexion")
          for s in SIDES]
  return {p + "group_names": np.asarray(list(GROUPS)),
          p + "masks": np.asarray(masks, dtype=np.float32),
          p + "grf": np.asarray(grf, dtype=np.float32),
          p + "hip_qadr": _i32([int(mj.jnt_qposadr[j]) if j >= 0 else -1
                                for j in hips]),
          p + "weight": _f64(float(np.sum(mj.body_mass)) * 9.81)}


def manip_model(obj: str, p: str = "cfg_manip_") -> Callable:
  """The site ids and joint qpos / dof addresses of the manipulation env's
  SITES and JOINTS."""
  def entries(mj, fields=None) -> Entries:
    from myosuite_tpu_torch.envs.manipulation import ENVS
    cls = ENVS[obj]
    out = {p + "site_" + n: _i32(_id(mj, "SITE", n)) for n in cls.SITES}
    for n in cls.JOINTS:
      j = _id(mj, "JOINT", n)
      out[p + "qadr_" + n] = _i32(mj.jnt_qposadr[j])
      out[p + "dadr_" + n] = _i32(mj.jnt_dofadr[j])
    return out
  return entries


def myodm_model(mj, fields) -> Entries:
  """The scene's object site id and its (nv, nefc, ncon_max)."""
  model = physics_io.model_from_numpy(fields, "cpu")
  nv, nefc = model.nv, model.plan["constraint"].nefc
  return {"cfg_myodm_object_site": _i32(_id(mj, "SITE", "object_site")),
          "myodm_nv": _i32(nv), "myodm_nefc": _i32(nefc),
          "myodm_ncon_max": _i32(model.ncon_max)}


def _jadr(mj, name: str):
  j = _id(mj, "JOINT", name)
  return int(mj.jnt_qposadr[j]), int(mj.jnt_dofadr[j])


def challenge_ids(name: str) -> Callable:
  """The ids a challenge env looks up by name (site, body and geom ids,
  joint addresses, its contact masks' geom groups), and the model's total
  body mass, as "cfg_chal_*"."""
  def entries(mj, fields=None) -> Entries:
    geom = lambda n: _id(mj, "GEOM", n)
    site = lambda n: _id(mj, "SITE", n)
    body = lambda n: _id(mj, "BODY", n)
    ids: Dict[str, Any] = {}
    if name.startswith("myoleg_"):
      for s in ("r", "l"):
        ids[f"grf_{s}_geoms"] = [geom(f"{s}_{g}") for g in
                                 ("heel_geom", "foot_geom", "toes_geom")]
    if name == "myoleg_soccer.npz":
      ids["ball_qadr"], ids["ball_dadr"] = _jadr(mj, "ball_free")
    if name == "myoleg_osl.npz":
      ids["knee_qadr"], ids["knee_dadr"] = _jadr(mj, "r_knee")
      ids["ankle_qadr"], ids["ankle_dadr"] = _jadr(mj, "r_ankle")
    if name == "myoarm_relocate.npz":
      g = geom("object_geom")
      ids.update(obj_site=site("object_site"), obj_geom=g,
                 obj_body=int(mj.geom_bodyid[g]))
      ids["obj_qadr"], ids["obj_dadr"] = _jadr(mj, "object_free")
    if name == "myoarm_bimanual.npz":
      obj = geom("object_geom")
      names = [n or "" for n in _names(mj, "GEOM", mj.ngeom)]
      pros = [g for g, n in enumerate(names) if n.startswith("pros_")]
      start, goal = [geom("start_pillar")], [geom("goal_pillar")]
      other = [g for g in range(mj.ngeom)
               if g != obj and g not in pros + start + goal]
      ids.update(rpalm_site=site("pros_palm"), obj_site=site("object_site"),
                 fin_sites=[site(n) for n in HAND_TIPS],
                 palm_body=body("palm"))
      ids["obj_qadr"], ids["obj_dadr"] = _jadr(mj, "object_free")
      ids["pros_qadr"], ids["pros_dadr"] = _jadr(mj, "pros_x")
      ids.update(obj_geom=obj,
                 touch_myo=[g for g in other if int(mj.geom_bodyid[g]) != 0],
                 touch_pros=pros, touch_start=start, touch_goal=goal,
                 touch_env=[g for g in other if int(mj.geom_bodyid[g]) == 0])
    if name == "myoarm_tabletennis.npz":
      ids.update(paddle_site=site("paddle_center"), ball_site=site("ball_site"),
                 palm_body=body("palm"), thorax_body=body("thorax"))
      ids["ball_qadr"], ids["ball_dadr"] = _jadr(mj, "ball_free")
      ids.update(paddle_geom=geom("paddle_geom"),
                 table_geom=geom("table_geom"), ball_geom=geom("ball_geom"))
    out = {"cfg_chal_" + k: _i32(v) for k, v in ids.items()}
    out["cfg_chal_body_mass"] = _f64(float(np.sum(mj.body_mass)))
    return out
  return entries


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FileSpec:
  """How a model file's extra arrays are made: `task` gives its task
  constants, `model` its model entries, each a function (mj, fields) ->
  dict."""
  task: Tuple[Callable, ...]
  model: Tuple[Callable, ...]


def _challenge_spec(name: str) -> FileSpec:
  cfg = CHALLENGE_CONFIGS[name]
  task = (config_task("cfg_chal_", cfg),)
  model = (challenge_ids(name), joint_actuator_names)
  if name.startswith("myoleg_"):
    task += (walk_task(cfg),)
    model += (walk_model(cfg["target_velocity"]),)
  return FileSpec(task, model)


_ARM_SPAN = (0.15, 0.15, 0.15)
SPECS: Dict[str, FileSpec] = {
    "myohand_reach.npz": FileSpec(
        (reach_task("cfg_", HAND_TIPS, span=(0.05, 0.04, 0.05)),),
        (reach_sites("cfg_", HAND_TIPS), joint_actuator_names)),
    "myoelbow.npz": FileSpec((pose_task([0.0], [2.27], 0.35),),
                             (body_names,)),
    "myofinger.npz": FileSpec(
        (pose_task([-0.3, -0.25, 0.0, 0.0], [0.3, 1.5, 1.8, 1.5], 0.5),
         reach_task("cfg_reach_", lo=[[-0.1, -0.1, 0.78]],
                    hi=[[0.1, 0.1, 0.92]])),
        (reach_sites("cfg_reach_", ("IFtip",)),)),
    "myoleg.npz": FileSpec((walk_task(WALK),),
                           (walk_model(WALK["target_velocity"]),
                            reflex_model)),
    "myoleg_terrain.npz": FileSpec((walk_task(WALK),),
                                   (walk_model(WALK["target_velocity"]),
                                    reflex_model)),
    **{f"myohand_{obj}.npz": FileSpec(
        (config_task("cfg_manip_", cfg, skip=("reset_type",)),),
        (manip_model(obj),))
       for obj, cfg in MANIP_CONFIGS.items()},
    "myotorso.npz": FileSpec(
        (pose_task(None, None, 0.5, extra_weights=dict(done=0.0),
                   named=True),), (joint_actuator_names,)),
    "myoarm_reach.npz": FileSpec(
        (reach_task("cfg_", ("IFtip",), span=_ARM_SPAN, far_th=1.0),),
        (reach_sites("cfg_", ("IFtip",)), joint_actuator_names)),
    "myoarm.npz": FileSpec(
        (pose_task(None, None, 1.5, far_th=8.0, named=True),),
        (joint_actuator_names,)),
    **{f"myodm/{obj}.npz": FileSpec((), (myodm_model,))
       for obj in myodm.GRAB_OBJECTS},
    **{name: _challenge_spec(name) for name in CHALLENGE_CONFIGS},
}
assert sorted(SPECS) == sorted(SOURCES)


def _entries(fns, mj, fields) -> Entries:
  out: Entries = {}
  for fn in fns:
    out.update(fn(mj, fields))
  return out


def export(name: str) -> Tuple[Entries, Entries]:
  """(fields, extra) of the committed model file `name`, made afresh from
  the port's builders (needs MuJoCo)."""
  mj = physics_io.compile_mjcf(model_xml(name))
  fields = physics_io.model_fields(mj)
  spec = SPECS[name]
  return fields, _entries(spec.task + spec.model, mj, fields)


def write(name: str, assets: Optional[str] = None) -> str:
  """Export the model file `name` afresh into `assets` (default the
  port's assets directory); returns its path."""
  fields, extra = export(name)
  path = os.path.join(assets or ASSETS, name)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  physics_io.save_model(path, fields, **extra)
  return path


def compiled_path(xml: str, name: str) -> str:
  """Where `write_compiled` keeps the compiled copy of the MJCF `xml` in
  place of the model file `name`: under assets/compiled/, named by the
  SHA-256 of the two."""
  key = hashlib.sha256(f"{name}\0{xml}".encode()).hexdigest()[:16]
  return os.path.join(ASSETS, "compiled", f"{key}.npz")


def write_compiled(xml: str, name: str) -> str:
  """Compile the MJCF `xml` (needs MuJoCo) and write its fields and model
  entries, as `load_xml` derives them in place of the model file `name`,
  to `compiled_path(xml, name)`; returns that path. A machine without
  MuJoCo (the card's) then runs the same `model_xml`."""
  mj = physics_io.compile_mjcf(xml)
  fields = physics_io.model_fields(mj)
  path = compiled_path(xml, name)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  physics_io.save_model(path, fields,
                        **_entries(SPECS[name].model, mj, fields))
  return path


def load_xml(xml: str, name: str, device=None):
  """(Model, extra) of a user's MJCF `xml` in place of the committed model
  file `name`: the model compiled on the host, the file's task constants,
  and the model entries derived from the user's model. Where MuJoCo cannot
  be imported, the compiled copy that `write_compiled` made of this very
  MJCF, if there is one; else the ImportError naming MuJoCo."""
  _, extra = physics_io.load_model(os.path.join(ASSETS, name), "cpu")
  try:
    mj = physics_io.compile_mjcf(xml)
  except ImportError:
    path = compiled_path(xml, name)
    if not os.path.exists(path):
      raise
    model, entries = physics_io.load_model(path, device)
    return model, {**extra, **entries}
  extra.update(_entries(SPECS[name].model, mj, physics_io.model_fields(mj)))
  return physics_io.put_model(mj, device), extra


def main(argv=None):
  import argparse
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("names", nargs="*", help="model files (under assets/)")
  parser.add_argument("--all", action="store_true", help="every file")
  parser.add_argument("--out", default=None,
                      help="directory to write into (default the port's "
                      "assets)")
  args = parser.parse_args(argv)
  for name in (sorted(SOURCES) if args.all else args.names):
    print("wrote", write(name, args.out))


if __name__ == "__main__":
  main()
