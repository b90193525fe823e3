"""Environment registry slice and `make`.

The port's envs load their model and task config from files committed in
`myosuite_tpu_torch/assets/`, compiled beforehand from MJCF, so `make`
needs no MuJoCo. Ids, aliases and suites follow the JAX package's
registry, with its muscle-condition variants: every base id registered
with `register_with_variants` also has an `MtxFati*` id (wrapped in the
3CC-r `FatigueWrapper`) and an `MtxSarc*` id (sarcopenia, half the muscle
force). Overrides merge into an env's config recursively, as
`ConfigDict.update` merges them in the JAX package. The MyoDM ids
(`envs/myodm.py`) load their scene file at `make`, never at import.
An override "model_xml" runs a user's MJCF in place of the id's model
file (`_load_model`; compiled on the host, so MuJoCo is needed there).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from myosuite_tpu_torch.envs import myodm
from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics import types

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
HAND_REACH_NPZ = os.path.join(ASSETS, "myohand_reach.npz")
ELBOW_NPZ = os.path.join(ASSETS, "myoelbow.npz")
FINGER_NPZ = os.path.join(ASSETS, "myofinger.npz")
LEG_NPZ = os.path.join(ASSETS, "myoleg.npz")
LEG_TERRAIN_NPZ = os.path.join(ASSETS, "myoleg_terrain.npz")
TORSO_NPZ = os.path.join(ASSETS, "myotorso.npz")
ARM_REACH_NPZ = os.path.join(ASSETS, "myoarm_reach.npz")
ARM_NPZ = os.path.join(ASSETS, "myoarm.npz")
# the in-hand manipulation models, by object (envs/manipulation.py ENVS)
MANIP_NPZ = {obj: os.path.join(ASSETS, f"myohand_{obj}.npz")
             for obj in ("hold", "die", "pen", "baoding", "key")}
# the MyoChallenge models, by task (envs/challenge.py)
CHALLENGE_NPZ = {task: os.path.join(ASSETS, f"{stem}.npz") for task, stem in (
    ("chasetag", "myoleg_chasetag"), ("soccer", "myoleg_soccer"),
    ("runtrack", "myoleg_osl"), ("relocate", "myoarm_relocate"),
    ("bimanual", "myoarm_bimanual"), ("tabletennis", "myoarm_tabletennis"))}

# order of the reward weights stored under "<prefix>reward_weights"
REACH_REWARDS = ("reach", "bonus", "penalty")
POSE_REWARDS = ("pose", "bonus", "act_reg", "penalty")

# The JAX package's pose-task defaults (its registry's base_env_config and
# pose_config), for the hand pose env, whose targets span the model's own
# joint ranges and which has no config of its own in a model file.
POSE_DEFAULTS = dict(
    ctrl_dt=0.02, sim_dt=0.002, max_episode_steps=100, norm_actions=True,
    reset_type="random", pose_thd=0.35, far_th=float(4 * np.pi / 2),
    fixed_target=False,
    reward_weights=dict(pose=1.0, bonus=4.0, act_reg=1.0, penalty=50.0))

# The walk task's scalar config keys, stored under "cfg_walk_<key>" (with
# the reward names and weights, site ids, hip addresses and gait keyframes;
# the terrain model adds hf_base and hf_extent).
WALK_SCALARS = ("ctrl_dt", "sim_dt", "max_episode_steps", "target_velocity",
                "gait_period", "hip_amplitude", "min_height", "max_rot",
                "stand_height")
WALK_IDS = ("pelvis_site", "torso_site", "rfoot_site", "lfoot_site",
            "rhip_adr", "lhip_adr")
# The JAX package's stand task: the walk config with these overrides.
STAND_OVERRIDES = dict(
    max_episode_steps=300, reset_type="none",
    reward_weights=dict(reach=1.0, bonus=4.0, penalty=50.0, act_reg=1.0))

# The ten ASL hand postures (the JAX package's registry): per digit prefix
# the flexion fraction of each joint's range; other joints 0.05, abduction
# joints 0.5, the wrist and deviation joints 0.
_E, _F, _O = 0.05, 0.85, 0.55   # extended / flexed / opposed-curved
ASL_PATTERNS = (
    {"TH": _O, "IF": 0.6, "MF": 0.6, "RF": 0.6, "LF": 0.6},   # 0
    {"TH": _F, "IF": _E, "MF": _F, "RF": _F, "LF": _F},       # 1
    {"TH": _F, "IF": _E, "MF": _E, "RF": _F, "LF": _F},       # 2
    {"TH": _E, "IF": _E, "MF": _E, "RF": _F, "LF": _F},       # 3
    {"TH": _F, "IF": _E, "MF": _E, "RF": _E, "LF": _E},       # 4
    {"TH": _E, "IF": _E, "MF": _E, "RF": _E, "LF": _E},       # 5
    {"TH": _O, "IF": _E, "MF": _E, "RF": _E, "LF": _O},       # 6
    {"TH": _O, "IF": _E, "MF": _E, "RF": _O, "LF": _E},       # 7
    {"TH": _O, "IF": _E, "MF": _O, "RF": _E, "LF": _E},       # 8
    {"TH": _O, "IF": _O, "MF": _E, "RF": _E, "LF": _E},       # 9
)
# reafferentation: the tendon transfer EIP -> EPL
REAF_SRC, REAF_DST = "IF_EIP", "TH_EPL"
# the elbow exo task: the elbow pose task plus a payload on this body,
# drawn in weight_range, and the exo's share of the gravity torque
EXO_CONFIG = dict(payload_body="forearm", weight_range=(0.0, 2.0),
                  exo_assist=0.6)
# the cyclic tracking tasks (the JAX package's TrackEnv configs)
CYCLIC_TRACK_CONFIG = dict(
    ctrl_dt=0.02, sim_dt=0.002, norm_actions=True, reset_type="random",
    max_episode_steps=200,
    reward_weights=dict(pose=1.0, vel=0.2, bonus=1.0, penalty=2.0))
TRACK_THRESHOLDS = {"finger": dict(pose_thd=0.6, far_th=4.0),
                    "hand": dict(pose_thd=1.2, far_th=8.0)}

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_ALIASES: Dict[str, str] = {}
_SUITES: Dict[str, str] = {}


def register(name: str, factory: Callable[..., Any], aliases=(),
             suite: str = "myobase") -> None:
  _REGISTRY[name] = factory
  _SUITES[name] = suite
  for a in aliases:
    _ALIASES[a] = name


def suite_of(name: str) -> str:
  """The suite an env id (or alias) belongs to."""
  return _SUITES.get(resolve(name), "myobase")


def registered_envs():
  return sorted(_REGISTRY)


def resolve(name: str) -> str:
  return _ALIASES.get(name, name)


def make(name: str, device=None, overrides: Optional[Dict[str, Any]] = None):
  """Instantiate an env by id on `device` (default "cuda"; raises when CUDA
  is not available unless another device is named); `overrides` update
  the env's config, nested dicts key by key."""
  name = resolve(name)
  if name not in _REGISTRY:
    raise KeyError(f"unknown env {name!r}; registered: {registered_envs()}")
  return _REGISTRY[name](types.resolve_device(device), dict(overrides or {}))


def _deep_merge(cfg: Dict[str, Any], overrides: Dict[str, Any]
                ) -> Dict[str, Any]:
  """`cfg` updated by `overrides`, a dict value merging into the dict it
  replaces key by key (as `ConfigDict.update` does); `cfg` is not
  changed."""
  out = dict(cfg)
  for k, v in overrides.items():
    if isinstance(v, dict) and isinstance(out.get(k), dict):
      out[k] = _deep_merge(out[k], v)
    else:
      out[k] = v
  return out


def _variant_alias(alias: str, tag: str) -> str:
  for prefix in ("Mjx", "myo"):
    if alias.startswith(prefix):
      return prefix + tag + alias[len(prefix):]
  return tag + alias


def register_with_variants(name: str, factory: Callable[..., Any],
                           aliases=(), suite: str = "myobase") -> None:
  """Register a base env and its muscle-condition variants: MtxFati<...>
  (the env in a FatigueWrapper) and MtxSarc<...> (muscle_condition
  "sarcopenia"), with the base's aliases tagged Fati / Sarc."""
  from myosuite_tpu_torch.envs.fatigue import FatigueWrapper

  register(name, factory, aliases, suite=suite)
  assert name.startswith("Mtx")
  suffix = name[len("Mtx"):]

  def fati_factory(device, overrides):
    return FatigueWrapper(factory(device, overrides))

  def sarc_factory(device, overrides):
    return factory(device, {**overrides, "muscle_condition": "sarcopenia"})

  register(f"MtxFati{suffix}", fati_factory,
           aliases=tuple(_variant_alias(a, "Fati") for a in aliases),
           suite=suite)
  register(f"MtxSarc{suffix}", sarc_factory,
           aliases=tuple(_variant_alias(a, "Sarc") for a in aliases),
           suite=suite)


def register_env_variant(env_id: str, variants: Dict[str, Any],
                         variant_id: Optional[str] = None,
                         silent: bool = False) -> str:
  """Register a variant of a registered env: `variants` maps dot-path keys
  ("reward_weights.pose", "max_episode_steps") to values, nested and merged
  into the env's config. The id is made from the keys when not given, and
  announced with an INFO prompt (`utils.prompt_utils`) unless `silent`.
  Returns the new id."""
  base = resolve(env_id)
  if base not in _REGISTRY:
    raise KeyError(f"unknown env {env_id!r}")
  if variant_id is None:
    tag = "-".join(f"{k.split('.')[-1]}={v}" for k, v in
                   sorted(variants.items()))
    stem, _, ver = base.rpartition("-")
    variant_id = f"{stem}_{tag}-{ver}"
  base_factory = _REGISTRY[base]
  nested: Dict[str, Any] = {}
  for k, v in variants.items():
    cur = nested
    parts = k.split(".")
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    cur[parts[-1]] = v

  def factory(device, overrides):
    return base_factory(device, _deep_merge(nested, overrides))

  register(variant_id, factory)
  if not silent:
    from myosuite_tpu_torch.utils.prompt_utils import prompt
    prompt(f"Registered env variant: {variant_id}", type_="INFO")
  return variant_id


def _episode_config(extra: Dict[str, np.ndarray], p: str) -> Dict[str, Any]:
  return dict(ctrl_dt=float(extra[p + "ctrl_dt"]),
              sim_dt=float(extra[p + "sim_dt"]),
              max_episode_steps=int(extra[p + "max_episode_steps"]),
              far_th=float(extra[p + "far_th"]), norm_actions=True)


def reach_config_from_npz(extra: Dict[str, np.ndarray],
                          p: str = "cfg_") -> Dict[str, Any]:
  """ReachEnv config from the "<p>*" arrays of a model file."""
  return dict(
      _episode_config(extra, p),
      tip_sids=[int(s) for s in extra[p + "tip_sids"]],
      target_lo=extra[p + "target_lo"], target_hi=extra[p + "target_hi"],
      reward_weights=dict(zip(REACH_REWARDS,
                              map(float, extra[p + "reward_weights"]))))


def pose_config_from_npz(extra: Dict[str, np.ndarray],
                         p: str = "cfg_pose_") -> Dict[str, Any]:
  """PoseEnv config from the "<p>*" arrays of a model file; the weights
  are named by "<p>reward_names" where the file has it, else they are
  POSE_REWARDS in order."""
  names = (map(str, extra[p + "reward_names"]) if p + "reward_names" in extra
           else POSE_REWARDS)
  return dict(
      _episode_config(extra, p),
      target_jnt_lo=extra[p + "target_jnt_lo"],
      target_jnt_hi=extra[p + "target_jnt_hi"],
      pose_thd=float(extra[p + "pose_thd"]),
      reset_type=str(extra[p + "reset_type"]),
      reward_weights=dict(zip(names,
                              map(float, extra[p + "reward_weights"]))))


def walk_config_from_npz(extra: Dict[str, np.ndarray],
                         p: str = "cfg_walk_") -> Dict[str, Any]:
  """WalkEnv config from the "<p>*" arrays of a model file."""
  cfg = {k: float(extra[p + k]) for k in WALK_SCALARS}
  cfg["max_episode_steps"] = int(cfg["max_episode_steps"])
  cfg.update({k: int(extra[p + k]) for k in WALK_IDS})
  cfg.update(
      norm_actions=True, reset_type=str(extra[p + "reset_type"]),
      reward_weights=dict(zip(map(str, extra[p + "reward_names"]),
                              map(float, extra[p + "reward_weights"]))),
      gait_qpos=extra[p + "gait_qpos"], gait_qvel=extra[p + "gait_qvel"])
  for k in ("hf_base", "hf_extent"):
    if p + k in extra:
      cfg[k] = tuple(map(float, extra[p + k]))
  return cfg


def reflex_tables_from_npz(extra: Dict[str, np.ndarray],
                           p: str = "cfg_reflex_") -> Dict[str, Any]:
  """The reflex controller's tables (`agents.reflex`) from the "<p>*"
  arrays of a leg model file, or None if it has none."""
  if p + "masks" not in extra:
    return None
  return {k: extra[p + k] for k in ("group_names", "masks", "grf",
                                    "hip_qadr", "weight")}


def task_config_from_npz(extra: Dict[str, np.ndarray],
                         p: str = "cfg_manip_") -> Dict[str, Any]:
  """A task config (the manipulation and challenge envs') from the "<p>*"
  arrays of a model file: strings as str, integers (site and geom ids,
  joint addresses, max_episode_steps) as int or a tuple of int, other
  numbers as float or a tuple of float, the reward names and weights as
  the ordered dict `reward_weights`."""
  cfg: Dict[str, Any] = dict(norm_actions=True)
  for key, v in extra.items():
    if not key.startswith(p) or key in (p + "reward_names",
                                        p + "reward_weights"):
      continue
    k = key[len(p):]
    if v.dtype.kind in "US":
      cfg[k] = str(v)
    elif np.issubdtype(v.dtype, np.integer):
      cfg[k] = tuple(map(int, v)) if v.ndim else int(v)
    else:
      cfg[k] = tuple(map(float, v)) if v.ndim else float(v)
  cfg["reward_weights"] = dict(zip(map(str, extra[p + "reward_names"]),
                                   map(float, extra[p + "reward_weights"])))
  return cfg


def _load_model(path: str, device, overrides: Dict[str, Any]):
  """(Model, extra, overrides) of the committed model file at `path`:
  `overrides` gains "model_file", the file's name under ASSETS, from which
  the env's host `mj_model` is built. Where `overrides` holds "model_xml",
  the model is that MJCF compiled on the host (MuJoCo needed, else an
  ImportError) with the file's task constants and the model entries (ids,
  addresses, names, reflex tables) derived from the user's model
  (`mjcf.export.load_xml`), as the JAX package's env rebuilds from
  `config.model_xml`."""
  name = os.path.relpath(path, ASSETS)
  overrides = {**overrides, "model_file": name}
  if overrides.get("model_xml") is None:
    model, extra = physics_io.load_model(path, device)
  else:
    from myosuite_tpu_torch.mjcf import export
    model, extra = export.load_xml(overrides["model_xml"], name, device)
  return model, extra, overrides


def _reach(path, prefix, device, overrides, fixed=False):
  from myosuite_tpu_torch.envs.reach import ReachEnv
  model, extra, overrides = _load_model(path, device, overrides)
  cfg = reach_config_from_npz(extra, prefix)
  cfg["fixed_target"] = fixed
  return ReachEnv(model, _deep_merge(cfg, overrides))


def _pose(path, device, overrides, fixed=False):
  from myosuite_tpu_torch.envs.pose import PoseEnv
  model, extra, overrides = _load_model(path, device, overrides)
  cfg = pose_config_from_npz(extra)
  cfg["fixed_target"] = fixed
  return PoseEnv(model, _deep_merge(cfg, overrides))


def asl_target(jnt_names, jnt_range: np.ndarray, pattern) -> np.ndarray:
  """(njnt,) float64 posture of an ASL pattern over the hand's joints:
  lo + frac (hi - lo) per joint, frac by the joint name's digit prefix."""
  q = np.zeros(len(jnt_names))
  for j, name in enumerate(jnt_names):
    frac = pattern.get(name.split("_")[0], 0.05)
    if name.endswith("_abd") or name.endswith("_dev") or "wrist" in name:
      frac = 0.0 if "wrist" in name or name.endswith("_dev") else 0.5
    lo, hi = (float(x) for x in jnt_range[j])
    q[j] = lo + frac * (hi - lo)
  return q


def _hand_pose(device, overrides, fixed=False, asl=None):
  """The hand pose task over the hand's own joint ranges; `asl` picks one
  of ASL_PATTERNS as the fixed target."""
  from myosuite_tpu_torch.envs.pose import PoseEnv
  model, _, overrides = _load_model(HAND_REACH_NPZ, device, overrides)
  # the targets span the default hand's ranges, also under a model_xml
  with np.load(HAND_REACH_NPZ) as z:
    rng, names = z["jnt_range"], [str(n) for n in z["jnt_names"]]
  cfg = dict(POSE_DEFAULTS, target_jnt_lo=rng[:, 0], target_jnt_hi=rng[:, 1],
             pose_thd=1.0, fixed_target=fixed)
  if asl is not None:
    cfg.update(fixed_target=True, target_jnt_value=asl_target(
        names, rng, ASL_PATTERNS[asl]))
  return PoseEnv(model, _deep_merge(cfg, overrides))


def _reaf_hand_pose(device, overrides):
  """The hand pose task with the EIP command sent to EPL."""
  from myosuite_tpu_torch.envs.base import ReafferentationWrapper
  env = _hand_pose(device, overrides)
  with np.load(HAND_REACH_NPZ) as z:
    names = [str(n) for n in z["actuator_names"]]
  return ReafferentationWrapper(env, src=names.index(REAF_SRC),
                                dst=names.index(REAF_DST))


def _elbow_exo(device, overrides, fixed=False):
  """The elbow pose task with a payload and an exo assist torque."""
  from myosuite_tpu_torch.envs.pose import ElbowExoPoseEnv
  model, extra, overrides = _load_model(ELBOW_NPZ, device, overrides)
  names = [str(n) for n in extra["body_names"]]
  cfg = dict(pose_config_from_npz(extra), fixed_target=fixed,
             **EXO_CONFIG)
  cfg["payload_body"] = names.index(EXO_CONFIG["payload_body"])
  return ElbowExoPoseEnv(model, _deep_merge(cfg, overrides))


def _sar(device, overrides, variant="8"):
  """The SAR reorientation task of `variant`'s geometry table, on the pen
  scene with the pen task's goal centre and reward weights."""
  from myosuite_tpu_torch.envs.sar import ReorientSAREnv
  model, extra, overrides = _load_model(MANIP_NPZ["pen"], device,
                                       overrides)
  cfg = task_config_from_npz(extra)
  del cfg["goal_pitch_limit"]
  cfg.update(fixed_target=False, geom_variant=variant)
  return ReorientSAREnv(model, _deep_merge(cfg, overrides))


def _track(which, device, overrides):
  """The cyclic tracking task of the finger or the hand model."""
  from myosuite_tpu_torch.envs.tracking import TrackEnv, make_cyclic_reference
  path = FINGER_NPZ if which == "finger" else HAND_REACH_NPZ
  model, _, overrides = _load_model(path, device, overrides)
  cfg = dict(CYCLIC_TRACK_CONFIG, **TRACK_THRESHOLDS[which])
  # the reference spans the default model's ranges, also under a model_xml
  with np.load(path) as z:
    jnt_range, nq = z["jnt_range"], len(z["qpos0"])
  ref = make_cyclic_reference(jnt_range, nq, device=model.device)
  return TrackEnv(model, _deep_merge(cfg, overrides), ref)


def _leg(device, overrides, kind="walk"):
  """The myoLeg tasks: "walk", "stand", or a terrain type for walking over
  terrain ("rough", "hilly", "stairs", "flat", "random")."""
  from myosuite_tpu_torch.envs import locomotion
  terrain = kind not in ("walk", "stand")
  model, extra, overrides = _load_model(
      LEG_TERRAIN_NPZ if terrain else LEG_NPZ, device, overrides)
  cfg = walk_config_from_npz(extra)
  reflex = reflex_tables_from_npz(extra)
  if reflex is not None:
    cfg["reflex"] = reflex
  if kind == "stand":
    return locomotion.StandEnv(
        model, _deep_merge(_deep_merge(cfg, STAND_OVERRIDES), overrides))
  if terrain:
    return locomotion.TerrainWalkEnv(
        model, _deep_merge({**cfg, "terrain_type": kind}, overrides))
  return locomotion.WalkEnv(model, _deep_merge(cfg, overrides))


def _manip(obj, device, overrides, fixed=False):
  """The in-hand manipulation task of the model file of `obj`."""
  from myosuite_tpu_torch.envs import manipulation
  model, extra, overrides = _load_model(MANIP_NPZ[obj], device, overrides)
  cfg = dict(task_config_from_npz(extra), fixed_target=fixed)
  return manipulation.ENVS[obj](model, _deep_merge(cfg, overrides))


def _challenge(task, device, overrides, role="chase"):
  """The MyoChallenge task `task` on its model file; the leg tasks take
  the walk config too, and ChaseTag the agent's role."""
  from myosuite_tpu_torch.envs import challenge
  model, extra, overrides = _load_model(CHALLENGE_NPZ[task], device,
                                       overrides)
  cfg = task_config_from_npz(extra, "cfg_chal_")
  if "cfg_walk_ctrl_dt" in extra:
    cfg = {**walk_config_from_npz(extra), **cfg}
  if task == "chasetag":
    cfg["agent_role"] = role
  cls = {"chasetag": challenge.ChaseTagEnv, "soccer": challenge.SoccerEnv,
         "runtrack": challenge.RunTrackEnv,
         "relocate": challenge.RelocateEnv,
         "bimanual": challenge.BimanualEnv,
         "tabletennis": challenge.TableTennisEnv}[task]
  return cls(model, _deep_merge(cfg, overrides))


def _register_pair(stem, factory, aliases, suite="myobase"):
  """<stem>{Random,Fixed}-v0 with their variants and aliases (each an alias
  stem)."""
  for kind in ("Random", "Fixed"):
    register_with_variants(
        f"{stem}{kind}-v0",
        functools.partial(factory, fixed=kind == "Fixed"),
        aliases=tuple(f"{a}{kind}-v0" for a in aliases), suite=suite)


_register_pair("MtxElbowPose", functools.partial(_pose, ELBOW_NPZ),
               ("MjxElbowPose", "myoElbowPose1D6M"))
_register_pair("MtxFingerPose", functools.partial(_pose, FINGER_NPZ),
               ("MjxFingerPose", "myoFingerPose"))
_register_pair("MtxFingerReach",
               functools.partial(_reach, FINGER_NPZ, "cfg_reach_"),
               ("myoFingerReach",))
_register_pair("MtxHandPose", _hand_pose, ("MjxHandPose", "myoHandPose"))
_register_pair("MtxHandReach",
               functools.partial(_reach, HAND_REACH_NPZ, "cfg_"),
               ("MjxHandReach", "myoHandReach"))
_register_pair("MtxHandObjHold", functools.partial(_manip, "hold"),
               ("myoHandObjHold",))
register_with_variants(
    "MtxHandDieReorient-v0", functools.partial(_manip, "die"),
    aliases=("myoChallengeDieReorientP1-v0", "myoHandReorient-v0"))
_register_pair("MtxHandPenTwirl", functools.partial(_manip, "pen"),
               ("myoHandPenTwirl",))
register_with_variants(
    "MtxHandBaoding-v0", functools.partial(_manip, "baoding"),
    aliases=("myoChallengeBaodingP1-v1", "myoHandBaodingRandom-v0"))
_register_pair("MtxHandKeyTurn", functools.partial(_manip, "key"),
               ("myoHandKeyTurn",))
register_with_variants("MtxLegWalk-v0", _leg, aliases=("myoLegWalk-v0",))
register_with_variants("MtxLegStand-v0", functools.partial(_leg, kind="stand"),
                       aliases=("myoLegReachFixed-v0", "myoLegStand-v0"))
for _kind, _alias in (("Rough", "Rough"), ("Hilly", "Hilly"),
                      ("Stairs", "Stair")):
  register_with_variants(
      f"MtxLegWalk{_kind}-v0", functools.partial(_leg, kind=_kind.lower()),
      aliases=(f"myoLeg{_alias}TerrainWalk-v0",))
for _k in range(len(ASL_PATTERNS)):
  register(f"MtxHandPose{_k}Fixed-v0", functools.partial(_hand_pose, asl=_k),
           aliases=(f"myoHandPose{_k}Fixed-v0",))
_register_pair("MtxTorsoPose", functools.partial(_pose, TORSO_NPZ),
               ("myoTorsoPose",))
_register_pair("MtxArmReach", functools.partial(_reach, ARM_REACH_NPZ, "cfg_"),
               ("myoArmReach",), suite="myoedits")
register_with_variants("MtxArmPoseRandom-v0",
                       functools.partial(_pose, ARM_NPZ),
                       aliases=("myoArmPoseRandom-v0",))
register("MtxReafHandPoseRandom-v0", _reaf_hand_pose,
         aliases=("myoReafHandPoseRandom-v0",))
_register_pair("MtxElbowPoseExo", _elbow_exo, ("myoElbowPose1D6MExo",))
for _variant, _rid in (("8", "Reorient8"), ("100", "Reorient100"),
                       ("id", "ReorientID"), ("ood", "ReorientOOD")):
  register(f"MtxHand{_rid}-v0", functools.partial(_sar, variant=_variant),
           aliases=(f"myoHand{_rid}-v0",))
register_with_variants("MtxFingerTrackCyclic-v0",
                       functools.partial(_track, "finger"),
                       aliases=("myoDmFingerTrack-v0",), suite="myodm")
register_with_variants("MtxHandTrackCyclic-v0",
                       functools.partial(_track, "hand"),
                       aliases=("myoDmHandTrack-v0",), suite="myodm")
myodm.register_all(functools.partial(register, suite="myodm"))
for _name, _task, _kw, _aliases in (
    ("MtxChaseTag-v0", "chasetag", {}, ("myoChallengeChaseTagP1-v0",)),
    ("MtxChaseTagEvade-v0", "chasetag", {"role": "evade"},
     ("myoChallengeChaseTagP2-v0",)),
    ("MtxSoccer-v0", "soccer", {}, ("myoChallengeSoccerP1-v0",)),
    ("MtxRunTrack-v0", "runtrack", {},
     ("myoChallengeRunTrackP1-v0", "myoChallengeOslRunFixed-v0")),
    ("MtxRelocate-v0", "relocate", {}, ("myoChallengeRelocateP1-v0",)),
    ("MtxBimanual-v0", "bimanual", {}, ("myoChallengeBimanual-v0",)),
    ("MtxTableTennis-v0", "tabletennis", {},
     ("myoChallengeTableTennisP1-v0",))):
  register(_name, functools.partial(_challenge, _task, **_kw),
           aliases=_aliases, suite="myochal")
