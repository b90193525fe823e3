"""MyoDM suite: hand + object reference-motion tracking over the 50 GRAB
objects (the JAX package's `envs.myodm`).

90 `MtxHand<Object><Task>-v0` ids track a synthetic motion per (object,
verb), and 100 `MtxHand<Object>{Fixed,Random}-v0` ids hold an object pose
target (a RANDOM one is drawn between two corner poses at every episode
boundary), all `ObjTrackEnv`s in suite "myodm". The motions are made with
numpy here, as the JAX package makes them: smooth object trajectories
whose shape follows the task verb (lift, pass, pour, shake, ...) and a
grasp posture for the hand over the scene file's hinge ranges.

Each object's scene (the palm-up myoHand and the object's proxy: sphere
and capsule objects are primitives, box and cylinder objects convex mesh
hulls) is a compressed model file `assets/myodm/<object>.npz`, exported from
`scene_xml` (`mjcf.export`) and read at `make`, never at import. Each
file records its (nv, nefc, ncon_max) under "myodm_nv", "myodm_nefc" and
"myodm_ncon_max", and the object site's id under "cfg_myodm_object_site".
"""

from __future__ import annotations

import functools
import os

import numpy as np

from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics import types

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "myodm")

# object name -> (geom type, size attr, mass): the GRAB household objects'
# proxies at hand scale
GRAB_OBJECTS = {
    "airplane": ("box", "0.07 0.05 0.02", 0.20),
    "alarmclock": ("cylinder", "0.035 0.02", 0.30),
    "apple": ("sphere", "0.038", 0.18),
    "banana": ("capsule", "0.015 0.06", 0.12),
    "binoculars": ("box", "0.05 0.035 0.025", 0.50),
    "bowl": ("cylinder", "0.055 0.025", 0.25),
    "camera": ("box", "0.045 0.03 0.025", 0.30),
    "coffeemug": ("cylinder", "0.04 0.05", 0.35),
    "cubelarge": ("box", "0.035 0.035 0.035", 0.25),
    "cubemedium": ("box", "0.028 0.028 0.028", 0.15),
    "cubesmall": ("box", "0.02 0.02 0.02", 0.07),
    "cup": ("cylinder", "0.035 0.045", 0.15),
    "cylinderlarge": ("cylinder", "0.035 0.07", 0.30),
    "cylindermedium": ("cylinder", "0.028 0.055", 0.20),
    "cylindersmall": ("cylinder", "0.02 0.04", 0.10),
    "duck": ("sphere", "0.04", 0.15),
    "elephant": ("box", "0.05 0.03 0.04", 0.20),
    "eyeglasses": ("box", "0.06 0.055 0.01", 0.05),
    "flashlight": ("cylinder", "0.018 0.065", 0.20),
    "flute": ("capsule", "0.012 0.08", 0.10),
    "gamecontroller": ("box", "0.055 0.04 0.02", 0.25),
    "hammer": ("capsule", "0.015 0.07", 0.45),
    "hand": ("box", "0.04 0.05 0.015", 0.20),
    "headphones": ("box", "0.05 0.05 0.02", 0.20),
    "knife": ("box", "0.01 0.07 0.008", 0.12),
    "lightbulb": ("sphere", "0.03", 0.06),
    "mouse": ("box", "0.03 0.045 0.018", 0.10),
    "mug": ("cylinder", "0.04 0.05", 0.35),
    "phone": ("box", "0.035 0.07 0.008", 0.18),
    "piggybank": ("box", "0.045 0.035 0.035", 0.30),
    "pyramidlarge": ("box", "0.04 0.04 0.03", 0.25),
    "pyramidmedium": ("box", "0.03 0.03 0.024", 0.15),
    "pyramidsmall": ("box", "0.02 0.02 0.016", 0.08),
    "scissors": ("box", "0.012 0.07 0.006", 0.08),
    "spherelarge": ("sphere", "0.05", 0.30),
    "spheremedium": ("sphere", "0.038", 0.18),
    "spheresmall": ("sphere", "0.025", 0.08),
    "stamp": ("cylinder", "0.018 0.03", 0.08),
    "stanfordbunny": ("box", "0.035 0.045 0.04", 0.20),
    "stapler": ("box", "0.02 0.06 0.02", 0.25),
    "teapot": ("sphere", "0.05", 0.40),
    "toothbrush": ("capsule", "0.008 0.08", 0.03),
    "toothpaste": ("capsule", "0.015 0.06", 0.08),
    "toruslarge": ("cylinder", "0.055 0.012", 0.25),
    "torusmedium": ("cylinder", "0.04 0.01", 0.15),
    "torussmall": ("cylinder", "0.028 0.008", 0.08),
    "train": ("box", "0.03 0.06 0.025", 0.35),
    "watch": ("cylinder", "0.025 0.008", 0.06),
    "waterbottle": ("cylinder", "0.03 0.09", 0.40),
    "wineglass": ("cylinder", "0.03 0.055", 0.12),
}

# the tracking tasks: (id suffix, object, verb)
TRACK_SPECS = (
    ("AirplaneFly", "airplane", "fly"),
    ("AirplaneLift", "airplane", "lift"),
    ("AirplanePass", "airplane", "pass"),
    ("AlarmclockLift", "alarmclock", "lift"),
    ("AlarmclockSee", "alarmclock", "inspect"),
    ("AlarmclockPass", "alarmclock", "pass"),
    ("AppleLift", "apple", "lift"),
    ("ApplePass", "apple", "pass"),
    ("BananaPass", "banana", "pass"),
    ("BinocularsPass", "binoculars", "pass"),
    ("BowlDrink2", "bowl", "drink"),
    ("BowlPass", "bowl", "pass"),
    ("CameraPass", "camera", "pass"),
    ("CubelargePass", "cubelarge", "pass"),
    ("CubemediumLInspect", "cubemedium", "inspect"),
    ("CubesmallLift", "cubesmall", "lift"),
    ("CubesmallPass", "cubesmall", "pass"),
    ("CupDrink", "cup", "drink"),
    ("CupPass", "cup", "pass"),
    ("CupPour", "cup", "pour"),
    ("CylinderlargeInspect", "cylinderlarge", "inspect"),
    ("CylindermediumLift", "cylindermedium", "lift"),
    ("CylindermediumPass", "cylindermedium", "pass"),
    ("CylindersmallInspect", "cylindersmall", "inspect"),
    ("CylindersmallPass", "cylindersmall", "pass"),
    ("DuckInspect", "duck", "inspect"),
    ("DuckLift", "duck", "lift"),
    ("DuckPass", "duck", "pass"),
    ("ElephantLift", "elephant", "lift"),
    ("ElephantPass", "elephant", "pass"),
    ("EyeglassesPass", "eyeglasses", "pass"),
    ("Flashlight1On", "flashlight", "on"),
    ("Flashlight2On", "flashlight", "on"),
    ("FlashlightLift", "flashlight", "lift"),
    ("FlashlightPass", "flashlight", "pass"),
    ("FlutePass", "flute", "pass"),
    ("GamecontrollerPass", "gamecontroller", "pass"),
    ("HammerPass", "hammer", "pass"),
    ("HammerUse", "hammer", "strike"),
    ("HandInspect", "hand", "inspect"),
    ("HeadphonesPass", "headphones", "pass"),
    ("KnifeChop", "knife", "strike"),
    ("LightbulbPass", "lightbulb", "pass"),
    ("MouseLift", "mouse", "lift"),
    ("MousePass", "mouse", "pass"),
    ("MouseUse", "mouse", "use"),
    ("MugDrink3", "mug", "drink"),
    ("MugLift", "mug", "lift"),
    ("MugPass", "mug", "pass"),
    ("PhoneLift", "phone", "lift"),
    ("PiggybankPass", "piggybank", "pass"),
    ("PiggybankUse", "piggybank", "shake"),
    ("PyramidlargePass", "pyramidlarge", "pass"),
    ("PyramidmediumPass", "pyramidmedium", "pass"),
    ("PyramidsmallInspect", "pyramidsmall", "inspect"),
    ("ScissorsUse", "scissors", "use"),
    ("SpherelargePass", "spherelarge", "pass"),
    ("SpheremediumInspect", "spheremedium", "inspect"),
    ("SpheremediumLift", "spheremedium", "lift"),
    ("SpheresmallInspect", "spheresmall", "inspect"),
    ("SpheresmallLift", "spheresmall", "lift"),
    ("SpheresmallPass", "spheresmall", "pass"),
    ("StampLift", "stamp", "lift"),
    ("StampStamp", "stamp", "strike"),
    ("StanfordbunnyInspect", "stanfordbunny", "inspect"),
    ("StanfordbunnyPass", "stanfordbunny", "pass"),
    ("StaplerLift", "stapler", "lift"),
    ("StaplerStaple1", "stapler", "strike"),
    ("StaplerStaple2", "stapler", "strike"),
    ("TeapotPour2", "teapot", "pour"),
    ("ToothbrushBrush1", "toothbrush", "brush"),
    ("ToothbrushLift", "toothbrush", "lift"),
    ("ToothpasteLift", "toothpaste", "lift"),
    ("ToothpasteSqueeze1", "toothpaste", "use"),
    ("ToruslargeInspect", "toruslarge", "inspect"),
    ("ToruslargeLift", "toruslarge", "lift"),
    ("TorusmediumLift", "torusmedium", "lift"),
    ("TorusmediumPass", "torusmedium", "pass"),
    ("TorussmallLift", "torussmall", "lift"),
    ("TorussmallPass", "torussmall", "pass"),
    ("TrainPlay", "train", "play"),
    ("WatchLift", "watch", "lift"),
    ("WatchPass", "watch", "pass"),
    ("WaterbottleLift", "waterbottle", "lift"),
    ("WaterbottlePass", "waterbottle", "pass"),
    ("WaterbottleShake", "waterbottle", "shake"),
    ("WineglassDrink2", "wineglass", "drink"),
    ("WineglassLift", "wineglass", "lift"),
    ("WineglassPass", "wineglass", "pass"),
    ("WineglassToast1", "wineglass", "toast"),
)

# scene frame: the palm-up myoHand's palm sits near this point
PALM = np.array([-0.15, 0.0, 1.245])

# the task config of every MyoDM id (the JAX package's _track_config):
# 200 control steps (4 s) for a track id, 100 for a Fixed / Random one;
# reward weights pose 0.0, object 1.0, bonus 1.0, penalty 2 (the penalty
# terms are -1, so the weighted penalty is -2)
TRACK_CONFIG = dict(
    ctrl_dt=0.02, sim_dt=0.002, norm_actions=True, reset_type="random",
    max_episode_steps=200,
    object_init=tuple(PALM.tolist()) + (1.0, 0.0, 0.0, 0.0),
    far_th=0.35, drop_th=1.05, lift_z=float(PALM[2] + 0.08), pose_thd=1.0,
    reward_weights=dict(pose=0.0, object=1.0, bonus=1.0, penalty=2.0))


def scene_path(obj_name: str) -> str:
  return os.path.join(ASSETS, f"{obj_name}.npz")


def _hull_vertices(gtype: str, size_str: str):
  """Convex-hull vertex cloud of a box or cylinder proxy (None: a sphere
  or capsule stays a primitive)."""
  dims = [float(x) for x in size_str.split()]
  if gtype == "box":
    sx, sy, sz = dims
    return [(ix * sx, iy * sy, iz * sz)
            for ix in (-1, 1) for iy in (-1, 1) for iz in (-1, 1)]
  if gtype == "cylinder":
    r, h = dims
    return [(r * np.cos(a), r * np.sin(a), s * h)
            for s in (-1, 1)
            for a in np.linspace(0.0, 2 * np.pi, 12, endpoint=False)]
  return None


def object_snippet(obj_name: str) -> str:
  """MJCF body of a GRAB object's proxy, for `mjcf.hand.build_hand`: box
  and cylinder shapes become convex mesh geoms, spheres and capsules stay
  primitives."""
  gtype, size, mass = GRAB_OBJECTS[obj_name]
  verts = _hull_vertices(gtype, size)
  if verts is None:
    geom = (f'<geom name="object_geom" type="{gtype}" size="{size}" '
            f'mass="{mass}"')
  else:
    geom = (f'<geom name="object_geom" type="mesh" mesh="grab_{obj_name}" '
            f'mass="{mass}"')
  return f"""
    <body name="object" pos="{{ox}} {{oy}} {{oz}}">
      <freejoint name="object_free"/>
      {geom}
            contype="2" conaffinity="5" friction="1 0.01 0.0005"
            solref="0.015 1" condim="3"/>
      <site name="object_site" pos="0 0 0" size="0.005"/>
    </body>
"""


def object_asset(obj_name: str) -> str:
  """<asset> mesh entry of the object's hull, '' for a primitive."""
  gtype, size, _ = GRAB_OBJECTS[obj_name]
  verts = _hull_vertices(gtype, size)
  if verts is None:
    return ""
  flat = "  ".join(f"{x:.5f} {y:.5f} {z:.5f}" for x, y, z in verts)
  return f'<mesh name="grab_{obj_name}" vertex="{flat}"/>'


def scene_builder_xml(obj_name: str) -> str:
  """The palm-up myoHand with `obj_name`'s proxy, before its muscles'
  length ranges are swept (the JAX package's scene, whose snippet and
  asset the port passes to `build_hand` as arguments)."""
  from myosuite_tpu_torch.mjcf import hand
  return hand.build_hand(palm_up=True, obj=f"grab_{obj_name}",
                         object_snippet=object_snippet(obj_name),
                         object_asset=object_asset(obj_name))


def scene_xml(obj_name: str) -> str:
  """The scene's MJCF with its muscles' length ranges (needs MuJoCo)."""
  from myosuite_tpu_torch.mjcf import builder
  return builder.finalize_muscles(scene_builder_xml(obj_name))


def _smoothstep(u: np.ndarray) -> np.ndarray:
  u = np.clip(u, 0.0, 1.0)
  return u * u * (3.0 - 2.0 * u)


def _euler_quat(roll, pitch, yaw):
  """(T,) euler xyz -> (T, 4) wxyz quaternion."""
  cr, sr = np.cos(roll / 2), np.sin(roll / 2)
  cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
  cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
  return np.stack([
      cr * cp * cy + sr * sp * sy,
      sr * cp * cy - cr * sp * sy,
      cr * sp * cy + sr * cp * sy,
      cr * cp * sy - sr * sp * cy], axis=-1)


def object_motion(verb: str, horizon: float = 4.0, dt: float = 0.02):
  """Synthetic object trajectory for a task verb: (time, obj_pose (T,7)).

  Shapes are chosen to mimic the corresponding GRAB behaviors: lifts rise
  and hold, passes translate laterally, pours/drinks tilt, strikes pulse
  downward, shakes oscillate. All curves are smooth (min-jerk style
  smoothstep ramps), start at rest on the palm, and are deterministic.
  """
  t = np.arange(0.0, horizon + dt / 2, dt)
  s = _smoothstep(t / (0.6 * horizon))        # main transport ramp
  zero = np.zeros_like(t)
  dx = dy = dz = zero
  roll = pitch = yaw = zero
  if verb == "lift":
    dz = 0.15 * s
  elif verb == "pass":
    dz = 0.10 * s
    dy = 0.22 * s
  elif verb == "fly":
    dz = 0.18 * s
    dy = 0.08 * np.sin(2 * np.pi * t / 2.0) * s
    pitch = 0.3 * np.sin(2 * np.pi * t / 2.0) * s
  elif verb == "inspect":
    dz = 0.12 * s
    yaw = 1.0 * np.sin(2 * np.pi * t / horizon) * s
  elif verb == "drink":
    dz = 0.20 * s
    dy = 0.10 * s
    roll = 0.9 * s
  elif verb == "pour":
    dz = 0.15 * s
    roll = 1.3 * s
  elif verb == "on":
    dz = 0.10 * s
    pitch = 0.4 * s
  elif verb == "use":
    dz = 0.08 * s
    yaw = 0.3 * np.sin(2 * np.pi * t / 1.5) * s
  elif verb == "play":
    dz = 0.10 * s
    dy = 0.05 * np.sin(2 * np.pi * t / 2.0) * s
  elif verb == "shake":
    dz = 0.15 * s + 0.02 * np.sin(2 * np.pi * t / 0.4) * s
  elif verb == "strike":
    dz = 0.12 * s - 0.10 * np.maximum(
        0.0, np.sin(2 * np.pi * t / 1.2)) * s
  elif verb == "brush":
    dz = 0.12 * s
    dx = 0.04 * np.sin(2 * np.pi * t / 0.8) * s
  elif verb == "toast":
    dz = 0.20 * s
    roll = 0.4 * np.sin(2 * np.pi * t / horizon) * s
  else:
    raise ValueError(f"unknown task verb {verb!r}")
  pos = PALM[None, :] + np.stack([dx, dy, dz], axis=-1)
  quat = _euler_quat(roll, pitch, yaw)
  return t, np.concatenate([pos, quat], axis=-1)


def hand_motion(hand_jnt_range: np.ndarray, t: np.ndarray) -> np.ndarray:
  """Grasp-posture hand trajectory: ramp into a mid-grasp then breathe.

  A stand-in for the GRAB hand mocap channel: the pose reward's weight is
  0.0, so the object channel dominates learning either way.
  """
  lo, hi = hand_jnt_range[:, 0], hand_jnt_range[:, 1]
  mid = lo + 0.45 * (hi - lo)
  amp = 0.10 * (hi - lo)
  s = _smoothstep(t / max(t[-1] * 0.25, 1e-6))
  breathe = np.sin(2 * np.pi * t / 2.0)
  return (s[:, None] * mid[None, :]
          + (s * breathe)[:, None] * amp[None, :])


def hand_jnt_range(model) -> np.ndarray:
  """(nhinge, 2) float64 ranges of the scene's hinge joints (the hand's),
  from the model file's jnt_type and jnt_range."""
  hinge = np.asarray(model.jnt_type) == int(types.JointType.HINGE)
  return model.jnt_range.cpu().numpy().astype(np.float64)[hinge]


def make_track_reference(model, verb: str, device=None):
  """The synthetic reference of `verb` over the scene `model`'s hand."""
  from myosuite_tpu_torch.logger.reference_motion import ReferenceMotion
  jnt_range = hand_jnt_range(model)
  t, obj = object_motion(verb)
  robot = hand_motion(jnt_range, t)
  return ReferenceMotion.from_arrays(t, robot, obj=obj, device=device)


def object_reference(nq_hand: int, random: bool, device=None):
  """The FIXED (one object pose) or RANDOM (two corner poses) reference of
  the object-pose ids."""
  from myosuite_tpu_torch.logger.reference_motion import ReferenceMotion
  if random:
    obj_rows = np.array([
        list(PALM + np.array([-0.05, -0.15, 0.05])) + [1.0, 0.0, 0.0, -0.5],
        list(PALM + np.array([0.05, 0.15, 0.20])) + [1.0, 0.0, 0.0, 0.5]])
    robot = np.zeros((2, nq_hand))
  else:
    obj_rows = np.array(
        [list(PALM + np.array([0.0, 0.15, 0.12])) + [1.0, 0.0, 0.0, 0.0]])
    robot = np.zeros((1, nq_hand))
  return ReferenceMotion.from_arrays(np.array([0.0, 4.0])[:len(obj_rows)],
                                     robot, obj=obj_rows, device=device)


def _load(obj_name: str, device, overrides, **cfg):
  """(model, config, scene): the env's model and config, and the committed
  scene's model, whose hand the reference follows (the same model but
  under a "model_xml" override, as the JAX package draws the reference
  from its default scene)."""
  from myosuite_tpu_torch.envs.registry import _deep_merge, _load_model
  path = scene_path(obj_name)
  model, extra, overrides = _load_model(path, device, overrides)
  scene = (model if overrides.get("model_xml") is None
           else physics_io.load_model(path, device)[0])
  config = dict(TRACK_CONFIG, object_site=int(extra["cfg_myodm_object_site"]),
                **cfg)
  return model, _deep_merge(config, overrides), scene


def make_track_env(suffix: str, obj_name: str, verb: str, device,
                   overrides):
  """The track id MtxHand<suffix>-v0: `obj_name`'s scene, `verb`'s
  motion."""
  from myosuite_tpu_torch.envs.tracking import ObjTrackEnv
  model, config, scene = _load(obj_name, device, overrides)
  return ObjTrackEnv(model, config,
                     make_track_reference(scene, verb, model.device))


def make_object_env(obj_name: str, random: bool, device, overrides):
  """The object-pose id MtxHand<Object>{Fixed,Random}-v0."""
  from myosuite_tpu_torch.envs.tracking import ObjTrackEnv
  model, config, scene = _load(obj_name, device, overrides,
                               max_episode_steps=100)
  return ObjTrackEnv(model, config, object_reference(scene.nq - 7, random,
                                                     model.device))


def register_all(register) -> None:
  """Register the MyoDM ids: 90 track and 100 Fixed / Random ids, each with
  its MyoHand... alias."""
  for suffix, obj_name, verb in TRACK_SPECS:
    register(f"MtxHand{suffix}-v0",
             functools.partial(make_track_env, suffix, obj_name, verb),
             aliases=(f"MyoHand{suffix}-v0",))
  for obj_name in GRAB_OBJECTS:
    title = obj_name.title()
    register(f"MtxHand{title}Fixed-v0",
             functools.partial(make_object_env, obj_name, False),
             aliases=(f"MyoHand{title}Fixed-v0",))
    register(f"MtxHand{title}Random-v0",
             functools.partial(make_object_env, obj_name, True),
             aliases=(f"MyoHand{title}Random-v0",))
