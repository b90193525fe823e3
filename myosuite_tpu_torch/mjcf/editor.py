"""Procedural model surgery via MjSpec (the reference's myoedits role; the
JAX package's `assets/editor.py`).

Mirrors the reference's ModelEditor load-edit-compile pipeline
(MyoSuite's myosuite/envs/myo/myoedits/model_editor.py:13-37) and its
arm-reaching edit (delete the hand digits, rebuild an IFtip end-effector
site; myoedits/__init__.py:23-120), operating on our procedurally authored
XML strings instead of simhive files. MuJoCo is imported inside the
functions that need it (`physics.io.import_mujoco`), so this module imports
on a machine without MuJoCo.
"""

from __future__ import annotations

from typing import Callable, Optional

from myosuite_tpu_torch.mjcf import builder, hand
from myosuite_tpu_torch.physics.io import import_mujoco


class ModelEditor:
  """Load an MJCF string into an MjSpec, apply an edit_fn, re-emit XML."""

  def __init__(self, xml: str):
    self.spec = import_mujoco().MjSpec.from_string(xml)

  def edit(self, edit_fn: Optional[Callable] = None) -> "ModelEditor":
    if edit_fn is not None:
      edit_fn(self.spec)
    return self

  def to_xml(self) -> str:
    self.spec.compile()
    return self.spec.to_xml()


def edit_fn_arm_reaching(spec) -> None:
  """Delete all digits (and their tendons/muscles) from an arm model and
  re-create the IFtip site on the palm as the reach end-effector.

  Reference semantics: myoedits/__init__.py:23-88 deletes hand digit bodies
  and rebuilds the IFtip site to make myoArmReach envs.
  """
  palm = spec.body("palm")
  digit_roots = [b for b in spec.bodies
                 if b.name in ("TH_meta", "IF_prox", "MF_prox", "RF_prox",
                               "LF_prox")]
  removed_prefixes = ("TH", "IF", "MF", "RF", "LF")
  for b in digit_roots:
    spec.delete(b)
  # drop tendons that referenced deleted sites, then their muscles
  kept_tendons = set()
  for t in list(spec.tendons):
    if t.name.startswith(removed_prefixes):
      spec.delete(t)
    else:
      kept_tendons.add(t.name)
  for a in list(spec.actuators):
    if a.target not in kept_tendons:
      spec.delete(a)
  # orphaned palm-level origin sites of the deleted digit muscles
  for s in list(spec.sites):
    if s.name.startswith(removed_prefixes) and "_" in s.name:
      try:
        spec.delete(s)
      except Exception:
        pass
  palm.add_site(name="IFtip", pos=[0, 0.026, -0.12], size=[0.005, 0, 0])


def build_arm_reach_xml() -> str:
  """Arm model with digits removed for end-effector reaching."""
  # finalize (inject muscle lengthranges) BEFORE surgery: the surviving
  # wrist/arm muscles keep their ranges through the MjSpec round-trip
  xml = builder.finalize_muscles(hand.build_hand(arm=True))
  return ModelEditor(xml).edit(edit_fn_arm_reaching).to_xml()


def edit_fn_tabletennis(spec) -> None:
  """Attach a paddle to the palm and add ball + table + net.

  Reference scene role: myochallenge TableTennisEnvV0
  (MyoSuite's myosuite/envs/myo/myochallenge/tabletennis_v0.py:28);
  the paddle is welded to the hand, the ball relaunches toward the agent.
  Collision masks keep ball<->{paddle, table} pairs only, so the static
  contact-slot table stays small.
  """
  mujoco = import_mujoco()
  palm = spec.body("palm")
  # masks: only the ball (contype=16) initiates pairs; paddle/table/net
  # respond (conaffinity=16) but never pair with each other (contype=0)
  palm.add_geom(name="paddle_geom", type=mujoco.mjtGeom.mjGEOM_BOX,
                pos=[0, 0.002, -0.16], size=[0.012, 0.08, 0.085],
                mass=0.17, contype=0, conaffinity=16)
  palm.add_site(name="paddle_center", pos=[0, 0.002, -0.16],
                size=[0.005, 0, 0])

  world = spec.worldbody
  # table: two halves + net, agent side near x=-0.45
  world.add_geom(name="table_geom", type=mujoco.mjtGeom.mjGEOM_BOX,
                 pos=[-1.3, 0.0, 0.86], size=[0.9, 0.78, 0.02],
                 contype=0, conaffinity=16)
  world.add_geom(name="net_geom", type=mujoco.mjtGeom.mjGEOM_BOX,
                 pos=[-1.3, 0.0, 0.95], size=[0.01, 0.78, 0.08],
                 contype=0, conaffinity=16)
  ball = world.add_body(name="pingpong", pos=[-2.0, 0.0, 1.2])
  ball.add_joint(name="ball_free", type=mujoco.mjtJoint.mjJNT_FREE,
                 limited=False, damping=0.0, armature=0.0)
  ball.add_geom(name="ball_geom", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                size=[0.02, 0, 0], mass=0.0027, contype=16, conaffinity=0,
                solref=[0.01, 0.6])
  ball.add_site(name="ball_site", size=[0.004, 0, 0])


def build_tabletennis_xml() -> str:
  """Full myoArm with a welded paddle, ball and table."""
  xml = builder.finalize_muscles(hand.build_hand(arm=True))
  return ModelEditor(xml).edit(edit_fn_tabletennis).to_xml()


# ---------------------------------------------------------------------------
# spec processing helpers (reference utils/spec_processing.py:4-40 roles)
# ---------------------------------------------------------------------------


def _subtree_bodies(spec, root_name: str):
  root = spec.body(root_name)
  out = [root]
  frontier = [root]
  names = {b.name for b in spec.bodies}
  while frontier:
    b = frontier.pop()
    for child in spec.bodies:
      try:
        parent = child.parent
      except Exception:
        parent = None
      if parent is not None and parent.name == b.name and child.name in names:
        out.append(child)
        frontier.append(child)
  return out


def recursive_immobilize(spec, root_name: str = None) -> None:
  """Delete every joint under root (whole model if None) — the reference's
  immobilize pass (spec_processing.py) used to freeze limb subtrees."""
  bodies = (_subtree_bodies(spec, root_name) if root_name
            else list(spec.bodies))
  for b in bodies:
    for j in list(b.joints):
      spec.delete(j)


def recursive_decontact(spec, root_name: str = None) -> None:
  """Zero contype/conaffinity under root (reference decontact pass)."""
  bodies = (_subtree_bodies(spec, root_name) if root_name
            else list(spec.bodies))
  for b in bodies:
    for g in b.geoms:
      g.contype = 0
      g.conaffinity = 0


def mirror_name(name: str) -> str:
  """r_/l_ prefix swap (reference mirror pass helper)."""
  if name.startswith("r_"):
    return "l_" + name[2:]
  if name.startswith("l_"):
    return "r_" + name[2:]
  return name
