"""Core types of the PyTorch physics engine.

`Model` holds a compiled musculoskeletal model: sizes are Python ints,
structural tables (tree topology, joint and wrap types, addresses) are host
numpy arrays, and numeric parameters are float32 tensors on the model's
device. Index tables that the step needs (level walks of the tree, tendon
segment tables, constraint row maps) are built once when the model is built
and kept on the device in `Model.plan`.

`Data` holds the state and every per-step quantity of a batch of envs. All
its tensors lead with the env axis.

A per-env model (`per_env_model`) gives each env of a batch its own values
of the PER_ENV_FIELDS: those tensors lead with the env axis, and the
physics stages that read them (`kinematics.com_pos`, `tendon.tendon`,
`collision.collision`) broadcast either form.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Tuple

import numpy as np
import torch


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class WrapType(enum.IntEnum):
  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


def resolve_device(device=None) -> torch.device:
  """The device an entry point runs on: CUDA unless the caller asks for
  another. Raises rather than running a CUDA request on the CPU."""
  dev = torch.device("cuda" if device is None else device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available; pass device='cpu' to run on the CPU")
  return dev


# Sizes (Python ints), in the npz / field-dict order.
SIZE_FIELDS = ("nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite",
               "ntendon", "nwrap", "nmocap", "ncon_max", "hfield_nrow",
               "hfield_ncol", "hfield_geomid")

# Structural tables (host numpy).
STRUCT_FIELDS = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "body_mocapid", "jnt_type", "jnt_qposadr",
    "jnt_dofadr", "jnt_bodyid", "jnt_limited", "jnt_actgravcomp",
    "dof_bodyid", "dof_jntid", "dof_parentid", "geom_type", "geom_bodyid",
    "geom_condim", "geom_priority", "geom_dataid", "site_bodyid",
    "tendon_adr", "tendon_num", "tendon_limited", "wrap_type", "wrap_objid",
    "wrap_sidesite", "actuator_trntype", "actuator_dyntype",
    "actuator_gaintype", "actuator_biastype", "actuator_trnid",
    "actuator_actadr", "actuator_actnum", "actuator_ctrllimited",
    "actuator_forcelimited", "actuator_actlimited", "collision_pairs")

# Numeric parameters (float32 tensors on the model's device).
PARAM_FIELDS = (
    "qpos0", "qpos_spring", "body_pos", "body_quat", "body_ipos",
    "body_iquat", "body_mass", "body_inertia", "body_invweight0",
    "body_gravcomp", "body_subtreemask", "jnt_axis", "jnt_pos", "jnt_range",
    "jnt_stiffness", "jnt_margin", "jnt_solref", "jnt_solimp",
    "dof_armature", "dof_damping", "dof_frictionloss", "dof_invweight0",
    "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_solref",
    "geom_solimp", "geom_solmix", "geom_margin", "geom_gap", "site_pos",
    "site_quat", "tendon_range", "tendon_stiffness", "tendon_damping",
    "tendon_lengthspring", "tendon_length0", "tendon_invweight0",
    "tendon_margin", "tendon_solref_lim", "tendon_solimp_lim", "wrap_prm",
    "actuator_dynprm", "actuator_gainprm", "actuator_biasprm",
    "actuator_ctrlrange", "actuator_forcerange", "actuator_actrange",
    "actuator_gear", "actuator_acc0", "actuator_length0",
    "actuator_lengthrange", "hfield_size")

# Parameters that may carry a leading env axis (B,) + their shared shape in
# a per-env model: the bodies' masses and inertias and the geoms' sizes and
# frictions, which envs randomize per episode (`MyoEnv._model_for_step`).
_SHARED_DIMS = {"body_mass": 1, "body_inertia": 2, "geom_size": 2,
                "geom_friction": 2}
PER_ENV_FIELDS = tuple(_SHARED_DIMS)

# What a renderer reads and the physics does not (host numpy, in
# `Model.render`): geom colours and groups, the cameras (names, parent
# bodies, modes, body-frame poses, vertical fields of view in degrees),
# MuJoCo's default free camera (mjv_defaultFreeCamera: look-at point,
# distance, azimuth and elevation in degrees), the free camera's vertical
# field of view and the near and far clipping distances (vis.map.znear and
# zfar times stat.extent). A model file written before these existed loads
# without them.
RENDER_FIELDS = ("geom_rgba", "geom_group", "cam_names", "cam_bodyid",
                 "cam_mode", "cam_pos", "cam_quat", "cam_fovy",
                 "free_lookat", "free_distance", "free_azimuth",
                 "free_elevation", "vis_fovy", "vis_znear", "vis_zfar")

# Option fields: static Python scalars, then float32 tensors. Stored in a
# field dict under "opt_<name>".
OPTION_STATIC = ("timestep", "integrator", "iterations", "ls_iterations",
                 "cone", "disableflags")
OPTION_PARAMS = ("gravity", "impratio", "tolerance", "ls_tolerance",
                 "o_margin")


@dataclasses.dataclass
class Option:
  """Simulation options (the subset of mjOption the myo suite uses)."""
  timestep: float
  integrator: int
  iterations: int
  ls_iterations: int
  cone: int
  disableflags: int
  gravity: torch.Tensor
  impratio: torch.Tensor
  tolerance: torch.Tensor
  ls_tolerance: torch.Tensor
  o_margin: torch.Tensor


@dataclasses.dataclass
class Model:
  """Physics model; field names follow mjModel and the JAX package.

  Built by `io.model_from_numpy` (which also fills `body_tree` and `plan`);
  the dataclass fields are listed in SIZE_FIELDS, STRUCT_FIELDS and
  PARAM_FIELDS above. `mesh_vert[i]` (V, 3) and `mesh_face[i]` (F, 3) are
  mesh i's geom-local vertices and triangles (host numpy). `render` holds
  the RENDER_FIELDS the model file has.
  """
  sizes: Dict[str, int]
  struct: Dict[str, np.ndarray]
  params: Dict[str, torch.Tensor]
  opt: Option
  body_tree: Tuple[Tuple[int, ...], ...]
  device: torch.device
  mesh_vert: Tuple[np.ndarray, ...] = ()
  mesh_face: Tuple[np.ndarray, ...] = ()
  plan: Dict[str, Any] = dataclasses.field(default_factory=dict)
  render: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

  def __getattr__(self, name):
    # Flat access (m.nv, m.jnt_type, m.dof_damping) like the JAX Model.
    # Only reached for names that are not dataclass fields.
    for table in ("sizes", "struct", "params"):
      d = self.__dict__.get(table)
      if d is not None and name in d:
        return d[name]
    raise AttributeError(name)


def per_env_model(m: Model, **fields: torch.Tensor) -> Model:
  """`m` with some of the PER_ENV_FIELDS replaced by per-env tensors of
  shape (B,) + the shared field's shape. The new Model shares `m`'s plan,
  index tables and every other field, so nothing is rebuilt; the derived
  fields (actuator_acc0 and the body, dof and tendon invweight0) keep
  `m`'s values, as the JAX package's `Model.replace` keeps them."""
  for k, v in fields.items():
    if k not in PER_ENV_FIELDS:
      raise ValueError(f"{k} is not a per-env field; these are "
                       f"{PER_ENV_FIELDS}")
    shared = m.params[k].shape[-_SHARED_DIMS[k]:]
    if v.dim() != _SHARED_DIMS[k] + 1 or v.shape[1:] != shared:
      raise ValueError(f"{k} must be (B,) + {tuple(shared)}, got "
                       f"{tuple(v.shape)}")
  return dataclasses.replace(m, params={**m.params, **fields})


@dataclasses.dataclass
class Contact:
  """Fixed-capacity contact set: every slot of every candidate pair, with
  activity given by dist < includemargin (not by a shape)."""
  dist: torch.Tensor           # (B, ncon)
  pos: torch.Tensor            # (B, ncon, 3)
  frame: torch.Tensor          # (B, ncon, 3, 3) rows: normal, tan1, tan2
  includemargin: torch.Tensor  # (B, ncon)
  friction: torch.Tensor       # (B, ncon, 5)
  solref: torch.Tensor         # (B, ncon, 2)
  solimp: torch.Tensor         # (B, ncon, 5)
  # static per-slot tables (torch.long, no env axis)
  geom1: torch.Tensor          # (ncon,)
  geom2: torch.Tensor          # (ncon,)
  dim: torch.Tensor            # (ncon,) condim

  STATIC = ("geom1", "geom2", "dim")

  def replace(self, **kw) -> "Contact":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Data:
  """State and per-step quantities of a batch of envs (leading env axis)."""
  # state
  time: torch.Tensor           # (B,)
  qpos: torch.Tensor           # (B, nq)
  qvel: torch.Tensor           # (B, nv)
  act: torch.Tensor            # (B, na)
  ctrl: torch.Tensor           # (B, nu)
  qfrc_applied: torch.Tensor   # (B, nv)
  xfrc_applied: torch.Tensor   # (B, nbody, 6)
  mocap_pos: torch.Tensor      # (B, max(nmocap, 1), 3)
  mocap_quat: torch.Tensor
  # kinematics
  xpos: torch.Tensor           # (B, nbody, 3)
  xquat: torch.Tensor          # (B, nbody, 4)
  xmat: torch.Tensor           # (B, nbody, 3, 3)
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor        # (B, njnt, 3)
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor
  # com-based quantities
  subtree_com: torch.Tensor    # (B, nbody, 3)
  cinert: torch.Tensor         # (B, nbody, 10)
  cdof: torch.Tensor           # (B, nv, 6)
  cdof_dot: torch.Tensor
  cvel: torch.Tensor           # (B, nbody, 6)
  # tendons / actuators
  ten_length: torch.Tensor     # (B, ntendon)
  ten_velocity: torch.Tensor
  ten_J: torch.Tensor          # (B, ntendon, nv)
  actuator_length: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_moment: torch.Tensor  # (B, nu, nv)
  actuator_force: torch.Tensor
  act_dot: torch.Tensor
  # dynamics
  qM: torch.Tensor             # (B, nv, nv) dense
  qfrc_bias: torch.Tensor
  qfrc_passive: torch.Tensor
  qfrc_actuator: torch.Tensor
  qfrc_smooth: torch.Tensor
  qacc_smooth: torch.Tensor
  qfrc_constraint: torch.Tensor
  qacc: torch.Tensor
  # (qM + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint), from the
  # fused solve
  qacc_euler: torch.Tensor
  # constraints
  efc_force: torch.Tensor      # (B, nefc)
  # contacts
  contact: Contact
  ncon_active: torch.Tensor    # (B,) int32: contacts within their margin
  contact_force: torch.Tensor  # (B, ncon_max) normal force per contact slot
  # terrain heights in meters, (B, hfield_nrow, hfield_ncol); (B, 0, 0) if
  # the model has no heightfield. Per env, so a reset can draw new terrain.
  hfield_data: torch.Tensor

  def replace(self, **kw) -> "Data":
    return dataclasses.replace(self, **kw)

  @property
  def batch(self) -> int:
    return self.qpos.shape[0]


def index_tensor(x, device) -> torch.Tensor:
  """Host index table -> torch.long tensor on `device`."""
  return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
