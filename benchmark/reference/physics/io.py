"""Model loading from a committed `.npz` model file into a `Model`.

Frozen copy of the program's loader (its MuJoCo compile path left out):
the topological levels of the kinematic tree, the collision-pair table
with its contact capacity, and each module's index plan, precomputed
once. Mesh i's vertices and triangles are stored under the numbered keys
"mesh_vert_<i>" and "mesh_face_<i>".
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from benchmark.reference.physics import types
from benchmark.reference.physics.types import (OPTION_PARAMS, OPTION_STATIC,
                                              PARAM_FIELDS, RENDER_FIELDS,
                                              SIZE_FIELDS, STRUCT_FIELDS,
                                              Data, GeomType, Model, Option)

# Number of contact points each supported pair class can generate.
_PAIR_NCON = {
    (GeomType.HFIELD, GeomType.SPHERE): 1,
    (GeomType.HFIELD, GeomType.CAPSULE): 2,
    (GeomType.HFIELD, GeomType.BOX): 4,
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.PLANE, GeomType.MESH): 4,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.MESH): 2,
    (GeomType.BOX, GeomType.MESH): 4,
}


def _body_levels(parentid: np.ndarray) -> Tuple[Tuple[int, ...], ...]:
  """Group body ids (excluding world=0) into topological levels."""
  n = len(parentid)
  depth = np.zeros(n, dtype=int)
  for i in range(1, n):
    depth[i] = depth[parentid[i]] + 1
  levels = []
  for d in range(1, depth.max() + 1 if n > 1 else 1):
    ids = tuple(int(i) for i in np.nonzero(depth == d)[0])
    if ids:
      levels.append(ids)
  return tuple(levels)


def _collision_pairs(m) -> np.ndarray:
  """Static (npair, 4) table [geom1, geom2, ncon_slots, condim], with
  MuJoCo's pair filtering (contype/conaffinity, same-body, parent-child and
  <exclude> rules)."""
  pairs = []
  excl = set()
  for sig in m.exclude_signature:
    excl.add((int(sig) >> 16, int(sig) & 0xFFFF))

  weld = m.body_weldid
  for g1 in range(m.ngeom):
    for g2 in range(g1 + 1, m.ngeom):
      t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
      b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
      mask = ((m.geom_contype[g1] & m.geom_conaffinity[g2]) or
              (m.geom_contype[g2] & m.geom_conaffinity[g1]))
      if not mask:
        continue
      w1, w2 = int(weld[b1]), int(weld[b2])
      if w1 == w2:
        continue
      pw1, pw2 = int(weld[m.body_parentid[w1]]), int(weld[m.body_parentid[w2]])
      if (pw1 == w2 and w2 != 0) or (pw2 == w1 and w1 != 0):
        continue
      if (b1, b2) in excl or (b2, b1) in excl:
        continue
      if t1 > t2:
        g1s, g2s, t1s, t2s = g2, g1, t2, t1
      else:
        g1s, g2s, t1s, t2s = g1, g2, t1, t2
      key = (GeomType(t1s), GeomType(t2s))
      if key not in _PAIR_NCON:
        continue
      condim = max(int(m.geom_condim[g1]), int(m.geom_condim[g2]))
      p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
      if p1 != p2:
        condim = int(m.geom_condim[g1 if p1 > p2 else g2])
      pairs.append((g1s, g2s, _PAIR_NCON[key], condim))

  if not pairs:
    return np.zeros((0, 4), dtype=np.int32)
  return np.array(pairs, dtype=np.int32)


def _subtree_mask(m) -> np.ndarray:
  """(nbody, nbody) matrix: mask[i, j] = 1 iff body j is in subtree(i)."""
  n = m.nbody
  mask = np.zeros((n, n), dtype=np.float32)
  for j in range(n):
    b = j
    while True:
      mask[b, j] = 1.0
      if b == 0:
        break
      b = int(m.body_parentid[b])
  return mask


def _wrap_sidesites(m) -> np.ndarray:
  """Side-site ids for sphere/cylinder wrap segments (-1 when none)."""
  side = np.full(m.nwrap, -1, dtype=np.int32)
  for i in range(m.nwrap):
    t = int(m.wrap_type[i])
    if t in (int(types.WrapType.SPHERE), int(types.WrapType.CYLINDER)):
      side[i] = int(m.wrap_prm[i])
  return side


def _is_mesh_key(k: str) -> bool:
  return k.startswith(("mesh_vert_", "mesh_face_"))


def model_from_numpy(fields: Dict[str, Any], device=None) -> Model:
  """Build the torch `Model` from a field dict of numpy arrays.

  Keys are the field names of SIZE_FIELDS, STRUCT_FIELDS and PARAM_FIELDS,
  "opt_<name>" for the options and "mesh_{vert,face}_<i>" for the meshes;
  those of RENDER_FIELDS that `fields` has go to `Model.render`; other keys
  are ignored.
  """
  from benchmark.reference.physics import (actuation, collision, constraint,
                                          forward, kinematics, smooth,
                                          tendon)

  dev = types.resolve_device(device)
  sizes = {k: int(np.asarray(fields[k])) for k in SIZE_FIELDS}
  struct = {k: np.array(fields[k]) for k in STRUCT_FIELDS}
  params = {k: torch.tensor(np.asarray(fields[k], dtype=np.float32),
                            device=dev) for k in PARAM_FIELDS}
  opt_static = {k: int(np.asarray(fields["opt_" + k]))
                for k in OPTION_STATIC[1:]}
  opt = Option(
      timestep=float(np.asarray(fields["opt_timestep"])), **opt_static,
      **{k: torch.tensor(np.asarray(fields["opt_" + k], dtype=np.float32),
                         device=dev)
         for k in OPTION_PARAMS})
  nmesh = sum(1 for k in fields if k.startswith("mesh_vert_"))
  m = Model(sizes=sizes, struct=struct, params=params, opt=opt,
            body_tree=_body_levels(struct["body_parentid"]), device=dev,
            mesh_vert=tuple(np.asarray(fields[f"mesh_vert_{i}"])
                            for i in range(nmesh)),
            mesh_face=tuple(np.asarray(fields[f"mesh_face_{i}"])
                            for i in range(nmesh)),
            render={k: np.asarray(fields[k]) for k in RENDER_FIELDS
                    if k in fields})
  for mod in (kinematics, tendon, actuation, smooth, collision, constraint,
              forward):
    m.plan[mod.__name__.rsplit(".", 1)[1]] = mod.make_plan(m)
  return m


def load_model(path: str, device=None
               ) -> Tuple[Model, Dict[str, np.ndarray]]:
  """Read a `save_model` file; returns (Model, the extra arrays)."""
  with np.load(path) as z:
    fields = {k: z[k] for k in z.files}
  model_keys = (set(SIZE_FIELDS) | set(STRUCT_FIELDS) | set(PARAM_FIELDS)
                | set(RENDER_FIELDS)
                | {"opt_" + k for k in OPTION_STATIC + OPTION_PARAMS})
  extra = {k: v for k, v in fields.items()
           if k not in model_keys and not _is_mesh_key(k)}
  return model_from_numpy(fields, device), extra


def make_data(m: Model, batch: int, device=None) -> Data:
  """Fresh batched Data at qpos0, everything else zeroed; every contact
  slot far apart (dist 1e10) with MuJoCo's default contact parameters."""
  dev = m.device if device is None else types.resolve_device(device)
  f32 = torch.float32

  def z(*shape):
    return torch.zeros((batch,) + shape, dtype=f32, device=dev)

  def tile(x, n):
    x = torch.as_tensor(x, dtype=f32, device=dev)
    return x.expand((batch, n) + x.shape).clone()

  eye3 = torch.eye(3)
  unit_quat = torch.tensor([1.0, 0.0, 0.0, 0.0])
  nmocap = max(m.nmocap, 1)
  from benchmark.reference.physics.collision import slot_pairs
  ncon = m.ncon_max
  slots = slot_pairs(m)
  contact = types.Contact(
      dist=torch.full((batch, ncon), 1e10, dtype=f32, device=dev),
      pos=z(ncon, 3), frame=tile(eye3, ncon), includemargin=z(ncon),
      friction=tile([1.0, 1.0, 0.005, 0.0001, 0.0001], ncon),
      solref=tile([0.02, 1.0], ncon),
      solimp=tile([0.9, 0.95, 0.001, 0.5, 2.0], ncon),
      geom1=types.index_tensor(slots[:, 0], dev),
      geom2=types.index_tensor(slots[:, 1], dev),
      dim=types.index_tensor(slots[:, 3], dev))
  return Data(
      time=z(),
      qpos=m.qpos0.to(dev).expand(batch, m.nq).clone(),
      qvel=z(m.nv), act=z(m.na), ctrl=z(m.nu),
      qfrc_applied=z(m.nv), xfrc_applied=z(m.nbody, 6),
      mocap_pos=z(nmocap, 3), mocap_quat=tile(unit_quat, nmocap),
      xpos=z(m.nbody, 3), xquat=tile(unit_quat, m.nbody),
      xmat=tile(eye3, m.nbody), xipos=z(m.nbody, 3),
      ximat=tile(eye3, m.nbody),
      xanchor=z(m.njnt, 3), xaxis=z(m.njnt, 3),
      geom_xpos=z(m.ngeom, 3), geom_xmat=tile(eye3, m.ngeom),
      site_xpos=z(m.nsite, 3), site_xmat=tile(eye3, m.nsite),
      subtree_com=z(m.nbody, 3), cinert=z(m.nbody, 10),
      cdof=z(m.nv, 6), cdof_dot=z(m.nv, 6), cvel=z(m.nbody, 6),
      ten_length=z(m.ntendon), ten_velocity=z(m.ntendon),
      ten_J=z(m.ntendon, m.nv),
      actuator_length=z(m.nu), actuator_velocity=z(m.nu),
      actuator_moment=z(m.nu, m.nv), actuator_force=z(m.nu),
      act_dot=z(m.na),
      qM=z(m.nv, m.nv), qfrc_bias=z(m.nv), qfrc_passive=z(m.nv),
      qfrc_actuator=z(m.nv), qfrc_smooth=z(m.nv), qacc_smooth=z(m.nv),
      qfrc_constraint=z(m.nv), qacc=z(m.nv), qacc_euler=z(m.nv),
      efc_force=z(m.plan["constraint"].nefc),
      contact=contact,
      ncon_active=torch.zeros(batch, dtype=torch.int32, device=dev),
      contact_force=z(ncon), hfield_data=z(m.hfield_nrow, m.hfield_ncol),
  )
