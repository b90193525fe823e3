"""Tendon paths: lengths and moment-arm Jacobians, batched over envs.

Fixed tendons are linear in qpos. Spatial tendons are site-to-site
polylines with pulley branches and sphere/cylinder wrap geoms (wrap.py).
The model's segment plan (built once, on the device) lists every straight
segment and every wrap segment across all tendons; each class is evaluated
as one batched op, and a (ntendon, segments) weight matrix sums segments
into their tendons.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.physics import math
from benchmark.reference.physics import wrap as wrap_mod
from benchmark.reference.physics.types import (Data, Model, WrapType,
                                              index_tensor)


class _Segments(NamedTuple):
  """Straight segments (wrap fields unused) or one wrap group."""
  sa: torch.Tensor          # start site
  sb: torch.Tensor          # end site
  ba: torch.Tensor          # body of sa
  bb: torch.Tensor          # body of sb
  to_tendon: math.FixedRows  # (ntendon, n) weights 1/divisor
  geom: torch.Tensor        # wrap geom
  gb: torch.Tensor          # body of the wrap geom
  side: torch.Tensor        # side site (unused when not sided)
  sphere: bool
  sided: bool


class Plan(NamedTuple):
  fixed_len_w: math.FixedRows  # (ntendon, nq)
  fixed_jac_w: torch.Tensor   # (ntendon, nv)
  straight: Tuple[_Segments, ...]
  wraps: Tuple[_Segments, ...]


def make_plan(m: Model) -> Plan:
  fixed_len_w = np.zeros((m.ntendon, m.nq), dtype=np.float32)
  fixed_jac_w = np.zeros((m.ntendon, m.nv), dtype=np.float32)
  st, wr = [], []
  wrap_prm = m.wrap_prm.detach().cpu().numpy()
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    wtypes = [int(m.wrap_type[adr + k]) for k in range(num)]
    objids = [int(m.wrap_objid[adr + k]) for k in range(num)]

    if all(wt == WrapType.JOINT for wt in wtypes):
      for k in range(num):
        j = objids[k]
        fixed_len_w[t, int(m.jnt_qposadr[j])] += wrap_prm[adr + k]
        fixed_jac_w[t, int(m.jnt_dofadr[j])] += wrap_prm[adr + k]
      continue

    divisor = 1.0
    cur = None
    k = 0
    while k < num:
      wt = wtypes[k]
      if wt == WrapType.PULLEY:
        divisor = float(wrap_prm[adr + k])
        cur = None
        k += 1
      elif wt == WrapType.SITE:
        if cur is not None:
          st.append((cur, objids[k], t, 1.0 / divisor))
        cur = objids[k]
        k += 1
      elif wt in (WrapType.SPHERE, WrapType.CYLINDER):
        if cur is None or k + 1 >= num or wtypes[k + 1] != WrapType.SITE:
          raise ValueError(f"tendon {t}: a wrap geom must join two sites")
        wr.append((cur, objids[k + 1], objids[k],
                   int(m.wrap_sidesite[adr + k]), wt == WrapType.SPHERE, t,
                   1.0 / divisor))
        cur = objids[k + 1]
        k += 2
      else:
        raise NotImplementedError(f"wrap type {wt} in tendon {t}")

  dev = m.device
  idx = lambda x: index_tensor(x, dev)
  site_body = m.site_bodyid

  def segments(rows, sphere=False, sided=False):
    sa = np.array([r[0] for r in rows], dtype=np.int64)
    sb = np.array([r[1] for r in rows], dtype=np.int64)
    w = np.zeros((m.ntendon, len(rows)), dtype=np.float32)
    for n, r in enumerate(rows):
      w[r[-2], n] = r[-1]
    geom = np.array([r[2] for r in rows] if len(rows[0]) == 7 else [],
                    dtype=np.int64)
    side = np.array([r[3] for r in rows] if len(rows[0]) == 7 else [],
                    dtype=np.int64)
    return _Segments(sa=idx(sa), sb=idx(sb), ba=idx(site_body[sa]),
                     bb=idx(site_body[sb]),
                     to_tendon=math.fixed_rows(w, dev),
                     geom=idx(geom), gb=idx(m.geom_bodyid[geom]),
                     side=idx(side), sphere=sphere, sided=sided)

  wraps = []
  for sphere in (True, False):
    for sided in (True, False):
      rows = [r for r in wr if r[4] == sphere and (r[3] >= 0) == sided]
      if rows:
        wraps.append(segments(rows, sphere, sided))
  return Plan(fixed_len_w=math.fixed_rows(fixed_len_w, dev),
              fixed_jac_w=torch.as_tensor(fixed_jac_w, device=dev),
              straight=(segments(st),) if st else (),
              wraps=tuple(wraps))


def _seg_contrib(m: Model, d: Data, pa, pb, ba, bb):
  """Length and dL/dq (B, n, nv) of straight segments pa-pb.

  Contracts each endpoint's point Jacobian with the segment direction
  directly: (cdof_ang x offset) . u = cdof_ang . (offset x u).
  """
  kin = m.plan["kinematics"]
  com_root = d.subtree_com[:, kin.root]
  dif = pb - pa
  length = math.norm_safe(dif)
  u = dif / torch.clamp(length, min=1e-9)[..., None]
  aa = torch.cat([math.cross(pa - com_root[:, ba], u), u], -1)
  ab = torch.cat([math.cross(pb - com_root[:, bb], u), u], -1)
  cdof_t = d.cdof.transpose(-1, -2)
  ta = math.fixed_mm(aa, cdof_t)                      # (B, n, nv)
  tb = math.fixed_mm(ab, cdof_t)
  dj = kin.body_dof_mask[bb] * tb - kin.body_dof_mask[ba] * ta
  return length, dj


def tendon(m: Model, d: Data) -> Data:
  """ten_length and ten_J of every tendon (mj_tendon semantics)."""
  if m.ntendon == 0:
    return d
  plan: Plan = m.plan["tendon"]
  ten_length = math.rows_apply(plan.fixed_len_w, d.qpos, 1)
  ten_J = plan.fixed_jac_w.expand(d.batch, -1, -1)

  for s in plan.straight:
    length, dj = _seg_contrib(m, d, d.site_xpos[:, s.sa], d.site_xpos[:, s.sb],
                              s.ba, s.bb)
    ten_length = ten_length + math.rows_apply(s.to_tendon, length, 1)
    ten_J = ten_J + math.rows_apply(s.to_tendon, dj, 1)

  for s in plan.wraps:
    pa = d.site_xpos[:, s.sa]
    pb = d.site_xpos[:, s.sb]
    side = d.site_xpos[:, s.side] if s.sided else None
    w1, w2, wlen = wrap_mod.wrap(pa, pb, d.geom_xpos[:, s.geom],
                                 d.geom_xmat[:, s.geom],
                                 m.geom_size[..., s.geom, 0], side,
                                 s.sphere)
    l1, j1 = _seg_contrib(m, d, pa, w1, s.ba, s.gb)
    l2, j2 = _seg_contrib(m, d, w2, pb, s.gb, s.bb)
    ls, js = _seg_contrib(m, d, pa, pb, s.ba, s.bb)
    active = wlen >= 0.0
    length = torch.where(active, l1 + wlen + l2, ls)
    dj = torch.where(active[..., None], j1 + j2, js)
    ten_length = ten_length + math.rows_apply(s.to_tendon, length, 1)
    ten_J = ten_J + math.rows_apply(s.to_tendon, dj, 1)

  return d.replace(ten_length=ten_length, ten_J=ten_J.contiguous())


def tendon_velocity(m: Model, d: Data) -> Data:
  if m.ntendon == 0:
    return d
  return d.replace(ten_velocity=math.fixed_mv(d.ten_J, d.qvel))
