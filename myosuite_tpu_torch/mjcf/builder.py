"""Procedural musculoskeletal MJCF model builders (the JAX package's
`assets/builder.py`).

MyoSuite's muscle models live in an external simhive fetched at init time
(MyoSuite's myosuite_init.py:78-101); this framework instead builds
self-contained models procedurally, scaled to the documented anchors
(myoElbow 2 DoF / 6 muscles, myoFinger 4 DoF / 5 muscles, myoHand 23
joints / 39 muscles, myoLeg 20 DoF / 80 muscles).

Muscles are MuJoCo muscle actuators on spatial tendons routed through via
sites placed to give anatomically plausible moment arms; major joints get
cylinder wrap geoms. The builders are plain string generators and need no
MuJoCo. `finalize_muscles` compiles a probe with the host MuJoCo compiler
to sweep the muscles' length ranges (MuJoCo is imported there, inside the
function), and gives the same string as the JAX package's.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

MUSCLE_DEFAULTS = (
    'timeconst="0.01 0.04" range="0.75 1.05" force="-1" scale="200" '
    'lmin="0.5" lmax="1.6" vmax="1.5" fpmax="1.3" fvmax="1.2"')


def _muscle(name: str, tendon: str, force: float = -1,
            scale: float = 200) -> str:
  frc = f'force="{force}"' if force > 0 else f'scale="{scale}"'
  return (f'<muscle name="{name}" tendon="{tendon}" {frc} '
          f'timeconst="0.01 0.04"/>')


def _spatial(name: str, sites: List[str], geoms: Optional[List[Tuple[int, str, str]]] = None) -> str:
  """Spatial tendon through `sites`; geoms = [(after_site_idx, geom, sidesite)]."""
  geoms = geoms or []
  parts = [f'<spatial name="{name}" width="0.002">']
  for i, s in enumerate(sites):
    parts.append(f'  <site site="{s}"/>')
    for idx, g, side in geoms:
      if idx == i:
        sattr = f' sidesite="{side}"' if side else ""
        parts.append(f'  <geom geom="{g}"{sattr}/>')
  parts.append("</spatial>")
  return "\n".join(parts)


# ---------------------------------------------------------------------------
# myoElbow: 1-DoF elbow, 6 muscles (3 flexors through a wrap cylinder,
# 3 extensors) — the reference env myoElbowPose1D6MRandom analog.
# ---------------------------------------------------------------------------


def build_elbow() -> str:
  tendons = []
  muscles = []
  # flexors attach anterior (x>0), extensors posterior (x<0)
  flexor_specs = [("BIClong", 0.028, -0.02, -0.10), ("BICshort", 0.024, -0.04, -0.09),
                  ("BRA", 0.020, -0.12, -0.06)]
  extensor_specs = [("TRIlong", 0.026, -0.02, -0.07), ("TRIlat", 0.023, -0.06, -0.06),
                    ("TRImed", 0.021, -0.10, -0.05)]
  sites = []
  for nm, off, oz, iz in flexor_specs:
    sites.append((f"{nm}_o", "upper_arm", (-off, 0.0, oz)))
    sites.append((f"{nm}_i", "forearm", (-off * 0.9, 0.0, iz)))
    tendons.append(_spatial(f"{nm}_t", [f"{nm}_o", f"{nm}_i"],
                            [(0, "elbow_wrap", "flex_side")]))
    muscles.append(_muscle(nm, f"{nm}_t"))
  for nm, off, oz, iz in extensor_specs:
    sites.append((f"{nm}_o", "upper_arm", (off, 0.0, oz)))
    sites.append((f"{nm}_i", "forearm", (off * 0.9, 0.0, iz)))
    tendons.append(_spatial(f"{nm}_t", [f"{nm}_o", f"{nm}_i"],
                            [(0, "elbow_wrap", "ext_side")]))
    muscles.append(_muscle(nm, f"{nm}_t"))

  def site_xml(body):
    return "\n".join(
        f'<site name="{n}" pos="{p[0]} {p[1]} {p[2]}" size="0.004"/>'
        for n, b, p in sites if b == body)

  return f"""
<mujoco model="mtx_elbow">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  <default>
    <joint limited="true" damping="0.05" armature="0.001"/>
    <geom contype="0" conaffinity="0" friction="1 0.005 0.0001"/>
    <site size="0.004"/>
  </default>
  <worldbody>
    <body name="upper_arm" pos="0 0 1.4">
      <geom name="humerus" type="capsule" fromto="0 0 0 0 0 -0.28" size="0.028" mass="2.0"/>
      {site_xml('upper_arm')}
      <body name="forearm" pos="0 0 -0.28">
        <joint name="r_elbow_flex" type="hinge" axis="0 1 0" range="0 2.27" ref="0"/>
        <geom name="elbow_wrap" type="cylinder" fromto="0 -0.035 0 0 0.035 0" size="0.022"/>
        <site name="flex_side" pos="-0.05 0 -0.02"/>
        <site name="ext_side" pos="0.05 0 0.02"/>
        <geom name="ulna" type="capsule" fromto="0 0 0 0 0 -0.25" size="0.022" mass="1.1"/>
        <site name="wrist" pos="0 0 -0.25" size="0.006"/>
        {site_xml('forearm')}
      </body>
    </body>
  </worldbody>
  <tendon>
    {chr(10).join(tendons)}
  </tendon>
  <actuator>
    {chr(10).join(muscles)}
  </actuator>
</mujoco>
"""


# ---------------------------------------------------------------------------
# myoFinger: 4-DoF finger (MCP abd/flex, PIP, DIP), 5 muscles
# ---------------------------------------------------------------------------


def build_finger() -> str:
  return """
<mujoco model="mtx_finger">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  <default>
    <joint limited="true" damping="0.02" armature="0.0002"/>
    <geom contype="0" conaffinity="0"/>
    <site size="0.003"/>
  </default>
  <worldbody>
    <body name="metacarpal" pos="0 0 1.0">
      <geom type="capsule" fromto="0 0 0 0 0 -0.07" size="0.010" mass="0.05"/>
      <site name="FDP_o" pos="-0.008 0 -0.01"/>
      <site name="FDS_o" pos="-0.010 0 -0.015"/>
      <site name="EDC_o" pos="0.008 0 -0.01"/>
      <site name="IO_r_o" pos="0.004 0.006 -0.03"/>
      <site name="IO_u_o" pos="0.004 -0.006 -0.03"/>
      <body name="proxph" pos="0 0 -0.07">
        <joint name="mcp_abd" type="hinge" axis="1 0 0" range="-0.35 0.35"/>
        <joint name="mcp_flex" type="hinge" axis="0 1 0" range="-0.3 1.57"/>
        <geom name="mcp_wrap" type="cylinder" fromto="0 -0.012 0 0 0.012 0" size="0.0085"/>
        <site name="mcp_flexside" pos="-0.02 0 -0.008"/>
        <site name="mcp_extside" pos="0.02 0 0.008"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.045" size="0.009" mass="0.03"/>
        <site name="FDP_p" pos="-0.007 0 -0.02"/>
        <site name="FDS_i" pos="-0.008 0 -0.035"/>
        <site name="EDC_p" pos="0.007 0 -0.02"/>
        <site name="IO_r_i" pos="0.005 0.005 -0.012"/>
        <site name="IO_u_i" pos="0.005 -0.005 -0.012"/>
        <body name="midph" pos="0 0 -0.045">
          <joint name="pip" type="hinge" axis="0 1 0" range="0 1.92"/>
          <geom name="pip_wrap" type="cylinder" fromto="0 -0.009 0 0 0.009 0" size="0.0065"/>
          <site name="pip_flexside" pos="-0.015 0 -0.006"/>
          <site name="pip_extside" pos="0.015 0 0.006"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.028" size="0.0075" mass="0.015"/>
          <site name="FDP_m" pos="-0.006 0 -0.014"/>
          <site name="EDC_m" pos="0.006 0 -0.014"/>
          <body name="distph" pos="0 0 -0.028">
            <joint name="dip" type="hinge" axis="0 1 0" range="0 1.57"/>
            <geom name="dip_wrap" type="cylinder" fromto="0 -0.007 0 0 0.007 0" size="0.005"/>
            <site name="dip_flexside" pos="-0.012 0 -0.005"/>
            <site name="dip_extside" pos="0.012 0 0.005"/>
            <geom type="capsule" fromto="0 0 0 0 0 -0.02" size="0.006" mass="0.008"/>
            <site name="FDP_i" pos="-0.005 0 -0.016"/>
            <site name="EDC_i" pos="0.005 0 -0.012"/>
            <site name="IFtip" pos="0 0 -0.022" size="0.004"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="FDP_t" width="0.0015">
      <site site="FDP_o"/>
      <geom geom="mcp_wrap" sidesite="mcp_flexside"/>
      <site site="FDP_p"/>
      <geom geom="pip_wrap" sidesite="pip_flexside"/>
      <site site="FDP_m"/>
      <geom geom="dip_wrap" sidesite="dip_flexside"/>
      <site site="FDP_i"/>
    </spatial>
    <spatial name="FDS_t" width="0.0015">
      <site site="FDS_o"/>
      <geom geom="mcp_wrap" sidesite="mcp_flexside"/>
      <site site="FDS_i"/>
    </spatial>
    <spatial name="EDC_t" width="0.0015">
      <site site="EDC_o"/>
      <geom geom="mcp_wrap" sidesite="mcp_extside"/>
      <site site="EDC_p"/>
      <geom geom="pip_wrap" sidesite="pip_extside"/>
      <site site="EDC_m"/>
      <geom geom="dip_wrap" sidesite="dip_extside"/>
      <site site="EDC_i"/>
    </spatial>
    <spatial name="IO_r_t" width="0.0015">
      <site site="IO_r_o"/>
      <site site="IO_r_i"/>
    </spatial>
    <spatial name="IO_u_t" width="0.0015">
      <site site="IO_u_o"/>
      <site site="IO_u_i"/>
    </spatial>
  </tendon>
  <actuator>
    <muscle name="FDP" tendon="FDP_t" scale="200" timeconst="0.01 0.04"/>
    <muscle name="FDS" tendon="FDS_t" scale="200" timeconst="0.01 0.04"/>
    <muscle name="EDC" tendon="EDC_t" scale="200" timeconst="0.01 0.04"/>
    <muscle name="IO_r" tendon="IO_r_t" scale="120" timeconst="0.01 0.04"/>
    <muscle name="IO_u" tendon="IO_u_t" scale="120" timeconst="0.01 0.04"/>
  </actuator>
</mujoco>
"""


def sweep_qpos(qpos0, jnt_qposadr, jnt_range, jnt_limited,
               nsamples: int = 64) -> np.ndarray:
  """(nsamples, nq) float64 joint samples of `finalize_muscles`' sweep:
  sample 0 every joint at its low end, sample 1 at its high end, then
  `RandomState(0).uniform` per joint in joint order. Only qpos[jnt_qposadr]
  is set (a free or ball joint's first coordinate), the rest stays at
  qpos0, and an unlimited joint takes [-1.5, 1.5]."""
  rng = np.random.RandomState(0)
  jlo = np.array(jnt_range[:, 0], dtype=np.float64)
  jhi = np.array(jnt_range[:, 1], dtype=np.float64)
  unlimited = ~np.asarray(jnt_limited).astype(bool)
  jlo[unlimited] = -1.5
  jhi[unlimited] = 1.5
  out = np.tile(np.asarray(qpos0, dtype=np.float64), (nsamples, 1))
  for s in range(nsamples):
    for j, adr in enumerate(jnt_qposadr):
      if s == 0:
        out[s, adr] = jlo[j]
      elif s == 1:
        out[s, adr] = jhi[j]
      else:
        out[s, adr] = rng.uniform(jlo[j], jhi[j])
  return out


def pad_lengthrange(lo: np.ndarray, hi: np.ndarray):
  """The swept (lo, hi) padded by 5% of the span (at least 1e-4), so the
  operating range sits inside."""
  pad = 0.05 * np.maximum(hi - lo, 1e-4)
  return lo - pad, hi + pad


def finalize_muscles(xml: str, nsamples: int = 64) -> str:
  """Two-pass build: sweep joint space to compute muscle lengthranges.

  MuJoCo's built-in simulation-based lengthrange solver can fail on wrapped
  paths; a direct kinematic sweep over the joint box is exact for
  tendon-transmitted muscles and deterministic. The probe is `xml` with
  every muscle a motor; its actuator lengths over `sweep_qpos`' samples,
  padded, are written into each muscle as `lengthrange` ("%.6f").
  Needs MuJoCo (imported here); without it, raises an ImportError that
  names MuJoCo.
  """
  from myosuite_tpu_torch.physics.io import import_mujoco
  mujoco = import_mujoco()

  probe_xml = xml.replace("<muscle ", "<motor ctrlrange='0 1' ")
  # strip muscle-only attributes from the probe motors
  def _clean(match):
    tag = match.group(0)
    for attr in ("timeconst", "range", "force", "scale", "lmin", "lmax",
                 "vmax", "fpmax", "fvmax"):
      tag = re.sub(rf'\s{attr}="[^"]*"', "", tag)
    return tag
  probe_xml = re.sub(r"<motor [^>]*>", _clean, probe_xml)

  pm = mujoco.MjModel.from_xml_string(probe_xml)
  pd = mujoco.MjData(pm)
  lo = np.full(pm.nu, np.inf)
  hi = np.full(pm.nu, -np.inf)
  for q in sweep_qpos(pm.qpos0, pm.jnt_qposadr, pm.jnt_range,
                      pm.jnt_limited, nsamples):
    pd.qpos[:] = q
    mujoco.mj_kinematics(pm, pd)
    mujoco.mj_comPos(pm, pd)
    mujoco.mj_tendon(pm, pd)
    mujoco.mj_transmission(pm, pd)
    lo = np.minimum(lo, pd.actuator_length)
    hi = np.maximum(hi, pd.actuator_length)
  lo, hi = pad_lengthrange(lo, hi)

  # inject explicit lengthranges in actuator order
  idx = [0]
  def _inject(match):
    tag = match.group(0)
    i = idx[0]
    idx[0] += 1
    return tag[:-2] + f' lengthrange="{lo[i]:.6f} {hi[i]:.6f}"/>'
  out = re.sub(r"<muscle [^>]*/>", _inject, xml)
  # non-muscle actuators (e.g. OSL prosthetic motors) must come after all
  # muscles so the sequential lengthrange injection stays index-aligned
  n_muscle = len(re.findall(r"<muscle [^>]*/>", xml))
  assert idx[0] == n_muscle <= pm.nu, (idx[0], n_muscle, pm.nu)
  return out


BUILDERS = {
    "elbow": lambda: finalize_muscles(build_elbow()),
    "finger": lambda: finalize_muscles(build_finger()),
}
