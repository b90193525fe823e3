"""Procedural myoTorso-scale model: 18 joints, 210 muscle fascicles (the
JAX package's `assets/torso.py`).

Scale anchor from the reference docs: myoTorso 18 joints / 210 actuators
(MyoSuite's docs/source/suite.rst:207) — a lumbar-spine model where
the actuator count comes from many short muscle fascicles per group
(multifidus, erector spinae, psoas, quadratus lumborum, abdominals).

Layout: fixed pelvis base -> L5..L1 -> thorax, each vertebral joint with
flexion (y), lateral bending (x) and axial twist (z) hinges = 6x3 = 18
joints. Muscles are straight-line spatial tendons between per-fascicle
origin/insertion sites (105 fascicles per side).
"""

from __future__ import annotations

from typing import List, Tuple

# chain of bodies from the base upwards; index into this list below
CHAIN = ["pelvis", "l5", "l4", "l3", "l2", "l1", "thorax"]
SEG_H = 0.04     # vertebral segment height
SEG_R = 0.038    # vertebral "disc" radius


def _fascicles() -> List[Tuple[str, int, int, Tuple[float, float, float],
                               Tuple[float, float, float], float]]:
  """(group, lower_idx, upper_idx, lower offset, upper offset, scale)
  for ONE side; offsets are body-local (x fwd, y left, z up). 105 total."""
  f = []

  def add(group, lo, hi, off_lo, off_hi, scale=150):
    f.append((group, lo, hi, off_lo, off_hi, scale))

  # multifidus: span-2 pairs, 3 fascicles each (posterior, near midline)
  for lo in range(5):
    for k, dy in enumerate((0.008, 0.014, 0.020)):
      add("MF", lo, lo + 2, (-0.045, dy, 0.0), (-0.04, dy * 0.7, 0.0), 120)
  # rotatores: every adjacent pair, 2 fascicles
  for lo in range(6):
    for dy in (0.01, 0.018):
      add("ROT", lo, lo + 1, (-0.04, dy, 0.0), (-0.035, dy * 0.5, 0.0), 80)
  # longissimus: pelvis to L3..thorax, 3 fascicles each
  for hi, n in ((3, 3), (4, 3), (5, 3), (6, 3)):
    for k in range(n):
      dy = 0.025 + 0.004 * k
      add("LTpL", 0, hi, (-0.05, dy, 0.01), (-0.03, dy * 0.8, 0.0), 200)
  # iliocostalis: pelvis to L2..thorax, 3 each
  for hi in (4, 5, 6):
    for k in range(3):
      dy = 0.04 + 0.004 * k
      add("ILpL", 0, hi, (-0.045, dy, 0.01), (-0.025, dy * 0.85, 0.0), 180)
  # spinalis: L5/L4/L3 to thorax, 2 each
  for lo in (1, 2, 3):
    for dy in (0.006, 0.012):
      add("SP", lo, 6, (-0.042, dy, 0.0), (-0.038, dy, 0.0), 100)
  # psoas fascicles: pelvis (anterior) to each lumbar vertebra, 2 each
  for hi in (1, 2, 3, 4, 5):
    for dy in (0.02, 0.03):
      add("PS", 0, hi, (0.04, dy, -0.01), (0.025, dy * 0.8, 0.0), 150)
  # quadratus lumborum: pelvis lateral to L3..thorax, 2 each
  for hi in (3, 4, 5, 6):
    for dy in (0.05, 0.058):
      add("QL", 0, hi, (-0.01, dy, 0.01), (-0.005, dy * 0.75, 0.0), 150)
  # rectus abdominis: pelvis to thorax, anterior, 3 fascicles
  for dy in (0.012, 0.02, 0.028):
    add("RA", 0, 6, (0.06, dy, 0.0), (0.055, dy, -0.02), 250)
  # external oblique: pelvis lateral -> thorax anterior (crossing), 6
  for k in range(6):
    dy = 0.035 + 0.004 * k
    add("EO", 0, 6, (0.02, dy, 0.0), (0.045, dy - 0.02, -0.03), 180)
  # internal oblique: pelvis anterior -> thorax lateral (crossing), 6
  for k in range(6):
    dy = 0.03 + 0.004 * k
    add("IO", 0, 6, (0.045, dy - 0.015, 0.0), (0.02, dy + 0.01, -0.03), 180)
  # interspinales: adjacent posterior midline, 1 each
  for lo in range(6):
    add("ISP", lo, lo + 1, (-0.05, 0.003, 0.0), (-0.05, 0.003, 0.0), 50)
  # intertransversarii: adjacent lateral, 2 each
  for lo in range(6):
    for dy in (0.045, 0.052):
      add("ITR", lo, lo + 1, (-0.005, dy, 0.0), (-0.005, dy * 0.9, 0.0), 50)

  assert len(f) == 105, len(f)
  return f


def build_torso() -> str:
  sites = {b: [] for b in CHAIN}
  tendons, muscles = [], []

  for side, ysign in (("r", -1.0), ("l", 1.0)):
    for i, (grp, lo, hi, off_lo, off_hi, scale) in enumerate(_fascicles()):
      name = f"{side}_{grp}_{lo}{hi}_{i}"
      blo, bhi = CHAIN[lo], CHAIN[hi]
      ox, oy, oz = off_lo
      ix, iy, iz = off_hi
      # origins sit at the top of the lower body, insertions at the bottom
      # of the upper body (z offsets relative to each body's frame)
      oz = oz + (0.06 if blo == "pelvis" else SEG_H * 0.5)
      iz = iz - (0.05 if bhi == "thorax" else SEG_H * 0.5)
      sites[blo].append(
          f'<site name="{name}_o" pos="{ox} {oy * ysign:.4f} {oz:.4f}"/>')
      sites[bhi].append(
          f'<site name="{name}_i" pos="{ix} {iy * ysign:.4f} {iz:.4f}"/>')
      tendons.append(
          f'<spatial name="{name}_t" width="0.002">\n'
          f'  <site site="{name}_o"/>\n  <site site="{name}_i"/>\n'
          f'</spatial>')
      muscles.append(
          f'<muscle name="{name}" tendon="{name}_t" scale="{scale}"'
          f' timeconst="0.01 0.04"/>')

  # nested vertebral chain L5 -> thorax
  def vert(idx: int) -> str:
    body = CHAIN[idx]
    if idx == 6:   # thorax
      geom = ('<geom name="thorax_geom" type="box" pos="0 0 0.12" '
              'size="0.09 0.13 0.14" mass="18.0"/>'
              '<site name="torso_top" pos="0 0 0.26"/>')
      inner = ""
    else:
      geom = (f'<geom name="{body}_geom" type="cylinder" '
              f'fromto="0 0 0 0 0 {SEG_H * 0.8:.3f}" size="{SEG_R}" '
              f'mass="1.2"/>')
      inner = vert(idx + 1)
    rng_f, rng_b, rng_t = (-0.25, 0.12), (-0.12, 0.12), (-0.10, 0.10)
    return f"""
<body name="{body}" pos="0 0 {SEG_H if idx > 1 else 0.07}">
  <joint name="flex_{body}" type="hinge" axis="0 1 0" range="{rng_f[0]} {rng_f[1]}"/>
  <joint name="bend_{body}" type="hinge" axis="1 0 0" range="{rng_b[0]} {rng_b[1]}"/>
  <joint name="twist_{body}" type="hinge" axis="0 0 1" range="{rng_t[0]} {rng_t[1]}"/>
  {geom}
  {''.join(sites[body])}
  {inner}
</body>
"""

  return f"""
<mujoco model="mtx_torso">
  <compiler angle="radian" autolimits="true">
    <lengthrange mode="none"/>
  </compiler>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  <default>
    <joint limited="true" damping="2.0" armature="0.01"/>
    <geom contype="0" conaffinity="0"/>
    <site size="0.003"/>
  </default>
  <worldbody>
    <body name="pelvis" pos="0 0 1.0">
      <geom name="pelvis_geom" type="box" size="0.10 0.14 0.06" mass="11.0"/>
      {''.join(sites['pelvis'])}
      {vert(1)}
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
