"""Procedural myoLeg-scale model: 20 DoF, 80 muscles, bilateral legs (the
JAX package's `assets/leg.py`).

Scale anchor from the reference docs: myoLeg 20 DoF / 80 muscles
(MyoSuite's docs/source/suite.rst:128). Layout: free-floating pelvis
root (6 DoF) + per leg hip(3) + knee(1) + ankle(2) + mtp(1) = 7 -> 20 DoF.
40 muscles per leg from the standard lower-limb muscle groups, routed as
spatial tendons with cylinder wraps at hip/knee/ankle; biarticular muscles
(RF, hamstrings, gastrocnemius) span two wraps.

Foot geoms are contact-enabled capsules/spheres for plane ground contact;
walking scenes add a floor plane.
"""

from __future__ import annotations

from typing import List

# (name, origin(body, pos), insertion(body, pos), wraps=[(geom, side)])
# positions are body-local; x forward, y left, z up; legs hang in -z.
# "P"=pelvis, "F"=femur, "T"=tibia, "C"=calcaneus(foot), "O"=toes


def _leg_muscles(s: str) -> List[dict]:
  """40 muscles for one leg; s is 'r' or 'l' (y mirrored).

  Peak isometric forces (the `force` field, Newtons) are anatomical
  anchors taken mid-range from the published models the reference's
  myoLeg anatomy derives from (OpenSim gait2392 [Delp 1990] and
  Rajagopal et al. 2016) — verified against those anchors by
  tools/fidelity_report.py -> docs/fidelity.md."""
  m = []

  def add(name, org, ins, wraps=(), scale=400, via=None, force=0):
    m.append(dict(name=name, org=org, ins=ins, wraps=list(wraps),
                  scale=scale, via=via, force=force))

  hipw_f, hipw_b = (f"{s}_hip_wrap", f"{s}_hipflex_side"), (f"{s}_hip_wrap", f"{s}_hipext_side")
  kneew_f, kneew_b = (f"{s}_knee_wrap", f"{s}_kneeflex_side"), (f"{s}_knee_wrap", f"{s}_kneeext_side")
  ankw_d, ankw_p = (f"{s}_ankle_wrap", f"{s}_dorsi_side"), (f"{s}_ankle_wrap", f"{s}_plantar_side")

  # --- hip extensors (5) ---
  add("GMAX1", ("P", (-0.07, 0.04, 0.02)), ("F", (-0.02, 0.01, -0.06)), [hipw_b], force=550)
  add("GMAX2", ("P", (-0.08, 0.03, -0.01)), ("F", (-0.02, 0.0, -0.10)), [hipw_b], force=700)
  add("GMAX3", ("P", (-0.08, 0.02, -0.04)), ("F", (-0.015, 0.0, -0.14)), [hipw_b], force=550)
  add("SEMIMEM", ("P", (-0.06, 0.02, -0.05)), ("T", (-0.02, 0.015, -0.03)), [hipw_b, kneew_f], via=("F", (-0.02, 0.012, -0.25)), force=1580)
  add("SEMITEN", ("P", (-0.06, 0.025, -0.055)), ("T", (-0.02, 0.02, -0.05)), [hipw_b, kneew_f], via=("F", (-0.02, 0.018, -0.26)), force=430)
  # --- hip flexors (5) ---
  add("PSOAS", ("P", (0.04, 0.02, 0.06)), ("F", (0.01, 0.01, -0.05)), [hipw_f], force=1200)
  add("ILIACUS", ("P", (0.045, 0.03, 0.03)), ("F", (0.012, 0.012, -0.045)), [hipw_f], force=900)
  add("RF", ("P", (0.05, 0.02, 0.0)), ("T", (0.035, 0.0, -0.02)), [hipw_f, kneew_b], via=("F", (0.028, 0.0, -0.22)), force=1170)
  add("SAR", ("P", (0.05, 0.05, 0.0)), ("T", (0.01, 0.02, -0.04)), [hipw_f], force=160)
  add("TFL", ("P", (0.04, 0.06, 0.0)), ("T", (0.015, -0.03, -0.02)), [hipw_f], force=230)
  # --- hip adductors (6) ---
  add("ADDLONG", ("P", (0.03, 0.01, -0.05)), ("F", (0.0, 0.01, -0.18)), force=430)
  add("ADDBREV", ("P", (0.025, 0.01, -0.045)), ("F", (0.0, 0.012, -0.12)), force=380)
  add("ADDMAG1", ("P", (-0.02, 0.01, -0.06)), ("F", (0.0, 0.012, -0.14)), force=550)
  add("ADDMAG2", ("P", (-0.025, 0.012, -0.065)), ("F", (0.0, 0.01, -0.22)), force=550)
  add("ADDMAG3", ("P", (-0.03, 0.014, -0.07)), ("F", (0.0, 0.008, -0.30)), force=550)
  add("GRA", ("P", (0.02, 0.008, -0.06)), ("T", (-0.005, 0.02, -0.05)), [kneew_f], force=140)
  # --- hip abductors / rotators (6) ---
  add("GMED1", ("P", (0.02, 0.07, 0.03)), ("F", (0.0, -0.03, -0.04)), force=820)
  add("GMED2", ("P", (0.0, 0.075, 0.035)), ("F", (0.0, -0.03, -0.045)), force=570)
  add("GMED3", ("P", (-0.02, 0.07, 0.03)), ("F", (-0.005, -0.03, -0.045)), force=650)
  add("GMIN", ("P", (0.0, 0.065, 0.015)), ("F", (0.005, -0.028, -0.04)), force=500)
  add("PIRI", ("P", (-0.05, 0.03, 0.0)), ("F", (-0.01, -0.02, -0.03)), force=440)
  add("QUADFEM", ("P", (-0.045, 0.02, -0.05)), ("F", (-0.015, -0.015, -0.05)), force=250)
  # --- knee extensors (3, + RF above) ---
  add("VASLAT", ("F", (0.015, -0.02, -0.12)), ("T", (0.035, -0.01, -0.02)), [kneew_b], force=1870)
  add("VASMED", ("F", (0.012, 0.02, -0.14)), ("T", (0.035, 0.01, -0.02)), [kneew_b], force=1290)
  add("VASINT", ("F", (0.015, 0.0, -0.12)), ("T", (0.036, 0.0, -0.02)), [kneew_b], force=1240)
  # --- knee flexors (3, + hams above) ---
  add("BFLH", ("P", (-0.055, 0.03, -0.05)), ("T", (-0.02, -0.025, -0.04)), [hipw_b, kneew_f], via=("F", (-0.02, -0.015, -0.25)), force=900)
  add("BFSH", ("F", (-0.01, -0.01, -0.25)), ("T", (-0.022, -0.025, -0.045)), [kneew_f], force=400)
  add("POP", ("F", (-0.01, 0.01, -0.36)), ("T", (-0.015, 0.01, -0.03)), [kneew_f], force=75)
  # --- plantarflexors (6) ---
  add("GASMED", ("F", (-0.015, 0.012, -0.36)), ("C", (-0.045, 0.005, 0.0)), [kneew_f, ankw_p], via=("T", (-0.025, 0.008, -0.10)), force=1600)
  add("GASLAT", ("F", (-0.015, -0.012, -0.36)), ("C", (-0.045, -0.005, 0.0)), [kneew_f, ankw_p], via=("T", (-0.025, -0.008, -0.10)), force=700)
  add("SOL", ("T", (-0.012, 0.0, -0.10)), ("C", (-0.045, 0.0, 0.005)), [ankw_p], force=3550)
  add("TP", ("T", (-0.01, 0.005, -0.15)), ("C", (0.01, 0.02, -0.005)), [ankw_p], force=1230)
  add("FDL", ("T", (-0.008, 0.01, -0.18)), ("O", (0.02, 0.005, -0.002)), [ankw_p], force=310)
  add("FHL", ("T", (-0.008, -0.005, -0.20)), ("O", (0.022, -0.008, -0.002)), [ankw_p], force=320)
  # --- dorsiflexors / everters (5) ---
  add("TA", ("T", (0.012, 0.005, -0.12)), ("C", (0.04, 0.015, 0.005)), [ankw_d], force=900)
  # EDL/EHL route through a retinaculum via point on the foot dorsum:
  # without it the chord to the toes bowstrings at plantarflexion and
  # the dorsiflexion moment arm balloons to 14 cm (anchor: 2-4 cm)
  add("EDL", ("T", (0.012, -0.005, -0.14)), ("O", (0.025, 0.01, 0.004)), [ankw_d], force=340, via=("C", (0.035, 0.01, 0.0)))
  add("EHL", ("T", (0.012, 0.0, -0.16)), ("O", (0.027, -0.005, 0.004)), [ankw_d], force=110, via=("C", (0.035, -0.005, 0.0)))
  add("PERLONG", ("T", (-0.005, -0.015, -0.12)), ("C", (0.005, -0.02, -0.005)), [ankw_p], force=940)
  add("PERBREV", ("T", (-0.005, -0.016, -0.16)), ("C", (0.0, -0.022, 0.0)), [ankw_p], force=350)
  # --- toe (1) ---
  add("FDB", ("C", (-0.02, 0.0, -0.01)), ("O", (0.018, 0.0, -0.004)), force=200)

  assert len(m) == 40, len(m)
  return m


_BODY_TAG = {"P": "pelvis", "F": "{s}_femur", "T": "{s}_tibia",
             "C": "{s}_foot", "O": "{s}_toes"}


def build_leg(floor: bool = True, pelvis_free: bool = True,
              terrain: bool = False,
              terrain_nrow: int = 48, terrain_ncol: int = 192,
              terrain_extent=(12.0, 3.0),
              terrain_center=None,
              osl: bool = False,
              extra_worldbody: str = "",
              extra_actuator: str = "") -> str:
  """When terrain=True the floor plane is replaced by a heightfield geom
  (the role of the reference's in-place hfield regeneration per reset,
  MyoSuite's myosuite/envs/myo/myobase/walk_v0.py:576-647); the height
  grid itself is dynamic Data, written by the terrain env at reset.

  osl=True builds the transfemoral-amputee variant for the OSL RunTrack
  task (reference myoosl model, run_track_v0.py:31): the right leg keeps
  only its 16 hip muscles (insertion on the femur), and torque motors on
  the prosthetic knee/ankle replace the rest — driven by the OSL FSM, not
  the policy. extra_worldbody/extra_actuator inject scene bodies (balls,
  goals, mocap opponents) for the challenge scenes."""
  sites = {"pelvis": [], "r_femur": [], "r_tibia": [], "r_foot": [],
           "r_toes": [], "l_femur": [], "l_tibia": [], "l_foot": [],
           "l_toes": []}
  tendons, muscles = [], []

  for s, ysign in (("r", -1.0), ("l", 1.0)):
    for mus in _leg_muscles(s):
      if osl and s == "r" and mus["ins"][0] != "F":
        continue  # amputated side keeps only hip muscles
      name = f"{s}_{mus['name']}"
      org_body = _BODY_TAG[mus["org"][0]].format(s=s)
      ins_body = _BODY_TAG[mus["ins"][0]].format(s=s)
      ox, oy, oz = mus["org"][1]
      ix, iy, iz = mus["ins"][1]
      oy, iy = oy * ysign, iy * ysign
      sites[org_body].append(
          f'<site name="{name}_o" pos="{ox} {oy} {oz}"/>')
      sites[ins_body].append(
          f'<site name="{name}_i" pos="{ix} {iy} {iz}"/>')
      if mus["via"] is not None:
        via_body = _BODY_TAG[mus["via"][0]].format(s=s)
        vx, vy, vz = mus["via"][1]
        sites[via_body].append(
            f'<site name="{name}_v" pos="{vx} {vy * ysign} {vz}"/>')
        wraps = mus["wraps"]
        if len(wraps) == 2:     # biarticular: wrap, via, wrap
          w1, w2 = wraps
          chain = (f'\n  <geom geom="{w1[0]}" sidesite="{w1[1]}"/>'
                   f'\n  <site site="{name}_v"/>'
                   f'\n  <geom geom="{w2[0]}" sidesite="{w2[1]}"/>')
        else:                   # single wrap + retinaculum-style via
          (w1,) = wraps
          chain = (f'\n  <geom geom="{w1[0]}" sidesite="{w1[1]}"/>'
                   f'\n  <site site="{name}_v"/>')
      else:
        chain = "".join(
            f'\n  <geom geom="{g}" sidesite="{side}"/>'
            for g, side in mus["wraps"])
      tendons.append(
          f'<spatial name="{name}_t" width="0.003">\n'
          f'  <site site="{name}_o"/>{chain}\n'
          f'  <site site="{name}_i"/>\n</spatial>')
      frc = (f'force="{mus["force"]}"' if mus.get("force")
             else f'scale="{mus["scale"]}"')
      muscles.append(
          f'<muscle name="{name}" tendon="{name}_t" {frc}'
          f' timeconst="0.01 0.04"/>')

  def leg_xml(s: str, ysign: float) -> str:
    y = 0.09 * ysign
    # hip wrap sidesites live in the PELVIS frame (same side-flip
    # rationale as the knee sidesites below: anterior/posterior of the
    # hip must not rotate with the femur at full flexion)
    sites["pelvis"].append(
        f'<site name="{s}_hipflex_side" pos="0.08 {y} -0.10"/>'
        f'<site name="{s}_hipext_side" pos="-0.08 {y} -0.10"/>')
    return f"""
<body name="{s}_femur" pos="0 {y} -0.07">
  <joint name="{s}_hip_flexion" type="hinge" axis="0 1 0" range="-0.7 2.0"/>
  <joint name="{s}_hip_adduction" type="hinge" axis="1 0 0" range="-0.7 0.5"/>
  <joint name="{s}_hip_rotation" type="hinge" axis="0 0 1" range="-0.7 0.7"/>
  <geom name="{s}_hip_wrap" type="cylinder" fromto="0 {-0.03*ysign:.3f} 0 0 {0.03*ysign:.3f} 0" size="0.035"/>
  <geom name="{s}_femur_geom" type="capsule" fromto="0 0 0 0 0 -0.40" size="0.035" mass="7.5"/>
  <!-- the posterior (flexor-side) knee sidesite lives in the FEMUR
       frame: fixed in the tibia it rotates with deep flexion and flips
       the wrap solution (observed: 9 cm tendon-length jump at knee
       < -1.3 rad). The anterior (extensor) sidesite tracks the tibia
       like a patella and stays well-posed across the range. -->
  <site name="{s}_kneeflex_side" pos="-0.07 0 -0.42"/>
  {''.join(sites[f"{s}_femur"])}
  <body name="{s}_tibia" pos="0 0 -0.40">
    <joint name="{s}_knee" type="hinge" axis="0 1 0" range="-2.1 0.02"/>
    <geom name="{s}_knee_wrap" type="cylinder" fromto="0 {-0.03*ysign:.3f} 0 0 {0.03*ysign:.3f} 0" size="0.03"/>
    <site name="{s}_kneeext_side" pos="0.07 0 -0.02"/>
    <geom name="{s}_tibia_geom" type="capsule" fromto="0 0 0 0 0 -0.40" size="0.028" mass="3.5"/>
    {''.join(sites[f"{s}_tibia"])}
    <body name="{s}_foot" pos="0 0 -0.40">
      <joint name="{s}_ankle" type="hinge" axis="0 1 0" range="-0.9 0.6"/>
      <joint name="{s}_subtalar" type="hinge" axis="1 0 0" range="-0.35 0.35"/>
      <geom name="{s}_ankle_wrap" type="cylinder" fromto="0 {-0.025*ysign:.3f} 0 0 {0.025*ysign:.3f} 0" size="0.025"/>
      <site name="{s}_dorsi_side" pos="0.05 0 0.01"/>
      <site name="{s}_plantar_side" pos="-0.05 0 -0.01"/>
      <geom name="{s}_heel_geom" type="sphere" pos="-0.04 0 -0.035" size="0.028" mass="0.6"
            contype="1" conaffinity="4" friction="1.2 0.005 0.0001" condim="3"/>
      <geom name="{s}_foot_geom" type="capsule" fromto="-0.03 0 -0.045 0.09 0 -0.045" size="0.018" mass="0.4"
            contype="1" conaffinity="4" friction="1.2 0.005 0.0001" condim="3"/>
      <site name="{s}_foot_site" pos="0.02 0 -0.05"/>
      {''.join(sites[f"{s}_foot"])}
      <body name="{s}_toes" pos="0.11 0 -0.045">
        <joint name="{s}_mtp" type="hinge" axis="0 1 0" range="-0.6 0.6"/>
        <geom name="{s}_toes_geom" type="capsule" fromto="0 0 0 0.05 0 -0.004" size="0.014" mass="0.15"
              contype="1" conaffinity="4" friction="1.2 0.005 0.0001" condim="3"/>
        {''.join(sites[f"{s}_toes"])}
      </body>
    </body>
  </body>
</body>
"""

  if osl:
    muscles.append('<motor name="osl_knee" joint="r_knee" gear="1" '
                   'ctrlrange="-150 150"/>')
    muscles.append('<motor name="osl_ankle" joint="r_ankle" gear="1" '
                   'ctrlrange="-150 150"/>')

  root_joint = '<freejoint name="root"/>' if pelvis_free else ""
  if terrain:
    ex, ey = terrain_extent
    asset_xml = (f'<asset><hfield name="terrain" nrow="{terrain_nrow}" '
                 f'ncol="{terrain_ncol}" size="{ex} {ey} 1.0 0.1"/></asset>')
    # default: track extends forward, x spans [-2, 2*ex - 2]; a custom
    # terrain_center recenters it (square chase-tag arenas)
    cx, cy = ((ex - 2.0, 0.0) if terrain_center is None else terrain_center)
    floor_xml = (f'<geom name="terrain" type="hfield" hfield="terrain" '
                 f'pos="{cx} {cy} 0" contype="4" conaffinity="1" '
                 f'friction="1.2 0.005 0.0001" condim="3"/>')
  else:
    asset_xml = ""
    floor_xml = ('<geom name="floor" type="plane" size="50 50 0.1" '
                 'contype="4" conaffinity="1" friction="1.2 0.005 0.0001" '
                 'condim="3"/>') if floor else ""

  # generate leg subtrees FIRST: leg_xml appends hip sidesites to
  # sites["pelvis"], which the template below joins
  r_leg_xml = leg_xml('r', -1.0)
  l_leg_xml = leg_xml('l', 1.0)

  return f"""
<mujoco model="mtx_leg">
  <compiler angle="radian" autolimits="true">
    <lengthrange mode="none"/>
  </compiler>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  {asset_xml}
  <default>
    <joint limited="true" damping="0.5" armature="0.01"/>
    <geom contype="0" conaffinity="0"/>
    <site size="0.005"/>
  </default>
  <worldbody>
    {floor_xml}
    <!-- z = 0.932 rests the foot soles exactly on the floor
         (hip chain -0.87, foot bottom -0.063): no reset
         drop-impact kick -->
    <body name="pelvis" pos="0 0 0.932">
      {root_joint}
      <!-- pelvis mass lumps the head-arms-trunk segment (the reference
           myoLeg carries a full torso above the pelvis): ~75 kg total
           body mass at anatomical segment proportions -->
      <geom name="pelvis_geom" type="box" size="0.10 0.14 0.07" mass="50.0"/>
      <site name="pelvis_site" pos="0 0 0"/>
      <site name="torso_site" pos="0 0 0.07"/>
      {''.join(sites["pelvis"])}
      {r_leg_xml}
      {l_leg_xml}
    </body>
    {extra_worldbody}
  </worldbody>
  <tendon>
    {chr(10).join(tendons)}
  </tendon>
  <actuator>
    {chr(10).join(muscles)}
    {extra_actuator}
  </actuator>
</mujoco>
"""
