"""Procedural myoHand-scale model: 23 joints, 39 muscles, 5 digits (the
JAX package's `assets/hand.py`).

Matches the reference's documented myoHand scale anchor (23 joints / 39
muscles, MyoSuite's docs/source/suite.rst:88) with the standard digit
layout: wrist flex+deviation, thumb CMC(2)+MCP(2)+IP, four fingers
MCP(2)+PIP+DIP. Muscles: 6 wrist (FCR FCU PL ECRL ECRB ECU), 7 thumb
(FPL EPL EPB APL ADPt ADPo OPP), per-finger FDP FDS EDC LUM RI UI with EIP
on the index and EDM on the little finger.

Tendons route through cylinder wrap geoms at every joint with flex/ext
sidesites; fingertip sites are named THtip/IFtip/MFtip/RFtip/LFtip as in
the reference's hand reach task.

`build_hand(obj=...)` places one of OBJECT_SNIPPETS (with its
OBJECT_ASSETS entry) over the palm; a scene of its own (the MyoDM objects,
`envs/myodm.py::scene_xml`) passes its snippet and asset as arguments
instead of adding them to these tables, which stay as they are.
"""

from __future__ import annotations

from typing import Optional

# digit: (prefix, y offset, segment lengths (prox, mid, dist), radius scale)
FINGERS = [
    ("IF", 0.026, (0.045, 0.028, 0.020), 1.00),   # index
    ("MF", 0.009, (0.050, 0.032, 0.022), 1.05),   # middle
    ("RF", -0.009, (0.046, 0.030, 0.021), 1.00),  # ring
    ("LF", -0.027, (0.036, 0.024, 0.018), 0.85),  # little
]


def _digit_xml(prefix: str, y: float, lens, rscale: float,
               abd: bool = True) -> str:
  lp, lm, ld = lens
  r = 0.009 * rscale
  rm = 0.0075 * rscale
  rd = 0.006 * rscale
  abd_jnt = (f'<joint name="{prefix}_mcp_abd" type="hinge" axis="1 0 0" '
             'range="-0.35 0.35"/>') if abd else ""
  s = f"""
<body name="{prefix}_prox" pos="0 {y} -0.085">
  {abd_jnt}
  <joint name="{prefix}_mcp_flex" type="hinge" axis="0 1 0" range="-0.3 1.57"/>
  <geom name="{prefix}_mcp_wrap" type="cylinder" fromto="0 -0.012 0 0 0.012 0" size="0.0085"/>
  <site name="{prefix}_mcp_flexside" pos="-0.02 0 -0.008"/>
  <site name="{prefix}_mcp_extside" pos="0.02 0 0.008"/>
  <geom name="{prefix}_prox_geom" type="capsule" fromto="0 0 0 0 0 -{lp}" size="{r}" mass="0.03" contype="1" conaffinity="2"/>
  <site name="{prefix}_FDP_p" pos="-0.007 0 -{lp*0.45:.4f}"/>
  <site name="{prefix}_FDS_p" pos="-0.008 0 -{lp*0.8:.4f}"/>
  <site name="{prefix}_EDC_p" pos="0.007 0 -{lp*0.45:.4f}"/>
  <site name="{prefix}_LUM_i" pos="-0.006 0.003 -{lp*0.3:.4f}"/>
  <site name="{prefix}_RI_i" pos="0.002 0.005 -{lp*0.25:.4f}"/>
  <site name="{prefix}_UI_i" pos="0.002 -0.005 -{lp*0.25:.4f}"/>
  <body name="{prefix}_mid" pos="0 0 -{lp}">
    <joint name="{prefix}_pip" type="hinge" axis="0 1 0" range="0 1.92"/>
    <geom name="{prefix}_pip_wrap" type="cylinder" fromto="0 -0.009 0 0 0.009 0" size="0.0065"/>
    <site name="{prefix}_pip_flexside" pos="-0.015 0 -0.006"/>
    <site name="{prefix}_pip_extside" pos="0.015 0 0.006"/>
    <geom name="{prefix}_mid_geom" type="capsule" fromto="0 0 0 0 0 -{lm}" size="{rm}" mass="0.015" contype="1" conaffinity="2"/>
    <site name="{prefix}_FDP_m" pos="-0.006 0 -{lm*0.5:.4f}"/>
    <!-- FDS inserts on the middle phalanx (crosses MCP + PIP), per its
         anatomical path (An et al. 1983) -->
    <site name="{prefix}_FDS_i" pos="-0.006 0 -{lm*0.35:.4f}"/>
    <site name="{prefix}_EDC_m" pos="0.006 0 -{lm*0.5:.4f}"/>
    <body name="{prefix}_dist" pos="0 0 -{lm}">
      <joint name="{prefix}_dip" type="hinge" axis="0 1 0" range="0 1.57"/>
      <geom name="{prefix}_dip_wrap" type="cylinder" fromto="0 -0.007 0 0 0.007 0" size="0.005"/>
      <site name="{prefix}_dip_flexside" pos="-0.012 0 -0.005"/>
      <site name="{prefix}_dip_extside" pos="0.012 0 0.005"/>
      <geom name="{prefix}_tip_geom" type="capsule" fromto="0 0 0 0 0 -{ld}" size="{rd}" mass="0.008" contype="1" conaffinity="2"/>
      <site name="{prefix}_FDP_i" pos="-0.005 0 -{ld*0.8:.4f}"/>
      <site name="{prefix}_EDC_i" pos="0.005 0 -{ld*0.6:.4f}"/>
      <site name="{prefix}tip" pos="0 0 -{ld+0.004:.4f}" size="0.004"/>
    </body>
  </body>
</body>
"""
  return s


def _finger_tendons(prefix: str, extra_ext: str = "") -> str:
  p = prefix
  t = f"""
<spatial name="{p}_FDP_t" width="0.0015">
  <site site="{p}_FDP_o"/>
  <geom geom="{p}_mcp_wrap" sidesite="{p}_mcp_flexside"/>
  <site site="{p}_FDP_p"/>
  <geom geom="{p}_pip_wrap" sidesite="{p}_pip_flexside"/>
  <site site="{p}_FDP_m"/>
  <geom geom="{p}_dip_wrap" sidesite="{p}_dip_flexside"/>
  <site site="{p}_FDP_i"/>
</spatial>
<spatial name="{p}_FDS_t" width="0.0015">
  <site site="{p}_FDS_o"/>
  <geom geom="{p}_mcp_wrap" sidesite="{p}_mcp_flexside"/>
  <site site="{p}_FDS_p"/>
  <geom geom="{p}_pip_wrap" sidesite="{p}_pip_flexside"/>
  <site site="{p}_FDS_i"/>
</spatial>
<spatial name="{p}_EDC_t" width="0.0015">
  <site site="{p}_EDC_o"/>
  <geom geom="{p}_mcp_wrap" sidesite="{p}_mcp_extside"/>
  <site site="{p}_EDC_p"/>
  <geom geom="{p}_pip_wrap" sidesite="{p}_pip_extside"/>
  <site site="{p}_EDC_m"/>
  <geom geom="{p}_dip_wrap" sidesite="{p}_dip_extside"/>
  <site site="{p}_EDC_i"/>
</spatial>
<spatial name="{p}_LUM_t" width="0.0015">
  <site site="{p}_LUM_o"/>
  <site site="{p}_LUM_i"/>
</spatial>
<spatial name="{p}_RI_t" width="0.0015">
  <site site="{p}_RI_o"/>
  <site site="{p}_RI_i"/>
</spatial>
<spatial name="{p}_UI_t" width="0.0015">
  <site site="{p}_UI_o"/>
  <site site="{p}_UI_i"/>
</spatial>
"""
  if extra_ext:
    t += f"""
<spatial name="{p}_{extra_ext}_t" width="0.0015">
  <site site="{p}_{extra_ext}_o"/>
  <geom geom="{p}_mcp_wrap" sidesite="{p}_mcp_extside"/>
  <site site="{p}_EDC_p"/>
  <geom geom="{p}_pip_wrap" sidesite="{p}_pip_extside"/>
  <site site="{p}_EDC_m"/>
</spatial>
"""
  return t


def _finger_palm_sites(prefix: str, y: float, extra_ext: str = "") -> str:
  p = prefix
  s = f"""
<site name="{p}_FDP_o" pos="-0.010 {y} -0.02"/>
<site name="{p}_FDS_o" pos="-0.012 {y} -0.025"/>
<site name="{p}_EDC_o" pos="0.010 {y} -0.02"/>
<site name="{p}_LUM_o" pos="-0.008 {y+0.004:.4f} -0.055"/>
<site name="{p}_RI_o" pos="0.004 {y+0.006:.4f} -0.06"/>
<site name="{p}_UI_o" pos="0.004 {y-0.006:.4f} -0.06"/>
"""
  if extra_ext:
    s += f'<site name="{p}_{extra_ext}_o" pos="0.012 {y} -0.028"/>\n'
  return s


def _finger_muscles(prefix: str, extra_ext: str = "") -> str:
  # peak isometric forces (N) anchored to MoBL-ARMS (Saul 2015) /
  # Gonzalez 1997 per-finger capacities; see docs/fidelity.md
  p = prefix
  mus = [
      f'<muscle name="{p}_FDP" tendon="{p}_FDP_t" force="70" timeconst="0.01 0.04"/>',
      f'<muscle name="{p}_FDS" tendon="{p}_FDS_t" force="75" timeconst="0.01 0.04"/>',
      f'<muscle name="{p}_EDC" tendon="{p}_EDC_t" force="30" timeconst="0.01 0.04"/>',
      f'<muscle name="{p}_LUM" tendon="{p}_LUM_t" force="10" timeconst="0.01 0.04"/>',
      f'<muscle name="{p}_RI" tendon="{p}_RI_t" force="18" timeconst="0.01 0.04"/>',
      f'<muscle name="{p}_UI" tendon="{p}_UI_t" force="18" timeconst="0.01 0.04"/>',
  ]
  if extra_ext:
    mus.append(
        f'<muscle name="{p}_{extra_ext}" tendon="{p}_{extra_ext}_t" '
        f'force="25" timeconst="0.01 0.04"/>')
  return "\n".join(mus)


OBJECT_SNIPPETS = {
    # sphere resting over the palm (ObjHold task family,
    # reference myohand_hold.xml scene role)
    "hold": """
    <body name="object" pos="{ox} {oy} {oz}">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="sphere" size="0.035" mass="0.15"
            contype="2" conaffinity="5" friction="1 0.01 0.0005"
            solref="0.015 1" condim="3"/>
      <site name="object_site" pos="0 0 0" size="0.005"/>
    </body>
""",
    # two baoding balls (reference myohand_baoding.xml scene role)
    "baoding": """
    <body name="ball1" pos="{ox} {oy1} {oz}">
      <freejoint name="ball1_free"/>
      <geom name="ball1_geom" type="sphere" size="0.022" mass="0.043"
            contype="2" conaffinity="7" friction="1 0.01 0.0005"
            solref="0.015 1" condim="3"/>
      <site name="ball1_site" size="0.004"/>
    </body>
    <body name="ball2" pos="{ox} {oy2} {oz}">
      <freejoint name="ball2_free"/>
      <geom name="ball2_geom" type="sphere" size="0.022" mass="0.043"
            contype="2" conaffinity="7" friction="1 0.01 0.0005"
            solref="0.015 1" condim="3"/>
      <site name="ball2_site" size="0.004"/>
    </body>
""",
    # die for in-hand reorientation (reference myohand_die.xml role).
    # The die is a real convex MESH geom (8-corner hull), exercising the
    # engine's mesh contact kernels (physics/collision.py) like the
    # reference's die mesh (myochallenge/reorient_v0.py:15).
    "die": """
    <body name="object" pos="{ox} {oy} {oz}">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="mesh" mesh="die_mesh"
            mass="0.07" contype="2" conaffinity="5"
            friction="1 0.01 0.0005" solref="0.015 1" condim="3"/>
      <site name="object_site" size="0.005"/>
    </body>
""",
    # pen for twirling (reference myohand_pen.xml role)
    "pen": """
    <body name="object" pos="{ox} {oy} {oz}" euler="0 1.57 0">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="capsule" fromto="-0.06 0 0 0.06 0 0"
            size="0.009" mass="0.025" contype="2" conaffinity="5"
            friction="1 0.01 0.0005" solref="0.015 1" condim="3"/>
      <site name="object_site" size="0.004"/>
      <site name="object_top" pos="0.06 0 0" size="0.004"/>
    </body>
""",
    # tabletop object + pedestal for the MyoChallenge'23 relocate task
    # (reference myoarm_relocate scene role, relocate_v0.py:16); the object
    # geom's size/mass/friction are randomized per episode in-graph
    "relocate": """
    <body name="pedestal" pos="0.0 0.02 0.90">
      <geom name="pedestal_geom" type="box" size="0.06 0.06 0.05"
            contype="4" conaffinity="3" friction="1 0.005 0.0001"/>
    </body>
    <body name="object" pos="0.0 0.02 1.0">
      <freejoint name="object_free"/>
      <geom name="object_geom" type="sphere" size="0.04" mass="0.2"
            contype="2" conaffinity="7" friction="1 0.01 0.0005"
            solref="0.015 1" condim="3"/>
      <site name="object_site" size="0.005"/>
    </body>
""",
    # spring-loaded key in front of the fingers (myohand_keyturn.xml role)
    "key": """
    <body name="key" pos="{ox} {oy} {oz}">
      <joint name="key_joint" type="hinge" axis="1 0 0" range="-6.3 0.1"
             damping="0.003" springref="0" stiffness="0.0"/>
      <geom name="key_shaft" type="cylinder" fromto="-0.02 0 0 0.02 0 0"
            size="0.004" mass="0.01" contype="0" conaffinity="0"/>
      <geom name="key_handle" type="box" pos="0 0 0.018"
            size="0.003 0.012 0.018" mass="0.01"
            contype="2" conaffinity="5" friction="1 0.01 0.0005"
            condim="3"/>
      <site name="key_site" pos="0 0 0.03" size="0.004"/>
    </body>
""",
}

# per-object <asset> entries (mesh colliders); half-size 0.023 die hull
OBJECT_ASSETS = {
    "die": """
    <mesh name="die_mesh" vertex="-0.023 -0.023 -0.023  0.023 -0.023 -0.023
                                  -0.023  0.023 -0.023  0.023  0.023 -0.023
                                  -0.023 -0.023  0.023  0.023 -0.023  0.023
                                  -0.023  0.023  0.023  0.023  0.023  0.023"/>
""",
}


def build_hand(palm_up: bool = False, obj: str = "",
               arm: bool = False, extra_worldbody: str = "",
               extra_actuators: str = "",
               object_snippet: Optional[str] = None,
               object_asset: Optional[str] = None) -> str:
  """The hand's MJCF (with the arm's 24 muscles when `arm`), palm up or
  down, with object `obj` over the palm: OBJECT_SNIPPETS[obj] and
  OBJECT_ASSETS.get(obj, ""), or `object_snippet` and `object_asset` where
  given (a snippet is formatted with the object's position, "{ox}",
  "{oy}", "{oz}", "{oy1}", "{oy2}")."""
  digits = []
  tendons = []
  palm_sites = []
  muscles = []
  for p, y, lens, rs in FINGERS:
    extra = "EIP" if p == "IF" else ("EDM" if p == "LF" else "")
    # arm mode drops LF mcp abduction so the full myoArm lands on the
    # documented 27-DoF anchor (MyoSuite's docs/source/suite.rst:189)
    abd = not (arm and p == "LF")
    digits.append(_digit_xml(p, y, lens, rs, abd=abd))
    tendons.append(_finger_tendons(p, extra))
    palm_sites.append(_finger_palm_sites(p, y, extra))
    muscles.append(_finger_muscles(p, extra))

  # thumb: CMC(2) + MCP(2) + IP
  thumb = """
<body name="TH_meta" pos="0.0 0.038 -0.035" euler="-1.1 0 0">
  <joint name="TH_cmc_abd" type="hinge" axis="1 0 0" range="-0.6 0.6"/>
  <joint name="TH_cmc_flex" type="hinge" axis="0 1 0" range="-0.5 1.0"/>
  <geom name="TH_cmc_wrap" type="cylinder" fromto="0 -0.012 0 0 0.012 0" size="0.009"/>
  <site name="TH_cmc_flexside" pos="-0.022 0 -0.008"/>
  <site name="TH_cmc_extside" pos="0.022 0 0.008"/>
  <geom type="capsule" fromto="0 0 0 0 0 -0.042" size="0.010" mass="0.04"/>
  <site name="TH_FPL_p" pos="-0.008 0 -0.02"/>
  <site name="TH_EPL_p" pos="0.008 0 -0.02"/>
  <site name="TH_ADPt_i" pos="-0.004 -0.007 -0.03"/>
  <site name="TH_ADPo_i" pos="-0.004 -0.007 -0.038"/>
  <site name="TH_OPP_i" pos="-0.006 0.004 -0.025"/>
  <site name="TH_APL_i" pos="0.008 0.006 -0.012"/>
  <body name="TH_prox" pos="0 0 -0.042">
    <joint name="TH_mcp_abd" type="hinge" axis="1 0 0" range="-0.3 0.3"/>
    <joint name="TH_mcp_flex" type="hinge" axis="0 1 0" range="-0.2 1.2"/>
    <geom name="TH_mcp_wrap" type="cylinder" fromto="0 -0.01 0 0 0.01 0" size="0.0075"/>
    <site name="TH_mcp_flexside" pos="-0.016 0 -0.006"/>
    <site name="TH_mcp_extside" pos="0.016 0 0.006"/>
    <geom name="TH_prox_geom" type="capsule" fromto="0 0 0 0 0 -0.032" size="0.0085" mass="0.02" contype="1" conaffinity="2"/>
    <site name="TH_FPL_m" pos="-0.006 0 -0.016"/>
    <site name="TH_EPL_m" pos="0.006 0 -0.016"/>
    <site name="TH_EPB_i" pos="0.006 0 -0.01"/>
    <body name="TH_dist" pos="0 0 -0.032">
      <joint name="TH_ip" type="hinge" axis="0 1 0" range="0 1.4"/>
      <geom name="TH_ip_wrap" type="cylinder" fromto="0 -0.008 0 0 0.008 0" size="0.0055"/>
      <site name="TH_ip_flexside" pos="-0.013 0 -0.005"/>
      <site name="TH_ip_extside" pos="0.013 0 0.005"/>
      <geom name="TH_tip_geom" type="capsule" fromto="0 0 0 0 0 -0.024" size="0.0065" mass="0.01" contype="1" conaffinity="2"/>
      <site name="TH_FPL_i" pos="-0.005 0 -0.019"/>
      <site name="TH_EPL_i" pos="0.005 0 -0.014"/>
      <site name="THtip" pos="0 0 -0.028" size="0.004"/>
    </body>
  </body>
</body>
"""

  thumb_palm_sites = """
<site name="TH_FPL_o" pos="-0.010 0.03 -0.015"/>
<site name="TH_EPL_o" pos="0.010 0.03 -0.015"/>
<site name="TH_EPB_o" pos="0.012 0.032 -0.018"/>
<site name="TH_APL_o" pos="0.008 0.028 -0.01"/>
<site name="TH_ADPt_o" pos="-0.006 -0.01 -0.05"/>
<site name="TH_ADPo_o" pos="-0.006 -0.004 -0.07"/>
<site name="TH_OPP_o" pos="-0.008 0.015 -0.02"/>
"""

  thumb_tendons = """
<spatial name="TH_FPL_t" width="0.0015">
  <site site="TH_FPL_o"/>
  <geom geom="TH_cmc_wrap" sidesite="TH_cmc_flexside"/>
  <site site="TH_FPL_p"/>
  <geom geom="TH_mcp_wrap" sidesite="TH_mcp_flexside"/>
  <site site="TH_FPL_m"/>
  <geom geom="TH_ip_wrap" sidesite="TH_ip_flexside"/>
  <site site="TH_FPL_i"/>
</spatial>
<spatial name="TH_EPL_t" width="0.0015">
  <site site="TH_EPL_o"/>
  <geom geom="TH_cmc_wrap" sidesite="TH_cmc_extside"/>
  <site site="TH_EPL_p"/>
  <geom geom="TH_mcp_wrap" sidesite="TH_mcp_extside"/>
  <site site="TH_EPL_m"/>
  <geom geom="TH_ip_wrap" sidesite="TH_ip_extside"/>
  <site site="TH_EPL_i"/>
</spatial>
<spatial name="TH_EPB_t" width="0.0015">
  <site site="TH_EPB_o"/>
  <geom geom="TH_cmc_wrap" sidesite="TH_cmc_extside"/>
  <site site="TH_EPB_i"/>
</spatial>
<spatial name="TH_APL_t" width="0.0015">
  <site site="TH_APL_o"/>
  <site site="TH_APL_i"/>
</spatial>
<spatial name="TH_ADPt_t" width="0.0015">
  <site site="TH_ADPt_o"/>
  <site site="TH_ADPt_i"/>
</spatial>
<spatial name="TH_ADPo_t" width="0.0015">
  <site site="TH_ADPo_o"/>
  <site site="TH_ADPo_i"/>
</spatial>
<spatial name="TH_OPP_t" width="0.0015">
  <site site="TH_OPP_o"/>
  <site site="TH_OPP_i"/>
</spatial>
"""

  thumb_muscles = """
<muscle name="TH_FPL" tendon="TH_FPL_t" force="80" timeconst="0.01 0.04"/>
<muscle name="TH_EPL" tendon="TH_EPL_t" force="30" timeconst="0.01 0.04"/>
<muscle name="TH_EPB" tendon="TH_EPB_t" force="15" timeconst="0.01 0.04"/>
<muscle name="TH_APL" tendon="TH_APL_t" force="50" timeconst="0.01 0.04"/>
<muscle name="TH_ADPt" tendon="TH_ADPt_t" force="60" timeconst="0.01 0.04"/>
<muscle name="TH_ADPo" tendon="TH_ADPo_t" force="60" timeconst="0.01 0.04"/>
<muscle name="TH_OPP" tendon="TH_OPP_t" force="60" timeconst="0.01 0.04"/>
"""

  # wrist muscles: forearm -> palm over the wrist wrap; origin depth scales
  # with the forearm length (longer forearm in arm mode)
  fz = -0.19 if arm else -0.06
  wrist_sites_forearm = f"""
<site name="FCR_o" pos="-0.012 0.008 {fz}"/>
<site name="FCU_o" pos="-0.012 -0.008 {fz}"/>
<site name="PL_o" pos="-0.013 0 {fz - 0.01:.3f}"/>
<site name="ECRL_o" pos="0.012 0.010 {fz + 0.01:.3f}"/>
<site name="ECRB_o" pos="0.012 0.004 {fz}"/>
<site name="ECU_o" pos="0.012 -0.008 {fz}"/>
"""
  wrist_sites_palm = """
<site name="FCR_i" pos="-0.010 0.012 -0.015"/>
<site name="FCU_i" pos="-0.010 -0.012 -0.015"/>
<site name="PL_i" pos="-0.011 0 -0.02"/>
<site name="ECRL_i" pos="0.010 0.014 -0.012"/>
<site name="ECRB_i" pos="0.010 0.004 -0.015"/>
<site name="ECU_i" pos="0.010 -0.012 -0.012"/>
"""
  wrist_tendons = "\n".join(f"""
<spatial name="{n}_t" width="0.002">
  <site site="{n}_o"/>
  <geom geom="wrist_wrap" sidesite="{side}"/>
  <site site="{n}_i"/>
</spatial>""" for n, side in [
      ("FCR", "wrist_flexside"), ("FCU", "wrist_flexside"),
      ("PL", "wrist_flexside"), ("ECRL", "wrist_extside"),
      ("ECRB", "wrist_extside"), ("ECU", "wrist_extside")])
  wrist_forces = {"FCR": 100, "FCU": 130, "PL": 50,
                  "ECRL": 300, "ECRB": 100, "ECU": 110}
  wrist_muscles = "\n".join(
      f'<muscle name="{n}" tendon="{n}_t" force="{f}" timeconst="0.01 0.04"/>'
      for n, f in wrist_forces.items())

  euler = "0 1.5708 0" if palm_up else "0 0 0"
  # palm-up object scenes: passive wrist tone so the hand holds level
  wrist_passive = ' stiffness="3.0" damping="0.5"' if palm_up else ""
  obj_xml = ""
  obj_assets = ""
  if obj:
    obj_assets = (OBJECT_ASSETS.get(obj, "") if object_asset is None
                  else object_asset)
    snippet = (OBJECT_SNIPPETS[obj] if object_snippet is None
               else object_snippet)
    obj_xml = snippet.format(ox=-0.15 if obj != "key" else -0.26,
                             oy=0.0, oz=1.245 if obj != "key" else 1.21,
                             oy1=0.025, oy2=-0.025)

  palm_subtree = f"""
      <body name="palm" pos="0 0 {-0.25 if arm else -0.10}">
        <joint name="wrist_flex" type="hinge" axis="0 1 0" range="-1.22 1.22"{wrist_passive}/>
        <joint name="wrist_dev" type="hinge" axis="1 0 0" range="-0.44 0.44"{wrist_passive}/>
        <geom name="wrist_wrap" type="cylinder" fromto="0 -0.02 0 0 0.02 0" size="0.014"/>
        <site name="wrist_flexside" pos="-0.03 0 -0.012"/>
        <site name="wrist_extside" pos="0.03 0 0.012"/>
        <geom name="palm_geom" type="box" pos="0 0.002 -0.05" size="0.012 0.038 0.042" mass="0.35" contype="1" conaffinity="2"/>
        {wrist_sites_palm}
        {thumb_palm_sites}
        {"".join(palm_sites)}
        {thumb}
        {"".join(digits)}
      </body>"""

  if arm:
    arm_sites, arm_tendons, arm_muscles = _arm_muscles()
    worldbody = f"""
    <body name="thorax" pos="0 0 1.7">
      <geom name="thorax_geom" type="box" pos="0 0.14 -0.1" size="0.08 0.12 0.18" mass="20.0"/>
      {arm_sites['thorax']}
      <body name="upper_arm" pos="0 0 0">
        <joint name="shoulder_flex" type="hinge" axis="0 1 0" range="-1.0 3.0"/>
        <joint name="shoulder_abd" type="hinge" axis="1 0 0" range="-0.5 1.57"/>
        <joint name="shoulder_rot" type="hinge" axis="0 0 1" range="-1.2 1.2"/>
        <geom name="shoulder_wrap" type="cylinder" fromto="0 -0.035 0 0 0.035 0" size="0.032"/>
        <site name="sh_front" pos="-0.07 0 -0.03"/>
        <site name="sh_back" pos="0.07 0 -0.03"/>
        <geom name="humerus_geom" type="capsule" fromto="0 0 0 0 0 -0.28" size="0.028" mass="2.2"/>
        {arm_sites['upper_arm']}
        <body name="forearm" pos="0 0 -0.28">
          <joint name="elbow_flex" type="hinge" axis="0 1 0" range="0 2.27"/>
          <joint name="pro_sup" type="hinge" axis="0 0 -1" range="-1.57 1.57"/>
          <geom name="elbow_wrap" type="cylinder" fromto="0 -0.03 0 0 0.03 0" size="0.02"/>
          <site name="elbow_flexside" pos="-0.05 0 -0.02"/>
          <site name="elbow_extside" pos="0.05 0 0.02"/>
          <geom name="ulna_geom" type="capsule" fromto="0 0 0 0 0 -0.25" size="0.02" mass="1.2"/>
          {arm_sites['forearm']}
          {wrist_sites_forearm}
          {palm_subtree}
        </body>
      </body>
    </body>
    {obj_xml}"""
    extra_tendons, extra_muscles = arm_tendons, arm_muscles
  else:
    worldbody = f"""
    <body name="forearm" pos="0 0 1.2" euler="{euler}">
      <geom type="capsule" fromto="0 0 0 0 0 -0.10" size="0.022" mass="1.2"/>
      {wrist_sites_forearm}
      {palm_subtree}
    </body>
    {obj_xml}"""
    extra_tendons, extra_muscles = "", ""

  return f"""
<mujoco model="{'mtx_arm' if arm else 'mtx_hand'}">
  <compiler angle="radian" autolimits="true">
    <lengthrange mode="none"/>
  </compiler>
  <option timestep="0.002" iterations="6" ls_iterations="6"/>
  <asset>
    {obj_assets}
  </asset>
  <default>
    <joint limited="true" damping="0.02" armature="0.0002"/>
    <geom contype="0" conaffinity="0" friction="1 0.005 0.0001"/>
    <site size="0.003"/>
  </default>
  <worldbody>
    {worldbody}
    {extra_worldbody}
  </worldbody>
  <tendon>
    {extra_tendons}
    {wrist_tendons}
    {thumb_tendons}
    {"".join(tendons)}
  </tendon>
  <actuator>
    {extra_muscles}
    {wrist_muscles}
    {thumb_muscles}
    {chr(10).join(muscles)}
    {extra_actuators}
  </actuator>
</mujoco>
"""


def _arm_muscles():
  """24 shoulder/elbow/forearm muscles for the full myoArm
  (63 total with the hand's 39; anchor
  MyoSuite's docs/source/suite.rst:189: myoArm 27 DoF / 63 muscles).

  Returns (sites_by_body, tendon_xml, muscle_xml). Anterior is -x (the
  convention of the elbow/hand builders); shoulder/elbow cylinder wraps with
  sidesites set the moment-arm sign.
  """
  # (name, origin(body, pos), insertion(body, pos), wraps, via, scale)
  shw_f, shw_b = ("shoulder_wrap", "sh_front"), ("shoulder_wrap", "sh_back")
  elw_f, elw_b = ("elbow_wrap", "elbow_flexside"), ("elbow_wrap", "elbow_extside")
  T, U, F = "thorax", "upper_arm", "forearm"
  specs = [
      ("DELT1", (T, (-0.03, 0.02, 0.02)), (U, (-0.008, 0.0, -0.08)), [shw_f], None, 500),
      ("DELT2", (T, (0.0, -0.04, 0.04)), (U, (0.0, -0.012, -0.08)), [], None, 500),
      ("DELT3", (T, (0.03, 0.02, 0.02)), (U, (0.008, 0.0, -0.08)), [shw_b], None, 400),
      ("PECM1", (T, (-0.05, 0.06, -0.02)), (U, (-0.01, -0.005, -0.05)), [shw_f], None, 500),
      ("PECM2", (T, (-0.05, 0.08, -0.06)), (U, (-0.01, -0.005, -0.055)), [shw_f], None, 500),
      ("PECM3", (T, (-0.05, 0.10, -0.10)), (U, (-0.01, -0.005, -0.06)), [shw_f], None, 400),
      ("LAT1", (T, (0.05, 0.06, -0.08)), (U, (0.006, -0.008, -0.06)), [shw_b], None, 500),
      ("LAT2", (T, (0.05, 0.08, -0.12)), (U, (0.006, -0.008, -0.065)), [shw_b], None, 500),
      ("LAT3", (T, (0.05, 0.10, -0.16)), (U, (0.006, -0.008, -0.07)), [shw_b], None, 400),
      ("TERmaj", (T, (0.04, 0.04, -0.05)), (U, (0.008, -0.005, -0.05)), [shw_b], None, 300),
      ("SUPSP", (T, (0.01, 0.05, 0.05)), (U, (0.0, -0.01, -0.02)), [], None, 300),
      ("INFSP", (T, (0.04, 0.05, 0.0)), (U, (0.01, -0.005, -0.03)), [], None, 300),
      ("CORB", (T, (-0.03, 0.03, -0.01)), (U, (-0.005, 0.0, -0.12)), [], None, 250),
      ("BIClong", (T, (-0.02, 0.015, 0.02)), (F, (-0.02, 0.0, -0.03)), [elw_f], (U, (-0.03, 0.0, -0.20)), 600),
      ("BICshort", (T, (-0.03, 0.03, 0.0)), (F, (-0.02, 0.0, -0.035)), [elw_f], (U, (-0.03, 0.0, -0.21)), 450),
      ("BRA", (U, (-0.026, 0.0, -0.16)), (F, (-0.018, 0.0, -0.05)), [elw_f], None, 500),
      ("BRD", (U, (-0.022, 0.0, -0.13)), (F, (-0.015, 0.0, -0.15)), [elw_f], None, 250),
      ("TRIlong", (T, (0.02, 0.015, 0.0)), (F, (0.02, 0.0, -0.02)), [elw_b], (U, (0.03, 0.0, -0.20)), 700),
      ("TRIlat", (U, (0.026, 0.0, -0.10)), (F, (0.02, 0.0, -0.022)), [elw_b], None, 500),
      ("TRImed", (U, (0.026, 0.0, -0.16)), (F, (0.02, 0.0, -0.025)), [elw_b], None, 500),
      ("ANC", (U, (0.022, 0.0, -0.25)), (F, (0.018, 0.0, -0.04)), [elw_b], None, 200),
      ("PT", (U, (-0.02, 0.012, -0.26)), (F, (-0.01, -0.016, -0.08)), [], None, 350),
      ("PQ", (U, (-0.012, 0.01, -0.27)), (F, (-0.008, -0.014, -0.06)), [], None, 200),
      ("SUP", (U, (0.015, 0.012, -0.26)), (F, (0.004, 0.016, -0.06)), [], None, 200),
  ]
  assert len(specs) == 24
  sites = {"thorax": [], "upper_arm": [], "forearm": []}
  tendons, muscles = [], []
  for name, org, ins, wraps, via, scale in specs:
    sites[org[0]].append(
        f'<site name="{name}_o" pos="{org[1][0]} {org[1][1]} {org[1][2]}"/>')
    sites[ins[0]].append(
        f'<site name="{name}_i" pos="{ins[1][0]} {ins[1][1]} {ins[1][2]}"/>')
    chain = ""
    if via is not None:
      sites[via[0]].append(
          f'<site name="{name}_v" pos="{via[1][0]} {via[1][1]} {via[1][2]}"/>')
      if len(wraps) == 1:
        chain = (f'\n  <site site="{name}_v"/>'
                 f'\n  <geom geom="{wraps[0][0]}" sidesite="{wraps[0][1]}"/>')
      else:
        chain = f'\n  <site site="{name}_v"/>'
    else:
      chain = "".join(f'\n  <geom geom="{g}" sidesite="{s}"/>'
                      for g, s in wraps)
    tendons.append(
        f'<spatial name="{name}_t" width="0.003">\n'
        f'  <site site="{name}_o"/>{chain}\n'
        f'  <site site="{name}_i"/>\n</spatial>')
    muscles.append(
        f'<muscle name="{name}" tendon="{name}_t" scale="{scale}"'
        f' timeconst="0.01 0.04"/>')
  return ({k: "".join(v) for k, v in sites.items()},
          "\n".join(tendons), "\n".join(muscles))
