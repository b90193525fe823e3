"""MJCF builders and the model export (the JAX package's `assets/*.py`).

- `builder`, `hand`, `leg`, `torso`: procedural MJCF string generators of
  the elbow, finger, hand, arm, leg and torso models and their scenes;
  `builder.finalize_muscles` sweeps the muscles' length ranges with the
  host MuJoCo.
- `editor`: MjSpec surgery (the arm-reach and table-tennis edits).
- `export`: the MJCF and the model file of every committed model
  (`myosuite_tpu_torch/assets/`), and the `model_xml` route's loader.
- `sweep`: `finalize_muscles`' sweep through the port's own kinematics, on
  any device.

The string builders need no MuJoCo; whatever compiles imports it inside
the function and raises an ImportError that names MuJoCo without it.
"""
