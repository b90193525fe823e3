"""The muscles' length-range sweep of `builder.finalize_muscles`, run on a
compiled model through the port's own kinematics, tendon and transmission
stages (plain batched PyTorch, on any device, with no MuJoCo).

`finalize_muscles` sweeps a probe model over `builder.sweep_qpos`' 64
joint samples with MuJoCo and writes each muscle's padded range of
actuator lengths into the MJCF. `sweep_lengthrange` draws the same
samples from a model file's own qpos0 and joint ranges, runs them as one
batch and pads the same way, so that its muscle rows stand within the
MJCF's "%.6f" rounding (and float32) of the file's actuator_lengthrange.

Except on MIRRORED_ROWS: there the JAX package's tendon path, which the
port follows, leaves MuJoCo's (the shoulder wrap's anterior muscles of
the arm, the hip flexors' and the hamstrings' and calf muscles' wraps of
the leg, and the leg's toe flexors already at qpos0), so the engine's
sweep misses the MuJoCo ranges the files store by over a centimetre (up
to 0.16 m). The port's sweep equals the JAX engine's there
(tests/test_torch_mjcf.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from myosuite_tpu_torch.mjcf import builder
from myosuite_tpu_torch.physics import actuation, kinematics, tendon
from myosuite_tpu_torch.physics import io as physics_io
from myosuite_tpu_torch.physics.types import GainType, Model


# Per model file, the actuator rows whose sweep through the JAX package's
# tendon path (and the port's) leaves MuJoCo's sweep, which made the
# file's ranges. The arm's rows are DELT1, PECM1-3; the leg's the right
# hip flexors (PSOAS, ILIACUS, RF, SAR, TFL) and, on the left, the
# hamstrings, gastrocnemii and toe flexors (the drawn joint samples
# differ with the scene's joints, so the rows do too).
_LEG_ROWS = (5, 6, 7, 8, 9, 43, 44, 55, 65, 66, 68, 69, 72, 73)
_ARM_ROWS = (0, 3, 4, 5)
MIRRORED_ROWS = {
    "myoarm.npz": _ARM_ROWS, "myoarm_bimanual.npz": _ARM_ROWS,
    "myoarm_relocate.npz": _ARM_ROWS, "myoleg.npz": _LEG_ROWS,
    "myoleg_chasetag.npz": _LEG_ROWS, "myoleg_terrain.npz": _LEG_ROWS,
    "myoleg_soccer.npz": (3,) + _LEG_ROWS,
    "myoleg_osl.npz": (3, 4, 19, 20, 31, 41, 42, 44, 45, 48, 49),
}


def muscle_rows(model: Model) -> np.ndarray:
  """The actuator ids of the model's muscles."""
  return np.nonzero(np.asarray(model.actuator_gaintype)
                    == int(GainType.MUSCLE))[0]


def sweep_lengthrange(model: Model, nsamples: int = 64) -> np.ndarray:
  """(nu, 2) float64: every actuator's padded range of lengths over the
  sweep's joint samples, as one batch of `nsamples` on the model's
  device."""
  qpos = builder.sweep_qpos(
      model.qpos0.cpu().numpy(), np.asarray(model.jnt_qposadr),
      model.jnt_range.cpu().numpy(), np.asarray(model.jnt_limited), nsamples)
  d = physics_io.make_data(model, nsamples)
  d = dataclasses.replace(d, qpos=torch.as_tensor(
      qpos, dtype=torch.float32, device=model.device))
  d = kinematics.kinematics(model, d)
  d = kinematics.com_pos(model, d)
  d = tendon.tendon(model, d)
  d = actuation.transmission(model, d)
  length = d.actuator_length.cpu().numpy().astype(np.float64)
  lo, hi = builder.pad_lengthrange(length.min(0), length.max(0))
  return np.stack([lo, hi], axis=1)


def sweep_gaps(model: Model, nsamples: int = 64):
  """(rows, swept, gaps) of the model's muscles: their actuator ids, their
  swept (n, 2) ranges and each one's largest gap (m) to the range the
  model stores."""
  rows = muscle_rows(model)
  swept = sweep_lengthrange(model, nsamples)[rows]
  stored = model.actuator_lengthrange.cpu().numpy().astype(np.float64)[rows]
  return rows, swept, np.abs(swept - stored).max(axis=1)


def named_range_gap(model: Model, names, ref: Model, ref_names) -> float:
  """The largest gap (m) between the stored length range of each of
  `model`'s muscles and that of the muscle of the same name in `ref`
  (for a model edited after its ranges were swept)."""
  index = {str(n): i for i, n in enumerate(ref_names)}
  mine = model.actuator_lengthrange.cpu().numpy().astype(np.float64)
  theirs = ref.actuator_lengthrange.cpu().numpy().astype(np.float64)
  rows = muscle_rows(model)
  if not len(rows):
    return 0.0
  return float(max(np.abs(mine[i] - theirs[index[str(names[i])]]).max()
                   for i in rows))
