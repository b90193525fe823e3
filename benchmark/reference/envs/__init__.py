"""The reference envs, built from a configuration file of the benchmark.

`make(config, device)` reads the configuration's frozen model file
(`model_file`, checked against its `model_sha256`) and builds the task
that the configuration's `task` names, with the task config stored in the
model file, as the program's registry does for the same env id. Each task
is a module of its own, `reference/tasks/<task>.py`, whose
`make(model, extra)` builds the env from the loaded model and the model
file's other arrays; a new task is a new file.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional

from benchmark.reference.physics import io as physics_io

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def model_path(config: Dict[str, Any]) -> str:
  """The configuration's frozen model file, after checking its SHA-256."""
  path = os.path.join(_REPO, config["model_file"])
  with open(path, "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()
  if digest != config["model_sha256"]:
    raise ValueError(f"{path} has SHA-256 {digest}, the configuration "
                     f"states {config['model_sha256']}")
  return path


def make(config: Dict[str, Any], device, root: Optional[str] = None):
  """The configuration's task on `device`, from the task module under
  `root` (the benchmark's folder)."""
  from benchmark import spec
  model, extra = physics_io.load_model(model_path(config), device)
  task = spec.load_module(root or spec.HERE, "reference/tasks",
                          config["task"])
  return task.make(model, extra)
