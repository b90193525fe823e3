"""Dict utilities: numpify and flatten nested dicts (the JAX package's
`utils/dict_utils.py`). Leaves may be tensors on any device or array-likes;
numpified leaves are numpy arrays on the host.

Role-equivalent of the reference's dict utils
(MyoSuite's myosuite/utils/dict_utils.py:4,71).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from myosuite_tpu_torch.logger.trace import to_numpy


def dict_numpify(data: Dict[str, Any], u_res=np.uint8, i_res=np.int8,
                 f_res=np.float16) -> Dict[str, Any]:
  """Recursively cast dict leaves to compact numpy dtypes (None = keep)."""
  out = {}
  for k, v in data.items():
    if isinstance(v, dict):
      out[k] = dict_numpify(v, u_res, i_res, f_res)
      continue
    arr = to_numpy(v)
    if np.issubdtype(arr.dtype, np.unsignedinteger) and u_res is not None:
      arr = arr.astype(u_res)
    elif np.issubdtype(arr.dtype, np.signedinteger) and i_res is not None:
      arr = arr.astype(i_res)
    elif np.issubdtype(arr.dtype, np.floating) and f_res is not None:
      arr = arr.astype(f_res)
    out[k] = arr
  return out


def flatten_dict(data: Dict[str, Any], sep: str = "/",
                 prefix: str = "") -> Dict[str, Any]:
  """Flatten nested dicts into a single level with `sep`-joined keys."""
  out = {}
  for k, v in data.items():
    key = f"{prefix}{sep}{k}" if prefix else str(k)
    if isinstance(v, dict):
      out.update(flatten_dict(v, sep=sep, prefix=key))
    else:
      out[key] = v
  return out


def expand_dims(data: Dict[str, Any]) -> Dict[str, Any]:
  """Add leading (traj, time) singleton dims so per-step reward code runs
  batched (reference ObsVecDict.expand_dims role,
  MyoSuite's myosuite/envs/obs_vec_dict.py)."""
  return {k: to_numpy(v)[None, None] for k, v in data.items()}


def squeeze_dims(data: Dict[str, Any]) -> Dict[str, Any]:
  """Inverse of expand_dims."""
  return {k: np.squeeze(to_numpy(v), axis=(0, 1)) if to_numpy(v).ndim >= 2
          else v for k, v in data.items()}
