"""Tensor/dict utilities for rollout post-processing, on the host (the JAX
package's `utils/tensor_utils.py`). Inputs may be tensors on any device or
array-likes; outputs are numpy arrays.

Role-equivalents of the reference's tensor_utils / dict_utils
(MyoSuite's myosuite/utils/tensor_utils.py:64-151,
dict_utils.py:4-71): stack/pad/concat lists of dict-trees, flatten nested
dicts, numpify.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from myosuite_tpu_torch.logger.trace import to_numpy


def stack_tensor_list(lst: List[np.ndarray]) -> np.ndarray:
  return np.stack([to_numpy(x) for x in lst])


def stack_tensor_dict_list(lst: List[Dict[str, Any]]) -> Dict[str, Any]:
  """[{k: v}, ...] -> {k: stacked v} recursively."""
  keys = lst[0].keys()
  out = {}
  for k in keys:
    vals = [d[k] for d in lst]
    if isinstance(vals[0], dict):
      out[k] = stack_tensor_dict_list(vals)
    else:
      out[k] = stack_tensor_list(vals)
  return out


def concat_tensor_dict_list(lst: List[Dict[str, Any]]) -> Dict[str, Any]:
  keys = lst[0].keys()
  out = {}
  for k in keys:
    vals = [d[k] for d in lst]
    if isinstance(vals[0], dict):
      out[k] = concat_tensor_dict_list(vals)
    else:
      out[k] = np.concatenate([to_numpy(v) for v in vals])
  return out


def pad_tensor(x: np.ndarray, max_len: int, mode: str = "zero") -> np.ndarray:
  """Pad the time dimension to max_len (zero or last-value padding)."""
  x = to_numpy(x)
  if x.shape[0] >= max_len:
    return x[:max_len]
  pad_shape = (max_len - x.shape[0],) + x.shape[1:]
  if mode == "last":
    pad = np.broadcast_to(x[-1], pad_shape)
  else:
    pad = np.zeros(pad_shape, dtype=x.dtype)
  return np.concatenate([x, pad])


def flatten_dict(d: Dict[str, Any], sep: str = ".",
                 prefix: str = "") -> Dict[str, Any]:
  """{'a': {'b': 1}} -> {'a.b': 1} (reference dot-path convention used by
  env variant overrides, env_variants.py:69)."""
  out = {}
  for k, v in d.items():
    key = f"{prefix}{sep}{k}" if prefix else str(k)
    if isinstance(v, dict):
      out.update(flatten_dict(v, sep, key))
    else:
      out[key] = v
  return out


def unflatten_dict(d: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
  out: Dict[str, Any] = {}
  for k, v in d.items():
    parts = str(k).split(sep)
    cur = out
    for p in parts[:-1]:
      cur = cur.setdefault(p, {})
    cur[parts[-1]] = v
  return out


def dict_numpify(d: Dict[str, Any]) -> Dict[str, Any]:
  return {k: (dict_numpify(v) if isinstance(v, dict) else to_numpy(v))
          for k, v in d.items()}
