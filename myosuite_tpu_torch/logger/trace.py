"""Trace: grouped rollout datasets, saved as HDF5, pickle or tracepack.

The JAX package's `logger.trace`: a trace is {group: {dataset: array or
list}}; datums are appended per step, stacked, cast to compact dtypes,
verified and saved. Tensors (on any device) become numpy arrays when they
are stacked or saved. The file format follows the path: `.pkl` /
`.pickle`, `.mtp` (the native threaded sink, `myosuite_tpu_torch.native`)
or HDF5 otherwise; `h5py` is imported only for an HDF5 path.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch


def to_numpy(x: Any) -> np.ndarray:
  """A tensor (any device) or array-like as a numpy array."""
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


class Trace:
  """Grouped rollout datasets (the reference's Trace)."""

  def __init__(self, name: str = "Trace"):
    self.name = name
    self.root = {name: {}}
    self.trace = self.root[name]

  # -- building -----------------------------------------------------------
  def create_group(self, name: str) -> None:
    self.trace[name] = {}

  def create_dataset(self, group_key: str, dataset_key: str,
                     dataset_val: Any = None) -> None:
    if group_key not in self.trace:
      self.create_group(group_key)
    self.trace[group_key][dataset_key] = (
        [] if dataset_val is None else [dataset_val])

  def append_datum(self, group_key: str, dataset_key: str, dataset_val):
    if dataset_key not in self.trace.get(group_key, {}):
      self.create_dataset(group_key, dataset_key)
    self.trace[group_key][dataset_key].append(dataset_val)

  def append_datums(self, group_key: str, dataset_key_val: Dict[str, Any]):
    for k, v in dataset_key_val.items():
      self.append_datum(group_key, k, v)

  # -- processing ---------------------------------------------------------
  def stack(self) -> None:
    for grp in self.trace.values():
      for k, v in grp.items():
        if isinstance(v, list):
          grp[k] = np.stack([to_numpy(x) for x in v])
        elif isinstance(v, torch.Tensor):
          grp[k] = to_numpy(v)

  def numpify(self, u_res=np.uint8, i_res=np.int8, f_res=np.float32) -> None:
    """Cast datasets to compact dtypes (the reference's resolutions)."""
    for grp in self.trace.values():
      for k, v in grp.items():
        arr = to_numpy(v)
        if np.issubdtype(arr.dtype, np.unsignedinteger) and u_res:
          grp[k] = arr.astype(u_res)
        elif np.issubdtype(arr.dtype, np.signedinteger) and i_res:
          grp[k] = arr.astype(i_res)
        elif np.issubdtype(arr.dtype, np.floating) and f_res:
          grp[k] = arr.astype(f_res)
        else:
          grp[k] = arr

  def verify(self) -> bool:
    """All datasets of a group must share the time dimension."""
    for gname, grp in self.trace.items():
      lens = {k: (len(v) if isinstance(v, list) else v.shape[0])
              for k, v in grp.items()}
      if len(set(lens.values())) > 1:
        raise ValueError(f"group {gname} has uneven datasets: {lens}")
    return True

  # -- io -----------------------------------------------------------------
  def save(self, path: str, compression="gzip") -> None:
    self.stack()
    self.verify()
    if path.endswith((".pkl", ".pickle")):
      with open(path, "wb") as f:
        pickle.dump(self.root, f)
      return
    if path.endswith(".mtp"):
      from myosuite_tpu_torch.native import TracePackWriter
      with TracePackWriter(path) as w:
        for gname, grp in self.trace.items():
          for k, v in grp.items():
            w.append(f"{gname}/{k}", v)
      return
    import h5py
    with h5py.File(path, "w") as f:
      for gname, grp in self.trace.items():
        hgrp = f.create_group(gname)
        for k, v in grp.items():
          hgrp.create_dataset(k, data=v, compression=compression)

  @classmethod
  def load(cls, path: str) -> "Trace":
    """A trace saved by `save` (or by the JAX package's Trace). Loading a
    pickle runs code from the file: load only traces you wrote."""
    tr = cls()
    if path.endswith((".pkl", ".pickle")):
      with open(path, "rb") as f:
        tr.root = pickle.load(f)
      tr.name = next(iter(tr.root))
      tr.trace = tr.root[tr.name]
      return tr
    tr.trace = {}
    if path.endswith(".mtp"):
      from myosuite_tpu_torch.native import read_tracepack
      for key, arr in read_tracepack(path).items():
        gname, _, dname = key.partition("/")
        tr.trace.setdefault(gname, {})[dname or "data"] = arr
    else:
      import h5py
      with h5py.File(path, "r") as f:
        for gname in f:
          tr.trace[gname] = {k: np.asarray(f[gname][k]) for k in f[gname]}
    tr.root = {tr.name: tr.trace}
    return tr

  # -- introspection ------------------------------------------------------
  def keys(self):
    return self.trace.keys()

  def __getitem__(self, key):
    return self.trace[key]

  def __repr__(self):
    lines = [f"Trace {self.name}:"]
    for gname, grp in self.trace.items():
      lines.append(f"  {gname}:")
      for k, v in grp.items():
        shape = len(v) if isinstance(v, list) else tuple(v.shape)
        lines.append(f"    {k}: {shape}")
    return "\n".join(lines)


def rollout_to_trace(rollout: Dict[str, Any],
                     group: str = "rollout0") -> Trace:
  """A (T, ...) dict of arrays or tensors as a one-group Trace."""
  tr = Trace()
  tr.create_group(group)
  for k, v in rollout.items():
    tr.trace[group][k] = to_numpy(v)
  return tr
