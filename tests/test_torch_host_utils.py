"""The port's host helpers against the JAX package's on the same inputs:
`xml_utils`, `dict_utils`, `tensor_utils`, `paths_utils` and
`prompt_utils`, and the registry's "Registered env variant" prompt.

The port's helpers also take tensors (on any device; here the CPU) where
the JAX package's take numpy arrays: each is fed both, and must give the
JAX result on the arrays.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from myosuite_tpu.utils import dict_utils as jdict
from myosuite_tpu.utils import paths_utils as jpaths
from myosuite_tpu.utils import prompt_utils as jprompt
from myosuite_tpu.utils import tensor_utils as jtensor
from myosuite_tpu.utils import xml_utils as jxml
from myosuite_tpu_torch.envs import registry
from myosuite_tpu_torch.logger.trace import Trace
from myosuite_tpu_torch.mjcf import builder
from myosuite_tpu_torch.utils import (dict_utils, paths_utils, prompt_utils,
                                      tensor_utils, xml_utils)

_OTHER = """<mujoco>
  <asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/></asset>
  <worldbody><body name="ball" pos="0 0 2"><freejoint/>
    <geom type="sphere" size="0.1"/></body></worldbody>
  <actuator><motor name="extra" joint="r_elbow_flex"/></actuator>
</mujoco>"""


def _equal_trees(a, b):
  assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                and isinstance(b, np.ndarray))
  if isinstance(a, dict):
    assert list(a) == list(b)
    for k in a:
      _equal_trees(a[k], b[k])
  elif isinstance(a, np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
  else:
    assert a == b


@pytest.mark.parametrize("case", ["merge", "reparent", "reparent_world",
                                  "remove", "find"])
def test_xml_utils_match_jax(case):
  xml = builder.build_elbow()
  if case == "merge":
    ours, theirs = (m.merge_xmls(xml, _OTHER) for m in (xml_utils, jxml))
  elif case == "reparent":
    ours, theirs = (m.reparent_body(xml, "forearm", "upper_arm", "0 0 -0.3")
                    for m in (xml_utils, jxml))
  elif case == "reparent_world":
    ours, theirs = (m.reparent_body(xml, "forearm", "worldbody")
                    for m in (xml_utils, jxml))
  elif case == "remove":
    ours, theirs = (m.remove_body(xml, "forearm") for m in (xml_utils, jxml))
  else:
    ours, theirs = (m.find_body(m.parse_xml(xml), "forearm").get("pos")
                    for m in (xml_utils, jxml))
  assert ours == theirs


def _nested(torch_leaves):
  rng = np.random.default_rng(0)
  leaves = {"u": rng.integers(0, 200, 5).astype(np.uint16),
            "i": rng.integers(-100, 100, (2, 3)).astype(np.int32),
            "f": rng.standard_normal((4,)).astype(np.float32)}
  def conv(v):
    if not torch_leaves:
      return v
    return torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint16
                            else v)
  return {"a": {k: conv(v) for k, v in leaves.items()},
          "b": conv(leaves["f"][:2]), "c": {"d": {"e": conv(leaves["i"])}}}


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_dict_utils_match_jax(leaves):
  data, ref = _nested(leaves == "torch"), _nested(False)
  if leaves == "numpy":
    _equal_trees(dict_utils.dict_numpify(data), jdict.dict_numpify(ref))
  else:     # a tensor has no uint16: the unsigned leaf comes in as int64
    got = dict_utils.dict_numpify(data)
    assert got["a"]["i"].dtype == np.int8 and got["a"]["f"].dtype == \
        np.float16
    np.testing.assert_array_equal(got["a"]["f"],
                                  jdict.dict_numpify(ref)["a"]["f"])
  for kw in ({}, dict(u_res=None, i_res=np.int16, f_res=None)):
    if leaves == "numpy":
      _equal_trees(dict_utils.dict_numpify(data, **kw),
                   jdict.dict_numpify(ref, **kw))
  assert dict_utils.flatten_dict(data).keys() == jdict.flatten_dict(
      ref).keys()
  flat = {"x": np.arange(3.0), "y": np.ones((2, 2))}
  ex = dict_utils.expand_dims({k: torch.from_numpy(v) for k, v in
                               flat.items()})
  _equal_trees(ex, jdict.expand_dims(flat))
  _equal_trees(dict_utils.squeeze_dims(ex), jdict.squeeze_dims(
      jdict.expand_dims(flat)))


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_tensor_utils_match_jax(leaves):
  rng = np.random.default_rng(1)
  steps = [{"obs": rng.standard_normal(3).astype(np.float32),
            "info": {"r": np.float32(rng.standard_normal())}}
           for _ in range(4)]
  conv = ((lambda v: torch.as_tensor(v)) if leaves == "torch"
          else (lambda v: v))
  ours_in = [{"obs": conv(s["obs"]), "info": {"r": conv(s["info"]["r"])}}
             for s in steps]
  _equal_trees(tensor_utils.stack_tensor_dict_list(ours_in),
               jtensor.stack_tensor_dict_list(steps))
  batches = [{"obs": rng.standard_normal((2, 3)), "info": {
      "r": rng.standard_normal(2)}} for _ in range(3)]
  conv_b = [{"obs": conv(b["obs"]), "info": {"r": conv(b["info"]["r"])}}
            for b in batches]
  _equal_trees(tensor_utils.concat_tensor_dict_list(conv_b),
               jtensor.concat_tensor_dict_list(batches))
  x = rng.standard_normal((3, 2)).astype(np.float32)
  for n, mode in ((5, "zero"), (5, "last"), (2, "zero")):
    _equal_trees(tensor_utils.pad_tensor(conv(x), n, mode),
                 jtensor.pad_tensor(x, n, mode))
  nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
  assert tensor_utils.flatten_dict(nested) == jtensor.flatten_dict(nested)
  flat = jtensor.flatten_dict(nested)
  assert tensor_utils.unflatten_dict(flat) == jtensor.unflatten_dict(flat)
  _equal_trees(tensor_utils.dict_numpify(
      {"a": conv(x), "b": {"c": conv(x[0])}}),
      jtensor.dict_numpify({"a": x, "b": {"c": x[0]}}))


def _paths(kind):
  """Three examine_env-style paths (obs, reward, solved) of 6, 4 and 9
  steps, as per-step lists (the JAX CLI's), arrays or tensors."""
  rng = np.random.default_rng(2)
  paths = []
  for n in (6, 4, 9):
    p = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
         "reward": rng.standard_normal(n).astype(np.float32),
         "solved": (rng.random(n) > 0.3).astype(np.float32)}
    if kind == "list":
      p = {k: [x for x in v] for k, v in p.items()}
      p["data"] = []
    elif kind == "torch":
      p = {k: torch.from_numpy(v) for k, v in p.items()}
    paths.append(p)
  return paths


@pytest.mark.parametrize("kind", ["list", "array", "torch"])
def test_paths_utils_match_jax(kind, tmp_path):
  ours, ref = _paths(kind), _paths("list" if kind == "list" else "array")
  assert paths_utils.path_stats(ours) == jpaths.path_stats(ref)
  cut = paths_utils.truncate_paths(ours, 5)
  want = jpaths.truncate_paths(ref, 5)
  for a, b in zip(cut, want):
    assert a.keys() == b.keys()
    for k in a:
      np.testing.assert_array_equal(np.asarray(
          a[k].numpy() if isinstance(a[k], torch.Tensor) else a[k]),
          np.asarray(b[k]))
      assert isinstance(a[k], torch.Tensor) == (kind == "torch")
  tr = paths_utils.paths_to_trace(ours)
  jtr = jpaths.paths_to_trace(ref)
  assert tr.name == jtr.name and list(tr.trace) == list(jtr.trace)
  for g in jtr.trace:
    assert list(tr.trace[g]) == list(jtr.trace[g])
    for k, v in jtr.trace[g].items():
      _equal_trees(tr.trace[g][k], v)
  path = str(tmp_path / "paths.mtp")
  tr.save(path)
  back = Trace.load(path)
  for g in jtr.trace:
    for k, v in jtr.trace[g].items():
      np.testing.assert_array_equal(back[g][k], v)


def test_pickle2h5_like_jax(tmp_path):
  """pickle2h5 converts a pickled list of paths (h5py is optional: without
  it both packages raise ImportError alike)."""
  src = str(tmp_path / "paths.pkl")
  with open(src, "wb") as f:
    pickle.dump(_paths("array"), f)
  try:
    import h5py  # noqa: F401
  except ImportError:
    for mod in (paths_utils, jpaths):
      with pytest.raises(ImportError):
        mod.pickle2h5(src, str(tmp_path / f"{mod.__name__}.h5"))
    return
  out = paths_utils.pickle2h5(src, str(tmp_path / "ours.h5"))
  back = Trace.load(out)
  assert sorted(back.keys()) == ["rollout0", "rollout1", "rollout2"]


def test_plots_when_matplotlib_is_there(tmp_path):
  pytest.importorskip("matplotlib")
  prefix = str(tmp_path / "p")
  assert paths_utils.plot_horizon(_paths("torch"), prefix).endswith(
      "_horizon.pdf")
  assert os.path.getsize(paths_utils.plot_obs_actions(
      _paths("torch"), prefix)) > 0


@pytest.mark.parametrize("verbosity", ["SILENT", "WARN", "INFO", "ALL"])
def test_prompt_utils_match_jax(verbosity, monkeypatch, capsys):
  monkeypatch.setenv("MTX_VERBOSITY", verbosity)
  monkeypatch.setattr(prompt_utils, "_ONCE_SEEN", set())
  monkeypatch.setattr(jprompt, "_ONCE_SEEN", set())
  outs = []
  for mod in (prompt_utils, jprompt):
    assert mod.verbosity().name == jprompt.verbosity().name
    for kind in ("INFO", "WARN", "ERROR", "ALWAYS", "ONCE", "ONCE"):
      mod.prompt(f"{kind} message", type_=kind)
    outs.append(capsys.readouterr())
  assert outs[0] == outs[1]


def test_registered_env_variant_prompts_like_jax(monkeypatch, capsys):
  """The variant's registration is an INFO prompt: shown at INFO, not at
  the default WARN."""
  for table in ("_REGISTRY", "_ALIASES", "_SUITES"):
    monkeypatch.setattr(registry, table, dict(getattr(registry, table)))
  for level, shown in (("WARN", False), ("INFO", True)):
    monkeypatch.setenv("MTX_VERBOSITY", level)
    vid = registry.register_env_variant("MtxElbowPoseRandom-v0",
                                        {"max_episode_steps": 9})
    out = capsys.readouterr().out
    assert (f"Registered env variant: {vid}" in out) == shown
