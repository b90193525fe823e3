"""CPU tests of the benchmark's harness: discovery by name, the import
rules, the result line, the refusal to run without a card, and the frozen
reference against the program's CPU path at a tiny batch.

Run from the repository's root: `python -m pytest benchmark/tests -q`.
"""

import ast
import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
  sys.path.insert(0, REPO)

from benchmark import check, harness, spec  # noqa: E402

SEED = 2 ** 31 + 11    # past 32 signed bits, as the driver's are


def bench():
  return spec.load_json(os.path.join(REPO, "BENCHMARK.json"))


def tiny(cell, n=6):
  """The cell at a size a CPU test holds: the same kinds and code paths."""
  t = copy.deepcopy(cell.traffic)
  t["num_envs"] = n
  if t["kind"] == "step":
    t.update(rollout_steps=2, check_rows=3, profile_steps=1)
  else:
    t["check_steps"] = 1
    t["ppo"].update(unroll_length=2, num_minibatches=2,
                    num_updates_per_batch=1)
  cell.traffic = t
  return cell


def test_every_entry_is_found_by_name():
  b = bench()
  for w in b["workloads"]:
    cell = spec.load_cell(w["name"], b)
    assert cell.config["name"] == w["config"]
    assert callable(cell.kind.drive) and callable(cell.kind.gaps)
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
      assert callable(m.reader().read)
      assert m.entry["moves"] in names
    ranks = {"replica_gap"} if cell.traffic.get("ranks", 1) > 1 else set()
    assert set(cell.limits) == set(cell.kind.NUMBERS) | ranks
  for c in b["configs"]:
    cfg = spec.load_json(os.path.join(REPO, c["file"]))
    with open(os.path.join(REPO, cfg["model_file"]), "rb") as f:
      assert hashlib.sha256(f.read()).hexdigest() == cfg["model_sha256"]
    assert cfg["reduced"] == c["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["source_settings"]) if \
        cfg["reduced"] else True


def test_each_cell_gets_every_end_to_end_metric_it_lists():
  win = harness.Window(setup_s=9.5, window_s=50.0, env_steps=8192 * 160,
                       step_ms=[300.0] * 150)
  dev = {"memory_peak_bytes": 1_915_469_824}
  for w in bench()["workloads"]:
    cell = spec.load_cell(w["name"])
    got = harness.end_to_end(win, cell.kind.RATE, dev)
    assert {m.name for m in cell.end_to_end} <= set(got), w["name"]
    assert got[cell.kind.RATE] == 8192 * 160 / 50.0
  assert got["memory_peak_gb"] == 1.915469824
  # a run with no device memory to read (the CPU) gives no memory metric
  assert "memory_peak_gb" not in harness.end_to_end(
      win, "r", {"memory_peak_bytes": 0})


def test_a_new_entry_needs_only_new_files(tmp_path):
  """A configuration with a new reference task, a traffic mix of a new
  kind, a cell's limits and a per-layer metric added as new files, with
  new entries: found with no file edited, and a whole run of the new cell
  is correct on the CPU."""
  root = tmp_path / "benchmark"
  for d in ("configs", "traffic", "limits", "metrics", "kinds",
            "reference/tasks"):
    shutil.copytree(os.path.join(BENCH, d), root / d,
                    ignore=shutil.ignore_patterns("__pycache__"))
  (root / "configs" / "throwaway.json").write_text(json.dumps(
      dict(spec.load_json(os.path.join(BENCH, "configs",
                                       "myohand_reach.json")),
           name="throwaway", task="throwaway_task")))
  (root / "reference" / "tasks" / "throwaway_task.py").write_text(
      "from benchmark.reference.tasks.reach import make  # noqa: F401\n")
  (root / "kinds" / "throwaway_kind.py").write_text(
      "from benchmark.kinds.step import *  # noqa: F401,F403\n"
      "RATE = 'throwaway_rate'\n")
  (root / "traffic" / "step6.json").write_text(json.dumps(
      {"kind": "throwaway_kind", "num_envs": 6, "rollout_steps": 2,
       "check_rows": 3, "profile_steps": 1}))
  (root / "limits" / "throwaway.step6.json").write_text(json.dumps(
      {"state_gap": 1e-6, "signal_gap": 1e-6}))
  (root / "metrics" / "throwaway_metric.step.py").write_text(
      "def read(ctx):\n  return 42.0\n")
  b = bench()
  b["configs"].append({"name": "throwaway", "source": "x",
                       "file": "benchmark/configs/throwaway.json",
                       "reduced": [], "why": "x"})
  b["workloads"].append({"name": "throwaway.step6", "config": "throwaway",
                         "traffic": "step6", "chips": 1, "why": "x"})
  b["end_to_end"].append({"name": "throwaway_rate", "unit": "env-steps/s",
                          "better": "higher", "bound": 0.25,
                          "source": "host_clock",
                          "workloads": ["throwaway.step6"]})
  b["per_layer"].append({"name": "throwaway_metric.step", "unit": "count",
                         "better": "lower", "source": "device_trace",
                         "layer": "device", "moves": "throwaway_rate",
                         "workloads": ["throwaway.step6"]})
  cell = spec.load_cell("throwaway.step6", b, root=str(root))
  assert cell.traffic["num_envs"] == 6
  assert cell.config["name"] == "throwaway"
  assert cell.kind.RATE == "throwaway_rate"
  assert {m.name for m in cell.end_to_end} == {"throwaway_rate", "setup_s"}
  assert [m.name for m in cell.per_layer] == ["throwaway_metric.step"]
  assert cell.per_layer[0].reader().read(None) == 42.0
  torch.set_num_threads(2)
  out = json.loads(harness.run(cell, SEED, 1.0, False, torch.device("cpu"),
                               time.perf_counter(), log=lambda s: None))
  assert out["correct"] is True, out["checked"]
  assert set(out["metrics"]) == {"throwaway_rate", "setup_s"}
  # the cells already there are unchanged
  assert spec.load_cell("hand_reach.step8192", b).traffic == spec.load_cell(
      "hand_reach.step8192").traffic


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
  base = harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, "myosuite_tpu_torch_like", object())
  monkeypatch.setitem(sys.modules, "jaxfoo", object())
  assert harness.forbidden_modules() == base
  monkeypatch.setitem(sys.modules, "myosuite_tpu.envs", object())
  monkeypatch.setitem(sys.modules, "jax.numpy", object())
  assert harness.forbidden_modules() == sorted(set(base) | {
      "jax", "myosuite_tpu"})


def _imports(path):
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_nothing_of_the_program():
  for dirpath, _, files in os.walk(BENCH):
    for f in files:
      if not f.endswith(".py"):
        continue
      path = os.path.join(dirpath, f)
      tops = {m.split(".")[0] for m in _imports(path)}
      assert not tops & set(harness.FORBIDDEN), path
      if os.sep + "reference" in path:
        assert "myosuite_tpu_torch" not in tops, path


def test_the_reference_runs_without_the_program():
  code = (
      "import sys; sys.path.insert(0, %r)\n"
      "import torch\n"
      "from benchmark import spec\n"
      "from benchmark.reference.envs import make\n"
      "from benchmark.reference.train import ppo\n"
      "env = make(spec.load_json(%r), 'cpu')\n"
      "s = env.reset(torch.Generator().manual_seed(1), 2)\n"
      "s = env.step(s, torch.full((2, env.action_size), 0.5))\n"
      "tops = {k.split('.')[0] for k in sys.modules}\n"
      "print(sorted(tops & {'myosuite_tpu_torch', 'myosuite_tpu', 'jax',"
      " 'jaxlib', 'flax'}))\n") % (
          REPO, os.path.join(BENCH, "configs", "myohand_reach.json"))
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().splitlines()[-1] == "[]"


def test_result_line_keys_and_order():
  line = harness.format_result(
      True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
      {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
       "memory_peak_bytes": 123},
      {"state_gap": {"value": 0.0, "limit": 1e-6}},
      {"device_ops": [["k", 0.1]], "idle_gaps": [["env_get_obs", 0.2]]})
  out = json.loads(line)
  assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "checked"]
  assert out["checked"]["state_gap"] == {"value": 0.0, "limit": 1e-6}
  assert "breakdown" not in json.loads(harness.format_result(
      False, 1, 1, {}, {}, {}))


def test_a_run_without_a_card_fails_and_prints_no_result():
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
  out = subprocess.run(
      [sys.executable, "benchmark/run.py", "--workload", "hand_reach.step8192",
       "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
  assert out.returncode != 0
  assert out.stdout.strip() == ""
  assert "CUDA" in out.stderr


def test_run_refuses_a_checkout_without_the_program(tmp_path):
  shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
  shutil.copytree(BENCH, tmp_path / "benchmark",
                  ignore=shutil.ignore_patterns("__pycache__"))
  out = subprocess.run(
      [sys.executable, "benchmark/run.py", "--workload", "hand_reach.step8192",
       "--seed", "1", "--seconds", "1", "--trace", "0"],
      cwd=tmp_path, capture_output=True, text=True, timeout=300,
      env=dict(os.environ, PYTHONPATH=""))
  assert out.returncode != 0
  assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["hand_reach.step8192", "hand_die.step8192"])
def test_reference_agrees_with_the_program_on_the_cpu(name):
  """The frozen reference and the program's CPU path, at a tiny batch:
  every compared field equal."""
  cell = tiny(spec.load_cell(name))
  kind = cell.kind
  torch.set_num_threads(2)
  prog = kind.StepTraffic(cell, SEED, torch.device("cpu"))
  rows = []
  prog.rollout(3, on_step=lambda s: rows.append(
      kind.record_rows(s, prog.rows_dev)))
  record = {"rows": prog.rows, "rollout": 3, "program": torch.stack(rows)}
  ref = kind.reference_record(cell, SEED, torch.device("cpu"), record)
  assert torch.equal(record["program"], ref[0])
  assert kind.gaps(record, ref) == {"state_gap": 0.0, "signal_gap": 0.0}


def test_reference_ppo_agrees_with_the_program_on_the_cpu():
  cell = tiny(spec.load_cell("hand_reach.ppo8192"))
  kind = cell.kind
  _, _, rec = kind.ppo_setup(cell, SEED, torch.device("cpu"))
  ref = kind.reference_record(cell, SEED, torch.device("cpu"), {})
  assert kind.gaps(kind.host_record(rec), ref) == {
      "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


@pytest.mark.parametrize("name", ["hand_reach.step8192", "hand_die.step8192",
                                  "hand_reach.ppo8192"])
def test_a_whole_run_on_the_cpu_is_correct(name):
  """Every part of a run but the look for a card, at a tiny size: the
  window, the traced sub-window and its readers, the check."""
  cell = tiny(spec.load_cell(name))
  line = harness.run(cell, SEED, 2.0, True, torch.device("cpu"),
                     time.perf_counter(), log=lambda s: None)
  out = json.loads(line)
  assert out["correct"] is True
  assert set(out["checked"]) == set(cell.limits)
  assert out["attempted"] >= 1 and out["failed"] == 0
  for m in cell.per_layer:
    if m.name.startswith("window_rate."):
      assert out["metrics"][m.name]["value"] > 0


def test_the_newton_operation_count_and_bound():
  """`costs` by hand at small shapes: the bytes of one env's launch, and a
  bound that is the larger of operations over the FP32 peak and bytes over
  the memory bandwidth."""
  from benchmark import costs
  # qM 4, J 6, 4 row vectors 12, 3 + 4 dof vectors 14, row forces 3
  assert costs.bytes_per_env(2, 3) == 4 * (4 + 6 + 12 + 6 + 8 + 3)
  ops = costs.flops_per_env(2, 3, 6, 6, 1.0)
  assert ops > 0
  bound, got_ops, got_bytes = costs.bound_seconds(10, 2, 3, 6, 6, 1.0)
  assert (got_ops, got_bytes) == (10 * ops, 10 * costs.bytes_per_env(2, 3))
  assert bound == max(got_ops / costs.H100_FP32_FLOPS,
                      got_bytes / costs.H100_HBM_BYTES_PER_S)
  force = torch.tensor([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 3.0]])
  # every friction row (1), and each other row that pushes: 1 and 1
  assert costs.weighted_rows(force, 1) == 2.0
