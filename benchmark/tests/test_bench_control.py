"""The output check fails what it must: the control (the reference in a
lower precision) and each fault planted in the program, through a whole
run but the look for a card. At a tiny size on the CPU; the TF32 control
changes only matrix products on the card, so its test is for the card.

On the card: `python -m pytest benchmark/tests -q -m cuda`; at the cells'
own size, `python3 benchmark/control.py` (its docstring).
"""

import json
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
  sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from benchmark import check, control, harness, spec  # noqa: E402
from test_bench_harness import SEED, tiny  # noqa: E402

FAULTS = ("unchanged", "half_batch", "altered")


@pytest.fixture
def cuda_device():
  """The card; skips off the card (TF32 changes matrix products only on a
  CUDA card)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["hand_reach.step8192", "hand_die.step8192",
                                  "hand_reach.ppo8192"])
def test_a_run_with_a_fault_in_the_timed_path_is_not_correct(name, fault):
  cell = tiny(spec.load_cell(name))
  with control.fault(cell, fault):
    line = harness.run(cell, SEED, 2.0, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda s: None)
  out = json.loads(line)
  assert out["correct"] is False, out["checked"]


def test_the_bf16_state_control_fails_the_step_check():
  cell = tiny(spec.load_cell("hand_reach.step8192"))
  out = control.readings(cell, [SEED], ["program", "control"],
                         torch.device("cpu"), log=lambda s: None)
  assert all(v == [0.0] for v in out["program"].values())
  assert any(v[0] > cell.limits[k] for k, v in out["control"].items())


@pytest.mark.cuda
def test_the_tf32_control_fails_the_ppo_check(cuda_device):
  cell = tiny(spec.load_cell("hand_reach.ppo8192"), n=256)
  out = control.readings(cell, [SEED], ["program", "control"], cuda_device,
                         log=lambda s: None)
  assert all(v[0] <= cell.limits[k] for k, v in out["program"].items())
  assert any(v[0] > cell.limits[k] for k, v in out["control"].items())


RANK_CODE = """
import json, sys, time, contextlib
sys.path.insert(0, {repo!r}); sys.path.insert(0, {here!r})
import torch
torch.set_num_threads(1)
from benchmark import control, harness, spec
from test_bench_harness import tiny
cell = tiny(spec.load_cell("hand_reach.ppo8192"), n=8)
cell.traffic["ranks"] = 2
cell.limits = dict(cell.limits, replica_gap=0.0)
fault = {fault!r}
with (control.fault(cell, fault) if fault else contextlib.nullcontext()):
  line = harness.run(cell, {seed}, 1.0, False, torch.device("cpu"),
                     time.perf_counter(), log=lambda s: None,
                     rank={rank}, init={init!r})
print(line)
"""


@pytest.mark.parametrize("fault", [None, "exchange"])
def test_data_parallel_ppo_over_two_ranks(tmp_path, fault):
  """Data-parallel PPO as the four-card cell runs it, over two gloo ranks
  on the CPU: sound, every number 0 and the learners replicated; with the
  exchange between ranks left out, not correct."""
  import subprocess
  init = "file://" + str(tmp_path / "rendezvous")
  procs = [subprocess.Popen(
      [sys.executable, "-c", RANK_CODE.format(
          repo=REPO, here=HERE, fault=fault, seed=SEED, rank=r, init=init)],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
      for r in range(2)]
  outs = [p.communicate(timeout=600) for p in procs]
  assert all(p.returncode == 0 for p in procs), outs
  out = json.loads(outs[0][0].strip().splitlines()[-1])
  assert outs[1][0].strip() == ""
  assert out["device"]["count"] == 1
  if fault is None:
    assert out["correct"] is True
    assert all(c["value"] == 0.0 for c in out["checked"].values())
    assert "replica_gap" in out["checked"]
  else:
    assert out["correct"] is False
