"""Readings of the output check's numbers that its limits are set from.

  python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
      --modes program,control,half_batch,altered,unchanged

For each seed, at the cell's own size: the reference once, then each mode's
record held against it, one JSON line per (seed, mode) and a summary of
each number's largest reading under "program" and smallest under every
other mode. The modes:

- "program": the program as the timed path runs it (the PPO cell's first
  `check_steps` training steps; one whole rollout of the step protocol).
- "control": the reference in the program's place, in the nearest
  precision below the configuration's float32 that changes its arithmetic
  (the kind's `CONTROL`): TF32 matrix products in PPO, whose networks are
  the only matrix products on its path; the physics state rounded to
  bfloat16 after every substep in the step cells, whose physics has no
  matrix product for TF32 to change.
- faults planted in the program (the kind's `fault`): "unchanged", a step
  that returns its state unchanged; "half_batch", half of the batch left
  out; "altered", an answer altered where it is produced (the first entry
  of every env's observation, +1e-3); "exchange", over several ranks, the
  exchange between cards left out.

Runs on the card, a process per card where the traffic names `ranks`
(rank 0 spawns the others and prints); `--device cpu` runs it here at the
size the traffic file says, which only a test's small traffic makes
quick.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def fault(cell, mode: str):
  """The program with fault `mode` of the cell's traffic kind planted
  ("program" and "control": none)."""
  if mode in ("program", "control"):
    yield
  else:
    with cell.kind.fault(mode):
      yield


def program_record(cell, seed: int, device, mode: str, mesh=None
                   ) -> Dict[str, Any]:
  """The record that a run's timed path hands the check, under `mode`
  (on `mesh`, this rank's)."""
  with fault(cell, mode):
    return cell.kind.program_record(cell, seed, device, mesh)


def readings(cell, seeds, modes, device, log=print, mesh=None
             ) -> Dict[str, Any]:
  """{mode: {number: [reading per seed]}}; logs a line per reading. On a
  `mesh` of ranks, every rank calls this, and the reference is
  data-parallel over the same ranks."""
  import torch
  kind = cell.kind
  ranks = None if mesh is None else (mesh.rank, mesh.world_size)
  out: Dict[str, Dict[str, list]] = {}
  for seed in seeds:
    ref = None
    sample = kind.sample(cell, seed)
    for mode in modes:
      t0 = time.perf_counter()
      if mode == "control":
        rec = kind.control_record(cell, seed, device, sample, ranks)
      else:
        rec = program_record(cell, seed, device, mode, mesh)
      if ref is None:
        ref = kind.reference_record(cell, seed, device, sample, ranks=ranks)
      gaps = kind.gaps(rec, ref)
      for k, v in gaps.items():
        out.setdefault(mode, {}).setdefault(k, []).append(v)
      log(json.dumps({"seed": seed, "mode": mode, "gaps": gaps,
                      "seconds": round(time.perf_counter() - t0, 3)}))
      del rec
      if device.type == "cuda":
        torch.cuda.empty_cache()
  return out


def summary(out: Dict[str, Any]) -> Dict[str, Any]:
  """Each number's lower reading (the largest under "program") and the
  smallest reading of every other mode."""
  res: Dict[str, Any] = {}
  for mode, nums in out.items():
    for k, vals in nums.items():
      res.setdefault(k, {})[mode] = (max(vals) if mode == "program"
                                     else min(vals))
  return res


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", required=True)
  p.add_argument("--modes", default="program,control")
  p.add_argument("--device", default="cuda")
  # a rank of a cell over several cards, spawned by rank 0
  p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
  p.add_argument("--init", default=None, help=argparse.SUPPRESS)
  args = p.parse_args(argv)
  if REPO not in sys.path:
    sys.path.insert(0, REPO)
  import torch
  from benchmark import spec
  cell = spec.load_cell(args.workload)
  if args.device == "cuda" and not torch.cuda.is_available():
    print("no CUDA device", file=sys.stderr)
    return 2
  world = int(cell.traffic.get("ranks", 1))
  if world > 1 and args.init is None:
    from benchmark import run

    def rank0(init):
      args.init = init
      return rank_main(args, cell, world), None
    return run.launch(os.path.abspath(__file__), argv, world, rank0)[0]
  return rank_main(args, cell, world)


def rank_main(args, cell, world: int) -> int:
  """This process's readings; rank 0 prints them."""
  import torch
  from benchmark import harness
  device = torch.device(args.device, args.rank) if args.device == "cuda" \
      else torch.device(args.device)
  mesh = None
  if world > 1:
    if device.type == "cuda":
      torch.cuda.set_device(device)
    mesh = harness.join_mesh(device, args.rank, world, args.init)
  log = print if args.rank == 0 else (lambda s: None)
  out = readings(cell, [int(s) for s in args.seeds.split(",")],
                 args.modes.split(","), device, log, mesh)
  log(json.dumps({"workload": cell.name, "summary": summary(out)}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
