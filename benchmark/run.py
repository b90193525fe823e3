"""Run one cell of BENCHMARK.json on this machine's NVIDIA cards.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Prints progress and the numbers compared (each beside its limit) on
standard error, and one JSON line as the last line of standard output.
Exits with a code other than 0, and prints no result, where CUDA is not
available or has fewer cards than the cell asks for, or where a module of
JAX, flax or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  # a rank of a cell over several cards, spawned by rank 0
  p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
  p.add_argument("--init", default=None, help=argparse.SUPPRESS)
  args = p.parse_args(argv)
  if REPO not in sys.path:
    sys.path.insert(0, REPO)
  from benchmark import spec
  cell = spec.load_cell(args.workload)
  import torch
  if not torch.cuda.is_available():
    print("no CUDA device: this benchmark runs on the card only",
          file=sys.stderr)
    return 2
  if torch.cuda.device_count() < cell.chips:
    print(f"{cell.name} needs {cell.chips} cards, "
          f"{torch.cuda.device_count()} found", file=sys.stderr)
    return 2
  ranks = int(cell.traffic.get("ranks", 1))
  if ranks > 1 and args.init is None:
    def rank0(init):
      args.init = init
      return run_rank(args, cell)
    rc, line = launch(os.path.abspath(__file__), argv, ranks, rank0)
  else:
    rc, line = run_rank(args, cell)
  if rc == 0 and line:
    sys.stderr.flush()
    print(line, flush=True)
  return rc


def run_rank(args, cell):
  """(exit code, result line) of this process's rank of the cell."""
  import torch
  from benchmark import harness
  line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", args.rank), T0, rank=args.rank,
                     init=args.init)
  return (3, None) if line is None else (0, line)


def launch(script: str, argv, ranks: int, rank0):
  """Rank 0 of a run over `ranks` cards: spawn ranks 1.. as processes of
  `script` with `argv` and `--rank r --init <rendezvous>` (their output to
  files in a temporary directory, which also holds the rendezvous file),
  run `rank0(init)` here, which returns (exit code, result), and wait for
  every rank; the result stands only where every rank ended well."""
  import shutil
  import subprocess
  import tempfile
  argv = list(sys.argv[1:] if argv is None else argv)
  tmp = tempfile.mkdtemp(prefix="bench-ranks-")
  init = "file://" + os.path.join(tmp, "rendezvous")
  procs, logs = [], []
  try:
    for r in range(1, ranks):
      logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w"))
      procs.append(subprocess.Popen(
          [sys.executable, script, *argv, "--rank", str(r), "--init", init],
          stdout=subprocess.DEVNULL, stderr=logs[-1]))
    rc, out = rank0(init)
    for r, proc in enumerate(procs, 1):
      try:
        proc.wait(timeout=120)
      except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
      if proc.returncode != 0:
        logs[r - 1].flush()
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
          print(f"rank {r} exited {proc.returncode}:\n{f.read()[-4000:]}",
                file=sys.stderr)
        rc = rc or 4
    return rc, out
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    for f in logs:
      f.close()
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
  sys.exit(main())
