"""The "step" traffic kind: MyoSuite's simulator protocol on the bare env.

One seeded reset batch of `num_envs`; rollouts of `rollout_steps` control
steps with uniform [0, 1) actions, each restarted from that reset state,
until the window ends. Rollout r draws its actions and the task's goal
redraws from streams seeded from (seed, r), so any rollout can be
replayed. Set-up warms up with the first WARMUP_STEPS control steps of a
rollout: every control step has the same shapes.

The check: one whole rollout of the window, drawn from the seed, at
`check_rows` env rows drawn from the seed. The reference steps those rows
alone from its own reset of the same draws (each draw is made at the full
batch and the sampled rows kept, as the program drew it) under the same
actions, and every control step's observation, reward, done flag and
physics state (qpos, qvel, act) is compared. `state_gap` is the widest gap
of qpos, qvel and act, `signal_gap` that of the observation and the
reward, each as a share of the largest magnitude that the reference's
field reaches; a done flag that differs anywhere makes `signal_gap` 1.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, List

import torch

from benchmark import check, harness, tracing
from benchmark.check import NOT_FINITE, sub_seed
from benchmark.spec import Cell

RATE = "env_steps_per_s"
NUMBERS = ("state_gap", "signal_gap")
# the reference in the nearest precision below the configuration's float32
# that changes its arithmetic: the physics has no matrix product for TF32
# to change, so the state is rounded to bfloat16 after every substep
CONTROL = "bf16_state"
FAULTS = ("unchanged", "half_batch", "altered")
WARMUP_STEPS = 2


def record_rows(s, rows: torch.Tensor) -> torch.Tensor:
  """What the check compares of a control step, at `rows`: observation,
  qpos, qvel, act, reward, done."""
  d = s.data
  return torch.cat([s.obs["state"], d.qpos, d.qvel, d.act,
                    s.reward[:, None], s.done[:, None]], -1)[rows]


class StepTraffic:
  """The program's bare env under the step protocol."""

  def __init__(self, cell: Cell, seed: int, device: torch.device):
    import myosuite_tpu_torch
    t = cell.traffic
    self.seed, self.device = seed, device
    self.n, self.steps = int(t["num_envs"]), int(t["rollout_steps"])
    self.env = myosuite_tpu_torch.make(cell.config["env_id"], device)
    self.gen = torch.Generator(device=device)
    self.gen.manual_seed(sub_seed(seed, "reset"))
    self.state0 = self.env.reset(self.gen, self.n)
    self.act_gen = torch.Generator(device=device)
    self.rows = check.sample_rows(seed, self.n, int(t["check_rows"]))
    self.rows_dev = self.rows.to(device)
    self.bad = torch.zeros((), dtype=torch.int64, device=device)

  def rollout(self, r, stop: Callable[[], bool] = lambda: False,
              on_step: Callable[[Any], None] = lambda s: None,
              labelled: bool = False) -> int:
    """Rollout r from the reset state; returns the control steps taken
    (fewer than `steps` where `stop` said so after a step). `labelled`
    names each control step as a host span."""
    self.gen.manual_seed(sub_seed(self.seed, f"goal/{r}"))
    self.act_gen.manual_seed(sub_seed(self.seed, f"act/{r}"))
    s = self.state0
    for t in range(self.steps):
      with (tracing.label("control_step") if labelled
            else contextlib.nullcontext()):
        a = torch.rand((self.n, self.env.action_size),
                       generator=self.act_gen, device=self.device)
        s = self.env.step(s, a)
      on_step(s)
      if stop():
        return t + 1
    return self.steps


def after(k: int) -> Callable[[], bool]:
  """A `stop` that says so after its k-th call."""
  calls = []
  return lambda: calls.append(1) or len(calls) >= k


def drive(cell: Cell, seed: int, seconds: float, trace: bool,
          device: torch.device, t0: float, ctx) -> harness.Window:
  prog = StepTraffic(cell, seed, device)
  ctx.env = prog.env
  ctx.mark("program import, make and reset")
  prog.rollout("warmup", after(WARMUP_STEPS))
  ctx.mark(f"warm-up, {WARMUP_STEPS} control steps")
  win = harness.Window()
  if trace:
    harness.install_readers(ctx)
  recorded: Dict[Any, List[torch.Tensor]] = {}
  ends: List[torch.cuda.Event] = []
  timing = device.type == "cuda"

  def on_step(s, r):
    recorded.setdefault(r, []).append(record_rows(s, prog.rows_dev))
    prog.bad += (~torch.isfinite(s.obs["state"]).all(-1)).sum()
    if timing:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      ends.append(ev)

  tracing.sync(device)
  start = time.perf_counter()
  win.setup_s = start - t0
  deadline = start + seconds
  stop = lambda: time.perf_counter() >= deadline
  r, steps, complete = 0, 0, []
  while True:
    n = prog.rollout(r, stop, lambda s, r=r: on_step(s, r))
    steps += n
    if n == prog.steps:
      complete.append(r)
    if stop():
      break
    r += 1
  tracing.sync(device)
  win.window_s = time.perf_counter() - start
  win.env_steps = steps * prog.n
  win.attempted, win.failed = steps * prog.n, int(prog.bad)
  win.step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
  # the sample the check compares: one whole rollout, drawn from the seed
  pick = complete[check.pick_index(seed, len(complete))] if complete else None
  win.record = {"rows": prog.rows, "rollout": pick,
                "program": (torch.stack(recorded[pick]).cpu()
                            if pick is not None else None)}
  recorded.clear()
  if trace:
    harness.span_stages(ctx, prog.env)
    ctx.profile = tracing.Profile(device)
    # the first `profile_steps` control steps of a rollout
    k = int(cell.traffic["profile_steps"])
    ctx.profile.run(lambda: prog.rollout("profile", after(k), labelled=True))
    ctx.profiled_substeps = k * prog.env._n_substeps
  return win


# -- the check ----------------------------------------------------------------

def sample(cell: Cell, seed: int) -> Dict[str, Any]:
  """What the check compares where a run is read outside the window:
  rollout 0 at the seed's rows."""
  t = cell.traffic
  return {"rows": check.sample_rows(seed, int(t["num_envs"]),
                                    int(t["check_rows"])), "rollout": 0}


def reference_record(cell: Cell, seed: int, device: torch.device, record,
                     mode: str = "fp32", ranks=None):
  """(steps, rows, features) of the reference over the record's rollout
  at its rows, in the program's record layout, and (nq, nv, na); None
  where the window completed no rollout."""
  from benchmark.reference.envs import make
  if record["rollout"] is None:
    return None
  t = cell.traffic
  n = int(t["num_envs"])
  rows = record["rows"]
  with check.precision(mode), torch.no_grad():
    env = make(cell.config, device, cell.root)
    rows_dev = rows.to(device)
    env.sample_rows, env.sample_of = rows_dev, n
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "reset"))
    s = env.reset(gen, len(rows))
    gen.manual_seed(sub_seed(seed, f"goal/{record['rollout']}"))
    act_gen = torch.Generator(device=device)
    act_gen.manual_seed(sub_seed(seed, f"act/{record['rollout']}"))
    out = []
    for _ in range(int(t["rollout_steps"])):
      a = torch.rand((n, env.action_size), generator=act_gen,
                     device=device)[rows_dev]
      s = env.step(s, a)
      out.append(record_rows(s, slice(None)))
    m = env.model
    return torch.stack(out).cpu(), (m.nq, m.nv, m.na)


def control_record(cell: Cell, seed: int, device: torch.device, record,
                   ranks=None) -> Dict[str, Any]:
  """The control in the program's place: the reference in CONTROL."""
  return {"program": reference_record(cell, seed, device, record,
                                      CONTROL)[0]}


def _field_gap(p: torch.Tensor, r: torch.Tensor) -> float:
  scale = float(r.abs().max()) if r.numel() else 0.0
  gap = float((p - r).abs().max()) if r.numel() else 0.0
  if not math.isfinite(gap) or not math.isfinite(scale):
    return NOT_FINITE
  return gap / max(scale, 1e-30) if gap else 0.0


def gaps(record: Dict[str, Any], ref) -> Dict[str, float]:
  """The numbers compared, of the program's record against the
  reference's."""
  program = record["program"]
  if ref is None or program is None or program.shape != ref[0].shape:
    return {k: NOT_FINITE for k in NUMBERS}
  ref, (nq, nv, na) = ref
  f = ref.shape[-1]
  n_obs = f - nq - nv - na - 2
  cuts = [0, n_obs, n_obs + nq, n_obs + nq + nv, n_obs + nq + nv + na,
          f - 1, f]
  p = [program[..., a:b] for a, b in zip(cuts, cuts[1:])]
  r = [ref[..., a:b] for a, b in zip(cuts, cuts[1:])]
  state = max(_field_gap(p[i], r[i]) for i in (1, 2, 3))
  signal = max(_field_gap(p[i], r[i]) for i in (0, 4))
  if not torch.equal(p[5], r[5]):
    signal = max(signal, 1.0)
  return {"state_gap": state, "signal_gap": signal}


# -- faults planted in the program ----------------------------------------------

@contextlib.contextmanager
def fault(mode: str):
  """The program with fault `mode` planted: "unchanged", a step that
  returns its state unchanged; "half_batch", rows in the second half of
  the batch not stepped; "altered", the first entry of every env's
  observation +1e-3 where the step produces it."""
  from myosuite_tpu_torch.envs import base, wrappers
  step = base.MyoEnv.step
  if mode == "unchanged":
    new = lambda self, state, action: state
  elif mode == "half_batch":
    def new(self, state, action):
      out = step(self, state, action)
      keep = torch.arange(out.reward.shape[0], device=out.reward.device
                          ) < out.reward.shape[0] // 2
      pick = lambda a, b: wrappers._pick(keep, a, b)
      return out.replace(
          data=wrappers._pick_fields(keep, out.data, state.data),
          obs={k: pick(v, state.obs[k]) for k, v in out.obs.items()},
          reward=pick(out.reward, state.reward),
          done=pick(out.done, state.done))
  elif mode == "altered":
    def new(self, state, action):
      out = step(self, state, action)
      obs = out.obs["state"].clone()
      obs[:, 0] += 1e-3
      return out.replace(obs={**out.obs, "state": obs})
  else:
    raise ValueError(f"no fault {mode!r} of the step protocol")
  with harness.patched(base.MyoEnv, "step", new):
    yield


def program_record(cell: Cell, seed: int, device: torch.device,
                   mesh=None) -> Dict[str, Any]:
  """What a run's timed path hands the check, of rollout 0."""
  prog = StepTraffic(cell, seed, device)
  rows = []
  prog.rollout(0, on_step=lambda s: rows.append(record_rows(s,
                                                            prog.rows_dev)))
  return {"rows": prog.rows, "rollout": 0,
          "program": torch.stack(rows).cpu()}
