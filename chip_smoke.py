"""Smoke test of the PyTorch port on one CUDA card: python3 chip_smoke.py

Builds the port's CUDA kernels from myosuite_tpu_torch/csrc, holds the warp
kernel against its plain PyTorch version on the card, drives the main path
(MtxHandReachRandom-v0, reset + 16 control steps at batch 4096) and checks
that every substep's solve went through the kernel, prints the kernel's
occupancy and its split by phase (from a second, clock-stamped build),
replays the golden trajectory of the JAX package, trains the hand with PPO
at its default config (4096 envs; 1 timed training step, a checkpoint
round trip) and shows PPO learning the elbow pose task. Phase 7 drives
contacts: MtxLegWalk-v0 at batch 4096 (16 timed control steps, its
profile, the kernel against its plain version at the leg's own solver
inputs, the leg golden trajectories), MtxLegWalkRough-v0 with a terrain
per env, and one timed PPO training step on the leg. Phase 8 drives the
five in-hand manipulation envs at batch 4096 (4 timed control steps
each, the kernel against its plain version at each env's own inputs,
occupancy, golden replays) and one timed PPO training step on
MtxHandObjHoldRandom-v0. Phase 9 drives the muscle conditions and the
rest of myobase at batch 4096: the torso (nv 18), the arm reach (nv 7) and
the arm pose (nv 27), an ASL posture, the reafferented hand, and the hand
under sarcopenia and fatigue (4 timed control steps each, the kernel
against its plain version at each env's own inputs), the sarcopenia
forces, the plain and the Fati hand in turns, the fatigue state's
conservation, growth and auto-reset, one timed PPO training step on
MtxFatiHandReachRandom-v0 and the myobase golden replays. Phase 10
drives per-env models, tracking and MyoDM at batch 4096: the elbow with a
payload and an exo torque, SAR's Reorient100 (a capsule per env), the
hand's and finger's cyclic tracks and one MyoDM id per object class
(sphere, box hull, cylinder hull, capsule) plus a Random object target (2
timed control steps each, the kernel against its plain version at each
env's own per-env inputs), Reorient100 against PenTwirl in pairs of turns,
the tracking golden replays, the per-env model check (two geometries in
one batch, each env bit-equal to a batch-1 run) and one timed PPO
training step on
MtxHandReorient100-v0, then phase 10's seconds by part. Phase 11 drives
the seven MyoChallenge ids at batch 4096: ChaseTag (chase and evade) with
its scripted opponent on a patch arena, Soccer with its goalkeeper,
RunTrack with the OSL controller, Relocate (a per-env object), Bimanual
and TableTennis (2 timed control steps each, the kernel against its plain
version at each env's own inputs), the OSL's phases, ChaseTag and Soccer
through the auto-reset (a done env's opponent or keeper fresh), the
challenge golden replays and one timed PPO training step on
MtxRunTrack-v0, whose policy commands nu - 2 actuators. Phase 12 drives
the other trainers and the agents: SAC and NPG at their default configs
on MtxHandReachRandom-v0 (SAC's collection epochs up to learning_starts,
then 2 timed epochs with updates; NPG one timed iteration),
the five shipped pretrained policies restored from their .pt files in
deterministic evals at batch 4096 against the JAX package's own eval
(assets/pretrained_golden.npz), the closed-loop goldens of the elbow and
the stand, the kernel against its plain version at the trained stand
policy's states, and the reflex controller's 50-step rollout of the walk
(its stimulations against the CPU controller's). Phase 13 drives the
scale-out and the user tools: a distributed PPO training step of the hand
over NCCL at world size 1 (bit-equal to the plain rollout and update fed
copies of the rank's generators), two gloo ranks on the one card with 2048
envs each (bit-identical learners, each bit-equal to the single-rank update
of the gathered trajectory), the robot layer and inverse kinematics at
batch 4096 against the CPU, a 4096-env rollout through the native trace
sink and examine_env on the shipped elbow policy. Phase 14 drives C5 and
the renderer: the C5 gate (sub-batches of the hand and of Reorient100
stepped alone, bit-equal to their rows of the batch), the hand's 4096
envs drawn (rgb, depth, segmentation at 64 x 64) after 20 Newton
launches, those frames and the rough leg's and the die's against the CPU
port's, a row drawn alone against its row, VisualObs's ResNet-18
features against the CPU and the rendering tools. Phase 15 drives what
the card runs of the model build: the MJCF builders' length-range sweep
of every committed model file (its 64 joint samples as one batch through
the port's kinematics, tendon and transmission on the card, held against
the file's ranges; the two edited arm files by muscle name), the host
path helpers on examine_env's device paths, and the builders and the
model_xml route where MuJoCo cannot be imported. Phase 16 drives the
Newton solve's wide route (csrc/newton_solver_wide.cu, for nv > 40 or rows
past the warp kernel's shared memory): the wide kernel bit-equal to its
plain version on newton_kernel.WIDE_EDGE_CASES (nv 41-256, up to 1,200
rows, in shared memory and in its device-memory workspace) and, called
directly, on WIDE_FINISH_CASES (nv 17, 18 and 19, around its factor's
warp finish), the Relocate scene with two more loose spheres (nv 45, nefc 375)
through make(..., overrides={"model_xml": ...}) at batch 4096 (10 wide
launches and no warp launch per control step, the kernel at the scene's
inputs with its bound, phase split, blocks per SM, the resource that
limits them, its waves and the shared-memory carveout its launch sets,
read back, and timed in turns against the largest split and the
CUDA runtime's default; the golden replay of assets/wide_golden.npz),
and both kernels at Bimanual's and Relocate's inputs, bit-equal and timed
in turns. Prints one JSON line of kernel numbers (with a
`shapes` list per env and (nv, nefc)) and, last,
{"ok": true, "device": {...}}. Exits non-zero, with no result line,
when any phase fails or when there is no CUDA card.

  python3 chip_smoke.py --parent DIR

also times the Newton kernel of another checkout DIR (one whose wrapper has
the same C interface) against this one in turns (DIR, this, this, DIR):
per launch, and per control step of the main path with DIR's kernel
swapped in, and prints DIR's phase split; phase 14 then also times DIR's
bare hand control step, and counts its launches per substep, against
this checkout's in turns, each in a process of its own; phase 16 builds
DIR's wide kernel and times it against this one in turns at the cluttered
Relocate's and Bimanual's inputs, which must be bit-equal.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH = 4096
STEPS = 16               # bench.py's protocol: 16 control steps
PPO_STEPS = 1            # timed PPO training steps (phase 5)
LEG_PPO_STEPS = 1        # timed PPO training steps on the leg (phase 7)
ROUGH_STEPS = 2          # control steps on terrain (phase 7)
MANIP_STEPS = 2          # control steps of each manipulation env (phase 8)
# phase 8: each model file's env at batch 4096, and its golden env (a Fixed
# id, or fixed_target=True)
MANIP = (("hold", "MtxHandObjHoldRandom-v0", "MtxHandObjHoldFixed-v0", None),
         ("die", "MtxHandDieReorient-v0", "MtxHandDieReorient-v0",
          {"fixed_target": True}),
         ("pen", "MtxHandPenTwirlRandom-v0", "MtxHandPenTwirlFixed-v0", None),
         ("baoding", "MtxHandBaoding-v0", "MtxHandBaoding-v0",
          {"fixed_target": True}),
         ("key", "MtxHandKeyTurnRandom-v0", "MtxHandKeyTurnFixed-v0", None))
MYOBASE_STEPS = 4        # control steps of each env of phase 9
TURN_PAIRS = 2           # phase 9: pairs of plain / Fati hand turns
TURN_STEPS = 4           # control steps a turn
# phase 9: the envs at batch 4096 (the first three are the new models)
MYOBASE = (("torso", "MtxTorsoPoseRandom-v0"),
           ("armreach", "MtxArmReachRandom-v0"),
           ("armpose", "MtxArmPoseRandom-v0"),
           ("asl", "MtxHandPose3Fixed-v0"),
           ("reaf", "MtxReafHandPoseRandom-v0"),
           ("sarc", "MtxSarcHandReachRandom-v0"),
           ("fati", "MtxFatiHandReachRandom-v0"))
NEW_MODELS = ("torso", "armreach", "armpose")
# the myobase golden file's envs: tag -> (id, overrides, supplied target),
# as tests/test_torch_conditions.py::GOLDEN_ENVS writes them
MYOBASE_GOLDEN = {
    "torso": ("MtxTorsoPoseFixed-v0", {"reset_type": "none"}, False),
    "armreach": ("MtxArmReachFixed-v0", None, False),
    "armpose": ("MtxArmPoseRandom-v0", {"reset_type": "none"}, True),
    "asl": ("MtxHandPose3Fixed-v0", {"reset_type": "none"}, False),
    "sarc": ("MtxSarcHandReachFixed-v0", None, False),
    "reaf": ("MtxReafHandPoseRandom-v0", {"reset_type": "none"}, True),
    "fati": ("MtxFatiHandReachFixed-v0", None, False)}
TRACK_STEPS = 2          # control steps of each env of phase 10
SAR_PAIRS = 2            # phase 10: pairs of PenTwirl / Reorient100 turns
SAR_TURN_STEPS = 3       # control steps a turn
# phase 10: per-env models, tracking and MyoDM at batch 4096 (tag, id)
TRACKING = (("exo", "MtxElbowPoseExoRandom-v0"),
            ("reorient100", "MtxHandReorient100-v0"),
            ("hand_track", "MtxHandTrackCyclic-v0"),
            ("finger_track", "MtxFingerTrackCyclic-v0"),
            ("apple_lift", "MtxHandAppleLift-v0"),          # sphere
            ("airplane_lift", "MtxHandAirplaneLift-v0"),    # box hull
            ("mug_lift", "MtxHandMugLift-v0"),              # cylinder hull
            ("flute_pass", "MtxHandFlutePass-v0"),          # capsule
            ("apple_random", "MtxHandAppleRandom-v0"))
# the tracking golden file's envs: tag -> (id, overrides), as
# tests/test_torch_tracking.py::GOLDEN_ENVS writes them; the info entries
# supplied before each step are stored as "<tag>_info_<key>"
TRACKING_GOLDEN = {tag: (name, {"reset_type": "none"} if tag == "exo"
                         else None) for tag, name in TRACKING}
CHAL_STEPS = 2           # control steps of each env of phase 11
RESET_STEPS = 2          # phase 11: control steps through the auto-reset
# phase 11: the MyoChallenge envs at batch 4096 (tag, id); the tags are
# tests/test_torch_challenge.py::IDS's, which wrote the golden file
CHALLENGE = (("chasetag", "MtxChaseTag-v0"),
             ("evade", "MtxChaseTagEvade-v0"),
             ("soccer", "MtxSoccer-v0"),
             ("runtrack", "MtxRunTrack-v0"),
             ("relocate", "MtxRelocate-v0"),
             ("bimanual", "MtxBimanual-v0"),
             ("tabletennis", "MtxTableTennis-v0"))
# Kernel vs plain version, on every output: |ours - ref| <= TOL |ref| +
# TOL max(1, max |ref|). The plain version sums in the kernel's order and the
# kernel is built without multiply-add contraction, so most outputs agree
# to the last bit.
TOL = 1e-4
FP32_FLOPS = 67e12       # H100 SXM, FP32 outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s


def compare(name, ours, ref, tol):
  """|ours - ref| <= tol |ref| + tol max(1, max |ref|) for every output.
  Returns the max abs error."""
  worst_abs = 0.0
  for o, r, out in zip(ours, ref, ("qacc", "qfrc", "force", "a_smooth",
                                   "qacc_euler")):
    same = float((o == r).double().mean())
    o, r = o.double(), r.double()
    scale = max(1.0, float(r.abs().max()))
    err = (o - r).abs()
    ok = bool((err <= tol * r.abs() + tol * scale).all())
    ok = ok and bool(torch.isfinite(o).all())
    print(f"  {name} {out}: max_abs_err {float(err.max()):.3e} "
          f"max_rel_err {float(err.max()) / scale:.3e} (scale {scale:.3e}, "
          f"tol {tol:g}) bit-equal {same:.4f} ok {ok}")
    if not ok:
      raise AssertionError(f"kernel disagrees with its plain version: "
                           f"{name} {out}")
    worst_abs = max(worst_abs, float(err.max()))
  return worst_abs


def cuda_ms(fn, n):
  """Mean milliseconds per call of fn over n calls, by CUDA events."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


class Stopwatch:
  """Seconds of host clock spent in each labelled part of a phase, the card
  synchronized at each part's end; `report` prints them."""

  def __init__(self):
    self.seconds = {}

  @contextlib.contextmanager
  def part(self, label):
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    self.seconds[label] = (self.seconds.get(label, 0.0)
                           + time.perf_counter() - t0)

  def report(self, phase):
    total = sum(self.seconds.values())
    print(f"  {phase} seconds by part ({total:.1f} s in all): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(self.seconds.items(),
                                          key=lambda kv: -kv[1])))


def phase_split(label, cycles, phases, per="warp"):
  """Print mean clock cycles per env (one warp, or one block of the wide
  kernel) of each phase."""
  mean = cycles.double().mean(0)
  total = float(mean.sum())
  print(f"  phase split, {label}: {total:.0f} cycles per {per}")
  for name, c in zip(phases, mean.tolist()):
    print(f"    {name:14s} {c:10.0f} cycles  {c / total:6.3f}")


def load_parent(path):
  """The Newton-kernel module of the checkout at `path`."""
  spec = importlib.util.spec_from_file_location(
      "parent_newton_kernel",
      os.path.join(path, "myosuite_tpu_torch", "physics", "newton_kernel.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def control_steps(env, state, gen, n):
  """ms per control step over n steps (host clock between two syncs)."""
  dev = state.obs["state"].device
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(n):
    state = env.step(state, torch.rand(BATCH, env.action_size,
                                       generator=gen, device=dev))
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / n * 1e3, state


def profile_call(fn, sync=torch.cuda.synchronize):
  """fn() under torch.profiler: (device-busy ms, wall ms, kernel launches,
  the five costliest kernels as (name, ms, calls)). Only the card's
  activity is traced (the host's where there is no card, for a rehearsal
  on the CPU): the host's op events of a control step (tens of thousands)
  took ~15 s each to process, and no number here reads them."""
  from torch.profiler import ProfilerActivity, profile
  sync()
  with profile(activities=[ProfilerActivity.CUDA
                           if torch.cuda.is_available()
                           else ProfilerActivity.CPU]) as prof:
    t0 = time.perf_counter()
    fn()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
  busy, launches, top = device_kernels(prof)
  if torch.cuda.is_available() and not launches:
    raise AssertionError("the profiler saw no kernel on the card")
  return busy, wall, launches, top


def device_kernels(prof):
  """(device-busy ms, kernel launches, the five costliest kernels as
  (name, ms, calls)) of a finished profile, summed over its raw events:
  `prof.key_averages()` gives the same numbers but first builds a Python
  event per launch, seconds for the 10,000-50,000 launches of a control
  step."""
  by_name = {}
  for e in prof.profiler.kineto_results.events():
    if e.device_type() == torch.autograd.DeviceType.CUDA:
      ns, n = by_name.get(e.name(), (0, 0))
      by_name[e.name()] = (ns + e.duration_ns(), n + 1)
  busy = sum(ns for ns, _ in by_name.values()) / 1e6
  launches = sum(n for _, n in by_name.values())
  top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
  return busy, launches, [(k[:60], ns / 1e6, n) for k, (ns, n) in top]


def step_profile(env, state, action, step_ms):
  """One control step under the profiler, printed with its launches per
  substep and the idle share of an unprofiled step of `step_ms`; returns
  (device-busy ms, launches)."""
  busy, prof_wall, n_launch, top = profile_call(
      lambda: env.step(state, action))
  print(f"  profile of one control step: device busy {busy:.2f} ms "
        f"({prof_wall:.2f} ms wall under the profiler), {n_launch} kernel "
        f"launches ({n_launch / env._n_substeps:.0f} per substep); idle "
        f"share of the unprofiled step {max(0.0, 1.0 - busy / step_ms):.3f}")
  for name, ms_k, n in top:
    print(f"    {ms_k:.3f} ms in {n} launches: {name}")
  return busy, n_launch


def contact_stages(m, d, step_ms, n_substeps):
  """`collision` and `make_efc` alone at the state d, by CUDA events;
  returns their ms per substep."""
  from myosuite_tpu_torch.physics import collision, constraint
  col_ms = cuda_ms(lambda: collision.collision(m, d), 20)
  efc_ms = cuda_ms(lambda: constraint.make_efc(m, d), 20)
  for stage, t in (("collision", col_ms), ("make_efc", efc_ms)):
    print(f"  {stage} alone: {t:.3f} ms per substep = "
          f"{n_substeps * t / step_ms:.3f} of a control step")
  return col_ms, efc_ms


def compare_parent(path, env, state, gen, args, kw, ours, few):
  """Time the kernel of the checkout at `path` against this one in turns
  (parent, this, this, parent): per launch on the main path's inputs (and
  at one block per SM), and per control step with each kernel swapped
  into the main path."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  parent = load_parent(path)
  plib = parent.load(parent.build()[0])
  phase_split(f"parent kernel, batch {BATCH}",
              parent.phase_cycles(*args, **kw), parent.PHASES)
  phase_split(f"parent kernel, batch {few[0].shape[0]}",
              parent.phase_cycles(*few, **kw), parent.PHASES)
  per_sm, epb = parent.occupancy(args[1].shape[2], args[1].shape[1], plib)
  print(f"  parent occupancy: {per_sm} blocks of {epb} envs per SM")
  libs = {"parent": plib, "this": nk._library()}
  nk._lib = plib
  same = all(torch.equal(a, b) for a, b in zip(nk.newton_solve(*args, **kw),
                                               ours))
  print(f"  parent kernel bit-equal to this one on the hand: {same}")
  for who in ("parent", "this", "this", "parent"):
    nk._lib = libs[who]
    ms = cuda_ms(lambda: nk.newton_solve(*args, **kw), 50)
    ms_few = cuda_ms(lambda: nk.newton_solve(*few, **kw), 50)
    control_steps(env, state, gen, 1)
    step_ms, state = control_steps(env, state, gen, STEPS)
    print(f"  turn {who}: {ms:.4f} ms per launch ({ms_few:.4f} at batch "
          f"{few[0].shape[0]}), {step_ms:.2f} ms per control step")
  nk._lib = libs["this"]


def kernel_numbers(label, args, kw, plain_ms=None):
  """The Newton kernel of the inputs' route against its plain version on
  one set of solver inputs (`compare` at TOL), its ms per launch, the
  plain version's ms (timed here unless `plain_ms` gives it, as measured
  at the same shape) and the bound from the cost model at the rows
  weighted at the solution."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  ours = nk.newton_solve(*args, **kw)
  ref = nk.newton_solve_reference(*args, **kw)
  max_abs = compare(label, ours, ref, TOL)
  ms = cuda_ms(lambda: nk.newton_solve(*args, **kw), 50)
  if plain_ms is None:
    plain_ms = cuda_ms(lambda: nk.newton_solve_reference(*args, **kw), 3)
  batch, nefc, nv = args[1].shape
  n_weighted = nk.weighted_rows(ours[2], kw["n_friction"])
  flops = batch * nk.flops_per_env(nv, nefc, kw["iterations"],
                                   kw["ls_iterations"], n_weighted)
  nbytes = batch * nk.bytes_per_env(nv, nefc)
  t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
  print(f"  newton_solver ({nk.route(nv, nefc)}), {label}: {ms:.4f} ms per "
        f"launch (plain version "
        f"{plain_ms:.3f} ms); work {flops:.3e} FP32 ops ({n_weighted:.2f} "
        f"of {nefc} rows weighted at the solution), {nbytes:.3e} bytes; "
        f"bound {max(t_ops, t_bytes):.4f} ms by {t_ops:.4f} ms of operations "
        f"and {t_bytes:.4f} ms of bytes")
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  if nk.route(nv, nefc) == "wide":
    per_sm, in_smem = nk.wide_occupancy(nv, nefc)
    epb = 1
    print(f"  occupancy: {per_sm} blocks of one env (128 threads) per SM, "
          f"the working set in {'shared' if in_smem else 'device'} memory; "
          f"{batch} blocks on {sms} SMs = {batch / (per_sm * sms):.3f} "
          f"waves")
  else:
    per_sm, epb = nk.occupancy(nv, nefc)
    blocks = -(-batch // epb)
    print(f"  occupancy: {per_sm} blocks of {epb} envs per SM "
          f"({per_sm * epb} warps), {blocks} blocks on {sms} SMs = "
          f"{blocks / (per_sm * sms):.3f} waves at batch {batch}")
  return dict(ours=ours, max_abs=max_abs, ms=ms, plain_ms=plain_ms,
              bound_ms=max(t_ops, t_bytes),
              bound_by="operations" if t_ops >= t_bytes else "bytes",
              epb=epb, blocks_per_sm=per_sm)


def ppo_phase(env, cfg, ckpt_dir, steps=PPO_STEPS):
  """PPO on `env` at `cfg`: one warm-up training step, then `steps` timed
  ones, each with its rollout / update split, Newton-kernel launches,
  losses and largest policy-parameter change; the auto-reset's cost; a
  checkpoint round trip into a fresh PPO; one deterministic policy call.
  Raises on any failed check; returns the numbers."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import checkpoint
  from myosuite_tpu_torch.train import ppo as ppo_mod
  dev = env.device
  sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
  trainer = ppo_mod.PPO(env, cfg)
  t0 = time.perf_counter()
  ts = trainer.init(torch.Generator(device=dev).manual_seed(cfg.seed))
  sync()
  print(f"  init at {cfg.num_envs} envs: {time.perf_counter() - t0:.2f} s")
  ts, _ = trainer.training_step(ts)   # warm-up
  sync()

  # the update's start and end, to split the step (a synchronize there)
  marks = []
  update = trainer._update_epoch

  def timed_update(*args, **kw):
    sync()
    marks.append(time.perf_counter())
    out = update(*args, **kw)
    sync()
    marks.append(time.perf_counter())
    return out

  trainer._update_epoch = timed_update
  per_step = cfg.unroll_length * cfg.num_envs
  want = cfg.unroll_length * env._n_substeps
  out = {"steps": []}
  for i in range(steps):
    before = {k: v.clone() for k, v in ts.policy_params.items()}
    marks.clear()
    sync()
    nk.launches = 0
    t0 = time.perf_counter()
    ts, metrics = trainer.training_step(ts)
    sync()
    t1 = time.perf_counter()
    launches = nk.launches
    m = {k: float(v) for k, v in metrics.items()}
    change = max(float((ts.policy_params[k] - v).abs().max())
                 for k, v in before.items())
    step = dict(rollout_ms=(marks[0] - t0) * 1e3,
                update_ms=(marks[1] - marks[0]) * 1e3,
                wall_ms=(t1 - t0) * 1e3, env_steps_per_s=per_step / (t1 - t0),
                launches=launches, max_param_change=change, **m)
    out["steps"].append(step)
    print(f"  training step {i}: rollout {step['rollout_ms']:.1f} ms, update "
          f"{step['update_ms']:.1f} ms, {step['wall_ms']:.1f} ms in all = "
          f"{step['env_steps_per_s']:.0f} training env-steps/s; Newton "
          f"launches {launches}; policy_loss {m['policy_loss']:.4g} "
          f"value_loss {m['value_loss']:.4g} entropy {m['entropy']:.4g} "
          f"reward_per_step {m['reward_per_step']:.4g}; largest policy "
          f"parameter change {change:.3e}")
    if launches != want:
      raise AssertionError(f"training step launched the kernel {launches} "
                           f"times, want {want}")
    if not all(np.isfinite(v) for v in m.values()):
      raise AssertionError(f"non-finite training metrics {m}")
    if not change > 0:
      raise AssertionError("the policy parameters did not change")
  trainer._update_epoch = update

  # where a training step's time goes: one control step of the wrapped env
  # (the auto-reset included) and one optimizer step on a minibatch of
  # this run's data, each under the profiler
  action = trainer.make_policy_fn(deterministic=False)(
      ts, ts.env_state.obs["state"], ts.generator)
  traj_ts, traj = trainer._rollout(ts)
  advs, rets = trainer._gae(traj_ts, traj, ts.obs_stats)
  mb = cfg.num_envs * cfg.unroll_length // cfg.num_minibatches
  batch = [x.reshape((-1,) + x.shape[2:])[:mb].contiguous()
           for x in (traj.obs, traj.raw_action, traj.log_prob, advs, rets)]
  for label, fn in (
      ("control step of the auto-reset env",
       lambda: trainer.env.step(ts.env_state, action)),
      (f"optimizer step on {mb} rows",
       lambda: trainer._minibatch_step(ts, batch, ts.obs_stats))):
    busy, wall, n_launch, top = profile_call(fn, sync)
    out[label] = dict(busy_ms=busy, wall_ms=wall, launches=n_launch)
    print(f"  profile of one {label}: device busy {busy:.2f} ms of "
          f"{wall:.2f} ms wall under the profiler, {n_launch} kernel "
          f"launches")
    for name, ms_k, n in top:
      print(f"    {ms_k:.3f} ms in {n} launches: {name}")

  # the auto-reset's extra cost: one full-batch reset per control step
  gen = torch.Generator(device=dev).manual_seed(1)
  trainer.env._env.reset(gen, cfg.num_envs)
  sync()
  t0 = time.perf_counter()
  for _ in range(3):
    trainer.env._env.reset(gen, cfg.num_envs)
  sync()
  out["reset_ms"] = (time.perf_counter() - t0) / 3 * 1e3
  print(f"  auto-reset: {out['reset_ms']:.1f} ms per full-batch reset "
        f"(one per control step, {cfg.unroll_length} per training step)")

  # checkpoint round trip into a fresh PPO
  path = checkpoint.save(ckpt_dir, ts, step=ts.env_steps)
  fresh = ppo_mod.PPO(env, cfg)
  got = checkpoint.restore(
      path, fresh.init(torch.Generator(device=dev).manual_seed(cfg.seed + 1)))
  pairs = [(got.policy_params[k], v) for k, v in ts.policy_params.items()]
  pairs += [(got.value_params[k], v) for k, v in ts.value_params.items()]
  o, p = got.opt_state, ts.opt_state
  pairs += list(zip(o.mu + o.nu + [o.count, o.notfinite_count],
                    p.mu + p.nu + [p.count, p.notfinite_count]))
  pairs += [(getattr(got.obs_stats, k), getattr(ts.obs_stats, k))
            for k in ("count", "mean", "m2")]
  same = all(torch.equal(a, b) and a.device == b.device for a, b in pairs)
  print(f"  checkpoint {path}: {len(pairs)} tensors (params, Adam state, obs "
        f"stats) restored into a fresh PPO, bit-equal {same}")
  if not same:
    raise AssertionError("checkpoint round trip is not bit-equal")

  act = fresh.make_policy_fn(deterministic=True)(got, got.env_state.obs[
      "state"])
  sync()
  ok = (tuple(act.shape) == (cfg.num_envs, env.action_size)
        and bool(torch.isfinite(act).all()) and bool((act.abs() <= 1).all()))
  print(f"  deterministic policy on the batch: actions {tuple(act.shape)} "
        f"finite and in [-1, 1] {ok}")
  if not ok:
    raise AssertionError("bad deterministic actions")
  return out


# PPO on the elbow as tests/test_training_smoke.py runs it in the JAX
# package: 64 envs, 40 training iterations in 8 outer ones
LEARN = dict(num_envs=64, unroll_length=10, num_minibatches=4,
             num_updates_per_batch=4, num_timesteps=64 * 10 * 40,
             num_evals=8, seed=3)


def learn_phase(device, ckpt_dir):
  """ppo.train on MtxElbowPoseRandom-v0 at LEARN; fails unless every
  reward_per_step is finite and the mean of the last two iterations beats
  that of the first two."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.train import callbacks
  from myosuite_tpu_torch.train import ppo as ppo_mod
  cfg = ppo_mod.default_config()
  for k, v in LEARN.items():
    setattr(cfg, k, v)
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device=device)
  history = []
  _, ts, info = ppo_mod.train(
      env, cfg,
      progress_fn=lambda step, m: history.append(m["reward_per_step"]),
      callbacks=[callbacks.InfoCallback(),
                 callbacks.FallbackCheckpoint(ckpt_dir, every=4)])
  early, late = float(np.mean(history[:2])), float(np.mean(history[-2:]))
  print(f"  reward_per_step by iteration: "
        f"{', '.join(f'{h:.4f}' for h in history)}; first two {early:.4f}, "
        f"last two {late:.4f}; {info['steps']} env steps in "
        f"{info['wall_clock']:.1f} s")
  if not (len(history) >= 6 and np.isfinite(history).all() and late > early):
    raise AssertionError(f"PPO did not learn the elbow: {history}")
  return history


GOLDEN_FIELDS = ("obs", "reward", "done", "qpos", "qvel", "act")


def check_golden(label, env, state, golden, prefix="", actions="actions",
                 fatigue=False, supplied=None):
  """Step `env` from `state` through the golden actions (golden[actions])
  and hold each field (with `fatigue`, MA, MR and MF of info["fatigue"]
  too) within the tolerance stored beside it (golden[prefix + field] and
  golden["atol_" + prefix + field]); print the largest gaps. `supplied`
  info entries are set before every step."""
  fields = GOLDEN_FIELDS + (("MA", "MR", "MF") if fatigue else ())
  rec = {k: [] for k in fields}
  dev = state.obs["state"].device
  for a in golden[actions]:
    if supplied:
      state = state.replace(info={**state.info, **supplied})
    state = env.step(state, torch.from_numpy(a).to(dev))
    vals = (state.obs["state"], state.reward, state.done, state.data.qpos,
            state.data.qvel, state.data.act)
    if fatigue:
      vals += tuple(state.info["fatigue"][k] for k in ("MA", "MR", "MF"))
    for k, v in zip(fields, vals):
      rec[k].append(v.cpu().numpy())
  gaps = {k: float(np.abs(np.stack(v) - golden[prefix + k]).max())
          for k, v in rec.items()}
  tol = {k: float(golden["atol_" + prefix + k]) for k in fields}
  print(f"{label}: " + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.3e})"
                                 for k, v in gaps.items()))
  for k, v in gaps.items():
    if not v <= tol[k]:
      raise AssertionError(f"{label}: {k} off by {v}")


def contact_phase(dev, build):
  """Phase 7: the leg's contacts at batch 4096 through the Newton kernel.
  Raises on any failed check."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod

  env = myosuite_tpu_torch.make("MtxLegWalk-v0")
  m = env.model
  gen = torch.Generator(dev).manual_seed(0)
  t0 = time.perf_counter()
  state = env.reset(gen, BATCH)
  torch.cuda.synchronize()
  classes = ", ".join(f"{g.key[0].name.lower()}-{g.key[1].name.lower()} "
                      f"x{len(g.g1)}" for g in m.plan["collision"].groups)
  print(f"phase 7 contacts: MtxLegWalk-v0 reset at batch {BATCH} in "
        f"{time.perf_counter() - t0:.2f} s; nv {m.nv}, nu {m.nu}, contact "
        f"slots {m.ncon_max} ({classes}), nefc "
        f"{m.plan['constraint'].nefc}")
  control_steps(env, state, gen, 2)                  # warm-up
  nk.launches = 0
  step_ms, state = control_steps(env, state, gen, STEPS)
  leg_launches = launches = nk.launches
  obs = state.obs["state"]
  d = state.data
  print(f"  {STEPS} control steps: {step_ms:.2f} ms per control step, "
        f"{BATCH / step_ms * 1e3:.0f} env-steps/s; kernel launches "
        f"{launches}; obs {tuple(obs.shape)} finite "
        f"{bool(torch.isfinite(obs).all())}; mean ncon_active "
        f"{float(d.ncon_active.float().mean()):.3f} of {m.ncon_max}; "
        f"largest contact_force {float(d.contact_force.max()):.2f} N; "
        f"done {float(state.done.mean()):.3f}")
  if launches != STEPS * env._n_substeps:
    raise AssertionError(f"leg: kernel launched {launches} times, want "
                         f"{STEPS * env._n_substeps}")
  if not bool(torch.isfinite(obs).all()):
    raise AssertionError("leg: non-finite observations")
  action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
  step_profile(env, state, action, step_ms)
  contact_stages(m, d, step_ms, env._n_substeps)

  # the kernel against its plain version at the leg's own inputs
  args, kw = forward.solve_inputs(m, d)
  leg = kernel_numbers(f"leg batch {BATCH}", args, kw)

  # the leg golden trajectories of the JAX package, replayed on the card
  with np.load(f"{ASSETS}/leg_walk_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  nb = golden["actions"].shape[1]
  for tag, name in (("walk", "MtxLegWalk-v0"),
                    ("rough", "MtxLegWalkRough-v0")):
    genv = myosuite_tpu_torch.make(
        name, overrides={"reset_type": "init"} if tag == "walk" else None)
    ggen = torch.Generator(dev).manual_seed(0)
    if tag == "rough":
      hf = torch.from_numpy(golden["hfield"]).to(dev)
      gstate = genv.reset(ggen, nb, hfield=hf.expand(nb, -1, -1).clone())
    else:
      gstate = genv.reset(ggen, nb)
    check_golden(f"  golden {tag}", genv, gstate, golden, f"{tag}_")

  # terrain: a heightfield per env, drawn at each reset
  renv = myosuite_tpu_torch.make("MtxLegWalkRough-v0")
  rstate = renv.reset(gen, BATCH)
  control_steps(renv, rstate, gen, 1)                # warm-up
  nk.launches = 0
  rough_ms, rstate = control_steps(renv, rstate, gen, ROUGH_STEPS)
  launches = nk.launches
  robs = rstate.obs["state"]
  print(f"  MtxLegWalkRough-v0, {ROUGH_STEPS} control steps at batch "
        f"{BATCH}: {rough_ms:.2f} ms per control step; kernel launches "
        f"{launches}; obs {tuple(robs.shape)} finite "
        f"{bool(torch.isfinite(robs).all())}; heightfields "
        f"{rstate.data.hfield_data.numel() * 4 / 1e6:.1f} MB")
  if launches != ROUGH_STEPS * renv._n_substeps:
    raise AssertionError(f"rough: kernel launched {launches} times")
  if not bool(torch.isfinite(robs).all()):
    raise AssertionError("rough: non-finite observations")
  terrain_ms = cuda_ms(lambda: renv.terrain(gen, BATCH), 5)
  renv.reset(gen, BATCH)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(3):
    renv.reset(gen, BATCH)
  torch.cuda.synchronize()
  reset_ms = (time.perf_counter() - t0) / 3 * 1e3
  wrapped = AutoResetWrapper(renv)
  wstate = wrapped.reset(gen, BATCH)
  wrapped_ms, _ = control_steps(wrapped, wstate, gen, 2)
  print(f"  auto-reset on terrain: {reset_ms:.1f} ms per full-batch reset "
        f"({terrain_ms:.2f} ms of it drawing {BATCH} terrains); a wrapped "
        f"control step {wrapped_ms:.2f} ms against {rough_ms:.2f} ms bare; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")

  # PPO on the leg
  cfg = ppo_mod.default_config()
  print(f"  PPO: MtxLegWalk-v0 at default_config() ({cfg.num_envs} envs)")
  trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_leg"),
                      steps=LEG_PPO_STEPS)
  return dict(leg=leg, nv=m.nv, nefc=m.plan["constraint"].nefc,
              step_ms=step_ms, launches=leg_launches,
              ppo=trained["steps"])


def manip_phase(dev, build, phase_lib):
  """Phase 8: the five in-hand manipulation envs at batch 4096 through the
  Newton kernel (each with its profile, the contact stages alone and the
  kernel's phase split from the clock-stamped library `phase_lib`), their
  golden replays, and PPO on MtxHandObjHoldRandom-v0. Raises on any failed
  check; returns the kernel's numbers per shape."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod

  with np.load(f"{ASSETS}/hand_manip_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  shapes = []
  for obj, name, golden_name, golden_overrides in MANIP:
    env = myosuite_tpu_torch.make(name)
    m = env.model
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    state = env.reset(gen, BATCH)
    torch.cuda.synchronize()
    nefc = m.plan["constraint"].nefc
    classes = ", ".join(f"{g.key[0].name.lower()}-{g.key[1].name.lower()} "
                        f"x{len(g.g1)}" for g in m.plan["collision"].groups)
    print(f"phase 8 manipulation: {name} reset at batch {BATCH} in "
          f"{time.perf_counter() - t0:.2f} s; nv {m.nv}, nefc {nefc}, "
          f"contact slots {m.ncon_max} ({classes})")
    _, state = control_steps(env, state, gen, 2)        # warm-up
    nk.launches = 0
    step_ms, state = control_steps(env, state, gen, MANIP_STEPS)
    launches = nk.launches
    obs, d = state.obs["state"], state.data
    finite = bool(torch.isfinite(obs).all() & torch.isfinite(state.reward)
                  .all())
    print(f"  {MANIP_STEPS} control steps: {step_ms:.2f} ms per control "
          f"step, {BATCH / step_ms * 1e3:.0f} env-steps/s; kernel launches "
          f"{launches} ({launches / MANIP_STEPS:g} per control step); obs "
          f"{tuple(obs.shape)} and reward finite {finite}; mean ncon_active "
          f"{float(d.ncon_active.float().mean()):.3f} of {m.ncon_max}; "
          f"done {float(state.done.mean()):.3f}")
    if launches != MANIP_STEPS * env._n_substeps:
      raise AssertionError(f"{name}: kernel launched {launches} times, want "
                           f"{MANIP_STEPS * env._n_substeps}")
    if not finite:
      raise AssertionError(f"{name}: non-finite observations or rewards")
    action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
    busy, n_launch = step_profile(env, state, action, step_ms)
    col_ms, efc_ms = contact_stages(m, d, step_ms, env._n_substeps)
    # the kernel against its plain version at this env's own inputs, those
    # of the substep after the rollout's last
    args, kw = forward.solve_inputs(m, d)
    k = kernel_numbers(f"{obj} batch {BATCH}", args, kw)
    phase_split(f"{obj} kernel, batch {BATCH}",
                nk.phase_cycles(*args, **kw, lib=phase_lib), nk.PHASES)
    if k["max_abs"] != 0.0:
      raise AssertionError(f"{name}: the kernel is not bit-equal to its "
                           f"plain version ({k['max_abs']})")
    shapes.append(dict(env=name, nv=m.nv, nefc=nefc, ms=k["ms"],
                       launches=launches, max_abs_err=k["max_abs"],
                       bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                       plain_ms=k["plain_ms"], step_ms=step_ms,
                       blocks_per_sm=k["blocks_per_sm"],
                       envs_per_block=k["epb"], busy_ms=busy,
                       launches_per_substep=n_launch / env._n_substeps,
                       collision_ms=col_ms, make_efc_ms=efc_ms))
    del env, state, d, args, k, action
    genv = myosuite_tpu_torch.make(golden_name, overrides=golden_overrides)
    gstate = genv.reset(torch.Generator(dev).manual_seed(0),
                        golden["actions"].shape[1])
    check_golden(f"  golden {obj}", genv, gstate, golden, f"{obj}_")

  # PPO on the slice's headline env
  env = myosuite_tpu_torch.make("MtxHandObjHoldRandom-v0")
  cfg = ppo_mod.default_config()
  print(f"  PPO: MtxHandObjHoldRandom-v0 at default_config() "
        f"({cfg.num_envs} envs)")
  trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_hold"), steps=1)
  return dict(shapes=shapes, ppo=trained["steps"])


def sarcopenia_check(label, base_env, sarc_env, data, gen):
  """The Sarc env's muscle gain and bias fields equal the base model's
  with the maximum force halved (gainprm / biasprm column 2 where it is
  > 0, else the scale in column 3, muscles only), and from one state and
  one control one substep's actuator_force is half the base model's, to
  1e-6 relative, on every actuator that no force range clamps. Raises
  on a miss."""
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics.types import GainType
  base_m, sarc_m = base_env.model, sarc_env.model
  muscle = np.asarray(base_m.actuator_gaintype) == int(GainType.MUSCLE)
  for k in ("actuator_gainprm", "actuator_biasprm"):
    prm = getattr(base_m, k).cpu().numpy()
    want = prm.copy()
    pos = muscle & (prm[:, 2] > 0)
    neg = muscle & (prm[:, 2] <= 0)
    want[pos, 2] = prm[pos, 2] * np.float32(0.5)
    want[neg, 3] = prm[neg, 3] * np.float32(0.5)
    got = getattr(sarc_m, k).cpu().numpy()
    if not np.array_equal(got, want):
      raise AssertionError(f"{label}: {k} is not the weakened field")
  ctrl = torch.rand(data.qpos.shape[0], base_m.nu, generator=gen,
                    device=data.qpos.device)
  d = data.replace(ctrl=ctrl)
  f_base = forward.step_n(base_m, d, 1).actuator_force
  f_sarc = forward.step_n(sarc_m, d, 1).actuator_force
  free = torch.as_tensor(np.asarray(base_m.actuator_forcelimited) == 0,
                         device=ctrl.device)
  half = 0.5 * f_base[:, free]
  err = (f_sarc[:, free] - half).abs()
  rel = float((err / half.abs().clamp(min=1e-30)).max())
  ok = bool((err <= 1e-6 * half.abs()).all())
  print(f"  sarcopenia {label}: gain and bias fields weakened "
        f"({int(pos.sum())} muscles by gainprm[:, 2], {int(neg.sum())} by "
        f"the scale gainprm[:, 3]); one substep's actuator_force of "
        f"{int(free.sum())} unclamped actuators = 0.5 x the base model's "
        f"to {rel:.3e} relative (largest |force| "
        f"{float(f_base.abs().max()):.2f} N) ok {ok}")
  if not ok:
    raise AssertionError(f"{label}: sarcopenia force is not half the base")


def fatigue_checks(dev):
  """Under a constant action of 1.0 for MYOBASE_STEPS control steps of
  MtxFatiHandReachRandom-v0 at batch 4096: MA + MR + MF within 1e-4 of 1
  for every muscle; MF never falls, and rises at every step after the
  first (from rested units the first update leaves MF at 0: it moves by F
  MA of the units active before it). Then in AutoResetWrapper with
  max_episode_steps 3: every env at a boundary comes back with MA = 0,
  MR = 1 and MF = 0, the others keep their MF. Raises on a miss."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
  env = myosuite_tpu_torch.make("MtxFatiHandReachRandom-v0")
  gen = torch.Generator(dev).manual_seed(3)
  state = env.reset(gen, BATCH)
  full = torch.ones(BATCH, env.action_size, device=dev)
  worst, prev, means = 0.0, state.info["fatigue"]["MF"], []
  for t in range(MYOBASE_STEPS):
    state = env.step(state, full)
    fat = state.info["fatigue"]
    worst = max(worst, float((fat["MA"] + fat["MR"] + fat["MF"] - 1)
                             .abs().max()))
    mf = fat["MF"]
    grew = bool((mf > prev).all()) if t else bool((mf == 0).all())
    if not (bool((mf >= prev).all()) and grew):
      raise AssertionError(f"fatigue: MF did not rise at step {t}")
    prev = mf
    means.append(float(mf.mean()))
  print(f"  fatigue under action 1.0: |MA + MR + MF - 1| <= {worst:.3e} over "
        f"{MYOBASE_STEPS} steps x {BATCH} envs x {env.action_size} muscles; "
        f"mean MF by step " + ", ".join(f"{m:.3e}" for m in means))
  if not worst <= 1e-4:
    raise AssertionError(f"fatigue: compartments off 1 by {worst}")
  wenv = AutoResetWrapper(myosuite_tpu_torch.make(
      "MtxFatiHandReachRandom-v0", overrides={"max_episode_steps": 3}))
  state = wenv.reset(gen, BATCH)
  n_reset = 0
  age = torch.zeros(BATCH, device=dev)    # control steps into the episode
  for t in range(5):
    state = wenv.step(state, full)
    age = age + 1
    fat = state.info["fatigue"]
    boundary = (state.done > 0) | (state.info["truncation"] > 0)
    rested = ((fat["MA"] == 0).all(1) & (fat["MR"] == 1).all(1)
              & (fat["MF"] == 0).all(1))
    n_reset += int(boundary.sum())
    if not bool(rested[boundary].all()):
      raise AssertionError(f"fatigue: an env at a boundary kept its fatigue "
                           f"(step {t})")
    if not bool((fat["MF"][~boundary & (age >= 2)] > 0).all()):
      raise AssertionError(f"fatigue: an env lost its fatigue mid-episode "
                           f"(step {t})")
    age = torch.where(boundary, torch.zeros_like(age), age)
  print(f"  fatigue auto-reset, max_episode_steps 3: {n_reset} env "
        f"boundaries in 5 steps at batch {BATCH}, each back at MA 0, MR 1, "
        f"MF 0; the others keep theirs")
  if n_reset < BATCH:
    raise AssertionError(f"fatigue: only {n_reset} boundaries")


def myobase_phase(dev, build, phase_lib):
  """Phase 9: muscle conditions and myobase at batch 4096 through the
  Newton kernel (each env's control step, the kernel against its plain
  version at its own inputs; the new models' profile and phase split),
  the sarcopenia and fatigue checks, PPO on MtxFatiHandReachRandom-v0 and
  the myobase golden replays. Raises on any failed check; returns the
  kernel's numbers per env."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod

  shapes, last = [], {}
  for tag, name in MYOBASE:
    env = myosuite_tpu_torch.make(name)
    m = env.model
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    state = env.reset(gen, BATCH)
    torch.cuda.synchronize()
    nefc = m.plan["constraint"].nefc
    print(f"phase 9 myobase: {name} ({type(env).__name__}) reset at batch "
          f"{BATCH} in {time.perf_counter() - t0:.2f} s; nv {m.nv}, nu "
          f"{m.nu}, nefc {nefc}, contact slots {m.ncon_max}")
    _, state = control_steps(env, state, gen, 2)        # warm-up
    nk.launches = 0
    step_ms, state = control_steps(env, state, gen, MYOBASE_STEPS)
    launches = nk.launches
    obs, d = state.obs["state"], state.data
    finite = bool(torch.isfinite(obs).all() & torch.isfinite(state.reward)
                  .all())
    print(f"  {MYOBASE_STEPS} control steps: {step_ms:.2f} ms per control "
          f"step, {BATCH / step_ms * 1e3:.0f} env-steps/s; kernel launches "
          f"{launches} ({launches / MYOBASE_STEPS:g} per control step); obs "
          f"{tuple(obs.shape)} and reward finite {finite}; done "
          f"{float(state.done.mean()):.3f}")
    if launches != MYOBASE_STEPS * env._n_substeps:
      raise AssertionError(f"{name}: kernel launched {launches} times, want "
                           f"{MYOBASE_STEPS * env._n_substeps}")
    if not finite:
      raise AssertionError(f"{name}: non-finite observations or rewards")
    busy = n_launch = None
    if tag in NEW_MODELS:
      action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
      busy, n_launch = step_profile(env, state, action, step_ms)
    args, kw = forward.solve_inputs(m, d)
    k = kernel_numbers(f"{tag} batch {BATCH}", args, kw)
    if tag in NEW_MODELS:
      phase_split(f"{tag} kernel, batch {BATCH}",
                  nk.phase_cycles(*args, **kw, lib=phase_lib), nk.PHASES)
    if k["max_abs"] != 0.0:
      raise AssertionError(f"{name}: the kernel is not bit-equal to its "
                           f"plain version ({k['max_abs']})")
    shapes.append(dict(env=name, tag=tag, nv=m.nv, nefc=nefc, ms=k["ms"],
                       launches=launches, max_abs_err=k["max_abs"],
                       bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                       plain_ms=k["plain_ms"], step_ms=step_ms,
                       blocks_per_sm=k["blocks_per_sm"],
                       envs_per_block=k["epb"], busy_ms=busy,
                       launches_per_substep=(None if n_launch is None else
                                             n_launch / env._n_substeps)))
    if tag in ("torso", "sarc"):
      last[tag] = (env, d, gen)
    del args, k, obs

  # what the fatigue update costs a control step: the plain and the Fati
  # hand in TURN_PAIRS pairs of turns, the first of each pair alternating,
  # TURN_STEPS control steps a turn after one unmeasured step
  turn_env = {who: myosuite_tpu_torch.make(name) for who, name in (
      ("plain", "MtxHandReachRandom-v0"),
      ("Fati", "MtxFatiHandReachRandom-v0"))}
  gen = torch.Generator(dev).manual_seed(4)
  turn_state = {who: e.reset(gen, BATCH) for who, e in turn_env.items()}
  ratios = []
  for p in range(TURN_PAIRS):
    ms = {}
    for who in (("plain", "Fati") if p % 2 == 0 else ("Fati", "plain")):
      _, turn_state[who] = control_steps(turn_env[who], turn_state[who], gen,
                                         1)
      ms[who], turn_state[who] = control_steps(
          turn_env[who], turn_state[who], gen, TURN_STEPS)
    ratios.append(ms["Fati"] / ms["plain"])
    print(f"  pair {p}: plain hand {ms['plain']:.2f}, Fati hand "
          f"{ms['Fati']:.2f} ms per control step")
  ratio = float(np.median(ratios))
  print(f"  Fati / plain hand control step: median {ratio:.3f} over "
        f"{TURN_PAIRS} pairs (Fati slower in {sum(r > 1 for r in ratios)}; "
        f"{min(ratios):.3f}-{max(ratios):.3f})")
  del turn_env, turn_state

  # sarcopenia on the card: the hand (gainprm[:, 2] > 0) and the torso
  # (every muscle through the scale), from the rollouts' last states
  for tag, base_name, sarc_name in (
      ("sarc", "MtxHandReachRandom-v0", None),
      ("torso", None, "MtxSarcTorsoPoseRandom-v0")):
    env, d, gen = last[tag]
    base_env = env if base_name is None else myosuite_tpu_torch.make(
        base_name)
    sarc_env = env if sarc_name is None else myosuite_tpu_torch.make(
        sarc_name)
    sarcopenia_check("hand" if tag == "sarc" else "torso", base_env,
                     sarc_env, d, gen)
  last.clear()

  fatigue_checks(dev)

  # PPO on the fatigued hand
  env = myosuite_tpu_torch.make("MtxFatiHandReachRandom-v0")
  cfg = ppo_mod.default_config()
  print(f"  PPO: MtxFatiHandReachRandom-v0 at default_config() "
        f"({cfg.num_envs} envs)")
  trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_fati"), steps=1)

  # the myobase golden trajectories of the JAX package, on the card
  with np.load(f"{ASSETS}/myobase_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  for tag, (name, overrides, target) in MYOBASE_GOLDEN.items():
    genv = myosuite_tpu_torch.make(name, overrides=overrides)
    nb = golden[f"{tag}_actions"].shape[1]
    gstate = genv.reset(torch.Generator(dev).manual_seed(0), nb)
    if target:
      cfg_ = genv.config
      mid = 0.5 * (np.asarray(cfg_["target_jnt_lo"], np.float32)
                   + np.asarray(cfg_["target_jnt_hi"], np.float32))
      gstate = gstate.replace(info={**gstate.info, "target_angles":
                                    torch.from_numpy(mid).to(dev)
                                    .expand(nb, -1).clone()})
    check_golden(f"  golden {tag}", genv, gstate, golden, f"{tag}_",
                 actions=f"{tag}_actions", fatigue=tag == "fati")
  return dict(shapes=shapes, ppo=trained["steps"])


def _env_row(d, i):
  """Env i of a batched Data, as a batch of 1."""
  import dataclasses
  out = {}
  for f in dataclasses.fields(d):
    v = getattr(d, f.name)
    if dataclasses.is_dataclass(v):
      out[f.name] = type(v)(**{
          g.name: getattr(v, g.name) if g.name in v.STATIC
          else getattr(v, g.name)[i:i + 1] for g in dataclasses.fields(v)})
    else:
      out[f.name] = v[i:i + 1]
  return type(d)(**out)


def per_env_model_check(dev):
  """Reorient100 with two geometry rows in one batch, one substep from
  the reset: the two envs' qM and contact distances differ; each env's
  whole substep equals, bit for bit, its row of the same batch stepped
  with its own geometry in both envs; and each env is bit-equal to a
  batch-1 run of its geometry (C5, repaired: phase 14a's gate names the
  op at fault). Raises on a miss."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import forward
  env = myosuite_tpu_torch.make("MtxHandReorient100-v0")
  gen = torch.Generator(dev).manual_seed(5)
  state = env.reset(gen, 2)
  idx = torch.tensor([3, 71], device=dev)
  rows = env._geoms[idx].cpu().numpy()
  d = state.data.replace(ctrl=torch.rand(2, env.action_size, generator=gen,
                                         device=dev))
  step = lambda geom, data: forward.step_n(
      env._model_for_step({"geom_idx": geom}), data, 1)
  fields = lambda x: {"qM": x.qM, "dist": x.contact.dist, "qpos": x.qpos,
                      "qvel": x.qvel, "qacc": x.qacc,
                      "efc_force": x.efc_force}
  both = fields(step(idx, d))
  differ = {k: not torch.equal(both[k][0], both[k][1])
            for k in ("qM", "dist")}
  print(f"  per-env model: Reorient100 geometry rows 3 and 71 (radius, "
        f"half-length, mass scale {rows[0].round(4).tolist()} and "
        f"{rows[1].round(4).tolist()}); after one substep the envs differ "
        f"in qM {differ['qM']}, contact dist {differ['dist']}")
  if not all(differ.values()):
    raise AssertionError("per-env model: the two geometries gave the same "
                         "system")
  for i in range(2):
    same = fields(step(idx[i].expand(2), d))
    if not all(torch.equal(v[i], same[k][i]) for k, v in both.items()):
      raise AssertionError(f"per-env model: env {i} is not its row of the "
                           f"batch with its own geometry")
    one = fields(step(idx[i:i + 1], _env_row(d, i)))
    gaps = []
    for k, v in one.items():
      gap = float((both[k][i:i + 1] - v).abs().max())
      scale = max(1.0, float(v.abs().max()))
      gaps.append(f"{k} {gap:.3e} of {scale:.3e}")
    print(f"    env {i}: bit-equal to its row of a batch with its geometry "
          f"in both envs; off its batch-1 run by " + ", ".join(gaps))
    if any(not torch.equal(both[k][i:i + 1], v) for k, v in one.items()):
      raise AssertionError(f"per-env model: env {i} is not bit-equal to its "
                           f"batch-1 run (C5)")


def tracking_phase(dev, build, phase_lib):
  """Phase 10: per-env models (the exo payload, SAR's capsule), the cyclic
  tracks and one MyoDM id per object class at batch 4096 through the
  Newton kernel (each env's control step, profile, and the kernel against
  its plain version at the env's own per-env inputs), Reorient100 against
  PenTwirl in pairs of turns, the tracking golden replays, the per-env
  model check and one PPO training step of MtxHandReorient100-v0. Raises
  on any failed check; returns the kernel's numbers per env."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod

  watch = Stopwatch()
  shapes = []
  plain_ms = {}        # (nv, nefc) -> the plain version's ms, timed once
  for tag, name in TRACKING:
    with watch.part("make"):
      env = myosuite_tpu_torch.make(name)
    m = env.model
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    with watch.part("reset"):
      state = env.reset(gen, BATCH)
    nefc = m.plan["constraint"].nefc
    print(f"phase 10 tracking: {name} ({type(env).__name__}) reset at "
          f"batch {BATCH} in {time.perf_counter() - t0:.2f} s; nv {m.nv}, "
          f"nu {m.nu}, nefc {nefc}, contact slots {m.ncon_max}")
    with watch.part("warm-up step"):
      _, state = control_steps(env, state, gen, 1)
    nk.launches = 0
    with watch.part("timed steps"):
      step_ms, state = control_steps(env, state, gen, TRACK_STEPS)
    launches = nk.launches
    obs, d = state.obs["state"], state.data
    finite = bool(torch.isfinite(obs).all() & torch.isfinite(state.reward)
                  .all())
    print(f"  {TRACK_STEPS} control steps: {step_ms:.2f} ms per control "
          f"step, {BATCH / step_ms * 1e3:.0f} env-steps/s; kernel launches "
          f"{launches} ({launches / TRACK_STEPS:g} per control step); obs "
          f"{tuple(obs.shape)} and reward finite {finite}; mean ncon_active "
          f"{float(d.ncon_active.float().mean()):.3f} of {m.ncon_max}; done "
          f"{float(state.done.mean()):.3f}")
    if launches != TRACK_STEPS * env._n_substeps:
      raise AssertionError(f"{name}: kernel launched {launches} times, want "
                           f"{TRACK_STEPS * env._n_substeps}")
    if not finite:
      raise AssertionError(f"{name}: non-finite observations or rewards")
    action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
    with watch.part("profile"):
      busy, n_launch = step_profile(env, state, action, step_ms)
    # the kernel at this env's own inputs: its per-env model's systems
    with watch.part("kernel vs plain"):
      args, kw = forward.solve_inputs(env._model_for_step(state.info), d)
      k = kernel_numbers(f"{tag} batch {BATCH}", args, kw,
                         plain_ms.get((m.nv, nefc)))
    plain_ms.setdefault((m.nv, nefc), k["plain_ms"])
    if tag in ("exo", "reorient100", "airplane_lift"):
      with watch.part("phase split"):
        phase_split(f"{tag} kernel, batch {BATCH}",
                    nk.phase_cycles(*args, **kw, lib=phase_lib), nk.PHASES)
    if k["max_abs"] != 0.0:
      raise AssertionError(f"{name}: the kernel is not bit-equal to its "
                           f"plain version ({k['max_abs']})")
    shapes.append(dict(env=name, tag=tag, nv=m.nv, nefc=nefc, ms=k["ms"],
                       launches=launches, max_abs_err=k["max_abs"],
                       bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                       plain_ms=k["plain_ms"], step_ms=step_ms,
                       blocks_per_sm=k["blocks_per_sm"],
                       envs_per_block=k["epb"], busy_ms=busy,
                       launches_per_substep=n_launch / env._n_substeps))
    del env, state, d, args, k, obs, action

  # what the per-env model costs a control step: Reorient100 (a per-env
  # capsule) against PenTwirl (the same scene, one shared model) in
  # SAR_PAIRS pairs of turns, the first of each pair alternating
  with watch.part("turns"):
    sar_turns(dev)

  # the tracking golden trajectories of the JAX package, on the card
  with watch.part("goldens"):
    with np.load(f"{ASSETS}/tracking_golden.npz") as z:
      golden = {k: z[k] for k in z.files}
    for tag, (name, overrides) in TRACKING_GOLDEN.items():
      genv = myosuite_tpu_torch.make(name, overrides=overrides)
      nb = golden[f"{tag}_actions"].shape[1]
      gstate = genv.reset(torch.Generator(dev).manual_seed(0), nb)
      prefix = f"{tag}_info_"
      supplied = {k[len(prefix):]: torch.from_numpy(v).to(dev)
                  for k, v in golden.items() if k.startswith(prefix)}
      if "geom_idx" in supplied:
        supplied["geom_idx"] = supplied["geom_idx"].long()
      check_golden(f"  golden {tag}", genv, gstate, golden, f"{tag}_",
                   actions=f"{tag}_actions", supplied=supplied)

  with watch.part("per-env model check"):
    per_env_model_check(dev)

  # PPO with per-env models: every rollout step's model from its info, the
  # auto-reset redrawing geom_idx
  with watch.part("PPO"):
    env = myosuite_tpu_torch.make("MtxHandReorient100-v0")
    cfg = ppo_mod.default_config()
    print(f"  PPO: MtxHandReorient100-v0 at default_config() "
          f"({cfg.num_envs} envs)")
    trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_sar"), steps=1)
  watch.report("phase 10")
  return dict(shapes=shapes, ppo=trained["steps"])


def sar_turns(dev):
  """Reorient100 against PenTwirl in SAR_PAIRS pairs of turns of
  SAR_TURN_STEPS control steps (after one untimed step), the first of each
  pair alternating; prints each pair and the median ratio."""
  import myosuite_tpu_torch
  turn_env = {who: myosuite_tpu_torch.make(name) for who, name in (
      ("PenTwirl", "MtxHandPenTwirlRandom-v0"),
      ("Reorient100", "MtxHandReorient100-v0"))}
  gen = torch.Generator(dev).manual_seed(4)
  turn_state = {who: e.reset(gen, BATCH) for who, e in turn_env.items()}
  ratios = []
  for p in range(SAR_PAIRS):
    ms = {}
    order = ("PenTwirl", "Reorient100")
    for who in (order if p % 2 == 0 else order[::-1]):
      _, turn_state[who] = control_steps(turn_env[who], turn_state[who], gen,
                                         1)
      ms[who], turn_state[who] = control_steps(
          turn_env[who], turn_state[who], gen, SAR_TURN_STEPS)
    ratios.append(ms["Reorient100"] / ms["PenTwirl"])
    print(f"  pair {p}: PenTwirl {ms['PenTwirl']:.2f}, Reorient100 "
          f"{ms['Reorient100']:.2f} ms per control step")
  print(f"  Reorient100 / PenTwirl control step: median "
        f"{float(np.median(ratios)):.3f} over {SAR_PAIRS} pairs "
        f"(Reorient100 slower in {sum(r > 1 for r in ratios)}; "
        f"{min(ratios):.3f}-{max(ratios):.3f})")


def autoreset_check(dev, name, entry):
  """`name` through the AutoResetWrapper for RESET_STEPS control steps at
  batch 4096 with every other env done at each step: a done env's
  opponent (keeper) state is every field of the wrapper's fresh reset's
  (its noise table included, t back at 0), a running env's the stepped
  one. Raises on a miss; returns ms per wrapped control step."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.wrappers import AutoResetWrapper
  env = myosuite_tpu_torch.make(name)
  done = (torch.arange(BATCH, device=dev) % 2).float()
  env._get_done = lambda state: done
  wrapped = AutoResetWrapper(env)
  gen = torch.Generator(dev).manual_seed(6)
  state = wrapped.reset(gen, BATCH)
  took, keep = done > 0, done == 0
  ms = []
  for i in range(RESET_STEPS):
    action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
    copy = torch.Generator(dev)
    copy.set_state(state.info["reset_generator"].get_state())
    stepped = env.step(state, action)
    fresh = env.reset(copy, BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = wrapped.step(state, action)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    got, new, old = (x.info[entry] for x in (state, fresh, stepped))
    for f in ("pose", "policy", "noise", "t"):
      g, n, o = (getattr(x, f) for x in (got, new, old))
      if not (torch.equal(g[took], n[took]) and torch.equal(g[keep],
                                                            o[keep])):
        raise AssertionError(f"{name} auto-reset step {i}: {entry}.{f} of "
                             f"the done envs is not the fresh reset's")
    if not (bool((got.t[took] == 0).all())
            and bool((got.t[keep] == i + 1).all())):
      raise AssertionError(f"{name} auto-reset step {i}: {entry}.t wrong")
  print(f"  auto-reset {name}: {RESET_STEPS} control steps with "
        f"{int(took.sum())} of {BATCH} envs done at each: {entry} of every "
        f"done env fresh (pose, policy, noise table, t 0), of every running "
        f"env kept; {np.mean(ms):.2f} ms per wrapped control step")
  return float(np.mean(ms))


def challenge_golden(label, tag, golden, dev):
  """The golden's reset and actions of `tag` through the port's env on
  the card, each field within the tolerance stored beside it."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.challenge import nested_info, state_from
  env = myosuite_tpu_torch.make(dict(CHALLENGE)[tag])
  nb = golden[f"{tag}_actions"].shape[1]
  state = env.reset(torch.Generator(dev).manual_seed(0), nb)
  at = lambda k: torch.from_numpy(golden[f"{tag}_{k}"]).to(dev)
  pre = f"{tag}_init_info_"
  info = nested_info({k[len(pre):]: torch.from_numpy(v).to(dev)
                      for k, v in golden.items() if k.startswith(pre)})
  state = state_from(env, state, at("init_qpos"), at("init_qvel"), info,
                     at("init_hfield") if f"{tag}_init_hfield" in golden
                     else None)
  check_golden(label, env, state, golden, f"{tag}_",
               actions=f"{tag}_actions")


def challenge_phase(dev, build, phase_lib):
  """Phase 11: the seven MyoChallenge ids at batch 4096 through the Newton
  kernel (each env's control step, profile, and the kernel against its
  plain version at the env's own inputs, per-env for Relocate; the phase
  split at Relocate's and Bimanual's shapes), ChaseTag's opponent redraw
  alone, the OSL phases after the rollout, ChaseTag and Soccer through
  the auto-reset, one PPO training step of MtxRunTrack-v0 (a policy of
  nu - 2 actions) and the challenge golden replays. Raises on any failed
  check; returns the kernel's numbers per env."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod

  watch = Stopwatch()
  shapes = []
  plain_ms = {}        # (nv, nefc) -> the plain version's ms, timed once
  for tag, name in CHALLENGE:
    with watch.part("make"):
      env = myosuite_tpu_torch.make(name)
    m = env.model
    gen = torch.Generator(dev).manual_seed(0)
    t0 = time.perf_counter()
    with watch.part("reset"):
      state = env.reset(gen, BATCH)
    nefc = m.plan["constraint"].nefc
    print(f"phase 11 challenge: {name} ({type(env).__name__}) reset at "
          f"batch {BATCH} in {time.perf_counter() - t0:.2f} s; nv {m.nv}, "
          f"nu {m.nu}, actions {env.action_size}, nefc {nefc}, contact "
          f"slots {m.ncon_max}")
    with watch.part("warm-up step"):
      _, state = control_steps(env, state, gen, 1)
    nk.launches = 0
    with watch.part("timed steps"):
      step_ms, state = control_steps(env, state, gen, CHAL_STEPS)
    launches = nk.launches
    obs, d = state.obs["state"], state.data
    finite = bool(torch.isfinite(obs).all() & torch.isfinite(state.reward)
                  .all())
    print(f"  {CHAL_STEPS} control steps: {step_ms:.2f} ms per control "
          f"step, {BATCH / step_ms * 1e3:.0f} env-steps/s; kernel launches "
          f"{launches} ({launches / CHAL_STEPS:g} per control step); obs "
          f"{tuple(obs.shape)} and reward finite {finite}; mean ncon_active "
          f"{float(d.ncon_active.float().mean()):.3f} of {m.ncon_max}; done "
          f"{float(state.done.mean()):.3f}")
    if launches != CHAL_STEPS * env._n_substeps:
      raise AssertionError(f"{name}: kernel launched {launches} times, want "
                           f"{CHAL_STEPS * env._n_substeps}")
    if not finite:
      raise AssertionError(f"{name}: non-finite observations or rewards")
    if tag == "runtrack":
      phase = state.info["osl_phase"]
      counts = torch.bincount(phase.long(), minlength=4).tolist()
      print(f"  OSL phases after {CHAL_STEPS + 1} control steps (e_stance, "
            f"l_stance, e_swing, l_swing): {counts}")
      if not bool(((phase >= 0) & (phase <= 3)).all()):
        raise AssertionError("RunTrack: an OSL phase id outside 0-3")
    if tag == "chasetag":
      with watch.part("opponent redraw"):
        redraw = cuda_ms(lambda: env._new_opponent(gen, BATCH), 5)
      print(f"  the opponent redraw of every control step's info "
            f"(reset_opponent at batch {BATCH}, a colored-noise table of "
            f"{env.max_episode_steps} x 2 per env): {redraw:.3f} ms")
    action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
    with watch.part("profile"):
      busy, n_launch = step_profile(env, state, action, step_ms)
    with watch.part("kernel vs plain"):
      args, kw = forward.solve_inputs(env._model_for_step(state.info), d)
      k = kernel_numbers(f"{tag} batch {BATCH}", args, kw,
                         plain_ms.get((m.nv, nefc)))
    plain_ms.setdefault((m.nv, nefc), k["plain_ms"])
    if tag in ("relocate", "bimanual"):
      with watch.part("phase split"):
        phase_split(f"{tag} kernel, batch {BATCH}",
                    nk.phase_cycles(*args, **kw, lib=phase_lib), nk.PHASES)
    if k["max_abs"] != 0.0:
      raise AssertionError(f"{name}: the kernel is not bit-equal to its "
                           f"plain version ({k['max_abs']})")
    shapes.append(dict(env=name, tag=tag, nv=m.nv, nefc=nefc, ms=k["ms"],
                       launches=launches, max_abs_err=k["max_abs"],
                       bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                       plain_ms=k["plain_ms"], step_ms=step_ms,
                       blocks_per_sm=k["blocks_per_sm"],
                       envs_per_block=k["epb"], busy_ms=busy,
                       launches_per_substep=n_launch / env._n_substeps))
    del env, state, d, args, k, obs, action

  with watch.part("auto-reset"):
    autoreset_check(dev, "MtxChaseTag-v0", "opponent")
    autoreset_check(dev, "MtxSoccer-v0", "keeper")

  # PPO where the policy's action width is not nu: the OSL's two motors
  with watch.part("PPO"):
    env = myosuite_tpu_torch.make("MtxRunTrack-v0")
    cfg = ppo_mod.default_config()
    print(f"  PPO: MtxRunTrack-v0 at default_config() ({cfg.num_envs} "
          f"envs, {env.action_size} actions of nu {env.model.nu})")
    trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_runtrack"),
                        steps=1)

  with watch.part("goldens"):
    with np.load(f"{ASSETS}/challenge_golden.npz") as z:
      golden = {k: z[k] for k in z.files}
    for tag, _ in CHALLENGE:
      challenge_golden(f"  golden {tag}", tag, golden, dev)
  watch.report("phase 11")
  return dict(shapes=shapes, ppo=trained["steps"])


SAC_EPOCHS = 2           # phase 12: timed SAC epochs past learning_starts
NPG_ITERS = 1            # phase 12: NPG iterations, each timed
EVAL_HORIZON = 100       # phase 12: control steps of each pretrained eval
REFLEX_STEPS = 25        # phase 12: control steps of the reflex rollout
KERNEL_AT_STEP = 50      # phase 12: the stand eval's step whose solve is
#                          taken apart (kernel against its plain version)


def _timed_method(obj, name, marks, sync):
  """Replace obj.<name> by a version that records its host seconds
  (between two synchronizations) under marks[name]."""
  fn = getattr(obj, name)

  def timed(*args, **kw):
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    marks[name] = marks.get(name, 0.0) + time.perf_counter() - t0
    return out
  setattr(obj, name, timed)


def sac_check(dev):
  """SAC at default_config() on the main path's env: collection epochs
  until learning_starts, then SAC_EPOCHS timed epochs with updates, each
  40 launches; finite losses, q_loss > 0, the buffer past
  learning_starts."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import sac as sac_mod
  cfg = sac_mod.default_config()
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
  trainer = sac_mod.SAC(env, cfg)
  ts = trainer.init(torch.Generator(device=dev).manual_seed(cfg.seed))
  block = cfg.unroll_length * cfg.num_envs
  want = cfg.unroll_length * env._n_substeps
  t0 = time.perf_counter()
  n_collect = 0
  while ts.env_steps + block < cfg.learning_starts:
    nk.launches = 0
    ts, m = trainer.training_step(ts)
    n_collect += 1
    if nk.launches != want:
      raise AssertionError(f"SAC epoch launched the kernel {nk.launches} "
                           f"times, want {want}")
  torch.cuda.synchronize()
  print(f"  SAC: {n_collect} collection epochs ({ts.env_steps} env steps) "
        f"in {time.perf_counter() - t0:.1f} s; replay {cfg.replay_capacity} "
        f"rows, {ts.buffer.nbytes / 1e6:.1f} MB on the card")
  marks = {}
  _timed_method(trainer, "_collect", marks, torch.cuda.synchronize)
  out = []
  for i in range(SAC_EPOCHS):
    marks.clear()
    nk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, metrics = trainer.training_step(ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = {k: float(v) for k, v in metrics.items()}
    row = dict(collect_ms=marks["_collect"] * 1e3,
               update_ms=(wall - marks["_collect"]) * 1e3,
               env_steps_per_s=block / wall, launches=nk.launches, **m)
    out.append(row)
    print(f"  SAC epoch {i}: collect {row['collect_ms']:.1f} ms, "
          f"{cfg.grad_updates_per_epoch} updates {row['update_ms']:.1f} ms "
          f"= {row['env_steps_per_s']:.0f} env-steps/s; Newton launches "
          f"{nk.launches}; q_loss {m['q_loss']:.4g} pi_loss "
          f"{m['pi_loss']:.4g} alpha {m['alpha']:.4g} entropy "
          f"{m['entropy']:.4g} buffer_size {m['buffer_size']:.0f}")
    if nk.launches != want:
      raise AssertionError(f"SAC epoch launched the kernel {nk.launches} "
                           f"times, want {want}")
    if not all(np.isfinite(v) for v in m.values()):
      raise AssertionError(f"non-finite SAC metrics {m}")
    if not (m["q_loss"] > 0 and m["buffer_size"] > cfg.learning_starts):
      raise AssertionError(f"SAC did not update: {m}")
  return out


def npg_check(dev):
  """NPG at default_config() on the main path's env: NPG_ITERS timed
  iterations, each 500 launches, split into rollout, natural step and
  value fit; 0 < kl_after < 10 delta. The first needs no warm-up: on an
  H100 it took as long as the second (18.87 and 18.79 s, PERF.md), the
  rollout's host time dominating both."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import npg as npg_mod
  cfg = npg_mod.default_config()
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
  trainer = npg_mod.NPG(env, cfg)
  ts = trainer.init(torch.Generator(device=dev).manual_seed(cfg.seed))
  want = cfg.unroll_length * env._n_substeps
  marks = {}
  for name in ("_rollout", "_natural_step", "_fit_value"):
    _timed_method(trainer, name, marks, torch.cuda.synchronize)
  out = []
  for i in range(NPG_ITERS):
    marks.clear()
    nk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, metrics = trainer.training_step(ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = {k: float(v) for k, v in metrics.items()}
    row = dict(rollout_ms=marks["_rollout"] * 1e3,
               natural_step_ms=marks["_natural_step"] * 1e3,
               value_fit_ms=marks["_fit_value"] * 1e3, wall_ms=wall * 1e3,
               env_steps_per_s=cfg.unroll_length * cfg.num_envs / wall,
               launches=nk.launches, **m)
    print(f"  NPG iteration {i}: rollout "
          f"{row['rollout_ms']:.1f} ms, natural step "
          f"{row['natural_step_ms']:.1f} ms, value fit "
          f"{row['value_fit_ms']:.1f} ms, {row['wall_ms']:.1f} ms in all = "
          f"{row['env_steps_per_s']:.0f} env-steps/s; Newton launches "
          f"{nk.launches}; kl_after {m['kl_after']:.4g} surrogate "
          f"{m['surrogate']:.4g} value_loss {m['value_loss']:.4g}")
    if nk.launches != want:
      raise AssertionError(f"NPG iteration launched the kernel "
                           f"{nk.launches} times, want {want}")
    if not all(np.isfinite(v) for v in m.values()):
      raise AssertionError(f"non-finite NPG metrics {m}")
    if not 0 < m["kl_after"] < 10 * cfg.normalized_step_size:
      raise AssertionError(f"NPG kl_after {m['kl_after']} outside (0, "
                           f"{10 * cfg.normalized_step_size})")
    out.append(row)
  return out


def closed_loop_golden(label, tag, golden, dev, env_id):
  """The pretrained policy from the JAX reset stored in `golden`, on the
  port's own observations, each field within its stored tolerance."""
  from myosuite_tpu_torch.agents import pretrained
  ours = pretrained.closed_loop(golden, tag, env_id, dev)
  gaps = {k: float(np.abs(v - golden[f"{tag}_{k}"]).max())
          for k, v in ours.items()}
  tol = {k: float(golden[f"atol_{tag}_{k}"]) for k in ours}
  print(f"{label}: " + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.3e})"
                                 for k, v in gaps.items()))
  for k, v in gaps.items():
    if not v <= tol[k]:
      raise AssertionError(f"{label}: {k} off by {v}")


def pretrained_check(dev, golden, watch):
  """The five shipped policies restored from their .pt files, each in a
  deterministic eval at batch BATCH for EVAL_HORIZON control steps from
  the port's own resets: success and mean return beside the JAX
  package's eval of the same policy (golden); fails when a success rate
  leaves the JAX one by more than 3 binomial standard errors of the JAX
  estimate plus 5 points. At the stand policy's states (step
  KERNEL_AT_STEP) the kernel against its plain version. Returns the
  stand kernel's numbers."""
  from myosuite_tpu_torch.agents import pretrained
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  stand = None
  for env_id in pretrained.ENV_IDS:
    tag = {"MtxElbowPoseRandom-v0": "elbow",
           "MtxFingerPoseRandom-v0": "finger",
           "MtxHandReachRandom-v0": "hand", "MtxLegStand-v0": "stand",
           "MtxLegWalk-v0": "walk"}[env_id]
    with watch.part(f"{tag} eval"):
      trainer, ts = pretrained.load(env_id, device=dev)
      env = trainer.env._env
      gen = torch.Generator(dev).manual_seed(0)
      seen = {}

      def grab(i, st, env=env):
        # the solver's inputs at the trained policy's states
        if tag == "stand" and i == KERNEL_AT_STEP - 1:
          seen["inputs"] = forward.solve_inputs(env.model, st.data)
      nk.launches = 0
      t0 = time.perf_counter()
      out = pretrained.evaluate(trainer, ts, gen, BATCH, EVAL_HORIZON,
                                on_step=grab)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
      launches = nk.launches
    want = EVAL_HORIZON * env._n_substeps
    n = golden[f"{tag}_returns"].shape[0]
    p_jax = float(golden[f"{tag}_success"]) / 100.0
    bound = 100.0 * (3 * np.sqrt(p_jax * (1 - p_jax) / n) + 0.05)
    succ = out["success"]
    ret = float(out["returns"].mean())
    print(f"  {env_id}: success {succ:.2f}% over {BATCH} episodes of "
          f"{EVAL_HORIZON} steps (JAX package {100 * p_jax:.2f}% over {n}; "
          f"bound +-{bound:.2f}), mean return {ret:.3f} (JAX "
          f"{float(golden[f'{tag}_returns'].mean()):.3f}); "
          f"{wall / EVAL_HORIZON * 1e3:.1f} ms per control step; Newton "
          f"launches {launches}")
    if launches != want:
      raise AssertionError(f"{env_id} eval launched the kernel {launches} "
                           f"times, want {want}")
    if not (np.isfinite(ret) and abs(succ - 100.0 * p_jax) <= bound):
      raise AssertionError(f"{env_id}: success {succ} against the JAX "
                           f"package's {100 * p_jax} (bound {bound})")
    if tag == "stand":
      with watch.part("stand kernel"):
        args, kw = seen["inputs"]
        stand = kernel_numbers(f"leg under the trained stand policy, step "
                               f"{KERNEL_AT_STEP}, batch {BATCH}", args, kw)
        stand["launches"] = launches
        bit = all(torch.equal(a, b) for a, b in zip(
            stand["ours"], nk.newton_solve_reference(*args, **kw)))
        print(f"  stand policy's inputs: kernel bit-equal to its plain "
              f"version {bit}; {stand['ms']:.4f} ms per launch (phase 7 "
              f"times the leg under uniform random actions)")
        if not bit:
          raise AssertionError("kernel not bit-equal at the stand policy's "
                               "inputs")
  return stand


def reflex_check(dev):
  """The reflex controller with the shipped gains on MtxLegWalk-v0:
  REFLEX_STEPS control steps of a batch of BATCH through step_ctrl, every
  stimulation finite and in [0, 1]; at the last state, the card's
  stimulations against the port's CPU controller within 1e-5; upright
  time and distance beside the gains file's."""
  import types
  import myosuite_tpu_torch
  from myosuite_tpu_torch.agents import pretrained, reflex
  from myosuite_tpu_torch.physics import newton_kernel as nk
  gait = os.path.join(pretrained.ROOT, "reflex_gait.json")
  params = reflex.params_from_json(gait)
  env = myosuite_tpu_torch.make("MtxLegWalk-v0", device=dev)
  ctl = reflex.ReflexController(env, params)
  nk.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  state, out = ctl.rollout(torch.Generator(dev).manual_seed(0),
                           REFLEX_STEPS, batch=BATCH)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  stim = out["stim"]
  ok = bool(torch.isfinite(stim).all()) and bool(
      ((stim >= 0) & (stim <= 1)).all())
  # upright time and distance, as the tuner measures them
  alive = torch.cumprod((out["height"] > env.config["min_height"]).float(),
                        0)
  upright = float(alive.sum(0).mean()) * env.dt
  dist = float(((alive * out["x"]).amax(0) - out["x0"]).mean())
  with open(gait) as f:
    rec = json.load(f)
  cpu_env = myosuite_tpu_torch.make("MtxLegWalk-v0", device="cpu")
  cpu_ctl = reflex.ReflexController(cpu_env, params)
  rows = {k: getattr(state.data, k).cpu() for k in (
      "qpos", "qvel", "actuator_force", "actuator_length", "contact_force",
      "time")}
  gap = float((ctl(state.data).cpu()
               - cpu_ctl(types.SimpleNamespace(**rows))).abs().max())
  print(f"  reflex: {REFLEX_STEPS} control steps at batch {BATCH} in "
        f"{wall:.1f} s ({wall / REFLEX_STEPS * 1e3:.1f} ms per control "
        f"step), Newton launches {nk.launches}; stimulations finite and in "
        f"[0, 1] {ok}; card against the CPU controller at the last state "
        f"{gap:.3e} (tol 1e-5); upright {upright:.2f} s and distance "
        f"{dist:.3f} m over {REFLEX_STEPS * env.dt:.1f} s (the gains file: "
        f"{rec['eval_upright_s'][0]:.2f} s and "
        f"{rec['eval_distance_m'][0]:.3f} m over {rec['eval_horizon_s']} s, "
        f"not on this card)")
  if nk.launches != REFLEX_STEPS * env._n_substeps:
    raise AssertionError(f"reflex rollout launched the kernel "
                         f"{nk.launches} times")
  if not ok or not gap <= 1e-5:
    raise AssertionError(f"reflex stimulations: in range {ok}, card "
                         f"against CPU {gap}")
  return dict(upright_s=upright, distance_m=dist, gap=gap)


def agents_phase(dev):
  """Phase 12: SAC and NPG at their default configs on the main path's
  env, the five pretrained policies against the JAX package's eval (and
  the closed-loop goldens of the elbow and the stand), the reflex
  controller, and the kernel at a trained policy's states."""
  from myosuite_tpu_torch.envs.registry import ASSETS
  watch = Stopwatch()
  print("phase 12 agents: SAC and NPG at default_config() on "
        "MtxHandReachRandom-v0")
  with watch.part("SAC"):
    sac = sac_check(dev)
  with watch.part("NPG"):
    npg = npg_check(dev)
  with np.load(f"{ASSETS}/pretrained_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  print(f"  pretrained policies: deterministic evals at batch {BATCH}")
  stand = pretrained_check(dev, golden, watch)
  with watch.part("closed-loop goldens"):
    closed_loop_golden("  closed-loop golden, elbow", "elbow", golden, dev,
                       "MtxElbowPoseRandom-v0")
    closed_loop_golden("  closed-loop golden, stand", "stand", golden, dev,
                       "MtxLegStand-v0")
  with watch.part("reflex"):
    refl = reflex_check(dev)
  watch.report("phase 12")
  return dict(sac=sac, npg=npg, stand=stand, reflex=refl)


MESH_TIMEOUT = 300       # phase 13: seconds a rank or a CLI run may take
IK_ROWS_CPU = 1024       # phase 13: IK rows held against the CPU
IK_TOL = 2e-3            # phase 13: IK stopping tolerance (m)
SINK_STEPS = 10          # phase 13: control steps written through the sink


def _clone_generator(g):
  c = torch.Generator(device=g.device)
  c.set_state(g.get_state())
  return c


def _cloned(ts):
  """`ts` with every generator (its own two and the env state's) copied,
  so a second run from it draws what the first drew."""
  info = {k: _clone_generator(v) if isinstance(v, torch.Generator) else v
          for k, v in ts.env_state.info.items()}
  return ts.replace(env_state=ts.env_state.replace(info=info),
                    generator=_clone_generator(ts.generator),
                    rollout_generator=_clone_generator(ts.rollout_generator))


def _learner(ts):
  """Params, Adam's moments and count, and the observation statistics."""
  from myosuite_tpu_torch.train import ppo as ppo_mod
  o, s = ts.opt_state, ts.obs_stats
  return (ppo_mod.PPO.flat_params(ts.policy_params, ts.value_params)
          + o.mu + o.nu + [o.count, s.count, s.mean, s.m2])


def _gap(a, b):
  """(bit-equal, largest absolute difference) of two tensor lists."""
  same = all(torch.equal(x, y) for x, y in zip(a, b))
  gap = max(float((x.double() - y.double()).abs().max()) for x, y in
            zip(a, b))
  return same, gap


def _timed_training_step(trainer, ts, mesh, sync):
  """One distributed training step, split at the rollout's end and the
  update's start and end (a synchronize at each); returns (ts, metrics,
  {rollout_ms, gather_ms, update_ms, wall_ms}, what the update was fed)."""
  marks, fed = {}, {}
  unroll, update = trainer._unroll, trainer._update_epoch

  def timed_unroll(ts):
    out = unroll(ts)
    sync()
    marks["unrolled"] = time.perf_counter()
    return out

  def timed_update(ts, traj, stats, perms=None, last_obs=None):
    fed.update(ts=ts, traj=traj, stats=stats, last_obs=last_obs,
               generator=_clone_generator(ts.generator))
    sync()
    marks["update"] = time.perf_counter()
    out = update(ts, traj, stats, perms=perms, last_obs=last_obs)
    sync()
    marks["updated"] = time.perf_counter()
    return out

  trainer._unroll, trainer._update_epoch = timed_unroll, timed_update
  try:
    sync()
    t0 = time.perf_counter()
    ts, metrics = trainer.training_step(ts, mesh)
    sync()
    t1 = time.perf_counter()
  finally:
    trainer._unroll, trainer._update_epoch = unroll, update
  split = dict(rollout_ms=(marks["unrolled"] - t0) * 1e3,
               gather_ms=(marks["update"] - marks["unrolled"]) * 1e3,
               update_ms=(marks["updated"] - marks["update"]) * 1e3,
               wall_ms=(t1 - t0) * 1e3)
  return ts, metrics, split, fed


def nccl_step_check(dev, build):
  """13(a): a distributed PPO training step of the hand at
  default_config() over NCCL at world size 1 in this process: one warm-up
  and one timed step, bit-equal to the plain rollout driven by a copy of
  the rank's rollout generator and the plain _update_epoch with the
  permutations of a copy of the permutation generator; 100 launches."""
  import torch.distributed as dist
  import myosuite_tpu_torch
  from myosuite_tpu_torch.parallel import mesh as mesh_mod
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.train import ppo as ppo_mod
  rendezvous = os.path.join(build, f"nccl_rendezvous_{os.getpid()}")
  if os.path.exists(rendezvous):
    os.unlink(rendezvous)
  mesh_mod.initialize_distributed(backend="nccl",
                                  init_method=f"file://{rendezvous}",
                                  world_size=1, rank=0, device=dev)
  try:
    mesh = mesh_mod.make_mesh(dev)
    env = myosuite_tpu_torch.make("MtxHandReachRandom-v0",
                                  device=mesh.device)
    cfg = ppo_mod.default_config()
    trainer = ppo_mod.PPO(env, cfg)
    ts = mesh_mod.place(trainer.init(torch.Generator(dev).manual_seed(
        cfg.seed)), trainer, mesh)
    ts, _ = trainer.training_step(ts, mesh)   # warm-up
    torch.cuda.synchronize()
    before = _cloned(ts)
    shapes = []
    gather = mesh_mod.gather_env_rows

    def watched(local, mesh):
      shapes.append(tuple(local.shape))
      return gather(local, mesh)
    mesh_mod.gather_env_rows = watched
    nk.launches = 0
    try:
      ts, metrics, split, _ = _timed_training_step(
          trainer, ts, mesh, torch.cuda.synchronize)
    finally:
      mesh_mod.gather_env_rows = gather
    launches = nk.launches
    rows = (cfg.num_envs,) + shapes[0][1:]
    nbytes = int(np.prod(rows)) * 4
    buf = torch.zeros(rows, device=mesh.device)
    reduce_ms = cuda_ms(lambda: dist.all_reduce(buf, group=mesh.group), 10)
    # the plain path from the same state
    plain = before.replace(generator=before.rollout_generator,
                           rollout_generator=None)
    plain, traj = trainer._rollout(plain)
    plain, _ = trainer._update_epoch(
        plain.replace(generator=before.generator), traj,
        before.obs_stats)
    same, gap = _gap(_learner(ts), _learner(plain))
    sps = cfg.unroll_length * cfg.num_envs / (split["wall_ms"] / 1e3)
    print(f"  13a NCCL, world size 1: rollout {split['rollout_ms']:.1f} ms, "
          f"gather {split['gather_ms']:.1f} ms (the pack, one all-reduce of "
          f"{rows} float32 = {nbytes / 1e6:.2f} MB, the unpack, the "
          f"statistics; the all-reduce alone {reduce_ms:.3f} ms), update "
          f"{split['update_ms']:.1f} ms, {split['wall_ms']:.1f} ms in all = "
          f"{sps:.0f} training env-steps/s; Newton launches {launches}; "
          f"learner bit-equal to the plain rollout and update {same} (gap "
          f"{gap:.3e}); reward_per_step "
          f"{float(metrics['reward_per_step']):.4g}")
    if launches != cfg.unroll_length * env._n_substeps:
      raise AssertionError(f"distributed step launched the kernel "
                           f"{launches} times")
    if not same:
      raise AssertionError(f"distributed step at world size 1 differs from "
                           f"the plain path by {gap}")
    return dict(split, bytes=nbytes, reduce_ms=reduce_ms, launches=launches,
                env_steps_per_s=sps)
  finally:
    dist.destroy_process_group()
    if os.path.exists(rendezvous):
      os.unlink(rendezvous)


# one rank of 13(b): argv rank, world, rendezvous URL, output directory,
# device, global env batch
MESH_RANK = r"""
import datetime, json, os, sys
import torch
import chip_smoke
import myosuite_tpu_torch
from myosuite_tpu_torch.parallel import mesh as mesh_mod
from myosuite_tpu_torch.physics import newton_kernel as nk
from myosuite_tpu_torch.train import ppo as ppo_mod

rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dev, batch = torch.device(sys.argv[5]), int(sys.argv[6])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
# the host's cores shared between the ranks (torchrun sets
# OMP_NUM_THREADS=1 for the same reason): CPU ops' spinning threads would
# otherwise stall each other
torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
mesh_mod.initialize_distributed(backend="gloo", init_method=init,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=240))
mesh = mesh_mod.make_mesh(dev)
env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
cfg = ppo_mod.default_config()
cfg.num_envs = batch
trainer = ppo_mod.PPO(env, cfg)
ts = mesh_mod.place(trainer.init(torch.Generator(dev).manual_seed(cfg.seed)),
                    trainer, mesh)
ts, _ = trainer.training_step(ts, mesh)   # warm-up
nk.launches = 0
ts, metrics, split, fed = chip_smoke._timed_training_step(
    trainer, ts, mesh, sync)
launches = nk.launches
singles = []
for _ in range(2):
  ref, _ = trainer._update_epoch(
      fed["ts"].replace(generator=chip_smoke._clone_generator(
          fed["generator"])), fed["traj"], fed["stats"],
      last_obs=fed["last_obs"])
  singles.append(chip_smoke._learner(ref))
ours = chip_smoke._learner(ts)
repeat_same, repeat_gap = chip_smoke._gap(singles[0], singles[1])
same, gap = chip_smoke._gap(ours, singles[0])
torch.save([t.cpu() for t in ours], out + "/rank%d.pt" % rank)
print("RANK_RESULT " + json.dumps(dict(
    split, rank=rank, launches=launches, rows=ts.env_state.obs[
        "state"].shape[0], bit_equal_single=same, gap_single=gap,
    singles_equal=repeat_same, singles_gap=repeat_gap,
    reward_per_step=float(metrics["reward_per_step"]))), flush=True)
torch.distributed.destroy_process_group()
"""


def gloo_ranks_check(dev, build):
  """13(b): two ranks on the one card over gloo (NCCL refuses two ranks
  on one GPU), 2048 envs each, as subprocesses with a file:// rendezvous
  and a timeout: after the timed step both ranks' learners are
  bit-identical, and each rank's equals the single-rank _update_epoch of
  the gathered trajectory with the same permutations (or, where two such
  single-rank updates already differ on the card, lies within their
  gap)."""
  out = os.path.join(build, f"gloo_ranks_{os.getpid()}")
  os.makedirs(out, exist_ok=True)
  rendezvous = os.path.join(out, "rendezvous")
  if os.path.exists(rendezvous):
    os.unlink(rendezvous)
  root = os.path.dirname(os.path.abspath(__file__))
  # each rank's output goes to a file: a full pipe that nobody reads
  # would stop a rank mid-collective and the other with it
  logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(2)]
  procs = [subprocess.Popen(
      [sys.executable, "-c", MESH_RANK, str(r), "2", f"file://{rendezvous}",
       out, str(dev), str(BATCH)], cwd=root, stdout=logs[r],
      stderr=subprocess.STDOUT, text=True) for r in range(2)]
  results = []
  try:
    deadline = time.monotonic() + MESH_TIMEOUT
    for p, log in zip(procs, logs):
      p.wait(timeout=max(1.0, deadline - time.monotonic()))
      log.seek(0)
      text = log.read()
      lines = [l for l in text.splitlines() if l.startswith("RANK_RESULT ")]
      if p.returncode != 0 or not lines:
        raise AssertionError(f"a gloo rank failed ({p.returncode}): "
                             f"{text[-3000:]}")
      results.append(json.loads(lines[-1][len("RANK_RESULT "):]))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
    for log in logs:
      log.close()
  learners = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
              for r in range(2)]
  identical, rank_gap = _gap(*learners)
  wall = max(r["wall_ms"] for r in results) / 1e3
  sps = 10 * BATCH / wall
  for r in results:
    print(f"  13b gloo rank {r['rank']} ({r['rows']} envs): rollout "
          f"{r['rollout_ms']:.1f} ms, gather {r['gather_ms']:.1f} ms, update "
          f"{r['update_ms']:.1f} ms, {r['wall_ms']:.1f} ms in all; Newton "
          f"launches {r['launches']}; learner bit-equal to the single-rank "
          f"update of the gathered trajectory {r['bit_equal_single']} (gap "
          f"{r['gap_single']:.3e}; two single-rank updates bit-equal "
          f"{r['singles_equal']}, gap {r['singles_gap']:.3e})")
  print(f"  13b two ranks: learners bit-identical {identical} (gap "
        f"{rank_gap:.3e}); {sps:.0f} global training env-steps/s")
  if not identical:
    raise AssertionError(f"the two ranks' learners differ by {rank_gap}")
  for r in results:
    ok = (r["bit_equal_single"] if r["singles_equal"]
          else r["gap_single"] <= r["singles_gap"])
    if not ok or r["launches"] != 100 or r["rows"] != BATCH // 2:
      raise AssertionError(f"gloo rank {r['rank']}: {r}")
  return dict(ranks=results, env_steps_per_s=sps)


C5_FIELDS = ("obs", "reward", "qpos", "qvel", "act", "qacc")


# 14(a): the C5 gate. Sub-batches of a BATCH-env state stepped alone: the
# single rows 1, 7 and 2048, the 7 rows 1-7 and the 2048 rows 2048-4095
C5_ROWS = ((1, 2), (7, 8), (2048, 2049), (1, 8), (2048, 4096))
C5_STEPS = 2
C5_ENVS = ("MtxHandReachRandom-v0", "MtxHandReorient100-v0")
_RANDOM_OPS = ("rand", "normal", "bernoulli", "uniform", "multinomial",
               "exponential", "randperm")


def batch_variant_ops(env, state, action, sizes=(1, 7)):
  """One control step of `state` (B envs) under a dispatch mode that runs
  every floating-point op whose output leads with the env axis again on
  the first n rows of its inputs that lead with it, for n in `sizes`:
  {(op, the port's source line): n} of the ops whose rows differ from
  their rows of the batch (an op whose arguments fix the batch size does
  not run again). Finds what breaks C5."""
  import traceback
  from torch.utils._python_dispatch import TorchDispatchMode
  from torch.utils._pytree import tree_flatten, tree_map
  B = action.shape[0]
  found = {}

  def same(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

  class RowCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      kwargs = kwargs or {}
      out = func(*args, **kwargs)
      name = str(func)
      leaves = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor) and o.dim()
                and o.dtype.is_floating_point and o.shape[0] == B]
      if (not leaves or func._schema.is_mutable
          or any(r in name for r in _RANDOM_OPS)):
        return out
      for n in sizes:
        cut = lambda x: (x[:n] if isinstance(x, torch.Tensor) and x.dim()
                         and x.shape[0] == B else x)
        try:
          sub = func(*tree_map(cut, args), **tree_map(cut, kwargs))
        except Exception:
          return out
        subs = [o for o in tree_flatten(sub)[0]
                if isinstance(o, torch.Tensor) and o.dim()
                and o.dtype.is_floating_point]
        if len(subs) != len(leaves) or any(
            a.shape != cut(b).shape for a, b in zip(subs, leaves)):
          return out
        if not all(same(a, cut(b)) for a, b in zip(subs, leaves)):
          where = [f"{os.path.relpath(f.filename)}:{f.lineno}"
                   for f in traceback.extract_stack()
                   if "myosuite_tpu_torch" in f.filename]
          found.setdefault((name, where[-1] if where else "?"), n)
          break
      return out

  with RowCheck():
    env.step(state, action)
  return found


BARE_STEP = r"""
import importlib.util, json, sys, torch
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps(smoke.bare_hand_step(torch.device("cuda"))))
"""


def bare_hand_step(dev):
  """The main path's bare control step at BATCH (after 2 warm-up steps):
  ms per control step over STEPS and launches per substep (one profiled
  step), for the checkout whose myosuite_tpu_torch is imported."""
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
  gen = torch.Generator(dev).manual_seed(0)
  state = env.reset(gen, BATCH)
  _, state = control_steps(env, state, gen, 2)
  ms, state = control_steps(env, state, gen, STEPS)
  action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
  _, _, launches, _ = profile_call(lambda: env.step(state, action))
  return dict(ms=ms, launches_per_substep=launches / env._n_substeps)


def bare_step_turns(parent):
  """The bare control step of the checkout `parent` and of this one, each
  in a process of its own, in turns (parent, this, this, parent)."""
  here = os.path.dirname(os.path.abspath(__file__))
  out = []
  for tag, root in (("parent", parent), ("this", here), ("this", here),
                    ("parent", parent)):
    run = subprocess.run([sys.executable, "-c", BARE_STEP,
                          os.path.abspath(root), os.path.abspath(__file__)],
                         capture_output=True, text=True, cwd=root,
                         timeout=MESH_TIMEOUT)
    if run.returncode:
      raise AssertionError(f"bare step of {tag}: {run.stderr[-2000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    out.append((tag, res))
    print(f"  14a bare hand control step at {BATCH}, {tag}: "
          f"{res['ms']:.2f} ms, {res['launches_per_substep']:.0f} launches "
          f"per substep")
  return out


def c5_gate(dev):
  """14(a): C5_STEPS control steps of each C5_ENVS env at BATCH and of
  each C5_ROWS sub-batch (its rows of the same reset and actions): every
  C5_FIELDS field bit-equal to its rows of the full batch. A row that
  reaches an episode boundary (done or truncation) in those steps gets a
  fresh draw of its task randomization (Reorient100's object and goal)
  from the batch's one generator, which a sub-batch draws anew, so such
  rows are left out and counted; a single row that does is replaced by
  the next row that does not. On a miss, prints the ops whose rows differ
  (`batch_variant_ops`) and raises."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.parallel.mesh import take_rows
  pick = lambda s: (s.obs["state"], s.reward, s.data.qpos, s.data.qvel,
                    s.data.act, s.data.qacc)
  for name in C5_ENVS:
    env = myosuite_tpu_torch.make(name, device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    state = env.reset(gen, BATCH)
    actions = [torch.rand(BATCH, env.action_size, generator=gen, device=dev)
               for _ in range(C5_STEPS)]
    full = state
    redrawn = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    for a in actions:
      full = env.step(full, a)
      redrawn |= (full.done != 0) | (full.info["truncation"] != 0)
    full = pick(full)
    clean = (~redrawn).nonzero()[:, 0].tolist()
    misses, notes = [], []
    for lo, hi in C5_ROWS:
      if hi - lo == 1:
        lo = next(i for i in clean if i >= lo)
        hi = lo + 1
      part = take_rows(state, slice(lo, hi), BATCH)
      for a in actions:
        part = env.step(part, a[lo:hi])
      keep = ~redrawn[lo:hi]
      notes.append(f"{lo}-{hi - 1}" + (f" ({int((~keep).sum())} redrawn)"
                                       if not bool(keep.all()) else ""))
      for k, p, f in zip(C5_FIELDS, pick(part), full):
        p, f = p[keep], f[lo:hi][keep]
        if not torch.equal(p, f):
          misses.append(f"rows {lo}-{hi - 1} {k} "
                        f"{float((p.double() - f.double()).abs().max()):.3e}"
                        f" of {float(f.abs().max()):.3e}")
    print(f"  14a C5 gate, {name}: {C5_STEPS} control steps of the rows "
          + ", ".join(notes) + f" alone against their rows of {BATCH} "
          f"({int(redrawn.sum())} of {BATCH} envs redrawn at a boundary): "
          + ("every field bit-equal" if not misses else "; ".join(misses)))
    if misses:
      for (op, where), n in batch_variant_ops(
          env, state, actions[0]).items():
        print(f"    batch-variant at {n} rows: {op} at {where}")
      raise AssertionError(f"C5: {name} rows differ from their rows of the "
                           f"batch")


def robot_ik_check(dev):
  """13(d), robot and IK on the hand at batch BATCH: the Robot methods
  and sensor2sim on the card against the port on the CPU for 8 envs
  (1e-5 relative); sensor2sim of noise-free sensors gives the settled
  state's kinematics back; IK to the forward kinematics of perturbed
  qposes, the card against the CPU on IK_ROWS_CPU rows."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import kinematics
  from myosuite_tpu_torch.robot import robot
  from myosuite_tpu_torch.utils import inverse_kinematics as ik
  name = "MtxHandReachRandom-v0"
  env = myosuite_tpu_torch.make(name, device=dev)
  cpu = myosuite_tpu_torch.make(name, device="cpu")
  gen = torch.Generator(dev).manual_seed(7)
  state = env.reset(gen, BATCH)
  d = state.data
  ctrl = 3 * torch.rand(BATCH, env.action_size, generator=gen,
                        device=dev) - 1.5
  rows = slice(0, 8)
  small = lambda x: x[rows].cpu()
  dc = cpu.reset(torch.Generator().manual_seed(0), 8).data.replace(
      qpos=small(d.qpos), qvel=small(d.qvel), act=small(d.act),
      actuator_length=small(d.actuator_length))
  worst = 0.0

  def close(label, a, b):
    nonlocal worst
    a, b = a.double().cpu(), b.double().cpu()
    err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    worst = max(worst, err)
    if not err <= 1e-5:
      raise AssertionError(f"robot {label}: card against CPU {err}")

  t0 = time.perf_counter()
  for vel in (None, 2.0):
    r, rc = robot.Robot(env.model, vel_limit=vel), robot.Robot(
        cpu.model, vel_limit=vel)
    close("normalize_actions", r.normalize_actions(ctrl)[rows],
          rc.normalize_actions(small(ctrl)))
    close("process_actuator", r.process_actuator(d, ctrl, env.dt)[rows],
          rc.process_actuator(dc, small(ctrl), env.dt))
  sensors = robot.Robot(env.model).get_sensors(d)
  back = robot.sensor2sim(env.model, d, sensors)
  back_cpu = robot.sensor2sim(cpu.model, dc, robot.Robot(
      cpu.model).get_sensors(dc))
  kin = ("xpos", "xquat", "site_xpos", "subtree_com", "ten_length",
         "actuator_length", "actuator_moment", "qM", "qfrc_bias")
  for k in kin:
    close(f"sensor2sim {k}", getattr(back, k)[rows], getattr(back_cpu, k))
  own = all(torch.equal(getattr(back, k), getattr(d, k)) for k in kin)
  own_gap = max(float((getattr(back, k) - getattr(d, k)).abs().max()
                      / max(1.0, float(getattr(d, k).abs().max())))
                for k in kin)
  torch.cuda.synchronize()
  robot_s = time.perf_counter() - t0
  print(f"  13d robot: normalize_actions, process_actuator and sensor2sim "
        f"at batch {BATCH} against the CPU on 8 envs, largest relative gap "
        f"{worst:.3e} (tol 1e-5); sensor2sim of noise-free sensors gives "
        f"the reset's own kinematics back: bit-equal {own}, gap "
        f"{own_gap:.3e}; {robot_s:.2f} s")
  if not own_gap <= 1e-6:
    raise AssertionError(f"sensor2sim moved the state's kinematics by "
                         f"{own_gap}")

  site = int(env._tip_sids[0])
  lo, hi = env.model.jnt_range[:, 0], env.model.jnt_range[:, 1]
  qt = torch.clamp(d.qpos + 0.6 * torch.rand(d.qpos.shape, generator=gen,
                                             device=dev) - 0.3, lo, hi)
  target = kinematics.kinematics(env.model, d.replace(qpos=qt)).site_xpos[
      :, site]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  res = ik.qpos_from_site_pose(env.model, d, site, target, tol=IK_TOL)
  torch.cuda.synchronize()
  ik_ms = (time.perf_counter() - t0) * 1e3
  n = IK_ROWS_CPU
  dcpu = cpu.reset(torch.Generator().manual_seed(0), n).data.replace(
      qpos=d.qpos[:n].cpu())
  ref = ik.qpos_from_site_pose(cpu.model, dcpu, site, target[:n].cpu(),
                               tol=IK_TOL)
  steps, err = res.steps[:n].cpu(), res.err_norm[:n].cpu()
  conv, conv_ref = err <= IK_TOL, ref.err_norm <= IK_TOL
  near = ((ref.err_norm - IK_TOL).abs() <= 0.1 * IK_TOL) | (
      (err - IK_TOL).abs() <= 0.1 * IK_TOL)
  both = conv & conv_ref
  qgap = float((res.qpos[:n].cpu() - ref.qpos)[both].abs().max()) \
      if bool(both.any()) else 0.0
  step_gap = int((steps - ref.steps).abs().max())
  differ = int(((conv != conv_ref) & ~near).sum())
  share = float((res.err_norm <= IK_TOL).float().mean())
  hist = torch.bincount(res.steps.cpu().long(), minlength=51)
  bins = [(0, 0), (1, 5), (6, 10), (11, 20), (21, 30), (31, 49), (50, 50)]
  print(f"  13d IK at batch {BATCH} (hand, site {site}, tol {IK_TOL}): "
        f"{ik_ms:.1f} ms for 50 iterations; converged {100 * share:.2f}%; "
        f"steps " + ", ".join(f"{a}-{b}: {int(hist[a:b + 1].sum())}"
                              for a, b in bins)
        + f"; against the CPU on {n} rows: qpos {qgap:.3e} where both "
        f"converged (tol 1e-4), steps within {step_gap} (tol 1), "
        f"converged sets differ on {differ} rows away from tol")
  if not (qgap <= 1e-4 and step_gap <= 1 and differ == 0):
    raise AssertionError("IK on the card disagrees with the CPU")
  return dict(robot_gap=worst, ik_ms=ik_ms, ik_converged=share,
              ik_qgap=qgap, robot_s=robot_s)


def sink_check(dev, build):
  """13(d), the native sink: SINK_STEPS control steps of the hand at
  batch BATCH written as .mtp and read back equal."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch import native
  from myosuite_tpu_torch.logger.trace import Trace, rollout_to_trace
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
  gen = torch.Generator(dev).manual_seed(9)
  state = env.reset(gen, BATCH)
  rec = {k: [] for k in ("obs", "reward", "done", "qpos", "qvel", "act")}
  for _ in range(SINK_STEPS):
    state = env.step(state, torch.rand(BATCH, env.action_size, generator=gen,
                                       device=dev))
    d = state.data
    for k, v in zip(rec, (state.obs["state"], state.reward, state.done,
                          d.qpos, d.qvel, d.act)):
      rec[k].append(v)
  host = {k: torch.stack(v).cpu() for k, v in rec.items()}
  path = os.path.join(build, f"rollout_{os.getpid()}.mtp")
  available = native.native_available()
  tr = rollout_to_trace(host)
  t0 = time.perf_counter()
  tr.save(path)
  seconds = time.perf_counter() - t0
  size = os.path.getsize(path)
  back = Trace.load(path)
  same = all(np.array_equal(back["rollout0"][k], v.numpy())
             for k, v in host.items())
  os.unlink(path)
  print(f"  13d sink: {SINK_STEPS} steps x {BATCH} envs, {size / 1e6:.1f} MB "
        f"written as .mtp in {seconds * 1e3:.1f} ms = "
        f"{size / 1e6 / seconds:.0f} MB/s (warm page cache); read back "
        f"equal {same}; native_available {available}")
  if not (available and same):
    raise AssertionError(f"native sink: available {available}, equal {same}")
  return dict(mb=size / 1e6, mb_per_s=size / 1e6 / seconds)


def examine_env_check(dev, trace_path):
  """13(d), examine_env on the card as a user runs it: the shipped elbow
  policy over 64 episodes, saved as a trace at `trace_path` (phase 15
  reads it); success beside the JAX package's eval, gated as phase 12
  gates it."""
  from myosuite_tpu_torch.agents import pretrained
  from myosuite_tpu_torch.envs.registry import ASSETS
  env_id = "MtxElbowPoseRandom-v0"
  root = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  proc = subprocess.run(
      [sys.executable, "-m", "myosuite_tpu_torch.utils.examine_env", "-e",
       env_id, "-p", pretrained.checkpoint_dir(env_id), "-n", "64",
       "--device", str(dev), "--trace", trace_path],
      cwd=root, capture_output=True, text=True, timeout=MESH_TIMEOUT)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    raise AssertionError(f"examine_env failed: {proc.stderr[-3000:]}")
  line = proc.stdout.strip().splitlines()[0]
  succ = float(line.split("success%:")[1].split()[0])
  with np.load(f"{ASSETS}/pretrained_golden.npz") as z:
    n = z["elbow_returns"].shape[0]
    p_jax = float(z["elbow_success"]) / 100.0
  bound = 100.0 * (3 * np.sqrt(p_jax * (1 - p_jax) / n) + 0.05)
  print(f"  13d examine_env -e {env_id} -p <the shipped policy> -n 64: "
        f"\"{line}\" (JAX package {100 * p_jax:.2f}% over {n}; bound "
        f"+-{bound:.2f}); {seconds:.1f} s with the process start")
  if not abs(succ - 100.0 * p_jax) <= bound:
    raise AssertionError(f"examine_env success {succ} against {p_jax}")
  return dict(success=succ, seconds=seconds, trace=trace_path)


def mesh_tools_phase(dev, build):
  """Phase 13: scale-out over ranks and the user tools."""
  watch = Stopwatch()
  print("phase 13 scale-out and tools: MtxHandReachRandom-v0 at "
        "default_config()")
  with watch.part("NCCL step"):
    nccl = nccl_step_check(dev, build)
  with watch.part("gloo ranks"):
    gloo = gloo_ranks_check(dev, build)
  with watch.part("robot and IK"):
    tools = robot_ik_check(dev)
  with watch.part("sink"):
    sink = sink_check(dev, build)
  with watch.part("examine_env"):
    exam = examine_env_check(dev, os.path.join(build, "examine_env.mtp"))
  watch.report("phase 13")
  return dict(nccl=nccl, gloo=gloo, tools=tools, sink=sink,
              examine_env=exam)


RENDER_HW = (64, 64)      # phase 14: the frames' height and width
RENDER_CPU_ROWS = 8      # phase 14: envs drawn again on the CPU
RENDER_BATCH = 256       # phase 14: the rough leg's, the die's and VisualObs's
RENDER_ROW = 5           # phase 14: the env drawn alone
VISUAL_KEY = "rgb:default:224x224:resnet18"


def _moved(x, dev):
  """x with every tensor on `dev`, through dicts and dataclasses."""
  import dataclasses
  if isinstance(x, torch.Tensor):
    return x.to(dev)
  if isinstance(x, dict):
    return {k: _moved(v, dev) for k, v in x.items()}
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    return dataclasses.replace(x, **{f.name: _moved(getattr(x, f.name), dev)
                                     for f in dataclasses.fields(x)})
  return x


def _three(renderer, data):
  """rgb, depth and segmentation of `data`."""
  return (renderer.render(data), renderer.render(data, depth=True),
          renderer.render(data, segmentation=True))


def render_against_cpu(label, env_id, data, card):
  """14(c): the first RENDER_CPU_ROWS envs of `data` drawn by the port on
  the CPU against the card's frames `card` (rgb, depth, segmentation):
  depth within 1e-5 relative, segmentation equal and rgb within 1 level
  on at least 99.9% of pixels. Raises on a miss."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.parallel.mesh import take_rows
  from myosuite_tpu_torch.renderer import Renderer
  env = myosuite_tpu_torch.make(env_id, device="cpu")
  rows = _moved(take_rows(data, slice(0, RENDER_CPU_ROWS), data.batch),
                "cpu")
  cpu = _three(Renderer(env, RENDER_HW[1], RENDER_HW[0]), rows)
  rgb, depth, seg = [x[:RENDER_CPU_ROWS].cpu() for x in card]
  dgap = float(((depth.double() - cpu[1].double()).abs()
                / cpu[1].double().abs()).max())
  seg_same = float((seg == cpu[2]).all(-1).double().mean())
  rgb_near = float(((rgb.int() - cpu[0].int()).abs() <= 1).all(-1)
                   .double().mean())
  hit = float((cpu[2][..., 0] >= 0).double().mean())
  print(f"  14c {label}: card against CPU on {RENDER_CPU_ROWS} envs "
        f"({hit:.3f} of pixels hit a geom): depth {dgap:.3e} relative, "
        f"segmentation equal on {seg_same:.5f}, rgb within 1 level on "
        f"{rgb_near:.5f} of pixels")
  if not (dgap <= 1e-5 and seg_same >= 0.999 and rgb_near >= 0.999):
    raise AssertionError(f"renderer: {label} card and CPU differ")
  return dict(depth_rel=dgap, seg_equal=seg_same, rgb_within_1=rgb_near)


def render_numbers(label, renderer, data):
  """ms per batch render of each output (CUDA events), launches of one
  rgb render, peak memory of the three."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  frames = _three(renderer, data)
  torch.cuda.synchronize()
  peak = torch.cuda.max_memory_allocated() / 2 ** 20
  ms = {k: cuda_ms(fn, 3) for k, fn in (
      ("rgb", lambda: renderer.render(data)),
      ("depth", lambda: renderer.render(data, depth=True)),
      ("segmentation", lambda: renderer.render(data, segmentation=True)))}
  busy, _, launches, _ = profile_call(lambda: renderer.render(data))
  print(f"  14 {label}: {data.batch} envs at {RENDER_HW[0]} x "
        f"{RENDER_HW[1]}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                                        ms.items())
        + f" per batch render; {launches} launches, device busy "
        f"{busy:.2f} ms of an rgb render; peak memory {peak:.0f} MiB")
  return frames, dict(ms=ms, launches=launches, busy_ms=busy, peak_mib=peak)


def render_phase(dev, build, parent=None):
  """Phase 14: C5 and the renderer. (a) the C5 gate (with --parent, the
  bare hand control step of the parent and of this checkout in turns);
  (b) the hand at BATCH: 2 control steps (20 Newton launches), then rgb,
  depth and segmentation of every env; (c) those frames against the CPU
  port's, and the same for the rough leg and the die at RENDER_BATCH; (d)
  env RENDER_ROW drawn alone bit-equal to its row; (e) VisualObs's
  ResNet-18 features at RENDER_BATCH against the CPU; (f) GymEnv.render,
  render_cams and examine_env's video frames (saved as .npy: the card has
  no imageio); (g) the phase's seconds by part."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.parallel.mesh import take_rows
  from myosuite_tpu_torch.physics import newton_kernel as nk
  from myosuite_tpu_torch.renderer import Renderer
  watch = Stopwatch()
  out = {}
  print("phase 14 C5 and the renderer")
  with watch.part("C5 gate"):
    c5_gate(dev)
  if parent:
    with watch.part("bare step turns"):
      out["bare_step"] = bare_step_turns(parent)

  with watch.part("hand"):
    env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    state = env.reset(gen, BATCH)
    torch.cuda.synchronize()
    nk.launches = 0
    for _ in range(2):
      state = env.step(state, torch.rand(BATCH, env.action_size,
                                         generator=gen, device=dev))
    torch.cuda.synchronize()
    launches = nk.launches
    print(f"  14b MtxHandReachRandom-v0 at {BATCH}: 2 control steps, "
          f"{launches} Newton launches")
    if launches != 2 * env._n_substeps:
      raise AssertionError(f"phase 14: {launches} Newton launches, want "
                           f"{2 * env._n_substeps}")
    out["launches"] = launches
    r = Renderer(env, RENDER_HW[1], RENDER_HW[0])
    frames, out["hand"] = render_numbers("hand", r, state.data)
    depth = frames[1]
    if not bool(torch.isfinite(depth).all()) or not bool(
        (frames[2][..., 0] >= 0).any()):
      raise AssertionError("phase 14: the hand's frames are empty or "
                           "not finite")
  with watch.part("card against CPU"):
    out["hand_cpu"] = render_against_cpu("hand", "MtxHandReachRandom-v0",
                                         state.data, frames)
  with watch.part("batch invariance"):
    alone = _three(r, take_rows(state.data,
                                slice(RENDER_ROW, RENDER_ROW + 1), BATCH))
    same = [torch.equal(a[0], f[RENDER_ROW]) for a, f in zip(alone, frames)]
    print(f"  14d env {RENDER_ROW} drawn alone against its row of {BATCH}: "
          f"rgb, depth, segmentation bit-equal {same}")
    if not all(same):
      raise AssertionError("phase 14: a row drawn alone differs from its "
                           "row of the batch")
  del frames, depth, alone
  for tag, env_id in (("rough leg", "MtxLegWalkRough-v0"),
                      ("die", "MtxHandDieReorient-v0")):
    with watch.part(tag):
      e = myosuite_tpu_torch.make(env_id, device=dev)
      g = torch.Generator(dev).manual_seed(0)
      s = e.reset(g, RENDER_BATCH)
      for _ in range(2):
        s = e.step(s, torch.rand(RENDER_BATCH, e.action_size, generator=g,
                                 device=dev))
      f, out[tag] = render_numbers(tag, Renderer(e, RENDER_HW[1],
                                                 RENDER_HW[0]), s.data)
      out[tag + " cpu"] = render_against_cpu(tag, env_id, s.data, f)

  with watch.part("VisualObs"):
    out["visual"] = visual_check(dev)
  with watch.part("tools"):
    out["tools"] = render_tools_check(dev, build)
  watch.report("phase 14")
  return out


def visual_check(dev):
  """14(e): VISUAL_KEY at RENDER_BATCH envs of the hand: ms of the render
  and of the encoder, features of RENDER_CPU_ROWS envs against the CPU
  port's within 1e-3 of their scale, the TF32 flags."""
  import warnings
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.visual import VisualObs, parse_visual_key
  warnings.simplefilter("ignore", RuntimeWarning)
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=dev)
  data = env.reset(torch.Generator(dev).manual_seed(0), RENDER_BATCH).data
  vo = VisualObs(env, [VISUAL_KEY])
  feats = vo.get_visuals(data)[VISUAL_KEY]
  _, _, hw, name = parse_visual_key(VISUAL_KEY)
  r = vo._renderers[hw]
  render_ms = cuda_ms(lambda: r.render(data), 3)
  img = r.render(data)
  encode = vo._encoders[name]
  enc_ms = cuda_ms(lambda: encode(img), 3)
  cpu_env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device="cpu")
  from myosuite_tpu_torch.parallel.mesh import take_rows
  rows = _moved(take_rows(data, slice(0, RENDER_CPU_ROWS), RENDER_BATCH),
                "cpu")
  cpu = VisualObs(cpu_env, [VISUAL_KEY]).get_visuals(rows)[VISUAL_KEY]
  ours = feats[:RENDER_CPU_ROWS].cpu().double()
  scale = float(cpu.double().abs().max())
  gap = float((ours - cpu.double()).abs().max()) / scale
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  print(f"  14e VisualObs {VISUAL_KEY} at {RENDER_BATCH} envs: features "
        f"{tuple(feats.shape)}, render {render_ms:.2f} ms, encoder "
        f"{enc_ms:.2f} ms; card against CPU on {RENDER_CPU_ROWS} envs "
        f"{gap:.3e} of the features' scale {scale:.3e}; matmul.allow_tf32 "
        f"{tf32[0]} cudnn.allow_tf32 {tf32[1]}")
  if not (gap <= 1e-3 and bool(torch.isfinite(feats).all())):
    raise AssertionError("VisualObs: card and CPU features differ")
  if any(tf32):
    raise AssertionError("phase 14: a TF32 flag is on")
  return dict(render_ms=render_ms, encoder_ms=enc_ms, rel_gap=gap)


def render_tools_check(dev, build):
  """14(f): GymEnv.render, render_cams and examine_env's video frames on
  the card, each frame set saved as .npy under `build`."""
  from myosuite_tpu_torch.envs.gym_adapter import GymEnv
  from myosuite_tpu_torch.utils import examine_env, render_cams
  import myosuite_tpu_torch
  out = {}
  gym = GymEnv("MtxHandReachRandom-v0", device=dev)
  gym.reset(seed=0)
  gym.step(np.zeros(gym.unwrapped_env.action_size, np.float32))
  out["gym"] = gym.render()
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device=dev)
  cams = render_cams.render_all_cams(env)
  out.update({f"cam_{k}": v for k, v in cams.items()})
  gen = torch.Generator(dev).manual_seed(0)
  rec = examine_env.rollout_episodes(
      env, lambda obs, g: 2.0 * torch.rand(obs.shape[0], env.action_size,
                                           generator=g, device=dev) - 1.0,
      4, 25, gen, poses=True)
  out["examine_env"] = examine_env.episode_frames(env, rec).cpu().numpy()
  for k, v in out.items():
    np.save(os.path.join(build, f"render_{k}.npy"), v)
    if v.dtype != np.uint8 or v.shape[-1] != 3 or not v.any():
      raise AssertionError(f"phase 14 tools: {k} frames {v.shape} "
                           f"{v.dtype} are wrong or black")
  print("  14f tools: " + ", ".join(f"{k} {v.shape}" for k, v in out.items())
        + f" saved as .npy under {os.path.relpath(build)}")
  return {k: list(v.shape) for k, v in out.items()}


SWEEP_TOL = 5e-6         # phase 15: swept against stored length ranges (m)
NAMED_TOL = 1e-6         # phase 15: an edited arm file's ranges by name (m)
PATHS_HORIZON = 50       # phase 15: truncate_paths' horizon


def sweep_check(dev):
  """15(a), the builders' sweep: for every committed model file whose MJCF
  is finalize_muscles of a builder string, the 64 joint samples of its
  sweep run as one batch through the port's kinematics, com_pos, tendon
  and transmission on the card, padded as finalize_muscles pads; every
  muscle within SWEEP_TOL of the file's actuator_lengthrange, but for
  sweep.MIRRORED_ROWS (where the JAX engine's tendon path, which the port
  follows, leaves MuJoCo's), which must be exactly the rows that miss and
  are held against the CPU port's sweep instead. The two edited arm files
  are held by muscle name against myoarm.npz's ranges."""
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.mjcf import export, sweep
  from myosuite_tpu_torch.physics import io as physics_io
  t0 = time.perf_counter()
  path = lambda n: os.path.join(ASSETS, n)
  arm, arm_extra = physics_io.load_model(path("myoarm.npz"), dev)
  worst, named, mirrored, bad = (0.0, ""), (0.0, ""), [], []
  nfiles = 0
  for name in sorted(export.SOURCES):
    model, extra = physics_io.load_model(path(name), dev)
    if name in export.EDITS:
      gap = sweep.named_range_gap(model, extra["actuator_names"], arm,
                                  arm_extra["actuator_names"])
      named = max(named, (gap, name))
      if not gap <= NAMED_TOL:
        bad.append(f"{name} by name {gap:.3e}")
      continue
    nfiles += 1
    rows, swept, gaps = sweep.sweep_gaps(model)
    want = sweep.MIRRORED_ROWS.get(name, ())
    mirror = np.isin(rows, want)
    if (~mirror).any():
      worst = max(worst, (float(gaps[~mirror].max()), name))
    missed = tuple(int(r) for r in rows[gaps > SWEEP_TOL])
    if missed != want:
      bad.append(f"{name} misses rows {missed}, want {want}")
    if mirror.any():
      cpu = physics_io.load_model(path(name), "cpu")[0]
      _, cpu_swept, _ = sweep.sweep_gaps(cpu)
      mirrored.append((name, int(mirror.sum()), float(gaps[mirror].max()),
                       float(np.abs(swept[mirror] - cpu_swept[mirror]).max())))
  seconds = time.perf_counter() - t0
  card_cpu = max((m[3] for m in mirrored), default=0.0)
  mirror_note = (
      f"{sum(m[1] for m in mirrored)} mirrored rows in {len(mirrored)} "
      f"files, MuJoCo's ranges {max(m[2] for m in mirrored):.4f} m away, "
      f"card against CPU {card_cpu:.3e} m" if mirrored
      else "no mirrored rows")
  print(f"  15a sweep: {nfiles} files swept on the card, every muscle but "
        f"the mirrored rows within {SWEEP_TOL:g} m of its file; largest gap "
        f"{worst[0]:.3e} m ({worst[1]}); {mirror_note}; the edited arm "
        f"files by name within {named[0]:.3e} m ({named[1]}); "
        f"{seconds:.1f} s")
  if card_cpu > SWEEP_TOL:
    bad.append(f"mirrored rows: card against CPU {card_cpu:.3e}")
  if worst[0] > SWEEP_TOL or bad:
    raise AssertionError(f"sweep: largest gap {worst}; {bad}")
  return dict(files=nfiles, max_gap=worst[0], file=worst[1],
              named_gap=named[0], seconds=seconds)


def host_paths_check(dev, trace_path):
  """15(b), the host helpers on the card: the paths of phase 13's
  examine_env (the shipped elbow policy, 64 episodes, each cut at its
  first done; read from the trace it saved) as device tensors; path_stats
  and truncate_paths on them equal to their results on numpy copies, and
  paths_to_trace's .mtp round trip through the native sink bit-equal."""
  from myosuite_tpu_torch import native
  from myosuite_tpu_torch.logger.trace import Trace
  from myosuite_tpu_torch.utils import paths_utils
  saved = Trace.load(trace_path)
  keys = (("obs", "observations"), ("reward", "rewards"),
          ("solved", "solved"))
  host = [{k: saved[g][key] for k, key in keys} for g in
          sorted(saved.keys(), key=lambda g: int(g[len("rollout"):]))]
  paths = [{k: torch.tensor(v, device=dev) for k, v in p.items()}
           for p in host]
  lengths = [len(p["reward"]) for p in host]
  stats = paths_utils.path_stats(paths)
  same_stats = stats == paths_utils.path_stats(host)
  cut = paths_utils.truncate_paths(paths, PATHS_HORIZON)
  same_cut = all(v.device.type == dev.type and np.array_equal(
      v.cpu().numpy(), h[k]) for p, h in zip(
          cut, paths_utils.truncate_paths(host, PATHS_HORIZON))
      for k, v in p.items())
  out = os.path.splitext(trace_path)[0] + "_paths.mtp"
  paths_utils.paths_to_trace(paths).save(out)
  back = Trace.load(out)
  os.unlink(out)
  same_trace = all(np.array_equal(back[f"rollout{i}"][k], v)
                   for i, h in enumerate(host) for k, v in h.items())
  print(f"  15b host helpers: phase 13's {len(paths)} examine_env paths on "
        f"the card ({min(lengths)}-{max(lengths)} steps); path_stats equal "
        f"{same_stats} (success {stats['success_rate']:.3f}, return "
        f"{stats['return_mean']:.3f}); truncate_paths at {PATHS_HORIZON} "
        f"equal {same_cut}; .mtp round trip bit-equal {same_trace} "
        f"(native_available {native.native_available()})")
  if not (same_stats and same_cut and same_trace
          and native.native_available()):
    raise AssertionError("host helpers on the card")
  return stats


NO_MUJOCO = r"""
import sys
sys.modules["mujoco"] = None
import myosuite_tpu_torch
import myosuite_tpu_torch.mjcf
from myosuite_tpu_torch.mjcf import builder, hand
assert hand.build_hand().count("<muscle ") == 39
try:
  myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu",
                          overrides={"model_xml": builder.build_elbow()})
except ImportError as e:
  assert "MuJoCo" in str(e), e
  print("raised:", e)
else:
  raise AssertionError("model_xml compiled without MuJoCo")
"""


def no_mujoco_check(dev):
  """15(c), what the card cannot run: whether MuJoCo imports here; in a
  subprocess with mujoco unimportable, the builders import and build the
  hand, and the model_xml route raises the MuJoCo ImportError. Where
  MuJoCo is here, the route on the elbow's MJCF at batch BATCH is held
  bit-equal to the committed file's env over 2 control steps."""
  import myosuite_tpu_torch
  try:
    import mujoco
    have = f"yes ({mujoco.__version__})"
  except ImportError:
    mujoco, have = None, "no"
  root = os.path.dirname(os.path.abspath(__file__))
  proc = subprocess.run([sys.executable, "-c", NO_MUJOCO], cwd=root,
                        capture_output=True, text=True, timeout=MESH_TIMEOUT)
  if proc.returncode != 0:
    raise AssertionError(f"builders without MuJoCo: {proc.stderr[-3000:]}")
  print(f"  15c MuJoCo importable on this machine: {have}; without it the "
        f"builders import and build the hand, and the model_xml route "
        f"{proc.stdout.strip()}")
  if mujoco is None:
    try:
      myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device=dev,
                              overrides={"model_xml": "<mujoco/>"})
    except ImportError as e:
      if "MuJoCo" not in str(e):
        raise
      return dict(mujoco=False)
    raise AssertionError("model_xml compiled without MuJoCo")
  from myosuite_tpu_torch.mjcf import export
  envs = [myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device=dev,
                                  overrides=ov)
          for ov in ({}, {"model_xml": export.model_xml("myoelbow.npz")})]
  states = []
  for env in envs:
    gen = torch.Generator(dev).manual_seed(0)
    state = env.reset(gen, BATCH)
    for _ in range(2):
      state = env.step(state, torch.rand(BATCH, env.action_size,
                                         generator=gen, device=dev))
    states.append(state)
  same = all(torch.equal(getattr(states[0].data, k), getattr(states[1].data,
                                                             k))
             for k in ("qpos", "qvel", "act"))
  print(f"  15c the elbow from its own MJCF at batch {BATCH}, 2 control "
        f"steps: bit-equal to the committed file's env {same}")
  if not same:
    raise AssertionError("model_xml route differs from the committed file")
  return dict(mujoco=True)


def model_build_phase(dev, examine_trace):
  """Phase 15: the model build layer (MJCF builders, export, host helpers)
  as far as the card runs it; `examine_trace` is the trace phase 13's
  examine_env saved."""
  watch = Stopwatch()
  print("phase 15 model build: the builders' sweep, the host helpers, "
        "MuJoCo's absence")
  with watch.part("sweep"):
    swept = sweep_check(dev)
  with watch.part("host helpers"):
    host_paths_check(dev, examine_trace)
  with watch.part("no MuJoCo"):
    no_mujoco_check(dev)
  watch.report("phase 15")
  return swept


WIDE_STEPS = 2           # phase 16: timed control steps of the scene
WIDE_TURNS = ("warp", "wide", "wide", "warp")   # phase 16c's order
# Phase 16's scene: the Relocate scene with two more loose spheres of the
# object's kind, one on either side of it (nv 45, nefc 375). Its MJCF, with
# the muscles' length ranges that MuJoCo sweeps, is stored in the golden
# file; the card has no MuJoCo, so the model_xml route loads its compiled
# copy (mjcf.export.write_compiled).
CLUTTER = """
    <body name="clutter_0" pos="-0.082 0.02 1.0">
      <freejoint name="clutter_0_free"/>
      <geom name="clutter_0_geom" type="sphere" size="0.04" mass="0.2"
            contype="2" conaffinity="7"/>
    </body>
    <body name="clutter_1" pos="0.082 0.02 1.0">
      <freejoint name="clutter_1_free"/>
      <geom name="clutter_1_geom" type="sphere" size="0.04" mass="0.2"
            contype="2" conaffinity="7"/>
    </body>
"""


def wide_edge_check(dev):
  """16(a): the wide kernel bit-equal to its plain version on every
  WIDE_EDGE_CASES row, in shared memory and in the device-memory
  workspace, and on WIDE_FINISH_CASES; the warp kernel's layout, which
  `route` computes without a build, against its library's."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  lib, wlib = nk._library(), nk._wide_library()
  for seed, case in enumerate(nk.WIDE_EDGE_CASES):
    nv, nefc, nfr, limits, batch, non_pd = case
    if nk.route(nv, nefc) != "wide":
      raise AssertionError(f"{case} does not take the wide route")
    in_smem = wlib.newton_wide_workspace_floats(nv, nefc) == 0
    args = [a.to(dev) for a in nk.random_batch(100 + seed, *case)]
    kw = dict(n_friction=nfr, iterations=6, ls_iterations=6)
    before = nk.launches_wide
    ours = nk.newton_solve(*args, **kw)
    if nk.launches_wide != before + 1:
      raise AssertionError(f"{case}: the wide kernel did not launch")
    err = compare(f"16a nv {nv} nefc {nefc} friction {nfr} limits {limits} "
                  f"batch {batch}{' non-PD' if non_pd else ''} "
                  f"({'shared' if in_smem else 'device'} memory)", ours,
                  nk.newton_solve_wide_reference(*args, **kw), TOL)
    if err != 0.0:
      raise AssertionError(f"{case}: not bit-equal to the plain version")
  for seed, case in enumerate(nk.WIDE_FINISH_CASES):
    # around the factor's warp finish; these shapes take the warp route,
    # so the wide kernel is called directly (not a launch of the main path)
    nv, nefc, nfr, limits, batch, _ = case
    args = [a.to(dev) for a in nk.random_batch(200 + seed, *case)]
    kw = dict(n_friction=nfr, iterations=6, ls_iterations=6)
    err = compare(f"16a nv {nv} nefc {nefc} friction {nfr} limits {limits} "
                  f"batch {batch} (the wide kernel called directly)",
                  nk._launch_wide(wlib, args, **kw),
                  nk.newton_solve_wide_reference(*args, **kw), TOL)
    if err != 0.0:
      raise AssertionError(f"{case}: not bit-equal to the plain version")
  for nv, nefc in ((23, 23), (33, 235), (38, 336), (40, 9)):
    if lib.newton_solve_smem_per_env(nv, nefc) != nk.warp_smem_per_env(
        nv, nefc):
      raise AssertionError(f"warp_smem_per_env({nv}, {nefc}) disagrees")
  print(f"  16a {len(nk.WIDE_EDGE_CASES)} wide cases and "
        f"{len(nk.WIDE_FINISH_CASES)} around the warp finish bit-equal; "
        f"route and the warp layout agree with the library")


def wide_split(label, phase_lib, args, kw):
  """The wide kernel's phase split at these inputs, from its phase-clock
  build `phase_lib` (whatever the inputs' route)."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  cycles = torch.zeros(args[0].shape[0], len(nk.PHASES), dtype=torch.int64,
                       device=args[0].device)
  nk._launch_wide(phase_lib, args, cycles=cycles, **kw)
  phase_split(label, cycles, nk.PHASES, per="block")


def clutter_check(dev, phase_lib, split_libs):
  """16(b): the cluttered Relocate through make(..., model_xml) at batch
  BATCH: reset, WIDE_STEPS timed control steps with the launch counts
  (10 wide per control step, no warp launch), the profile, the wide kernel
  against its plain version at the scene's own per-env inputs with its
  numbers, its phase split beside its blocks per SM, the resource that
  limits them and its waves, its carveout in turns against `split_libs`'
  (carveout_turns), and the golden replay."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.envs.challenge import state_from
  from myosuite_tpu_torch.envs.registry import ASSETS
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  with np.load(os.path.join(ASSETS, "wide_golden.npz")) as z:
    golden = {k: z[k] for k in z.files}
  xml = str(golden["scene_xml"])
  if CLUTTER not in xml:
    raise AssertionError("the golden's scene is not the cluttered one")
  env = myosuite_tpu_torch.make("MtxRelocate-v0",
                                overrides={"model_xml": xml})
  m = env.model
  nefc = m.plan["constraint"].nefc
  gen = torch.Generator(dev).manual_seed(0)
  t0 = time.perf_counter()
  state = env.reset(gen, BATCH)
  print(f"  16b cluttered Relocate (model_xml) reset at batch {BATCH} in "
        f"{time.perf_counter() - t0:.2f} s; nv {m.nv}, nu {m.nu}, nefc "
        f"{nefc}, contact slots {m.ncon_max}, route "
        f"{nk.route(m.nv, nefc)}")
  if (m.nv, nefc) != (45, 375) or nk.route(m.nv, nefc) != "wide":
    raise AssertionError("the scene is not (45, 375) on the wide route")
  _, state = control_steps(env, state, gen, 1)
  nk.launches = nk.launches_wide = 0
  step_ms, state = control_steps(env, state, gen, WIDE_STEPS)
  launches, wide = nk.launches, nk.launches_wide
  obs, d = state.obs["state"], state.data
  finite = bool(torch.isfinite(obs).all() & torch.isfinite(state.reward)
                .all())
  print(f"  {WIDE_STEPS} control steps: {step_ms:.2f} ms per control step, "
        f"{BATCH / step_ms * 1e3:.0f} env-steps/s; wide launches {wide} "
        f"({wide / WIDE_STEPS:g} per control step), warp launches "
        f"{launches}; obs and reward finite {finite}; mean ncon_active "
        f"{float(d.ncon_active.float().mean()):.3f} of {m.ncon_max}")
  if wide != WIDE_STEPS * env._n_substeps or launches != 0:
    raise AssertionError(f"cluttered Relocate: {wide} wide and {launches} "
                         f"warp launches, want "
                         f"{WIDE_STEPS * env._n_substeps} and 0")
  if not finite:
    raise AssertionError("cluttered Relocate: non-finite obs or reward")
  action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
  busy, n_launch = step_profile(env, state, action, step_ms)
  args, kw = forward.solve_inputs(env._model_for_step(state.info), d)
  k = kernel_numbers(f"cluttered Relocate batch {BATCH}", args, kw)
  wide_split(f"wide kernel, cluttered Relocate batch {BATCH}", phase_lib,
             args, kw)
  _, bound, waves, config = wide_occupancy_line("cluttered Relocate", m.nv,
                                                nefc)
  if k["max_abs"] != 0.0:
    raise AssertionError(f"cluttered Relocate: the wide kernel is not "
                         f"bit-equal to its plain version ({k['max_abs']})")
  nb = golden["actions"].shape[1]
  gstate = env.reset(torch.Generator(dev).manual_seed(0), nb)
  at = lambda key: torch.from_numpy(golden[key]).to(dev)
  info = {key[len("init_info_"):]: at(key) for key in golden
          if key.startswith("init_info_")}
  gstate = state_from(env, gstate, at("init_qpos"), at("init_qvel"), info)
  check_golden("  16b golden", env, gstate, golden)
  turns = carveout_turns("cluttered Relocate", split_libs, args, kw)
  return dict(k, nv=m.nv, nefc=nefc, launches=wide, step_ms=step_ms,
              busy_ms=busy, launches_per_substep=n_launch / env._n_substeps,
              limited_by=bound, waves=waves,
              carveout=dict(config, ms_in_turns=turns), args=args, kw=kw,
              env="MtxRelocate-v0 + 2 loose spheres (model_xml)")


def wide_occupancy_line(label, nv, nefc, batch=BATCH):
  """Print the wide kernel's blocks per SM at these sizes (the occupancy
  API, with the attributes a launch sets), the resource that limits them
  (shared memory where they are as many as it alone allows at the largest
  split, else registers: 128 threads a block leave room for 16) and the
  waves of `batch` envs, beside what the launch is set up with, read back
  from the runtime (nk.wide_config); returns (blocks per SM, the limiting
  resource, waves, the config)."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  per_sm, in_smem = nk.wide_occupancy(nv, nefc)
  config = nk.wide_config(nv, nefc)
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  bound = ("shared memory" if per_sm == config["smem_blocks_largest"]
           else "registers")
  waves = batch / (per_sm * sms)
  smem = nk._wide_library().newton_wide_smem_bytes(nv, nefc)
  print(f"  occupancy, {label}: {per_sm} blocks (envs) per SM, limited by "
        f"{bound} (shared memory alone allows "
        f"{config['smem_blocks_largest']} at the largest split; "
        f"{config['registers']} registers and {config['local_bytes']} "
        f"bytes of local memory a thread, {smem} bytes of shared memory an "
        f"env, the working set in {'shared' if in_smem else 'device'} "
        f"memory); carveout read back {config['carveout_pct']}% = the "
        f"{config['split_kb']} KB shared-memory split "
        f"({256 - config['split_kb']} KB of L1; shared memory alone allows "
        f"{config['smem_blocks']} there); {batch} envs on {sms} SMs = "
        f"{waves:.3f} waves ({-(-batch // (per_sm * sms))} rounded up)")
  return per_sm, bound, waves, config


def carveout_turns(label, split_libs, args, kw):
  """The wide kernel at these inputs with the carveout its launch sets
  ("set") against builds that ask for another (`split_libs`: "largest",
  the 228 KB split; "default", no preference), each's carveout read back
  and its blocks per SM, bit-equal, timed in turns (set, others, others
  reversed, set); returns {name: [ms, ms]}."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  nv, nefc = args[1].shape[2], args[1].shape[1]
  libs = dict(set=nk._wide_library(), **split_libs)
  base = nk._launch_wide(libs["set"], args, **kw)
  for name, lib in libs.items():
    config = nk.wide_config(nv, nefc, lib)
    same = all(torch.equal(a, b)
               for a, b in zip(nk._launch_wide(lib, args, **kw), base))
    print(f"  16b carveout {name}: read back {config['carveout_pct']}% "
          f"(split {config['split_kb']} KB; -1: the runtime's default), "
          f"{nk.wide_occupancy(nv, nefc, lib)[0]} blocks per SM, bit-equal "
          f"{same}")
    if not same:
      raise AssertionError(f"16b: the {name} carveout build differs")
  order = ["set", *split_libs, *reversed(split_libs), "set"]
  ms = {name: [] for name in libs}
  for name in order:
    ms[name].append(cuda_ms(lambda: nk._launch_wide(libs[name], args, **kw),
                            20))
  print(f"  16b {label} by carveout in turns ({', '.join(order)}): "
        + "; ".join(f"{name} {v} ms" for name, v in ms.items()))
  return ms


def warp_route_record(dev, phase_lib, name):
  """16(c), a record for the routing of an env that stays on the warp
  kernel (Bimanual's (38, 336), Relocate's (33, 235)): both kernels at its
  inputs after a control step, bit-equal to the plain version and to each
  other, timed in turns."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk
  env = myosuite_tpu_torch.make(name)
  gen = torch.Generator(dev).manual_seed(0)
  state = env.reset(gen, BATCH)
  _, state = control_steps(env, state, gen, 1)
  args, kw = forward.solve_inputs(env._model_for_step(state.info),
                                  state.data)
  nv, nefc = args[1].shape[2], args[1].shape[1]
  if nk.route(nv, nefc) != "warp":
    raise AssertionError(f"{name} left the warp kernel")
  wlib = nk._wide_library()
  run = {"warp": lambda: nk.newton_solve(*args, **kw),
         "wide": lambda: nk._launch_wide(wlib, args, **kw)}
  ref = nk.newton_solve_reference(*args, **kw)
  outs = {who: fn() for who, fn in run.items()}
  err = compare(f"16c {name} ({nv}, {nefc}) batch {BATCH} wide",
                outs["wide"], ref, TOL)
  same = all(torch.equal(a, b) for a, b in zip(outs["wide"], outs["warp"]))
  if err != 0.0 or not same:
    raise AssertionError(f"16c: the wide kernel is not bit-equal to the "
                         f"plain version and the warp kernel at {name}'s "
                         f"inputs")
  ms = {"warp": [], "wide": []}
  for who in WIDE_TURNS:
    ms[who].append(cuda_ms(run[who], 20))
  wide_split(f"wide kernel, {name} batch {BATCH}", phase_lib, args, kw)
  per_sm, bound, waves, _ = wide_occupancy_line(name, nv, nefc)
  print(f"  16c {name} in turns ({', '.join(WIDE_TURNS)}): warp "
        f"{ms['warp']} ms, wide {ms['wide']} ms per launch; the wide kernel "
        f"bit-equal to the warp kernel {same}")
  return dict(nv=nv, nefc=nefc, ms=float(np.mean(ms["wide"])),
              warp_ms=float(np.mean(ms["warp"])), max_abs_err=err,
              blocks_per_sm=per_sm, waves=waves, args=args, kw=kw,
              env=f"{name} (record; routed to the warp kernel)")


def compare_parent_wide(path, shapes):
  """--parent: the wide kernel of the checkout at `path` against this one
  at each (label, args, kw) of `shapes`: bit-equal, in turns (parent,
  this, this, parent), with the parent's occupancy and phase split."""
  from myosuite_tpu_torch.physics import newton_kernel as nk
  parent = load_parent(path)
  with ThreadPoolExecutor(2) as pool:
    builds = [pool.submit(parent.build, True, (), parent.WIDE_SOURCE),
              pool.submit(parent.build, True, ("NEWTON_PHASE_CLOCKS",),
                          parent.WIDE_SOURCE)]
    (plib_path, _, _), (pclk_path, _, _) = [b.result() for b in builds]
  libs = {"parent": parent.load_wide(plib_path),
          "this": nk._wide_library()}
  pclk = parent.load_wide(pclk_path)
  out = {}
  for label, args, kw in shapes:
    nv, nefc = args[1].shape[2], args[1].shape[1]
    res = {who: nk._launch_wide(lib, args, **kw) for who, lib in libs.items()}
    same = all(torch.equal(a, b) for a, b in zip(res["parent"], res["this"]))
    ms = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
      ms[who].append(cuda_ms(lambda: nk._launch_wide(libs[who], args, **kw),
                             20))
    per_sm = libs["parent"].newton_wide_occupancy(nv, nefc)
    print(f"  16d {label} ({nv}, {nefc}) in turns (parent, this, this, "
          f"parent): parent {ms['parent']} ms, this {ms['this']} ms per "
          f"launch ({np.mean(ms['parent']) / np.mean(ms['this']):.3f}x); "
          f"bit-equal {same}; parent {per_sm} blocks per SM")
    wide_split(f"parent wide kernel, {label} batch {BATCH}", pclk, args, kw)
    if not same:
      raise AssertionError(f"16d: the parent's wide kernel and this one "
                           f"differ at {label}'s inputs")
    out[label] = dict(parent_ms=ms["parent"], ms=ms["this"],
                      parent_blocks_per_sm=per_sm)
  return out


def wide_phase(dev, phase_lib, split_libs, parent=None):
  """Phase 16: the wide route (nv > 40, or rows past the warp kernel's
  shared memory): the edge cases, the cluttered Relocate as the main path
  of the wide kernel, the Bimanual and Relocate records, and with
  `parent` the parent's wide kernel in turns; `phase_lib` is the wide
  kernel's phase-clock build, `split_libs` its builds that ask for
  another carveout (carveout_turns). Raises on any failed check; returns
  the numbers."""
  watch = Stopwatch()
  print("phase 16 wide route: csrc/newton_solver_wide.cu")
  with watch.part("edge cases"):
    wide_edge_check(dev)
  with watch.part("cluttered Relocate"):
    scene = clutter_check(dev, phase_lib, split_libs)
  records = {}
  for name in ("MtxBimanual-v0", "MtxRelocate-v0"):
    with watch.part(f"{name} record"):
      records[name] = warp_route_record(dev, phase_lib, name)
  turns = None
  if parent:
    with watch.part("parent's wide kernel"):
      turns = compare_parent_wide(parent, [
          ("cluttered Relocate", scene["args"], scene["kw"]),
          ("Bimanual", records["MtxBimanual-v0"]["args"],
           records["MtxBimanual-v0"]["kw"])])
  watch.report("phase 16")
  return dict(scene=scene, records=records, parent=turns)


def main():
  parser = argparse.ArgumentParser()
  parser.add_argument("--parent", help="checkout whose Newton kernels to "
                      "time against this one in turns (the warp kernel in "
                      "phase 3, the hand's control step in 14, the wide "
                      "kernel in 16)")
  opts = parser.parse_args()
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card", file=sys.stderr)
    return 2
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import forward
  from myosuite_tpu_torch.physics import newton_kernel as nk

  dev = torch.device("cuda")
  t_start = time.perf_counter()
  ends = []            # (phase, seconds since the start) at each phase's end

  def mark(n):
    ends.append((n, time.perf_counter() - t_start))

  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0]
  print(f"nvidia-smi: {smi}")
  print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")

  # 1. build: each kernel's library and its phase-clock one, and the wide
  # kernel asking for the largest split and for none, at once
  clocks = ("NEWTON_PHASE_CLOCKS",)
  splits = {"largest": "NEWTON_WIDE_CARVEOUT=100",
            "default": "NEWTON_WIDE_CARVEOUT=-1"}
  with ThreadPoolExecutor(6) as pool:
    builds = [pool.submit(nk.build, True),
              pool.submit(nk.build, True, clocks),
              pool.submit(nk.build, True, (), nk.WIDE_SOURCE),
              pool.submit(nk.build, True, clocks, nk.WIDE_SOURCE)]
    split_builds = {name: pool.submit(nk.build, True, (d,), nk.WIDE_SOURCE)
                    for name, d in splits.items()}
    ((path, seconds, log), (phase_path, phase_s, _),
     (wide_path, wide_s, wide_log), (wide_phase_path, wide_phase_s, _)) = [
         b.result() for b in builds]
    split_paths = {name: b.result()[0] for name, b in split_builds.items()}
  print(f"phase 1 build: {nk.SOURCE} -> {path} in {seconds:.1f} s; "
        f"phase-clock build {phase_path} in {phase_s:.1f} s; "
        f"{nk.WIDE_SOURCE} -> {wide_path} in {wide_s:.1f} s, its "
        f"phase-clock build {wide_phase_path} in {wide_phase_s:.1f} s; "
        f"its builds with {', '.join(splits.values())}")
  for line in (log + wide_log).splitlines():
    if "Compiling" in line or "registers" in line or "spill" in line:
      print("  ptxas:", line.strip())

  mark(1)
  # 2. kernel against its plain version on synthetic systems
  print("phase 2 kernel vs plain version")
  for seed, case in enumerate(nk.EDGE_CASES):
    nv, nefc, nfr, limits, batch, non_pd = case
    args = [a.to(dev) for a in nk.random_batch(seed, *case)]
    kw = dict(n_friction=nfr, iterations=6, ls_iterations=6)
    compare(f"nv {nv} nefc {nefc} friction {nfr} limits {limits} batch "
            f"{batch}{' non-PD' if non_pd else ''}",
            nk.newton_solve(*args, **kw),
            nk.newton_solve_reference(*args, **kw), TOL)

  mark(2)
  # 3. the main path
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0")
  gen = torch.Generator(dev).manual_seed(0)
  t0 = time.perf_counter()
  state = env.reset(gen, BATCH)
  torch.cuda.synchronize()
  print(f"phase 3 main path: reset at batch {BATCH} in "
        f"{time.perf_counter() - t0:.2f} s; nv {env.model.nv}, nu "
        f"{env.model.nu}, nefc {env.model.plan['constraint'].nefc}")
  for _ in range(2):   # warm-up
    state = env.step(state, torch.rand(BATCH, env.action_size,
                                       generator=gen, device=dev))
  torch.cuda.synchronize()
  nk.launches = 0
  t0 = time.perf_counter()
  for _ in range(STEPS):
    state = env.step(state, torch.rand(BATCH, env.action_size,
                                       generator=gen, device=dev))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = nk.launches
  obs = state.obs["state"]
  print(f"  {STEPS} control steps: {wall / STEPS * 1e3:.2f} ms per control "
        f"step, {BATCH * STEPS / wall:.0f} env-steps/s; kernel launches "
        f"{launches}; obs {tuple(obs.shape)} finite "
        f"{bool(torch.isfinite(obs).all())}")
  want = STEPS * env._n_substeps
  if launches != want:
    raise AssertionError(f"kernel launched {launches} times, want {want}")
  if not bool(torch.isfinite(obs).all()):
    raise AssertionError("non-finite observations")
  action = torch.rand(BATCH, env.action_size, generator=gen, device=dev)
  step_profile(env, state, action, wall / STEPS * 1e3)

  # kernel vs plain version at the main path's shapes, and their times
  args, kw = forward.solve_inputs(env.model, state.data)
  hand = kernel_numbers(f"hand batch {BATCH}", args, kw)
  ours, epb = hand["ours"], hand["epb"]
  ms = hand["ms"]
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  # the same inputs at one block per SM: a quarter of the warps compete for
  # each scheduler, so the time falls as far as issue, not latency, bounds
  few = [a[:sms * epb].contiguous() for a in args]
  ms_few = cuda_ms(lambda: nk.newton_solve(*few, **kw), 50)
  print(f"  at one block per SM (batch {sms * epb}): {ms_few:.4f} ms per "
        f"launch, {ms / ms_few:.2f}x under batch {BATCH}")
  phase_lib = nk.load(phase_path)
  phase_split(f"this kernel, batch {BATCH}",
              nk.phase_cycles(*args, **kw, lib=phase_lib), nk.PHASES)
  phase_split(f"this kernel, batch {sms * epb}",
              nk.phase_cycles(*few, **kw, lib=phase_lib), nk.PHASES)
  if opts.parent:
    compare_parent(opts.parent, env, state, gen, args, kw, ours, few)

  mark(3)
  # 4. golden trajectory of the JAX package, replayed on the card
  from myosuite_tpu_torch.envs.registry import ASSETS
  with np.load(f"{ASSETS}/hand_reach_golden.npz") as z:
    golden = {k: z[k] for k in z.files}
  genv = myosuite_tpu_torch.make("MtxHandReachFixed-v0")
  gstate = genv.reset(torch.Generator(dev).manual_seed(0),
                      golden["actions"].shape[1])
  check_golden("phase 4 golden", genv, gstate, golden)

  mark(4)
  # 5. PPO on the main path at full width
  from myosuite_tpu_torch.train import ppo as ppo_mod
  build = os.path.join(os.path.dirname(os.path.abspath(nk.__file__)),
                       os.pardir, "_build")
  print(f"phase 5 PPO: MtxHandReachRandom-v0 at default_config() "
        f"({BATCH} envs)")
  cfg = ppo_mod.default_config()
  trained = ppo_phase(env, cfg, os.path.join(build, "ckpt_hand"))
  launches_ppo = sum(s["launches"] for s in trained["steps"])

  mark(5)
  # 6. PPO learns
  print("phase 6 PPO learns: MtxElbowPoseRandom-v0, "
        + ", ".join(f"{k} {v}" for k, v in LEARN.items()))
  learn_phase(dev, os.path.join(build, "ckpt_elbow"))

  mark(6)
  # 7. contacts: the leg
  leg = contact_phase(dev, build)

  mark(7)
  # 8. in-hand manipulation
  manip = manip_phase(dev, build, phase_lib)

  mark(8)
  # 9. muscle conditions and myobase
  myobase = myobase_phase(dev, build, phase_lib)

  mark(9)
  # 10. per-env models, tracking and MyoDM
  tracking = tracking_phase(dev, build, phase_lib)

  mark(10)
  # 11. the MyoChallenge envs
  chal = challenge_phase(dev, build, phase_lib)

  mark(11)
  # 12. trainers and agents: SAC, NPG, the pretrained policies, reflex
  agents = agents_phase(dev)
  stand = agents["stand"]

  mark(12)
  # 13. scale-out over ranks and the user tools
  tools = mesh_tools_phase(dev, build)

  mark(13)
  # 14. C5 and the renderer
  rendered = render_phase(dev, build, opts.parent)

  mark(14)
  # 15. the model build: the builders' sweep and the host helpers
  model_build_phase(dev, tools["examine_env"]["trace"])

  mark(15)
  # 16. the wide route
  wide = wide_phase(dev, nk.load_wide(wide_phase_path),
                    {name: nk.load_wide(p) for name, p in split_paths.items()},
                    opts.parent)
  scene, records = wide["scene"], wide["records"]

  mark(16)
  print("phase ends (s since the start): " + ", ".join(
      f"{n} {t:.0f}" for n, t in ends))
  # the card again, on one of the last lines (the head of a long output
  # may be cut off where it is read)
  print(f"phases 1-16 in {time.perf_counter() - t_start:.0f} s")
  print(f"nvidia-smi: {smi}")
  print(json.dumps({"kernels": [{
      "name": "newton_solver", "route": "cuda",
      "source": "myosuite_tpu_torch/csrc/newton_solver.cu",
      "replaces": "myosuite_tpu/physics/pallas_solver.py:95",
      "launches": launches_ppo,
      "launches_per_training_step": launches_ppo / len(trained["steps"]),
      "launches_per_control_step": launches / STEPS,
      "launches_phase_14": rendered["launches"],
      "max_abs_err": hand["max_abs"], "ms": ms,
      "plain_ms": hand["plain_ms"], "bound_ms": hand["bound_ms"],
      "bound_by": hand["bound_by"], "library_ms": None,
      "shapes": [dict(nv=env.model.nv,
                      nefc=env.model.plan["constraint"].nefc,
                      env="MtxHandReachRandom-v0", ms=ms,
                      launches=launches, max_abs_err=hand["max_abs"],
                      bound_ms=hand["bound_ms"], plain_ms=hand["plain_ms"]),
                 dict(nv=leg["nv"], nefc=leg["nefc"], env="MtxLegWalk-v0",
                      ms=leg["leg"]["ms"], launches=leg["launches"],
                      max_abs_err=leg["leg"]["max_abs"],
                      bound_ms=leg["leg"]["bound_ms"],
                      plain_ms=leg["leg"]["plain_ms"])]
      + [{k: s[k] for k in ("nv", "nefc", "env", "ms", "launches",
                            "max_abs_err", "bound_ms", "plain_ms")}
         for s in manip["shapes"]
         + [s for s in myobase["shapes"] if s["tag"] in NEW_MODELS]
         + tracking["shapes"] + chal["shapes"]]
      + [dict(nv=leg["nv"], nefc=leg["nefc"],
              env="MtxLegStand-v0 under its trained policy",
              ms=stand["ms"], launches=stand["launches"],
              max_abs_err=stand["max_abs"], bound_ms=stand["bound_ms"],
              plain_ms=stand["plain_ms"])]}, {
      "name": "newton_solver_wide", "route": "cuda",
      "source": "myosuite_tpu_torch/csrc/newton_solver_wide.cu",
      "replaces": "myosuite_tpu/physics/pallas_solver.py:95",
      "launches": scene["launches"],
      "launches_per_control_step": scene["launches"] / WIDE_STEPS,
      "max_abs_err": scene["max_abs"], "ms": scene["ms"],
      "plain_ms": scene["plain_ms"], "bound_ms": scene["bound_ms"],
      "bound_by": scene["bound_by"], "library_ms": None,
      "blocks_per_sm": scene["blocks_per_sm"],
      "limited_by": scene["limited_by"], "waves": scene["waves"],
      "carveout": scene["carveout"],
      "shapes": [dict(nv=scene["nv"], nefc=scene["nefc"], env=scene["env"],
                      ms=scene["ms"], launches=scene["launches"],
                      max_abs_err=scene["max_abs"],
                      bound_ms=scene["bound_ms"],
                      plain_ms=scene["plain_ms"])]
      + [dict({k: v for k, v in r.items() if k not in ("args", "kw")},
              launches=0) for r in records.values()],
      "parent_turns": wide["parent"]}]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
