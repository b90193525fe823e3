"""The CUDA Newton kernels against their plain PyTorch version, on the card.

Imports neither JAX nor MuJoCo, so it runs where only PyTorch is installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Every test skips without a CUDA card.
"""

import numpy as np
import pytest
import torch

from myosuite_tpu_torch.physics import forward, newton_kernel

NAMES = ("qacc", "qfrc", "force", "a_smooth", "qacc_euler")
KW = dict(iterations=6, ls_iterations=6)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda")


def _synthetic(seed, batch):
  """The synthetic systems of tests/test_pallas_parity.py: nv 5, nefc 9,
  3 friction rows."""
  return newton_kernel.random_batch(seed, 5, 9, 3, "some", batch, False)


def _hand(device, batch, steps=3):
  """Solve inputs of the port's MtxHandReachRandom-v0 after `steps`
  control steps of uniform random actions."""
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device=device)
  gen = torch.Generator(device).manual_seed(0)
  state = env.reset(gen, batch)
  for _ in range(steps):
    state = env.step(state, torch.rand(batch, env.action_size,
                                       generator=gen, device=device))
  args, kw = forward.solve_inputs(env.model, state.data)
  assert kw["n_friction"] == 0
  return args


def _assert_close(ours, ref, name, tol=1e-4):
  """|ours - ref| <= tol |ref| + tol max(1, max |ref|): the hand's
  accelerations reach ~1e4, and float32 rounding of the largest component
  reaches every component through the Cholesky solves."""
  ours, ref = ours.double().cpu(), ref.double().cpu()
  scale = max(1.0, float(ref.abs().max()))
  assert torch.isfinite(ours).all(), name
  assert bool(((ours - ref).abs() <= tol * ref.abs() + tol * scale).all()), (
      name, float((ours - ref).abs().max()), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [5, 37])
def test_kernel_matches_plain_synthetic(cuda, batch):
  args = [a.to(cuda) for a in _synthetic(batch, batch)]
  before = newton_kernel.launches
  out = newton_kernel.newton_solve(*args, n_friction=3, **KW)
  torch.cuda.synchronize()
  assert newton_kernel.launches == before + 1
  ref = newton_kernel.newton_solve_reference(*args, n_friction=3, **KW)
  for o, r, name in zip(out, ref, NAMES):
    _assert_close(o, r, name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", newton_kernel.EDGE_CASES,
                         ids=lambda c: "nv{}-nefc{}-fr{}-{}-b{}{}".format(
                             *c[:5], "-nonpd" if c[5] else ""))
def test_kernel_matches_plain_edge_cases(cuda, case):
  """Every lane of the tile (nv 32) and past it (nv 33-40: two dofs per
  lane), weighted rows past one warp (nefc 70) and the manipulation
  models' 83-168 rows, all or no limit rows active, ragged batches and a
  negative pivot: the kernel and its plain version round alike, so the
  outputs are equal."""
  seed = newton_kernel.EDGE_CASES.index(case)
  args = [a.to(cuda) for a in newton_kernel.random_batch(seed, *case)]
  kw = dict(n_friction=case[2], **KW)
  out = newton_kernel.newton_solve(*args, **kw)
  ref = newton_kernel.newton_solve_reference(*args, **kw)
  for o, r, name in zip(out, ref, NAMES):
    assert torch.isfinite(o).all(), name
    assert torch.equal(o, r), (name, float((o - r).abs().max()))


@pytest.mark.cuda
def test_kernel_takes_nv_up_to_40(cuda):
  """nv 40 goes to the warp kernel (one launch); nv 41 to the wide kernel
  (one wide launch, none of the warp kernel), bit-equal to its plain
  version."""
  args = [a.to(cuda) for a in newton_kernel.random_batch(0, 40, 9, 0, "some",
                                                          3, False)]
  before = newton_kernel.launches, newton_kernel.launches_wide
  out = newton_kernel.newton_solve(*args, n_friction=0, **KW)
  torch.cuda.synchronize()
  assert (newton_kernel.launches, newton_kernel.launches_wide) == (
      before[0] + 1, before[1])
  assert all(bool(torch.isfinite(o).all()) for o in out)
  big = [a.to(cuda) for a in newton_kernel.random_batch(0, 41, 9, 0, "some",
                                                         3, False)]
  out = newton_kernel.newton_solve(*big, n_friction=0, **KW)
  torch.cuda.synchronize()
  assert (newton_kernel.launches, newton_kernel.launches_wide) == (
      before[0] + 1, before[1] + 1)
  ref = newton_kernel.newton_solve_wide_reference(*big, n_friction=0, **KW)
  for o, r, name in zip(out, ref, NAMES):
    assert torch.equal(o, r), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", newton_kernel.WIDE_EDGE_CASES,
                         ids=lambda c: "nv{}-nefc{}-fr{}-{}-b{}{}".format(
                             *c[:5], "-nonpd" if c[5] else ""))
def test_wide_kernel_bit_equal_edge_cases(cuda, case):
  """The wide kernel on its EDGE_CASES rows (nv 41-256, one row to 1,200,
  friction rows, all or no limit rows active, a negative pivot; in shared
  memory and in the device-memory workspace): every output equal to its
  plain version's, and one wide launch."""
  nv, nefc, nfr = case[:3]
  args = [a.to(cuda) for a in newton_kernel.random_batch(
      100 + newton_kernel.WIDE_EDGE_CASES.index(case), *case)]
  before = newton_kernel.launches_wide
  out = newton_kernel.newton_solve(*args, n_friction=nfr, **KW)
  torch.cuda.synchronize()
  assert newton_kernel.launches_wide == before + 1
  ref = newton_kernel.newton_solve_wide_reference(*args, n_friction=nfr,
                                                  **KW)
  for o, r, name in zip(out, ref, NAMES):
    assert torch.isfinite(o).all(), name
    assert torch.equal(o, r), (name, float((o - r).abs().max()))
  lib = newton_kernel._wide_library()
  in_smem = lib.newton_wide_workspace_floats(nv, nefc) == 0
  assert in_smem == (newton_kernel.wide_smem_bytes(nv, nefc)
                     <= newton_kernel._SMEM_LIMIT)
  if in_smem:
    assert lib.newton_wide_smem_bytes(nv, nefc) == \
        newton_kernel.wide_smem_bytes(nv, nefc)


@pytest.mark.cuda
@pytest.mark.parametrize("case", newton_kernel.WIDE_FINISH_CASES,
                         ids=lambda c: "nv{}-nefc{}-fr{}".format(*c[:3]))
def test_wide_kernel_around_its_warp_finish(cuda, case):
  """Around the factor's warp finish (nv 17: the whole factor in warp 0;
  nv 18 and 19: one pair of columns under block barriers first), shapes
  of the warp route, the wide kernel called directly is bit-equal to the
  plain version."""
  nfr = case[2]
  args = [a.to(cuda) for a in newton_kernel.random_batch(
      200 + newton_kernel.WIDE_FINISH_CASES.index(case), *case)]
  out = newton_kernel._launch_wide(newton_kernel._wide_library(), args,
                                   n_friction=nfr, **KW)
  ref = newton_kernel.newton_solve_wide_reference(*args, n_friction=nfr,
                                                  **KW)
  for o, r, name in zip(out, ref, NAMES):
    assert torch.equal(o, r), (name, float((o - r).abs().max()))


@pytest.mark.cuda
def test_wide_kernel_runs_8_envs_per_sm_at_the_scene(cuda):
  """At the cluttered Relocate's (45, 375) 8 blocks (envs) share an SM,
  the working set in shared memory: 64 registers a thread limit them
  (shared memory alone would allow 9), and the launch asks for the 196 KB
  shared-memory split (a carveout of 85 percent, read back from the
  runtime), the smallest that holds 8 x (24,016 + 1,024) bytes, which
  leaves 60 KB of L1 for the passes over J."""
  assert newton_kernel.wide_occupancy(45, 375) == (8, True)
  config = newton_kernel.wide_config(45, 375)
  assert config["registers"] <= 64
  assert (config["carveout_pct"], config["split_kb"]) == (85, 196)
  assert (config["smem_blocks"], config["smem_blocks_largest"]) == (8, 9)


@pytest.mark.cuda
def test_wide_kernel_equals_warp_kernel_where_both_take(cuda):
  """At Bimanual's (38, 336), which routes to the warp kernel, the wide
  kernel called directly gives the warp kernel's outputs bit for bit; the
  route's shared-memory rule is the warp library's."""
  args = [a.to(cuda) for a in newton_kernel.random_batch(7, 38, 336, 0,
                                                          "some", 64, False)]
  assert newton_kernel.route(38, 336) == "warp"
  warp = newton_kernel.newton_solve(*args, n_friction=0, **KW)
  wide = newton_kernel._launch_wide(newton_kernel._wide_library(), args,
                                    n_friction=0, **KW)
  for a, b, name in zip(warp, wide, NAMES):
    assert torch.equal(a, b), name
  lib = newton_kernel._library()
  for nv, nefc in ((23, 23), (33, 235), (38, 336), (40, 9), (38, 1068)):
    assert lib.newton_solve_smem_per_env(nv, nefc) == \
        newton_kernel.warp_smem_per_env(nv, nefc)


@pytest.mark.cuda
def test_kernel_occupancy_one_wave_on_hand(cuda):
  """The hand's solve (nv = nefc = 23) at batch 4096 fits the card in one
  wave of blocks."""
  blocks_per_sm, epb = newton_kernel.occupancy(23, 23)
  sms = torch.cuda.get_device_properties(cuda).multi_processor_count
  assert -(-4096 // epb) <= blocks_per_sm * sms, (blocks_per_sm, epb, sms)


@pytest.mark.cuda
def test_kernel_matches_plain_hand(cuda):
  args = _hand(cuda, 512)
  out = newton_kernel.newton_solve(*args, n_friction=0, **KW)
  ref = newton_kernel.newton_solve_reference(*args, n_friction=0, **KW)
  for o, r, name in zip(out, ref, NAMES):
    _assert_close(o, r, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["MtxTorsoPoseRandom-v0",
                                  "MtxArmReachRandom-v0",
                                  "MtxArmPoseRandom-v0",
                                  "MtxSarcHandReachRandom-v0",
                                  "MtxFatiHandReachRandom-v0"])
def test_kernel_bit_equal_at_myobase_inputs(cuda, name):
  """The torso (nv 18, nefc 18), the arm reach (7, 7), the arm pose
  (27, 27), and the hand under sarcopenia and fatigue, at each env's own
  solver inputs after 3 control steps: outputs equal to the plain
  version's."""
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make(name, device=cuda)
  gen = torch.Generator(cuda).manual_seed(0)
  state = env.reset(gen, 256)
  for _ in range(3):
    state = env.step(state, torch.rand(256, env.action_size, generator=gen,
                                       device=cuda))
  args, kw = forward.solve_inputs(env.model, state.data)
  out = newton_kernel.newton_solve(*args, **kw)
  ref = newton_kernel.newton_solve_reference(*args, **kw)
  for o, r, n in zip(out, ref, NAMES):
    assert torch.isfinite(o).all(), n
    assert torch.equal(o, r), (n, float((o - r).abs().max()))


# the envs of chip_smoke.py's phase 10: per-env models (the exo payload,
# SAR's capsule), the cyclic tracks and one MyoDM id per object class
TRACKING_IDS = ("MtxElbowPoseExoRandom-v0", "MtxHandReorient100-v0",
                "MtxHandTrackCyclic-v0", "MtxFingerTrackCyclic-v0",
                "MtxHandAppleLift-v0", "MtxHandAirplaneLift-v0",
                "MtxHandMugLift-v0", "MtxHandFlutePass-v0",
                "MtxHandAppleRandom-v0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRACKING_IDS)
def test_kernel_bit_equal_at_tracking_inputs(cuda, name):
  """The elbow with a payload (nv 1), SAR's per-env capsule (29, 87), the
  cyclic tracks (23, 23) and (4, 4), the MyoDM sphere (29, 83), box and
  cylinder hulls (29, 151) and capsule (29, 87), at each env's own solver
  inputs (its per-env model's) after 3 control steps: outputs equal to
  the plain version's."""
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make(name, device=cuda)
  gen = torch.Generator(cuda).manual_seed(0)
  state = env.reset(gen, 256)
  for _ in range(3):
    state = env.step(state, torch.rand(256, env.action_size, generator=gen,
                                       device=cuda))
  args, kw = forward.solve_inputs(env._model_for_step(state.info),
                                  state.data)
  out = newton_kernel.newton_solve(*args, **kw)
  ref = newton_kernel.newton_solve_reference(*args, **kw)
  for o, r, n in zip(out, ref, NAMES):
    assert torch.isfinite(o).all(), n
    assert torch.equal(o, r), (n, float((o - r).abs().max()))


# the envs of chip_smoke.py's phase 11: the leg's (20, 54) with an opponent
# and with the OSL, Soccer (26, 138), Relocate's per-env object (33, 235),
# Bimanual (38, 336) and TableTennis (33, 39)
CHALLENGE_IDS = ("MtxChaseTag-v0", "MtxSoccer-v0", "MtxRunTrack-v0",
                 "MtxRelocate-v0", "MtxBimanual-v0", "MtxTableTennis-v0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CHALLENGE_IDS)
def test_kernel_bit_equal_at_challenge_inputs(cuda, name):
  """Each MyoChallenge env's own solver inputs (Relocate's per-env
  model's) after 3 control steps at batch 256: outputs equal to the plain
  version's."""
  test_kernel_bit_equal_at_tracking_inputs(cuda, name)


@pytest.mark.cuda
def test_kernel_bit_equal_at_trained_stand_policy_inputs(cuda):
  """The committed stand policy, restored on the card, drives
  MtxLegStand-v0 for 20 control steps at batch 64; the solver's inputs at
  the states it reaches (the leg's (20, 54) under a trained policy's
  contact load) give the kernel and its plain version bit-equal
  outputs."""
  from myosuite_tpu_torch.agents import pretrained
  trainer, ts = pretrained.load("MtxLegStand-v0", device=cuda)
  env = trainer.env._env
  pol = trainer.make_policy_fn(deterministic=True)
  state = env.reset(torch.Generator(cuda).manual_seed(0), 64)
  with torch.no_grad():
    for _ in range(20):
      state = env.step(state, pol(ts, state.obs["state"]))
  args, kw = forward.solve_inputs(env.model, state.data)
  assert args[1].shape[1:] == (54, 20)
  out = newton_kernel.newton_solve(*args, **kw)
  ref = newton_kernel.newton_solve_reference(*args, **kw)
  for o, r, name in zip(out, ref, NAMES):
    assert torch.equal(o, r), name


@pytest.mark.cuda
def test_kernel_takes_every_myodm_scene(cuda):
  """Each committed MyoDM scene's recorded (nv, nefc) fits a block's
  shared memory in the built library."""
  import glob
  import os
  from myosuite_tpu_torch.envs.registry import ASSETS
  lib = newton_kernel._library()
  paths = sorted(glob.glob(os.path.join(ASSETS, "myodm", "*.npz")))
  assert len(paths) == 50
  for path in paths:
    with np.load(path) as z:
      nv, nefc = int(z["myodm_nv"]), int(z["myodm_nefc"])
    assert newton_kernel._envs_per_block(lib, nv, nefc) >= 1, path


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
  args = [a.to(cuda) for a in _synthetic(0, 4)]
  bad = list(args)
  bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
  with pytest.raises(ValueError, match="contiguous float32"):
    newton_kernel.newton_solve(*bad, n_friction=3, **KW)
  bad = list(args)
  bad[0] = args[0].double()
  with pytest.raises(ValueError, match="contiguous float32"):
    newton_kernel.newton_solve(*bad, n_friction=3, **KW)


def _elbow_trainer(device, num_envs=64):
  import myosuite_tpu_torch
  from myosuite_tpu_torch.train import ppo
  cfg = ppo.default_config()
  cfg.num_envs, cfg.num_minibatches, cfg.num_updates_per_batch = \
      num_envs, 4, 2
  return ppo.PPO(myosuite_tpu_torch.make("MtxElbowPoseRandom-v0",
                                         device=device), cfg)


@pytest.mark.cuda
def test_training_step_runs_the_kernel(cuda):
  """A PPO training step of the elbow (nv = 1) on the card solves every
  substep of every rollout step in the kernel: unroll_length x 10
  launches, finite metrics."""
  trainer = _elbow_trainer(cuda)
  ts = trainer.init(torch.Generator(device=cuda).manual_seed(0))
  before = newton_kernel.launches
  ts, metrics = trainer.training_step(ts)
  torch.cuda.synchronize()
  assert newton_kernel.launches - before == trainer.cfg.unroll_length * 10
  assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics


@pytest.mark.cuda
def test_cuda_env_with_cpu_generator_raises(cuda):
  """No fallback: a CPU generator for a CUDA env is an error."""
  trainer = _elbow_trainer(cuda, num_envs=8)
  with pytest.raises(ValueError, match="generator is on cpu"):
    trainer.init(torch.Generator().manual_seed(0))
  ts = trainer.init(torch.Generator(device=cuda).manual_seed(0))
  ts.generator = torch.Generator()
  with pytest.raises(ValueError, match="generator is on cpu"):
    trainer.training_step(ts)
