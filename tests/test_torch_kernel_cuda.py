"""The CUDA Newton kernel against its plain PyTorch version, on the card.

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
  rng = np.random.default_rng(seed)
  return [torch.from_numpy(np.stack(x)) for x in zip(
      *[newton_kernel.random_system(rng, 5, 9, 3) for _ in range(batch)])]


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
def test_kernel_matches_plain_hand(cuda):
  args = _hand(cuda, 512)
  out = newton_kernel.newton_solve(*args, n_friction=0, **KW)
  ref = newton_kernel.newton_solve_reference(*args, n_friction=0, **KW)
  for o, r, name in zip(out, ref, NAMES):
    _assert_close(o, r, name)


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
