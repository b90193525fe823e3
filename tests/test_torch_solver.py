"""Newton-solver kernel's plain version against the JAX package's solvers.

`newton_solve_reference` (the CUDA kernel's plain PyTorch version) is held
against the Pallas kernel in interpret mode and against vmap of
`newton_xla` + `linalg.solve_pd`, on the synthetic systems of
tests/test_pallas_parity.py, at its tolerance (rtol = atol = 1e-4). The
CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_kernel_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_tpu.physics import pallas_solver
from myosuite_tpu.physics import solver as jax_solver
from myosuite_tpu.physics.constraint import Efc as JaxEfc
from myosuite_tpu_torch.physics import newton_kernel, solver
from myosuite_tpu_torch.physics.constraint import Efc
from tests.test_pallas_parity import _random_system, _xla_reference

NAMES = ("qacc", "qfrc", "force", "a_smooth", "qacc_euler")


def _systems(seed, batch, nv, nefc, n_fr):
  rng = np.random.default_rng(seed)
  return [np.stack(x) for x in zip(
      *[_random_system(rng, nv, nefc, n_fr) for _ in range(batch)])]


def _hand_systems(seed, batch, steps=1):
  """The myoHand's constraint systems (nv = nefc = 23, joint-limit rows
  only): the solve inputs of the port's MtxHandReachRandom-v0 after
  `steps` control steps of uniform random actions, on the CPU."""
  import myosuite_tpu_torch
  from myosuite_tpu_torch.physics import forward
  env = myosuite_tpu_torch.make("MtxHandReachRandom-v0", device="cpu")
  rng = np.random.default_rng(seed)
  state = env.reset(torch.Generator().manual_seed(seed), batch)
  for _ in range(steps):
    action = rng.uniform(0, 1, (batch, env.model.nu)).astype(np.float32)
    state = env.step(state, torch.from_numpy(action))
  args, kw = forward.solve_inputs(env.model, state.data)
  assert args[1].shape[1:] == (23, 23) and kw["n_friction"] == 0
  return [x.numpy() for x in args]


def assert_close_scaled(ours, ref, tol=1e-4, err_msg=""):
  """|ours - ref| <= tol |ref| + tol max(1, max |ref|), elementwise.

  The hand's light finger segments give accelerations up to ~1e4, so
  float32 rounding of the largest component (~1e-3) reaches every
  component through the Cholesky solves: the absolute tolerance scales
  with the output's largest magnitude.
  """
  ref = np.asarray(ref)
  atol = tol * max(1.0, float(np.abs(ref).max(initial=0.0)))
  np.testing.assert_allclose(ours, ref, rtol=tol, atol=atol,
                             err_msg=err_msg)


def _reference(args, n_fr):
  return newton_kernel.newton_solve_reference(
      *map(torch.from_numpy, args), n_friction=n_fr, iterations=6,
      ls_iterations=6)


def _xla(args, n_fr, nefc):
  is_friction = tuple([True] * n_fr + [False] * (nefc - n_fr))
  fn = jax.jit(jax.vmap(_xla_reference(is_friction)))
  return fn(*map(jnp.asarray, args))


@pytest.mark.parametrize("batch", [5, 37])
def test_reference_matches_pallas_and_xla(batch):
  nv, nefc, n_fr = 5, 9, 3
  args = _systems(0, batch, nv, nefc, n_fr)
  ours = _reference(args, n_fr)
  is_friction = tuple([True] * n_fr + [False] * (nefc - n_fr))
  pallas = pallas_solver.solve_batched(
      *map(jnp.asarray, args), is_friction=is_friction, iterations=6,
      ls_iterations=6, interpret=True)
  xla = _xla(args, n_fr, nefc)
  for o, p, x, name in zip(ours, pallas, xla, NAMES):
    np.testing.assert_allclose(o.numpy(), p, rtol=1e-4, atol=1e-4,
                               err_msg="pallas " + name)
    np.testing.assert_allclose(o.numpy(), x, rtol=1e-4, atol=1e-4,
                               err_msg="xla " + name)


def test_reference_matches_pallas_and_xla_past_32_rows():
  """More constraint rows than a warp has lanes (the kernel gathers its
  weighted rows 32 at a time): nv 5, nefc 40, 3 friction rows."""
  nv, nefc, n_fr = 5, 40, 3
  args = _systems(5, 4, nv, nefc, n_fr)
  ours = _reference(args, n_fr)
  is_friction = tuple([True] * n_fr + [False] * (nefc - n_fr))
  pallas = pallas_solver.solve_batched(
      *map(jnp.asarray, args), is_friction=is_friction, iterations=6,
      ls_iterations=6, interpret=True)
  xla = _xla(args, n_fr, nefc)
  assert (ours[2][:, n_fr:] != 0).any(), "no limit row pushes"
  for o, p, x, name in zip(ours, pallas, xla, NAMES):
    np.testing.assert_allclose(o.numpy(), p, rtol=1e-4, atol=1e-4,
                               err_msg="pallas " + name)
    np.testing.assert_allclose(o.numpy(), x, rtol=1e-4, atol=1e-4,
                               err_msg="xla " + name)


def test_reference_hand_shaped_matches_xla():
  args = _hand_systems(1, 8)
  assert args[5].any()   # some limit rows are active
  ours = _reference(args, 0)
  xla = _xla(args, 0, 23)
  for o, x, name in zip(ours, xla, NAMES):
    assert np.isfinite(o.numpy()).all(), name
    assert_close_scaled(o.numpy(), x, err_msg=name)


def test_reference_non_pd_matches_pallas():
  """Non-PD mass matrices: negative pivots are clamped and give a finite
  result, as in the Pallas kernel, where linalg.solve_pd gives NaN."""
  nv, nefc, n_fr = 3, 4, 1
  args = _systems(2, 3, nv, nefc, n_fr)
  args[0][1] = np.diag([1.0, -2.0, 3.0]).astype(np.float32)
  args[0][2] = np.diag([1.0, -1e-3, 3.0]).astype(np.float32)
  ours = _reference(args, n_fr)
  pallas = pallas_solver.solve_batched(
      *map(jnp.asarray, args), is_friction=(True, False, False, False),
      iterations=6, ls_iterations=6, interpret=True)
  for o, p, name in zip(ours, pallas, NAMES):
    assert np.isfinite(o.numpy()).all(), name
    np.testing.assert_allclose(o.numpy(), p, rtol=1e-4, atol=1e-4,
                               err_msg=name)


def test_newton_torch_matches_newton_xla():
  nv, nefc, n_fr = 5, 9, 3
  args = _systems(3, 7, nv, nefc, n_fr)
  qM, J, aref, R, floss, active, warm, qfs, _ = args
  a_smooth = np.linalg.solve(qM, qfs[..., None])[..., 0].astype(np.float32)
  t = torch.from_numpy
  efc = Efc(J=t(J), aref=t(aref), R=t(R), floss=t(floss),
            active=t(active) != 0, n_friction=n_fr)
  ours = solver.newton_torch(t(qM), efc, t(warm), t(a_smooth), 6, 6)
  isfr = np.arange(nefc) < n_fr

  def one(qM, J, aref, R, floss, active, warm, a_smooth):
    e = JaxEfc(J=J, aref=aref, R=R, floss=floss, active=active != 0,
               is_friction=isfr)
    return jax_solver.newton_xla(qM, e, warm, a_smooth, 6, 6)

  ref = jax.jit(jax.vmap(one))(*map(jnp.asarray, (
      qM, J, aref, R, floss, active, warm, a_smooth)))
  for o, x, name in zip(ours, ref, NAMES):
    np.testing.assert_allclose(o.numpy(), x, rtol=1e-4, atol=1e-4,
                               err_msg=name)


def test_newton_solve_dispatch_and_limits():
  args = [torch.from_numpy(a) for a in _systems(4, 2, 4, 5, 1)]
  before = newton_kernel.launches
  out = newton_kernel.newton_solve(*args, n_friction=1, iterations=6,
                                   ls_iterations=6)
  ref = newton_kernel.newton_solve_reference(*args, n_friction=1,
                                             iterations=6, ls_iterations=6)
  for o, r in zip(out, ref):
    assert torch.equal(o, r)
  assert newton_kernel.launches == before   # the CPU path launches nothing
  big = [torch.zeros(1, 33, 33), torch.zeros(1, 2, 33)] + [
      torch.zeros(1, 2)] * 4 + [torch.zeros(1, 33)] * 3
  with pytest.raises(ValueError, match="nv <= 32"):
    newton_kernel.newton_solve(*big, n_friction=0, iterations=1,
                               ls_iterations=1)
