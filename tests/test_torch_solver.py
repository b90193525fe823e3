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
  # nv 41 takes the wide route: on the CPU its plain version, no launch
  wide = newton_kernel.random_batch(0, 41, 9, 0, "some", 3, False)
  before = (newton_kernel.launches, newton_kernel.launches_wide)
  out = newton_kernel.newton_solve(*wide, n_friction=0, iterations=6,
                                   ls_iterations=6)
  ref = newton_kernel.newton_solve_wide_reference(
      *wide, n_friction=0, iterations=6, ls_iterations=6)
  for o, r in zip(out, ref):
    assert torch.equal(o, r)
  assert all(bool(torch.isfinite(o).all()) for o in out)
  assert (newton_kernel.launches, newton_kernel.launches_wide) == before
  # malformed inputs still raise
  for i, bad in ((0, torch.zeros(3, 41, 40)), (1, torch.zeros(3, 9, 40)),
                 (2, torch.zeros(3, 8)), (6, torch.zeros(3, 40)),
                 (1, torch.zeros(3, 9))):
    args = list(wide)
    args[i] = bad
    with pytest.raises(ValueError, match="must be"):
      newton_kernel.newton_solve(*args, n_friction=0, iterations=1,
                                 ls_iterations=1)


def test_reference_matches_xla_past_32_dofs():
  """Past one warp lane per dof (the kernel holds dofs r and r + 32 in
  lane r): the Baoding model's shape, nv 35 and nefc 147, here with 3
  friction rows, against newton_xla. Two Newton iterations of two
  line-search steps: the unrolled XLA solve at 6 x 6 takes ~20 s to
  compile on a CPU, and the kernel's 6 x 6 is held against this plain
  version on the card."""
  nv, nefc, n_fr = 35, 147, 3
  args = _systems(6, 4, nv, nefc, n_fr)
  ours = newton_kernel.newton_solve_reference(
      *map(torch.from_numpy, args), n_friction=n_fr, iterations=2,
      ls_iterations=2)
  is_friction = tuple([True] * n_fr + [False] * (nefc - n_fr))

  def one(qM, J, aref, R, floss, active, warm, qfrc_smooth, damph):
    from myosuite_tpu.physics import linalg
    a_smooth = linalg.solve_pd(qM, qfrc_smooth)
    efc = JaxEfc(J=J, aref=aref, R=R, floss=floss, active=active != 0,
                 is_friction=np.asarray(is_friction))
    qacc, qfrc, force = jax_solver.newton_xla(qM, efc, warm, a_smooth, 2, 2)
    return qacc, qfrc, force, a_smooth

  xla = jax.jit(jax.vmap(one))(*map(jnp.asarray, args))
  assert (ours[2][:, n_fr:] != 0).any(), "no limit row pushes"
  for o, x, name in zip(ours, xla, NAMES):
    np.testing.assert_allclose(o.numpy(), x, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.slow
@pytest.mark.parametrize("nefc,n_fr", [(40, 3), (147, 0)])
def test_reference_matches_pallas_past_32_dofs(nefc, n_fr):
  """nv 35 against the Pallas kernel in interpret mode (~70 s per shape on
  a CPU, hence slow)."""
  nv = 35
  args = _systems(8, 4, nv, nefc, n_fr)
  ours = _reference(args, n_fr)
  is_friction = tuple([True] * n_fr + [False] * (nefc - n_fr))
  pallas = pallas_solver.solve_batched(
      *map(jnp.asarray, args), is_friction=is_friction, iterations=6,
      ls_iterations=6, interpret=True)
  for o, p, name in zip(ours, pallas, NAMES):
    np.testing.assert_allclose(o.numpy(), p, rtol=1e-4, atol=1e-4,
                               err_msg="pallas " + name)


# the EDGE_CASES rows past 32 dofs or 70 rows (the kernel's second half of
# each vector and the manipulation models' shapes)
_WIDE_ROWS = [c for c in newton_kernel.EDGE_CASES if c[0] > 32 or c[1] > 70]


@pytest.mark.parametrize("case", _WIDE_ROWS,
                         ids=lambda c: "nv{}-nefc{}-fr{}-{}-b{}{}".format(
                             *c[:5], "-nonpd" if c[5] else ""))
def test_reference_edge_rows_solve_their_systems(case):
  """The plain version on the wide EDGE_CASES rows (the card holds the
  kernel to it bit for bit): finite outputs, a_smooth and qacc_euler
  solving their systems (checked in float64), qfrc = J^T force, friction
  forces within +-floss, limit and contact forces pushing only, and only
  on active rows."""
  seed = newton_kernel.EDGE_CASES.index(case)
  check_solves_its_systems(case, newton_kernel.random_batch(seed, *case))


def check_solves_its_systems(case, args):
  """The plain version on one EDGE_CASES-style row's systems `args`:
  finite outputs, a_smooth and qacc_euler solving their systems (checked
  in float64), qfrc = J^T force, friction forces within +-floss, limit and
  contact forces pushing only, and only on active rows."""
  nv, nefc, n_fr, _, _, non_pd = case
  out = newton_kernel.newton_solve_reference(
      *args, n_friction=n_fr, iterations=6, ls_iterations=6)
  for o, name in zip(out, NAMES):
    assert torch.isfinite(o).all(), name
  qM, J, _, _, floss, active, _, qfs, damph = [a.double() for a in args]
  qacc, qfrc, force, a_smooth, qacc_euler = [o.double() for o in out]
  np.testing.assert_allclose(qfrc, torch.einsum("ben,be->bn", J, force),
                             rtol=1e-5, atol=1e-5 * float(qfrc.abs().max()))
  assert bool((force[:, :n_fr].abs() <= floss[:, :n_fr] * (1 + 1e-6)).all())
  assert bool((force[:, n_fr:] >= 0).all())
  assert bool((force[:, n_fr:][active[:, n_fr:] == 0] == 0).all())
  ok = slice(1, None) if non_pd else slice(None)   # env 0: clamped pivot
  for M, x, b, name in ((qM, a_smooth, qfs, "a_smooth"),
                        (qM + torch.diag_embed(damph), qacc_euler,
                         qfs + qfrc, "qacc_euler")):
    M, x, b = M[ok], x[ok], b[ok]
    res = (torch.einsum("bij,bj->bi", M, x) - b).abs().max()
    scale = float(M.abs().max() * x.abs().max() + b.abs().max())
    assert float(res) <= 1e-5 * scale, (name, float(res), scale)
