"""The port's SAC and NPG against the JAX package's, on the CPU.

The JAX oracles are the trainers' pieces (the critics, both losses and
their gradients, one update, GAE, the Fisher-vector product, the natural
step, the value fit) on synthetic observations and a synthetic replay
buffer; flax parameters go across by `myosuite_tpu_torch.train.convert`.
Where the JAX side draws (buffer indices, action normals, permutations),
the port is given the same draws, reproduced from the JAX keys. Parameter
vectors are compared through the parameter structure, never flat index by
index. Tolerances are stated in each test. The port-only smoke tests train
on the elbow at the JAX package's smoke configs (tests/test_sac_npg.py);
they are marked slow (~40 and ~30 s on a CPU: 240 and 192 control steps
of the plain PyTorch physics).
"""

import functools
import types

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_tpu.train import npg as jnpg_mod
from myosuite_tpu.train import running_stats as jrs
from myosuite_tpu.train import sac as jsac_mod
import myosuite_tpu_torch
from myosuite_tpu_torch.train import convert, networks
from myosuite_tpu_torch.train import npg as npg_mod
from myosuite_tpu_torch.train import sac as sac_mod
from tests.torch_common import assert_close

OBS, ACT, HIDDEN = 9, 3, (32, 32)
CAP, ROWS = 256, 200        # replay capacity, rows filled


@pytest.fixture(autouse=True)
def one_thread():
  """One intra-op thread: the many small ops of a CPU env step run faster
  alone than on a thread pool shared with the other test workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


def _stats(rng, dim=OBS):
  """Non-trivial obs statistics, made by the JAX package."""
  s = jrs.init(dim)
  for _ in range(2):
    s = jrs.update(s, jnp.asarray(
        rng.normal(0.3, 2.0, (50, dim)).astype(np.float32)))
  return jax.device_get(s)


def _flax_tree_close(name, got: dict, want_tree, to_sd, atol=0.0,
                     rtol=0.0):
  """A port state dict against a flax tree, tensor by tensor."""
  for k, w in to_sd(jax.device_get(want_tree)).items():
    assert_close(f"{name} {k}", got[k], w, atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# SAC
# ---------------------------------------------------------------------------

SAC_CFG = dict(policy_hidden=HIDDEN, q_hidden=HIDDEN, batch_size=64,
               replay_capacity=CAP, num_envs=8, unroll_length=4)


def _sac_pair():
  """(JAX SAC, port SAC, JAX SACState) of a small config on synthetic
  data: a buffer of ROWS rows (some done), a target net off the critics,
  log_alpha -0.3. The JAX side is made once per process."""
  tcfg = sac_mod.default_config()
  for k, v in SAC_CFG.items():
    setattr(tcfg, k, v)
  tsac = sac_mod.SAC(types.SimpleNamespace(action_size=ACT,
                                           device=torch.device("cpu")), tcfg)
  tsac.build_networks(OBS)
  jsac, jts = _jax_sac()
  return jsac, tsac, jts


@functools.lru_cache(maxsize=None)
def _jax_sac():
  jcfg = jsac_mod.default_config()
  for k, v in SAC_CFG.items():
    setattr(jcfg, k, v)
  jsac = jsac_mod.SAC(types.SimpleNamespace(action_size=ACT), jcfg)
  rng = np.random.default_rng(11)
  k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
  dummy_o, dummy_a = jnp.zeros((1, OBS)), jnp.zeros((1, ACT))
  pp = jsac.policy.init(k1, dummy_o)
  qp = jsac.q.init(k2, dummy_o, dummy_a)
  qt = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(k3, x.shape), qp)
  f32 = lambda *s: rng.normal(0, 1, s).astype(np.float32)
  buf = jsac_mod.ReplayBuffer(
      obs=jnp.asarray(np.pad(2 * f32(ROWS, OBS), ((0, CAP - ROWS), (0, 0)))),
      action=jnp.asarray(np.pad(np.tanh(f32(ROWS, ACT)),
                                ((0, CAP - ROWS), (0, 0)))),
      reward=jnp.asarray(np.pad(f32(ROWS), (0, CAP - ROWS))),
      next_obs=jnp.asarray(np.pad(2 * f32(ROWS, OBS),
                                  ((0, CAP - ROWS), (0, 0)))),
      done=jnp.asarray(np.pad((rng.random(ROWS) < 0.2).astype(np.float32),
                              (0, CAP - ROWS))),
      ptr=jnp.int32(ROWS // 32), size=jnp.int32(ROWS))
  log_alpha = jnp.float32(-0.3)
  jts = jsac_mod.SACState(
      policy_params=pp, q_params=qp, q_target_params=qt, log_alpha=log_alpha,
      policy_opt=jsac.policy_tx.init(pp), q_opt=jsac.q_tx.init(qp),
      alpha_opt=jsac.alpha_tx.init(log_alpha), obs_stats=_stats(rng),
      buffer=buf, env_state=None, rng=jax.random.PRNGKey(9),
      env_steps=jnp.int32(0))
  return jsac, jax.device_get(jts)


def _port_sac_state(tsac, jts):
  """The JAX SACState as the port's (fresh Adam states, as the JAX
  ones are)."""
  pp = convert.state_dict_from_flax(jts.policy_params)
  qp = convert.q_state_dict_from_flax(jts.q_params)
  b = jts.buffer
  t = lambda x: torch.from_numpy(np.asarray(x))
  buf = sac_mod.ReplayBuffer(obs=t(b.obs), action=t(b.action),
                             reward=t(b.reward), next_obs=t(b.next_obs),
                             done=t(b.done), ptr=int(b.ptr), size=int(b.size))
  log_alpha = torch.tensor(float(jts.log_alpha))
  return sac_mod.SACState(
      policy_params=pp, q_params=qp,
      q_target_params=convert.q_state_dict_from_flax(jts.q_target_params),
      log_alpha=log_alpha,
      policy_opt=convert.adam_state_from_optax(jts.policy_opt),
      q_opt=convert.adam_state_from_optax(
          jts.q_opt, convert.q_state_dict_from_flax),
      alpha_opt=convert.adam_state_from_optax(jts.alpha_opt),
      obs_stats=convert.running_stats_from_flax(jts.obs_stats), buffer=buf,
      env_state=None, generator=torch.Generator(), env_steps=0)


def _jax_update_draws(jsac, jts, key):
  """The draws of JAX's _one_update(ts, key): the batch indices and the
  normals of the critic's and the actor's sampled actions."""
  _, k_idx, k_q, k_pi = jax.random.split(key, 4)
  idx = jax.random.randint(k_idx, (jsac.cfg.batch_size,), 0,
                           jnp.maximum(jts.buffer.size, 1))
  shape = (jsac.cfg.batch_size, ACT)
  t = lambda x: torch.from_numpy(np.asarray(x))
  return (t(idx).long(), t(jax.random.normal(k_q, shape)),
          t(jax.random.normal(k_pi, shape)))


def test_qnet_matches_flax_both_ways():
  """QNet's twin outputs (2, batch) on the flax weights: atol 1e-5; the
  state dict back as the flax tree, bit for bit."""
  jsac, tsac, jts = _sac_pair()
  rng = np.random.default_rng(0)
  obs = rng.normal(0, 2, (64, OBS)).astype(np.float32)
  act = np.tanh(rng.normal(0, 1, (64, ACT))).astype(np.float32)
  want = jax.jit(jsac.q.apply)(jts.q_params, obs, act)
  sd = convert.q_state_dict_from_flax(jts.q_params)
  tsac.q.load_state_dict(sd)
  with torch.no_grad():
    got = tsac.q(torch.from_numpy(obs), torch.from_numpy(act))
  assert got.shape == (2, 64)
  assert_close("QNet", got, want, atol=1e-5)
  back = convert.flax_q_from_state_dict(tsac.q.state_dict())
  assert sorted(back["params"]) == sorted(jts.q_params["params"])
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jts.q_params)):
    np.testing.assert_array_equal(a, b)


def test_sac_losses_and_gradients_match_jax():
  """_critic_loss w.r.t. the critics and _actor_loss w.r.t. the policy,
  fed the JAX normals: losses rel 1e-5, every gradient tensor within 1e-4
  of its largest entry; no gradient reaches the target, the policy (from
  the critic loss) or the critics (from the actor loss)."""
  jsac, tsac, jts = _sac_pair()
  tts = _port_sac_state(tsac, jts)
  idx, nq, npi = _jax_update_draws(jsac, jts, jax.random.PRNGKey(3))
  b = jts.buffer
  jbatch = tuple(x[idx.numpy()] for x in (b.obs, b.action, b.reward,
                                          b.next_obs, b.done))
  tb = tts.buffer
  tbatch = tuple(x[idx] for x in (tb.obs, tb.action, tb.reward, tb.next_obs,
                                  tb.done))
  # the JAX losses with the normals the port is given
  _, _, k_q, k_pi = jax.random.split(jax.random.PRNGKey(3), 4)
  jq, jgq = jax.jit(jax.value_and_grad(jsac._critic_loss))(
      jts.q_params, jts, jbatch, k_q)
  (jpi, jlogp), jgpi = jax.jit(jax.value_and_grad(
      jsac._actor_loss, has_aux=True))(jts.policy_params, jts, jbatch, k_pi)

  qp = {k: v.clone().requires_grad_() for k, v in tts.q_params.items()}
  pp = {k: v.clone().requires_grad_() for k, v in tts.policy_params.items()}
  watched = tts.replace(policy_params=pp, q_params=qp,
                        q_target_params={k: v.clone().requires_grad_()
                                         for k, v in
                                         tts.q_target_params.items()})
  tq = tsac._critic_loss(qp, watched, tbatch, nq)
  assert_close("critic loss", tq.detach(), jq, rtol=1e-5)
  tq.backward()
  assert all(v.grad is None for v in
             (*pp.values(), *watched.q_target_params.values()))
  for k, w in convert.q_state_dict_from_flax(jax.device_get(jgq)).items():
    assert_close(f"critic grad {k}", qp[k].grad, w,
                 atol=1e-4 * float(np.abs(w).max()))

  for v in qp.values():
    v.grad = None
  tpi, tlogp = tsac._actor_loss(pp, watched, tbatch, npi)
  assert_close("actor loss", tpi.detach(), jpi, rtol=1e-5)
  assert_close("actor mean logp", tlogp.detach(), jlogp, rtol=1e-5)
  tpi.backward()
  assert all(v.grad is None for v in qp.values())
  for k, w in convert.state_dict_from_flax(jax.device_get(jgpi)).items():
    assert_close(f"actor grad {k}", pp[k].grad, w,
                 atol=1e-4 * float(np.abs(w).max()))


def test_sac_one_update_matches_jax():
  """One _one_update fed the JAX draws: policy, critics, target critics
  and log_alpha within 2e-6, the metrics rel 1e-5, each Adam count 1."""
  jsac, tsac, jts = _sac_pair()
  tts = _port_sac_state(tsac, jts)
  key = jax.random.PRNGKey(5)
  jts2, jm = jax.jit(jsac._one_update)(jts, key)
  tts2, tm = tsac._one_update(tts, _jax_update_draws(jsac, jts, key))
  _flax_tree_close("policy", tts2.policy_params, jts2.policy_params,
                   convert.state_dict_from_flax, atol=2e-6)
  _flax_tree_close("critics", tts2.q_params, jts2.q_params,
                   convert.q_state_dict_from_flax, atol=2e-6)
  _flax_tree_close("target", tts2.q_target_params, jts2.q_target_params,
                   convert.q_state_dict_from_flax, atol=2e-6)
  assert_close("log_alpha", tts2.log_alpha, jts2.log_alpha, atol=2e-6)
  for k, v in jm.items():
    assert_close(f"metric {k}", tm[k], v, rtol=1e-5)
  for opt in (tts2.policy_opt, tts2.q_opt, tts2.alpha_opt):
    assert int(opt.count) == 1


def test_sac_alpha_tracks_target_entropy():
  """Ten updates with the target entropy far below, then far above, the
  policy's: alpha falls, then rises (the check of
  tests/test_sac_npg.py::test_sac_alpha_tracks_target_entropy, on the
  port's updates)."""
  jsac, tsac, jts = _sac_pair()
  tts = _port_sac_state(tsac, jts)
  a0 = float(tts.log_alpha)

  def run(target):
    tsac.target_entropy = target
    ts = tts.replace(generator=torch.Generator().manual_seed(0))
    for _ in range(10):
      ts, _ = tsac._one_update(ts)
    return float(ts.log_alpha)

  assert run(-1000.0) < a0, "alpha must fall when entropy > target"
  assert run(+1000.0) > a0, "alpha must rise when entropy < target"


def test_sac_replay_ring_wraparound():
  """The elbow at 8 envs, unroll 2, a ring of 3 blocks and no updates:
  after 5 epochs ptr is 5 % 3 and size the capacity, every row finite
  (tests/test_sac_npg.py::test_sac_replay_ring_wraparound)."""
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  cfg = sac_mod.default_config()
  cfg.num_envs, cfg.unroll_length = 8, 2
  cfg.replay_capacity = 8 * 2 * 3
  cfg.learning_starts = 10 ** 9
  cfg.policy_hidden = cfg.q_hidden = HIDDEN
  sac = sac_mod.SAC(env, cfg)
  ts = sac.init(torch.Generator().manual_seed(0))
  sizes = []
  for _ in range(5):
    ts, m = sac.training_step(ts)
    sizes.append(m["buffer_size"])
  assert sizes == [16, 32, 48, 48, 48]
  assert ts.buffer.ptr == 5 % 3 and ts.buffer.size == cfg.replay_capacity
  assert bool(torch.isfinite(ts.buffer.obs).all())
  with pytest.raises(ValueError, match="multiple"):
    cfg.replay_capacity = 40
    sac_mod.SAC(env, cfg)


@pytest.mark.slow
def test_sac_trains_on_the_elbow():
  """sac.train at the JAX smoke test's config (32 envs, unroll 4, 60
  epochs in 6 calls, updates from 256 env steps): six progress calls,
  finite metrics, the buffer past learning_starts, q_loss > 0, and the
  deterministic policy's actions in [-1, 1]."""
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  cfg = sac_mod.default_config()
  cfg.num_envs, cfg.unroll_length = 32, 4
  cfg.replay_capacity = 32 * 4 * 64
  cfg.learning_starts, cfg.batch_size = 256, 128
  cfg.grad_updates_per_epoch = 4
  cfg.num_timesteps, cfg.num_evals = 32 * 4 * 60, 6
  history = []
  sac, ts = sac_mod.train(env, cfg,
                          progress_fn=lambda s, m: history.append(m))
  assert len(history) == 6
  last = history[-1]
  for k in ("q_loss", "pi_loss", "alpha", "entropy", "mean_return"):
    assert np.isfinite(last[k]), (k, last)
  assert last["buffer_size"] > cfg.learning_starts
  assert last["q_loss"] > 0.0
  act = sac.make_policy_fn(deterministic=True)(
      ts, ts.env_state.obs["state"][:4])
  assert act.shape == (4, env.action_size)
  assert bool((act.abs() <= 1.0).all())


# ---------------------------------------------------------------------------
# NPG
# ---------------------------------------------------------------------------

T, B = 6, 8


NPG_CFG = dict(num_envs=B, unroll_length=T, value_batches=4,
               value_hidden=HIDDEN)


def _npg_pair():
  """(JAX NPG, port NPG, JAX NPGState, stats, trajectory) of a small
  config on synthetic data; the JAX side is made once per process."""
  tcfg = npg_mod.default_config()
  for k, v in NPG_CFG.items():
    setattr(tcfg, k, v)
  tnpg = npg_mod.NPG(types.SimpleNamespace(action_size=ACT,
                                           device=torch.device("cpu")), tcfg)
  tnpg.build_networks(OBS)
  jnpg, jts, stats, traj = _jax_npg()
  return jnpg, tnpg, jts, stats, traj


@functools.lru_cache(maxsize=None)
def _jax_npg():
  jcfg = jnpg_mod.default_config()
  for k, v in NPG_CFG.items():
    setattr(jcfg, k, v)
  jnpg = jnpg_mod.NPG(types.SimpleNamespace(action_size=ACT), jcfg)
  rng = np.random.default_rng(21)
  k1, k2 = jax.random.split(jax.random.PRNGKey(8))
  dummy = jnp.zeros((1, OBS))
  pp, vp = jnpg.policy.init(k1, dummy), jnpg.value.init(k2, dummy)
  stats = _stats(rng)
  jts = jax.device_get(jnpg_mod.NPGState(
      policy_params=pp, value_params=vp, value_opt=jnpg.value_tx.init(vp),
      obs_stats=stats, env_state=None, rng=jax.random.PRNGKey(13),
      env_steps=jnp.int32(0)))
  flags = rng.random((T, B))
  done = (flags < 0.15).astype(np.float32)
  trunc = ((flags > 0.9) & (done == 0)).astype(np.float32)
  f32 = lambda *s: rng.normal(0, 1, s).astype(np.float32)
  traj = (2 * f32(T, B, OBS), f32(T, B, ACT), f32(T, B), done, trunc,
          2 * f32(T, B, OBS))
  return jnpg, jts, stats, traj


def _port_npg_state(jts):
  vp = convert.state_dict_from_flax(jts.value_params)
  return npg_mod.NPGState(
      policy_params=convert.state_dict_from_flax(jts.policy_params),
      value_params=vp, value_opt=convert.adam_state_from_optax(jts.value_opt),
      obs_stats=convert.running_stats_from_flax(jts.obs_stats),
      env_state=None, generator=torch.Generator(), env_steps=0)


def _torch_traj(traj):
  return npg_mod.Trajectory(*[torch.from_numpy(x) for x in traj])


def test_npg_gae_matches_jax():
  """_gae: advantages (normalized over the batch) and returns, atol
  1e-5."""
  jnpg, tnpg, jts, stats, traj = _npg_pair()
  jadv, jret = jax.jit(jnpg._gae)(jts, tuple(map(jnp.asarray, traj)), stats)
  tts = _port_npg_state(jts)
  tadv, tret = tnpg._gae(tts, _torch_traj(traj), tts.obs_stats)
  assert_close("gae advantages", tadv, jadv, atol=1e-5)
  assert_close("gae returns", tret, jret, atol=1e-5)


def _jax_fvp(jnpg, jts, stats, traj, v_tree):
  """The JAX package's Fisher-vector product (NPG._natural_step's fvp, a
  closure there: the same code on the same inputs) at the policy's
  parameters, for the vector given as a flax tree; returns a flax tree."""
  nobs = jrs.normalize(stats, jnp.asarray(traj[0]))
  flat_obs = nobs.reshape((-1, OBS))
  params0, unravel = jax.flatten_util.ravel_pytree(jts.policy_params)
  old_mean, old_log_std = jnpg.policy.apply(jts.policy_params, flat_obs)

  def mean_kl(flat_params):
    mean, log_std = jnpg.policy.apply(unravel(flat_params), flat_obs)
    var0 = jnp.exp(2.0 * old_log_std)
    var1 = jnp.exp(2.0 * log_std)
    kl = (log_std - old_log_std
          + (var0 + (old_mean - mean) ** 2) / (2.0 * var1) - 0.5)
    return jnp.mean(jnp.sum(kl, axis=-1))

  v = jax.flatten_util.ravel_pytree(v_tree)[0]
  _, hv = jax.jvp(jax.grad(mean_kl), (params0,), (v,))
  return unravel(hv + jnpg.cfg.cg_damping * v)


def test_npg_fisher_vector_product_matches_jax():
  """The Fisher-vector product on a supplied vector (given tensor by
  tensor in the parameter structure): rel 1e-5 of each tensor's largest
  entry."""
  jnpg, tnpg, jts, stats, traj = _npg_pair()
  tts = _port_npg_state(jts)
  rng = np.random.default_rng(3)
  v_sd = {k: torch.from_numpy(rng.normal(0, 1, tuple(p.shape)).astype(
      np.float32)) for k, p in tts.policy_params.items()}
  want = convert.state_dict_from_flax(jax.device_get(jax.jit(
      lambda v: _jax_fvp(jnpg, jts, stats, traj, v))(
          convert.flax_from_state_dict(v_sd))))
  nobs = tnpg._norm_obs(tts.obs_stats, torch.from_numpy(traj[0]))
  flat_obs = nobs.reshape(-1, OBS)
  like = tts.policy_params
  p = networks.flat_params(like).clone().requires_grad_()
  with torch.no_grad():
    old_mean, old_log_std = tnpg.apply_policy(like, flat_obs)
  mean, log_std = tnpg.apply_policy(networks.param_views(p, like), flat_obs)
  kl = torch.mean(torch.sum(
      log_std - old_log_std + (torch.exp(2.0 * old_log_std)
                               + (old_mean - mean) ** 2)
      / (2.0 * torch.exp(2.0 * log_std)) - 0.5, -1))
  grad_kl, = torch.autograd.grad(kl, [p], create_graph=True)
  hv = tnpg.fisher_product(p, grad_kl)(networks.flat_params(v_sd))
  got = networks.param_views(hv.detach(), like)
  for k, w in want.items():
    assert_close(f"fvp {k}", got[k], w, atol=1e-5 * float(np.abs(w).max()))


def test_npg_natural_step_matches_jax():
  """_natural_step (10 CG iterations): surrogate rel 1e-5; the new
  policy within 1e-5 of the step's largest entry and kl_after rel 1e-4,
  looser than the product's (float32 CG amplifies its last bits); kl_after
  near delta."""
  jnpg, tnpg, jts, stats, traj = _npg_pair()
  jtraj = tuple(map(jnp.asarray, traj))
  jadv, _ = jax.jit(jnpg._gae)(jts, jtraj, stats)
  jts2, jm = jax.jit(jnpg._natural_step)(jts, jtraj, jadv, stats)
  tts = _port_npg_state(jts)
  tts2, tm = tnpg._natural_step(tts, _torch_traj(traj),
                                torch.from_numpy(np.asarray(jadv)),
                                tts.obs_stats)
  assert_close("surrogate", tm["surrogate"], jm["surrogate"], rtol=1e-5,
               atol=1e-7)
  assert_close("grad_norm", tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
  assert_close("kl_after", tm["kl_after"], jm["kl_after"], rtol=1e-4)
  old = convert.state_dict_from_flax(jts.policy_params)
  new = convert.state_dict_from_flax(jax.device_get(jts2.policy_params))
  step = max(float(np.abs(new[k] - old[k]).max()) for k in old)
  for k, w in new.items():
    assert_close(f"natural step {k}", tts2.policy_params[k], w,
                 atol=1e-5 * step)
  assert 0 < float(tm["kl_after"]) < 10 * tnpg.cfg.normalized_step_size


def test_npg_fit_value_matches_jax():
  """_fit_value (2 epochs of 4 Adam minibatches) with the permutations
  JAX drew: the value parameters within 1e-5, the last epoch's loss rel
  1e-5."""
  jnpg, tnpg, jts, stats, traj = _npg_pair()
  jtraj = tuple(map(jnp.asarray, traj))
  _, jret = jax.jit(jnpg._gae)(jts, jtraj, stats)
  jts2, jloss = jax.jit(jnpg._fit_value)(jts, jtraj, jret, stats)
  # the permutations _fit_value draws from ts.rng
  _, key = jax.random.split(jts.rng)
  perms = []
  for _ in range(jnpg.cfg.value_epochs):
    key, sub = jax.random.split(key)
    perms.append(torch.from_numpy(np.asarray(
        jax.random.permutation(sub, T * B))).long())
  tts = _port_npg_state(jts)
  tts2, tloss = tnpg._fit_value(tts, _torch_traj(traj),
                                torch.from_numpy(np.asarray(jret)),
                                tts.obs_stats, perms=perms)
  _flax_tree_close("value fit", tts2.value_params, jts2.value_params,
                   convert.state_dict_from_flax, atol=1e-5)
  assert_close("value loss", tloss, jloss, rtol=1e-5)
  assert int(tts2.value_opt.count) == 8


@pytest.mark.slow
def test_npg_trains_on_the_elbow():
  """npg.train at the JAX smoke test's config (32 envs, unroll 16, CG 5,
  12 iterations in 4 calls): finite metrics at every call, the last
  kl_after in (0, 10 delta), the deterministic policy's actions shaped
  (2, nu)."""
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  cfg = npg_mod.default_config()
  cfg.num_envs, cfg.unroll_length, cfg.cg_iters = 32, 16, 5
  cfg.num_timesteps, cfg.num_evals, cfg.seed = 32 * 16 * 12, 4, 1
  history = []
  npg, ts = npg_mod.train(env, cfg,
                          progress_fn=lambda s, m: history.append(m))
  assert len(history) == 4
  for m in history:
    for k in ("kl_after", "value_loss", "reward_per_step"):
      assert np.isfinite(m[k]), history
  assert 0.0 < history[-1]["kl_after"] < 10 * cfg.normalized_step_size
  act = npg.make_policy_fn(deterministic=True)(
      ts, ts.env_state.obs["state"][:2])
  assert act.shape == (2, env.action_size)
