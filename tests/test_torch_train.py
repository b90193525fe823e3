"""The port's PPO pieces against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function and the port's; the
flax parameters go across by `myosuite_tpu_torch.train.convert`. The JAX
oracles are the pieces (`_loss`, `_gae`, one small `_update_epoch`) on
synthetic observations, never a jitted training step of an env, so the file
stays cheap. `jax.random` and `torch.Generator` streams differ, so where
the JAX side draws (the minibatch permutations) the port is given its
draws. Tolerances are stated in each test.
"""

import io
import json
import math
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myosuite_tpu.train import networks as jnet
from myosuite_tpu.train import ppo as jppo_mod
from myosuite_tpu.train import running_stats as jrs
from myosuite_tpu_torch.train import checkpoint, convert, networks
from myosuite_tpu_torch.train import ppo as ppo_mod
from myosuite_tpu_torch.train import running_stats, train_ppo
from tests.torch_common import assert_close

T, B, OBS, ACT = 5, 8, 9, 3
HIDDEN = (32, 32)


def _configs():
  """The same small PPO config for both packages."""
  jcfg = jppo_mod.default_config()
  tcfg = ppo_mod.default_config()
  small = dict(num_envs=B, unroll_length=T, num_minibatches=4,
               num_updates_per_batch=2, policy_hidden=HIDDEN,
               value_hidden=HIDDEN)
  for k, v in small.items():
    setattr(jcfg, k, v)
    setattr(tcfg, k, v)
  return jcfg, tcfg


def _pair():
  """(JAX PPO, port PPO, flax policy params, flax value params) of a small
  config; the port's networks hold the flax weights."""
  jcfg, tcfg = _configs()
  jppo = jppo_mod.PPO(types.SimpleNamespace(action_size=ACT), jcfg)
  dummy = jnp.zeros((1, OBS))
  k1, k2 = jax.random.split(jax.random.PRNGKey(7))
  pp = jax.device_get(jppo.policy.init(k1, dummy))
  vp = jax.device_get(jppo.value.init(k2, dummy))
  tppo = ppo_mod.PPO(types.SimpleNamespace(device=torch.device("cpu"),
                                           action_size=ACT), tcfg)
  tppo.build_networks(OBS)
  return jppo, tppo, pp, vp


def _stats(rng):
  """Non-trivial obs statistics, made by the JAX package."""
  s = jrs.init(OBS)
  for _ in range(2):
    s = jrs.update(s, jnp.asarray(
        rng.normal(0.3, 2.0, (50, OBS)).astype(np.float32)))
  return jax.device_get(s)


def _trajectory(rng, jppo, pp, stats):
  """A (T, B) trajectory with terminal dones and truncations (never both
  at once, as the rollout records them); old log-probs are the policy's,
  perturbed so that some ratios leave the clip range."""
  obs = rng.normal(0.0, 2.0, (T, B, OBS)).astype(np.float32)
  raw = rng.normal(0.0, 1.0, (T, B, ACT)).astype(np.float32)
  mean, log_std = jppo.policy.apply(pp, jrs.normalize(stats, obs))
  logp = np.asarray(jnet.gaussian_tanh_log_prob(mean, log_std, raw))
  logp = (logp + rng.normal(0.0, 0.3, logp.shape)).astype(np.float32)
  flags = rng.random((T, B))
  done = (flags < 0.15).astype(np.float32)
  trunc = ((flags > 0.9) & (done == 0)).astype(np.float32)
  return dict(obs=obs, action=np.tanh(raw), raw_action=raw, log_prob=logp,
              reward=rng.normal(0.0, 1.0, (T, B)).astype(np.float32),
              done=done, truncation=trunc,
              terminal_obs=rng.normal(0.0, 2.0, (T, B, OBS)).astype(
                  np.float32))


def _states(jppo, tppo, pp, vp, stats, last_obs, seed=3):
  """Matching JAX and port TrainStates (fresh optimizers) whose env state
  only carries the observation the GAE bootstraps from."""
  jts = jppo_mod.TrainState(
      policy_params=pp, value_params=vp,
      opt_state=jppo.optimizer.init((pp, vp)), obs_stats=stats,
      env_state=types.SimpleNamespace(obs={"state": jnp.asarray(last_obs)}),
      rng=jax.random.PRNGKey(seed), env_steps=0)
  tpol = convert.state_dict_from_flax(pp)
  tval = convert.state_dict_from_flax(vp)
  tts = ppo_mod.TrainState(
      policy_params=tpol, value_params=tval,
      opt_state=ppo_mod.init_opt_state([tppo._flatten(tpol, tval)]),
      obs_stats=convert.running_stats_from_flax(stats),
      env_state=types.SimpleNamespace(
          obs={"state": torch.from_numpy(last_obs)}),
      generator=torch.Generator(), env_steps=0)
  return jts, tts


def _adam_count(jopt):
  """Adam's count inside apply_if_finite(chain(clip, adam))."""
  return int(jopt.inner_state[1][0].count)


def test_policy_and_value_forward_match_flax():
  """PolicyNet / ValueNet forward on the flax weights: atol 1e-5."""
  jppo, tppo, pp, vp = _pair()
  obs = np.random.default_rng(0).normal(0, 3, (64, OBS)).astype(np.float32)
  jmean, jlog_std = jppo.policy.apply(pp, obs)
  tppo.policy.load_state_dict(convert.state_dict_from_flax(pp))
  tppo.value.load_state_dict(convert.state_dict_from_flax(vp))
  with torch.no_grad():
    tmean, tlog_std = tppo.policy(torch.from_numpy(obs))
    tv = tppo.value(torch.from_numpy(obs))
  assert_close("policy mean", tmean, jmean, atol=1e-5)
  assert_close("policy log_std", tlog_std, jlog_std, atol=1e-5)
  assert_close("value", tv, jppo.value.apply(vp, obs), atol=1e-5)
  # and back: the state dict as flax params is the flax tree
  back = convert.flax_from_state_dict(tppo.policy.state_dict())
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pp)):
    np.testing.assert_array_equal(a, b)


def test_log_prob_and_entropy_match_jax():
  """gaussian_tanh_log_prob and entropy_estimate on supplied raw actions,
  some beyond |raw| = 10 (where softplus must be exact): atol 1e-5."""
  rng = np.random.default_rng(1)
  mean = rng.normal(0, 1, (32, 4)).astype(np.float32)
  log_std = rng.uniform(-5, 2, (32, 4)).astype(np.float32)
  raw = (mean + np.exp(log_std) * rng.normal(0, 1, (32, 4))).astype(
      np.float32)
  raw[:4, 0] = [10.5, -11.0, 14.0, -16.0]
  mean[:4, 0] = raw[:4, 0] - 0.5
  t = [torch.from_numpy(x) for x in (mean, log_std, raw)]
  assert_close("gaussian_tanh_log_prob", networks.gaussian_tanh_log_prob(*t),
               jnet.gaussian_tanh_log_prob(mean, log_std, raw), atol=1e-5)
  assert_close("entropy_estimate", networks.entropy_estimate(*t),
               jnet.entropy_estimate(mean, log_std, raw), atol=1e-5)
  # the sampled action's log-prob is the same function of the noise
  noise = rng.normal(0, 1, (32, 4)).astype(np.float32)
  action, raw2, logp = networks.sample_action_raw(
      t[0], t[1], noise=torch.from_numpy(noise))
  np.testing.assert_allclose(raw2.numpy(), mean + np.exp(log_std) * noise,
                             rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(logp.numpy(), jnet.gaussian_tanh_log_prob(
      mean, log_std, raw2.numpy()), rtol=0, atol=1e-5)


def test_running_stats_match_jax():
  """update over 3 batches, then normalize: rtol 1e-6."""
  rng = np.random.default_rng(2)
  js, ts = jrs.init(OBS), running_stats.init(OBS)
  x = None
  for n in (7, 33, 100):
    x = rng.normal(rng.normal(0, 3, OBS), rng.uniform(0.1, 4, OBS),
                   (n, OBS)).astype(np.float32)
    js = jrs.update(js, jnp.asarray(x))
    ts = running_stats.update(ts, torch.from_numpy(x))
  for k in ("count", "mean", "m2"):
    assert_close(f"running_stats {k}", getattr(ts, k), getattr(js, k),
                 rtol=1e-6)
  assert_close("running_stats normalize",
               running_stats.normalize(ts, torch.from_numpy(x)),
               jrs.normalize(js, jnp.asarray(x)), rtol=1e-6, atol=1e-6)
  # as the JAX package's fields, and back
  back = convert.running_stats_from_flax(jrs.RunningStats(
      **convert.running_stats_to_numpy(ts)))
  for k in ("count", "mean", "m2"):
    assert torch.equal(getattr(back, k), getattr(ts, k)), k
  # identity std while count <= 1
  fresh = running_stats.init(OBS)
  np.testing.assert_array_equal(fresh.std.numpy(), np.ones(OBS))


def test_gae_matches_jax():
  """_gae on a supplied (T=5, B=8) trajectory with terminal dones and
  truncations: advantages and returns to atol 1e-5."""
  rng = np.random.default_rng(3)
  jppo, tppo, pp, vp = _pair()
  stats = _stats(rng)
  traj = _trajectory(rng, jppo, pp, stats)
  last = rng.normal(0, 2, (B, OBS)).astype(np.float32)
  jts, tts = _states(jppo, tppo, pp, vp, stats, last)
  jadv, jret = jppo._gae(jts, jppo_mod.Transition(**traj), stats)
  tadv, tret = tppo._gae(tts, ppo_mod.Transition(
      **{k: torch.from_numpy(v) for k, v in traj.items()}), tts.obs_stats)
  assert_close("gae advantages", tadv, jadv, atol=1e-5)
  assert_close("gae returns", tret, jret, atol=1e-5)


def test_loss_and_gradients_match_jax():
  """_loss on a supplied minibatch: the loss to rtol 1e-5, its parts to
  rtol 1e-5, and the gradients of both networks to 1e-4 of each tensor's
  largest entry (elementwise rtol alone fails on entries that cancel to
  ~0)."""
  rng = np.random.default_rng(4)
  jppo, tppo, pp, vp = _pair()
  stats = _stats(rng)
  traj = _trajectory(rng, jppo, pp, stats)
  n = T * B
  batch = [traj["obs"].reshape(n, OBS), traj["raw_action"].reshape(n, ACT),
           traj["log_prob"].reshape(n),
           rng.normal(0.5, 2, n).astype(np.float32),
           rng.normal(0, 3, n).astype(np.float32)]
  (jloss, jaux), (jgp, jgv) = jax.value_and_grad(jppo._loss, has_aux=True)(
      (pp, vp), [jnp.asarray(x) for x in batch], stats)
  tpol = {k: v.requires_grad_() for k, v in
          convert.state_dict_from_flax(pp).items()}
  tval = {k: v.requires_grad_() for k, v in
          convert.state_dict_from_flax(vp).items()}
  tloss, taux = tppo._loss((tpol, tval), [torch.from_numpy(x) for x in batch],
                           convert.running_stats_from_flax(stats))
  grads = torch.autograd.grad(tloss, [*tpol.values(), *tval.values()])
  assert_close("loss", tloss, jloss, rtol=1e-5)
  for k, v in jaux.items():
    assert_close(f"loss {k}", taux[k], v, rtol=1e-5)
  want = [*convert.state_dict_from_flax(jgp).values(),
          *convert.state_dict_from_flax(jgv).values()]
  names = [*tpol, *tval]
  for name, g, w in zip(names, grads, want):
    scale = float(w.abs().max())
    assert scale > 0
    assert_close(f"grad {name}", g, w, atol=1e-4 * scale)


def test_update_epoch_matches_jax_and_skips_nonfinite():
  """One _update_epoch (2 passes of 4 minibatches) with the permutations
  JAX drew: every parameter within 1e-5. The reward of (t=0, env 0) is
  inf, so that sample's advantage is not finite and the minibatch holding
  it gives a non-finite gradient: both sides skip it once per pass, with
  Adam's count 2 short of the 8 steps."""
  rng = np.random.default_rng(5)
  jppo, tppo, pp, vp = _pair()
  stats = _stats(rng)
  traj = _trajectory(rng, jppo, pp, stats)
  traj["reward"][0, 0] = np.inf
  last = rng.normal(0, 2, (B, OBS)).astype(np.float32)
  jts, tts = _states(jppo, tppo, pp, vp, stats, last)
  # the permutations _update_epoch draws from ts.rng
  perms, key = [], jts.rng
  for _ in range(2):
    key, sub = jax.random.split(key)
    perms.append(torch.tensor(np.asarray(
        jax.random.permutation(sub, T * B)), dtype=torch.long))
  jts2, jaux = jppo._update_epoch(
      jts, jppo_mod.Transition(**{k: jnp.asarray(v) for k, v in traj.items()}),
      stats)
  tts2, taux = tppo._update_epoch(
      tts, ppo_mod.Transition(**{k: torch.from_numpy(v)
                                 for k, v in traj.items()}),
      tts.obs_stats, perms=perms)
  for got, want in ((tts2.policy_params, jts2.policy_params),
                    (tts2.value_params, jts2.value_params)):
    for k, w in convert.state_dict_from_flax(jax.device_get(want)).items():
      assert_close(f"update_epoch {k}", got[k], w, atol=1e-5)
  assert _adam_count(jts2.opt_state) == 6
  assert int(tts2.opt_state.count) == 6
  assert int(jts2.opt_state.total_notfinite) == 2
  assert int(tts2.opt_state.total_notfinite) == 2
  assert not any(torch.isnan(p).any() for p in
                 ppo_mod.PPO.flat_params(tts2.policy_params,
                                         tts2.value_params))
  for k, v in jaux.items():   # the skipped minibatches make the means NaN
    np.testing.assert_allclose(float(taux[k]), float(v), rtol=1e-5,
                               equal_nan=True, err_msg=k)


def test_optimizer_gives_up_after_100_nonfinite_in_a_row():
  """apply_if_finite's max_consecutive_errors: the 101st non-finite
  gradient in a row is applied, as optax applies it."""
  params = [torch.ones(3)]
  opt = ppo_mod.init_opt_state(params)
  bad = [torch.tensor([1.0, float("nan"), 0.0])]
  for i in range(100):
    params, opt = ppo_mod.apply_update(params, bad, opt, 1e-3, 1.0)
  assert torch.equal(params[0], torch.ones(3)) and int(opt.count) == 0
  assert int(opt.notfinite_count) == 100 and not bool(opt.last_finite)
  params, opt = ppo_mod.apply_update(params, bad, opt, 1e-3, 1.0)
  assert int(opt.count) == 1 and torch.isnan(params[0]).any()
  # a finite gradient resets the run
  _, opt = ppo_mod.apply_update([torch.ones(3)], [torch.ones(3)], opt, 1e-3,
                                1.0)
  assert int(opt.notfinite_count) == 0 and int(opt.total_notfinite) == 101


def test_optimizer_matches_optax():
  """Five steps of clip_by_global_norm + adam (constant and cosine lr)
  against optax on random gradients, some above the clip norm: rtol 1e-6
  on the params."""
  rng = np.random.default_rng(6)
  p0 = [rng.normal(0, 1, (4, 3)).astype(np.float32),
        rng.normal(0, 1, 3).astype(np.float32)]
  sched = optax.cosine_decay_schedule(1e-2, 7, alpha=0.05)
  for lr, tlr in ((3e-4, 3e-4), (sched, ppo_mod.cosine_decay(1e-2, 7, 0.05))):
    opt = optax.apply_if_finite(optax.chain(
        optax.clip_by_global_norm(1.0), optax.adam(lr)), 100)
    jp, jst = [jnp.asarray(x) for x in p0], None
    jst = opt.init(jp)
    tp = [torch.from_numpy(x) for x in p0]
    tst = ppo_mod.init_opt_state(tp)
    for i in range(5):
      g = [rng.normal(0, 0.2 + i, x.shape).astype(np.float32) for x in p0]
      upd, jst = opt.update([jnp.asarray(x) for x in g], jst, jp)
      jp = optax.apply_updates(jp, upd)
      tp, tst = ppo_mod.apply_update(tp, [torch.from_numpy(x) for x in g],
                                     tst, tlr, 1.0)
      for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_optax():
  """optax.cosine_decay_schedule(3e-4, 1000, alpha=0.05) at counts 0, 1,
  250, 999, 1000 and past the end: rtol 1e-6."""
  ours = ppo_mod.cosine_decay(3e-4, 1000, 0.05)
  ref = optax.cosine_decay_schedule(3e-4, 1000, alpha=0.05)
  for c in (0, 1, 250, 999, 1000, 5000):
    np.testing.assert_allclose(
        float(ours(torch.tensor(c, dtype=torch.int32))),
        float(ref(jnp.int32(c))), rtol=1e-6, err_msg=str(c))


@pytest.mark.parametrize("shape", [(256, 512), (64, 9)], ids=["wide", "obs"])
def test_init_statistics_follow_lecun_normal(shape):
  """A Linear's weight after reset_parameters: std within 5% of
  sqrt(1/fan_in) (wide layer only: 131k samples), nothing beyond 2
  standard deviations of the untruncated normal, and a zero bias."""
  out_dim, in_dim = shape
  mlp = networks.MLP(in_dim, (out_dim,))
  mlp.reset_parameters(torch.Generator().manual_seed(0))
  w, b = mlp.layers[0].weight.detach(), mlp.layers[0].bias.detach()
  target = math.sqrt(1.0 / in_dim)
  cut = 2 * target / 0.87962566103423978
  assert float(w.abs().max()) <= cut
  if w.numel() > 100_000:
    assert abs(float(w.std()) / target - 1) < 0.05
  assert torch.equal(b, torch.zeros_like(b))


def _tiny_elbow_ppo(num_envs=4):
  import myosuite_tpu_torch
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  cfg = ppo_mod.default_config()
  cfg.num_envs, cfg.unroll_length, cfg.num_minibatches = num_envs, 2, 2
  cfg.num_updates_per_batch, cfg.policy_hidden = 1, (16,)
  cfg.value_hidden = (16,)
  return ppo_mod.PPO(env, cfg)


def _assert_same(a, b):
  for x, y in zip(ppo_mod.PPO.flat_params(a.policy_params, a.value_params),
                  ppo_mod.PPO.flat_params(b.policy_params, b.value_params)):
    assert torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path):
  """Full and learner-only checkpoints of a trained state come back
  bit-equal; restore_learner(skip_opt=True) keeps the target's optimizer,
  and the env state and generators of a full restore continue the same
  stream."""
  ppo = _tiny_elbow_ppo()
  ts = ppo.init(torch.Generator().manual_seed(0))
  ts, _ = ppo.training_step(ts)
  full = checkpoint.save(str(tmp_path), ts, step=ts.env_steps)
  learner = checkpoint.save(str(tmp_path / "learner"), ts, learner_only=True)
  assert checkpoint.latest_step_dir(str(tmp_path)) == full

  fresh = _tiny_elbow_ppo()
  target = fresh.init(torch.Generator().manual_seed(1))
  got = checkpoint.restore(full, target)
  _assert_same(got, ts)
  for a, b in zip(got.opt_state.mu + got.opt_state.nu + [got.opt_state.count],
                  ts.opt_state.mu + ts.opt_state.nu + [ts.opt_state.count]):
    assert torch.equal(a, b)
  for k in ("count", "mean", "m2"):
    assert torch.equal(getattr(got.obs_stats, k), getattr(ts.obs_stats, k))
  assert got.env_steps == ts.env_steps
  assert torch.equal(got.env_state.data.qpos, ts.env_state.data.qpos)
  assert torch.equal(got.env_state.info["target_angles"],
                     ts.env_state.info["target_angles"])
  assert torch.equal(torch.rand(3, generator=got.generator),
                     torch.rand(3, generator=ts.generator))

  got = checkpoint.restore_learner(learner, target, skip_opt=True)
  _assert_same(got, ts)
  assert got.opt_state is target.opt_state
  assert got.env_state is target.env_state
  got = checkpoint.restore_learner(learner, target)
  assert torch.equal(got.opt_state.mu[0], ts.opt_state.mu[0])
  with pytest.raises(KeyError):
    checkpoint.restore(learner, target)   # no env state in a learner file


def test_training_step_changes_params_and_keeps_finite():
  """Two training steps of the elbow on the CPU: finite metrics, params
  that moved, env steps counted, and the rollout's transitions shaped
  (T, B, ...)."""
  ppo = _tiny_elbow_ppo()
  ts = ppo.init(torch.Generator().manual_seed(0))
  before = [p.clone() for p in ppo.flat_params(ts.policy_params,
                                               ts.value_params)]
  ts2, traj = ppo._rollout(ts)
  assert traj.obs.shape == (2, 4, 9) and traj.raw_action.shape == (2, 4, 6)
  ts, metrics = ppo.make_training_fn(2)(ts)
  assert ts.env_steps == 2 * 2 * 4
  assert sorted(metrics) == ["entropy", "episode_return", "policy_loss",
                             "reward_per_step", "value_loss"]
  assert all(bool(torch.isfinite(v)) for v in metrics.values())
  after = ppo.flat_params(ts.policy_params, ts.value_params)
  assert max(float((a - b).abs().max()) for a, b in zip(after, before)) > 0
  act = ppo.make_policy_fn(deterministic=True)(ts, ts.env_state.obs["state"])
  assert act.shape == (4, 6) and bool((act.abs() <= 1).all())


def test_generator_of_another_device_raises():
  """A CUDA env with a CPU generator (or the reverse) is an error: the
  trainer never falls back to drawing on another device. (On a card,
  tests/test_torch_kernel_cuda.py runs the training step itself.)"""
  with pytest.raises(ValueError, match="generator is on cpu"):
    ppo_mod.check_generator(torch.Generator(), torch.device("cuda"))
  ppo = _tiny_elbow_ppo()
  ts = ppo.init(torch.Generator().manual_seed(0))
  ts.generator = types.SimpleNamespace(device=torch.device("cuda"))
  with pytest.raises(ValueError, match="generator is on cuda"):
    ppo.training_step(ts)


def test_train_ppo_cli_on_the_cpu(tmp_path, monkeypatch):
  """train_ppo.main with --device cpu: 2 iterations of the elbow with 8
  envs, a checkpoint per iteration and the closing JSON line. With --mesh
  and no process group in the environment it trains the same run at world
  size 1 (tests/test_torch_mesh.py runs it over ranks)."""
  for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
    monkeypatch.delenv(var, raising=False)
  flags = ["-e", "MtxElbowPoseRandom-v0", "--num_timesteps", "160",
           "--num_envs", "8", "--num_minibatches", "4", "--num_evals", "2",
           "--device", "cpu"]
  runs = {}
  for mesh in ([], ["--mesh"]):
    out = io.StringIO()
    ckpt = tmp_path / ("mesh" if mesh else "plain")
    with redirect_stdout(out):
      train_ppo.main(flags + mesh + ["--ckpt", str(ckpt)])
    lines = out.getvalue().strip().splitlines()
    assert lines[0].startswith("training MtxElbowPoseRandom-v0: 160 steps")
    assert lines[0].endswith("8 envs, 1 device(s)")
    assert sum(line.startswith("steps=") for line in lines) == 2
    assert json.loads(lines[-1])["steps"] == 160
    path = checkpoint.latest_step_dir(str(ckpt))
    assert path.endswith("step_160")
    runs[bool(mesh)] = torch.load(f"{path}/{checkpoint.FILE}",
                                  weights_only=True)
  for k, v in runs[False]["policy_params"].items():
    assert torch.equal(runs[True]["policy_params"][k], v), k
