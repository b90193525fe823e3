"""The port's scale-out (`parallel/mesh.py`, PPO over ranks, `train_ppo
--mesh`) on the CPU, against the JAX package's mesh and PPO.

Ranks are processes joined over gloo with a `file://` rendezvous under the
test's tmp_path (no port to race for under xdist); every launch has a
timeout. The two-rank run is shared by the tests that read it
(`two_ranks`): the statistics update over the group, and one training step
of MtxElbowPoseRandom-v0 at 4 envs per rank, unroll 2, 2 minibatches.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import time
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import myosuite_tpu_torch
from myosuite_tpu_torch.envs.base import State
from myosuite_tpu.parallel import mesh as jmesh
from myosuite_tpu.train import ppo as jppo_mod
from myosuite_tpu.train import running_stats as jrs
from myosuite_tpu_torch.parallel import mesh as mesh_mod
from myosuite_tpu_torch.train import checkpoint, convert
from myosuite_tpu_torch.train import ppo as ppo_mod
from myosuite_tpu_torch.train import running_stats, train_ppo
from tests.torch_common import assert_close

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, PER_RANK, T, MINIBATCHES, PASSES = 2, 4, 2, 2, 2
HIDDEN = (16, 16)
STATS_N, STATS_D = 13, 5
TIMEOUT = 120   # seconds for a launch of ranks

# One rank of the two-rank run: the statistics over the group, then a
# distributed training step of the elbow, whose update is held bit for bit
# against the single-rank _update_epoch of the gathered trajectory in the
# same process.
_RANK = r"""
import datetime, sys
import numpy as np
import torch
torch.set_num_threads(1)
import myosuite_tpu_torch
from myosuite_tpu_torch.parallel import mesh as mesh_mod
from myosuite_tpu_torch.train import ppo as ppo_mod, running_stats

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
mesh_mod.initialize_distributed(
    backend="gloo", init_method=init, world_size=world, rank=rank,
    timeout=datetime.timedelta(seconds=60))
mesh = mesh_mod.make_mesh("cpu")
assert (mesh.world_size, mesh.rank) == (world, rank)

z = np.load(out + "/stats_in.npz")
start = running_stats.RunningStats(*(torch.from_numpy(z[k]) for k in
                                     ("count", "mean", "m2")))
got = running_stats.update(start, torch.from_numpy(z["x"][rank]),
                           group=mesh.group)

cfg = ppo_mod.default_config()
for k, v in dict(num_envs=%(per)d * world, unroll_length=%(t)d,
                 num_minibatches=%(mb)d, num_updates_per_batch=%(passes)d,
                 policy_hidden=%(hidden)r, value_hidden=%(hidden)r,
                 seed=3).items():
  setattr(cfg, k, v)
env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
ppo = ppo_mod.PPO(env, cfg)
ts = mesh_mod.place(ppo.init(torch.Generator().manual_seed(cfg.seed)), ppo,
                    mesh)
seen = {}
update = ppo._update_epoch

def capture(ts, traj, stats, perms=None, last_obs=None):
  seen.update(ts=ts, traj=traj, stats=stats, last_obs=last_obs,
              gen=ts.generator.get_state())
  return update(ts, traj, stats, perms=perms, last_obs=last_obs)

ppo._update_epoch = capture
after, metrics = ppo.training_step(ts, mesh)
ppo._update_epoch = update
single = torch.Generator()
single.set_state(seen["gen"])
ref, _ = update(seen["ts"].replace(generator=single), seen["traj"],
                seen["stats"], last_obs=seen["last_obs"])
flat = lambda s: ppo.flat_params(s.policy_params, s.value_params) + \
    s.opt_state.mu + s.opt_state.nu + [s.opt_state.count]
bit = all(torch.equal(a, b) for a, b in zip(flat(after), flat(ref)))
res = {"stats_" + k: getattr(got, k).numpy() for k in ("count", "mean", "m2")}
res.update({"learner_%%d" %% i: t.numpy() for i, t in enumerate(flat(after))})
res.update({"traj_" + k: v.numpy() for k, v in seen["traj"]._asdict().items()})
res.update({"pre_" + k: v.numpy() for k, v in
            seen["ts"].policy_params.items()})
res.update({"pre_value_" + k: v.numpy() for k, v in
            seen["ts"].value_params.items()})
res.update({"behavior_" + k: getattr(seen["stats"], k).numpy()
            for k in ("count", "mean", "m2")})
res.update(last_obs=seen["last_obs"].numpy(), bit_equal=bit,
           env_steps=after.env_steps,
           reward_per_step=float(metrics["reward_per_step"]),
           episode_return=float(metrics["episode_return"]),
           local_rows=ts.env_state.obs["state"].numpy())
np.savez(out + "/rank%%d.npz" %% rank, **res)
torch.distributed.destroy_process_group()
print("ok")
""" % dict(per=PER_RANK, t=T, mb=MINIBATCHES, passes=PASSES, hidden=HIDDEN)


def _launch(argvs, logdir, envs=None, timeout=TIMEOUT):
  """Start one process per argv (with envs[i] as its environment) at once;
  wait for all, within the timeout (killed past it); return their
  (returncode, stdout, stderr). Output goes to files under logdir: a full
  pipe that nobody reads would stop a rank mid-collective."""
  envs = envs or [None] * len(argvs)
  files = [(open(os.path.join(logdir, f"p{i}.out"), "w+"),
            open(os.path.join(logdir, f"p{i}.err"), "w+"))
           for i in range(len(argvs))]
  procs = [subprocess.Popen(a, cwd=_REPO, env=e, stdout=f[0], stderr=f[1],
                            text=True)
           for a, e, f in zip(argvs, envs, files)]
  outs = []
  try:
    deadline = time.monotonic() + timeout
    for p, (out, err) in zip(procs, files):
      p.wait(timeout=max(1.0, deadline - time.monotonic()))
      out.seek(0)
      err.seek(0)
      outs.append((p.returncode, out.read(), err.read()))
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
    for pair in files:
      for f in pair:
        f.close()
  return outs


def _stats_inputs(rng):
  x = rng.normal(rng.normal(0, 2, STATS_D), rng.uniform(0.5, 3, STATS_D),
                 (WORLD, STATS_N, STATS_D)).astype(np.float32)
  return dict(x=x, count=np.float32(40.0),
              mean=rng.normal(0, 1, STATS_D).astype(np.float32),
              m2=rng.uniform(5, 50, STATS_D).astype(np.float32))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
  """The two-rank run: (rank 0's results, rank 1's, the stats inputs)."""
  out = tmp_path_factory.mktemp("ranks")
  stats_in = _stats_inputs(np.random.default_rng(0))
  np.savez(out / "stats_in.npz", **stats_in)
  init = f"file://{out}/rendezvous"
  res = _launch([[sys.executable, "-c", _RANK, str(r), str(WORLD), init,
                  str(out)] for r in range(WORLD)], out)
  for rc, stdout, err in res:
    assert rc == 0 and stdout.strip().endswith("ok"), err[-3000:]
  ranks = []
  for r in range(WORLD):
    with np.load(out / f"rank{r}.npz") as z:
      ranks.append({k: z[k] for k in z.files})
  return ranks[0], ranks[1], stats_in


# -- the mesh's pieces -------------------------------------------------------

def _jax_slice(global_batch, world, rank, monkeypatch):
  """JAX's local_env_slice for `rank` of a `world`-process mesh of one
  device per process."""
  devs = [types.SimpleNamespace(process_index=p) for p in range(world)]
  fake = types.SimpleNamespace(devices=np.array(devs, dtype=object))
  monkeypatch.setattr(jax, "process_index", lambda: rank)
  return jmesh.local_env_slice(fake, global_batch)


@pytest.mark.parametrize("global_batch,world", [(8, 1), (8, 2), (4096, 2),
                                                (4096, 4), (48, 3)])
def test_local_env_slice_matches_jax(global_batch, world, monkeypatch):
  for rank in range(world):
    mesh = mesh_mod.Mesh(world_size=world, rank=rank,
                         device=torch.device("cpu"))
    got = mesh_mod.local_env_slice(mesh, global_batch)
    want = _jax_slice(global_batch, world, rank, monkeypatch)
    assert (got.start, got.stop) == (want.start, want.stop)


def test_local_env_slice_rejects_an_uneven_batch(monkeypatch):
  mesh = mesh_mod.Mesh(world_size=3, rank=0, device=torch.device("cpu"))
  with pytest.raises(ValueError, match="does not divide"):
    mesh_mod.local_env_slice(mesh, 8)
  with pytest.raises(AssertionError):
    _jax_slice(8, 3, 0, monkeypatch)


def test_initialize_distributed_is_a_noop_without_a_group(monkeypatch):
  for var in mesh_mod.GROUP_VARS:
    monkeypatch.delenv(var, raising=False)
  calls = []
  monkeypatch.setattr(dist, "init_process_group",
                      lambda **kw: calls.append(kw))
  mesh_mod.initialize_distributed()
  assert not calls and not dist.is_initialized()
  mesh = mesh_mod.make_mesh("cpu")
  assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
  local = torch.arange(6.0).reshape(3, 2)
  assert mesh_mod.gather_env_rows(local, mesh) is local


def test_initialize_distributed_error_handling(monkeypatch):
  """The benign double join is swallowed; every other failure raises, and
  the backend follows the device unless named."""
  monkeypatch.setattr(dist, "is_initialized", lambda: False)
  calls, msg = [], []

  def fake_init(**kw):
    calls.append(kw)
    if msg:
      raise RuntimeError(msg[0])
  monkeypatch.setattr(dist, "init_process_group", fake_init)
  mesh_mod.initialize_distributed(init_method="file:///nowhere",
                                  world_size=2, rank=1, device="cpu")
  assert calls[-1]["backend"] == "gloo" and calls[-1]["rank"] == 1
  msg.append("the default process group is already initialized")
  mesh_mod.initialize_distributed(backend="gloo", init_method="file:///x",
                                  world_size=2, rank=0)
  msg[0] = "connection refused by the rendezvous"
  with pytest.raises(RuntimeError, match="connection refused"):
    mesh_mod.initialize_distributed(backend="gloo",
                                    init_method="file:///x",
                                    world_size=2, rank=0)
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    mesh_mod.initialize_distributed(world_size=2, rank=0)   # nccl asked


@dataclasses.dataclass
class _Opponent:
  pos: torch.Tensor      # (B, 2)
  table: torch.Tensor    # no env axis
  STATIC = ("table",)


def _tiny_ppo(num_envs=8):
  cfg = ppo_mod.default_config()
  cfg.num_envs, cfg.seed = num_envs, 5
  env = types.SimpleNamespace(device=torch.device("cpu"), action_size=2)
  return ppo_mod.PPO(env, cfg)


def _nested_state(batch):
  rows = torch.arange(batch, dtype=torch.float32)
  info = {"fatigue": {"ma": rows[:, None] * torch.ones(batch, 3),
                      "deep": {"mf": rows}},
          "opponent": _Opponent(pos=torch.stack([rows, -rows], 1),
                                table=torch.arange(float(batch))),
          "generator": torch.Generator().manual_seed(1),
          "reset_generator": torch.Generator().manual_seed(2),
          "step_count": torch.zeros(batch), "scalar": torch.tensor(7.0),
          "name": "elbow"}
  env_state = State(data=None, obs={"state": rows[:, None].repeat(1, 4)},
                    reward=rows, done=torch.zeros(batch), metrics={},
                    info=info)
  return ppo_mod.TrainState(
      policy_params={}, value_params={}, opt_state=None, obs_stats=None,
      env_state=env_state, generator=torch.Generator().manual_seed(0),
      env_steps=0)


def test_place_keeps_each_ranks_rows_of_a_nested_state():
  """Rows 4r..4r+3 of every env-axis tensor, through dicts and a
  dataclass (its STATIC table kept whole); scalars, strings and the
  permutation generator kept; new generators of the rank's own."""
  ppo = _tiny_ppo(8)
  ts = _nested_state(8)
  draws = []
  for rank in range(2):
    mesh = mesh_mod.Mesh(world_size=2, rank=rank,
                         device=torch.device("cpu"))
    got = mesh_mod.place(ts, ppo, mesh)
    want = torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float32)
    info = got.env_state.info
    assert torch.equal(got.env_state.obs["state"][:, 0], want)
    assert torch.equal(info["fatigue"]["ma"][:, 1], want)
    assert torch.equal(info["fatigue"]["deep"]["mf"], want)
    assert torch.equal(info["opponent"].pos[:, 1], -want)
    assert torch.equal(info["opponent"].table, torch.arange(8.0))
    assert info["scalar"] == 7.0 and info["name"] == "elbow"
    assert got.generator is ts.generator
    for k in ("generator", "reset_generator"):
      assert info[k] is not ts.env_state.info[k]
    draws.append([torch.randn(6, generator=g) for g in (
        got.rollout_generator, info["generator"], info["reset_generator"])])
  # the ranks' action noise, env draws and auto-reset draws all differ
  for a, b in zip(*draws):
    assert not torch.equal(a, b)
  # and rank 0 of a second placement draws what it drew the first time
  again = mesh_mod.place(ts, ppo, mesh_mod.Mesh(2, 0, torch.device("cpu")))
  assert torch.equal(torch.randn(6, generator=again.rollout_generator),
                     draws[0][0])


def test_distributed_training_fn_needs_a_placed_state():
  ppo = _tiny_ppo(8)
  with pytest.raises(ValueError, match="place"):
    mesh_mod.make_distributed_training_fn(
        ppo, _nested_state(8), mesh_mod.Mesh(2, 0, torch.device("cpu")), 1)


# -- two ranks over gloo -----------------------------------------------------

def test_group_running_stats_match_jax_psum(two_ranks):
  """running_stats.update over the two ranks' batches against the JAX
  package's axis_name update under pmap on 2 of the 8 CPU devices: rtol
  1e-6 (test_torch_train's tolerance); both ranks agree bit for bit."""
  r0, r1, s = two_ranks
  start = jrs.RunningStats(count=jnp.float32(s["count"]),
                           mean=jnp.asarray(s["mean"]),
                           m2=jnp.asarray(s["m2"]))
  want = jax.pmap(lambda x: jrs.update(start, x, axis_name="env"),
                  axis_name="env", devices=jax.devices()[:WORLD])(
                      jnp.asarray(s["x"]))
  for k in ("count", "mean", "m2"):
    assert_close(f"group stats {k}", r0["stats_" + k],
                 np.asarray(getattr(want, k))[0], rtol=1e-6)
    np.testing.assert_array_equal(r0["stats_" + k], r1["stats_" + k])
  # the whole batch through the single-rank update: the same statistics
  one = running_stats.update(
      running_stats.RunningStats(*(torch.from_numpy(np.asarray(s[k]))
                                   for k in ("count", "mean", "m2"))),
      torch.from_numpy(s["x"].reshape(-1, STATS_D)))
  for k in ("count", "mean", "m2"):
    assert_close(f"group vs one batch {k}", r0["stats_" + k],
                 getattr(one, k), rtol=1e-6)


def test_two_rank_learner_is_identical_and_equals_single_rank(two_ranks):
  """After one distributed training step both ranks' params, Adam moments
  and count are bit-identical, rank 0's equal (bit for bit, in its
  process) the single-rank _update_epoch of the gathered trajectory with
  the same permutations; the gathered trajectory holds each rank's rows
  in rank order; env_steps and metrics are global."""
  r0, r1, _ = two_ranks
  keys = sorted(k for k in r0 if k.startswith("learner_"))
  assert keys
  for k in keys:
    np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
  assert bool(r0["bit_equal"]) and bool(r1["bit_equal"])
  for k in r0:
    if k.startswith(("traj_", "last_obs", "behavior_")):
      np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
  assert r0["traj_obs"].shape[:2] == (T, WORLD * PER_RANK)
  # the gathered first observations are each rank's own rows
  np.testing.assert_array_equal(r0["traj_obs"][0, :PER_RANK],
                                r0["local_rows"])
  np.testing.assert_array_equal(r0["traj_obs"][0, PER_RANK:],
                                r1["local_rows"])
  assert int(r0["env_steps"]) == T * WORLD * PER_RANK
  assert float(r0["episode_return"]) == float(r1["episode_return"])
  assert np.isclose(float(r0["reward_per_step"]),
                    float(r0["traj_reward"].astype(np.float64).mean()),
                    rtol=1e-6)


def test_two_rank_update_matches_jax_update_epoch(two_ranks):
  """The gathered trajectory through JAX's _update_epoch (its own
  permutations) and the port's single-rank one given those permutations:
  every parameter within 1e-5 (test_torch_train.py's pattern and
  tolerance)."""
  r0, _, _ = two_ranks
  names = sorted(k[4:] for k in r0 if k.startswith("pre_")
                 and not k.startswith("pre_value_"))
  pol = {k: torch.from_numpy(r0["pre_" + k]) for k in names}
  val = {k[len("pre_value_"):]: torch.from_numpy(r0[k]) for k in r0
         if k.startswith("pre_value_")}
  traj = {k[5:]: r0[k] for k in r0 if k.startswith("traj_")}
  stats = running_stats.RunningStats(*(torch.from_numpy(r0["behavior_" + k])
                                       for k in ("count", "mean", "m2")))
  obs_dim, act = traj["obs"].shape[-1], traj["raw_action"].shape[-1]
  jcfg, tcfg = jppo_mod.default_config(), ppo_mod.default_config()
  for c in (jcfg, tcfg):
    for k, v in dict(num_envs=WORLD * PER_RANK, unroll_length=T,
                     num_minibatches=MINIBATCHES,
                     num_updates_per_batch=PASSES, policy_hidden=HIDDEN,
                     value_hidden=HIDDEN).items():
      setattr(c, k, v)
  jppo = jppo_mod.PPO(types.SimpleNamespace(action_size=act), jcfg)
  tppo = ppo_mod.PPO(types.SimpleNamespace(device=torch.device("cpu"),
                                           action_size=act), tcfg)
  tppo.build_networks(obs_dim)
  pp, vp = convert.flax_from_state_dict(pol), convert.flax_from_state_dict(
      val)
  jstats = jrs.RunningStats(**convert.running_stats_to_numpy(stats))
  key = jax.random.PRNGKey(11)
  jts = jppo_mod.TrainState(
      policy_params=pp, value_params=vp,
      opt_state=jppo.optimizer.init((pp, vp)), obs_stats=jstats,
      env_state=types.SimpleNamespace(obs={"state": jnp.asarray(
          r0["last_obs"])}), rng=key, env_steps=0)
  perms = []
  for _ in range(PASSES):
    key, sub = jax.random.split(key)
    perms.append(torch.tensor(np.asarray(jax.random.permutation(
        sub, T * WORLD * PER_RANK)), dtype=torch.long))
  jts2, _ = jppo._update_epoch(
      jts, jppo_mod.Transition(**{k: jnp.asarray(v) for k, v in
                                  traj.items()}), jstats)
  tts = ppo_mod.TrainState(
      policy_params=pol, value_params=val,
      opt_state=ppo_mod.init_opt_state([tppo._flatten(pol, val)]),
      obs_stats=stats, env_state=None, generator=torch.Generator(),
      env_steps=0)
  tts2, _ = tppo._update_epoch(
      tts, ppo_mod.Transition(**{k: torch.from_numpy(v) for k, v in
                                 traj.items()}), stats, perms=perms,
      last_obs=torch.from_numpy(r0["last_obs"]))
  for got, want in ((tts2.policy_params, jts2.policy_params),
                    (tts2.value_params, jts2.value_params)):
    for k, w in convert.state_dict_from_flax(jax.device_get(want)).items():
      assert_close(f"update_epoch {k}", got[k], w, atol=1e-5)


# -- train_ppo --mesh --------------------------------------------------------

_CLI = ["-m", "myosuite_tpu_torch.train.train_ppo", "--mesh", "-e",
        "MtxElbowPoseRandom-v0", "--num_timesteps", "64", "--num_envs", "8",
        "--unroll_length", "2", "--num_minibatches", "2", "--num_evals",
        "2", "--device", "cpu"]


@pytest.mark.parametrize("world", [1, 2])
def test_train_ppo_mesh_checkpoint_restores_bit_for_bit(world, tmp_path):
  """train_ppo --mesh with RANK / WORLD_SIZE set as torchrun sets them (a
  file:// rendezvous): rank 0 alone prints the CLI's lines and writes a
  learner-only checkpoint, which a single-rank PPO restores bit for
  bit."""
  ckpt = tmp_path / "ckpt"
  envs = []
  for rank in range(world):
    env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1"}
    env.pop("MASTER_ADDR", None)
    envs.append(env)
  argv = [sys.executable, *_CLI, "--init_method",
          f"file://{tmp_path}/rendezvous", "--ckpt", str(ckpt)]
  outs = _launch([argv] * world, tmp_path, envs)
  for rc, _, err in outs:
    assert rc == 0, err[-3000:]
  lines = outs[0][1].strip().splitlines()
  assert lines[0].endswith(f"8 envs, {world} device(s)")
  assert sum(line.startswith("steps=") for line in lines) == 2
  assert json.loads(lines[-1])["steps"] == 64
  assert all(not o[1].strip() for o in outs[1:])   # the other ranks are mute
  path = checkpoint.latest_step_dir(str(ckpt))
  assert path.endswith("step_64")
  saved = torch.load(f"{path}/{checkpoint.FILE}", weights_only=True)
  assert "env_state" not in saved
  env = myosuite_tpu_torch.make("MtxElbowPoseRandom-v0", device="cpu")
  cfg = ppo_mod.default_config()
  cfg.num_envs, cfg.unroll_length, cfg.num_minibatches = 8, 2, 2
  ppo = ppo_mod.PPO(env, cfg)
  got = checkpoint.restore_learner(path, ppo.init(
      torch.Generator().manual_seed(9)))
  assert got.env_steps == 64
  for k, v in saved["policy_params"].items():
    assert torch.equal(got.policy_params[k], v), k
  for k, v in saved["value_params"].items():
    assert torch.equal(got.value_params[k], v), k
  for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                  saved["opt_state"]["mu"] + saved["opt_state"]["nu"]):
    assert torch.equal(a, b)
  for k in ("count", "mean", "m2"):
    assert torch.equal(getattr(got.obs_stats, k), saved["obs_stats"][k])


def test_train_ppo_mesh_rejects_an_uneven_batch(monkeypatch):
  """--num_envs must divide by the world size (here a mesh of 3)."""
  monkeypatch.setattr(mesh_mod, "initialize_distributed",
                      lambda **kw: None)
  monkeypatch.setattr(mesh_mod, "make_mesh", lambda device=None:
                      mesh_mod.Mesh(3, 0, torch.device("cpu"), group="g"))
  with pytest.raises(ValueError, match="does not divide by the world size"):
    with redirect_stdout(io.StringIO()):
      train_ppo.main(["--mesh", "--num_envs", "8", "--device", "cpu"])
