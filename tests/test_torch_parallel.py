"""The port's data-parallel PPO/A2C over ranks, on the CPU over gloo.

`parallel/distributed.py`'s decisions run in subprocesses with a stubbed
`init_process_group` (the counterparts of `tests/test_services.py`'s init
tests). A real two-rank world (two processes of this file, `file://`
rendezvous, gloo) runs every multi-rank case in one spawn, beside a third
process that computes the one-process references: an all_reduce and the
gather's bits; PPO and A2C on Env01-v1 with 6-step episodes (16 envs x 4
steps, minibatch 4, 1 epoch, 3 iterations, float64, the training grade
of the solver) and PPO on the noisy
Env01-v2 (2 iterations), whose params must be bit-equal on both ranks and
within 1e-12 of the one-process run of the same seed (identically seeded
shards that drew the same noise would fail this); the sharded update from
per-rank shards of one trajectory against the JAX package's `_update` on a
2-device mesh of virtual CPU devices (1e-9); and the runner under 2 ranks
on a toy env: rank 0 alone writes, the resume file is the one-process
run's and loads either way, and `max_wall_s=0` stops both ranks at once.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.parallel import mesh as pm
from balance_robot_tpu_torch.train import checkpoint, runner
from balance_robot_tpu_torch.train.ppo import PPO, PPOConfig

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
WORLD = 2
WORLD_TIMEOUT_S = 600

# (env id, PPOConfig overrides, iterations) of the two-rank training runs
A2C = dict(clip_range=None, optimizer="rmsprop", normalize_advantage=False,
           gae_lambda=1.0, lr=7e-4)
TRAIN_CASES = {"ppo-env01-v1": ("Env01-v1", {}, 3),
               "a2c-env01-v1": ("Env01-v1", A2C, 3),
               "ppo-env01-v2": ("Env01-v2", {}, 2)}
UPDATE_CASES = {"ppo": False, "ppo-privileged": True}   # privileged critic
UPDATE_T, UPDATE_B, UPDATE_MB, UPDATE_EPOCHS = 4, 8, 8, 2


def train_case(name, mesh=None):
    """The run of TRAIN_CASES[name] from seed 0, on `mesh` if given:
    (final params in the JAX layout, metrics of the last iteration)."""
    env_id, overrides, iters = TRAIN_CASES[name]
    env = brt.make(env_id, device="cpu", dtype=F64).use_fast_solver()
    if env_id == "Env01-v1":
        env.max_episode_steps = 6    # episodes end within 12 steps
    cfg = PPOConfig(n_envs=16, n_steps=4, minibatch_size=4, n_epochs=1,
                    **overrides)
    ppo = PPO(env, cfg)
    ts = ppo.init(0)
    if mesh is not None:
        ts = pm.shard_train_state(ts, mesh, cfg.n_envs)
    for _ in range(iters):
        ts, metrics = ppo.iteration(ts)
    return (mlp.to_numpy_params(ts.net),
            {k: float(v) for k, v in metrics.items()})


# ------------------------------------------------------------ a toy env

class ToyPhys(NamedTuple):
    qpos: torch.Tensor


class ToyState(NamedTuple):
    t: torch.Tensor
    x: torch.Tensor

    @property
    def phys(self):
        """What a recording reads: qpos (B, 2) = [x, t]."""
        return ToyPhys(torch.stack((self.x, self.t.to(F64)), -1))


class ShardToy:
    """A cheap env that draws through `global_draw`, so that a shard of it
    draws the global batch's rows: x0 ~ U(0, 1); obs [x, t/10, x^2, -x,
    0, 1]; reward 1 + x - a0^2; x += 0.1 a1; truncation at 3 steps."""

    id = "ShardToy-v0"
    obs_dim, act_dim = 6, 2
    max_episode_steps = 3
    reward_threshold = 1e9
    shard = None

    def __init__(self, seed=0):
        self.device, self.dtype = torch.device("cpu"), F64
        self.generator = torch.Generator().manual_seed(seed)

    def _obs(self, s):
        z = torch.zeros_like(s.x)
        return torch.stack([s.x, s.t.to(F64) / 10, s.x ** 2, -s.x, z, z + 1],
                           -1).float()

    def reset(self, n):
        x = pm.global_draw(lambda shape: torch.rand(
            shape, generator=self.generator, dtype=F64), (n,), self.shard)
        s = ToyState(t=torch.zeros(n, dtype=torch.int32), x=x)
        return s, self._obs(s)

    def step(self, s, action, uniforms=None):
        a = action.to(F64)
        reward = 1.0 + s.x - a[:, 0] ** 2
        s = ToyState(t=s.t + 1, x=s.x + 0.1 * a[:, 1])
        trunc = s.t >= self.max_episode_steps
        return s, self._obs(s), reward, torch.zeros_like(trunc), trunc


TOY_CFG = PPOConfig(n_envs=4, n_steps=3, minibatch_size=4, n_epochs=1,
                    gamma=0.9)
TOY_ITER = TOY_CFG.n_envs * TOY_CFG.n_steps


def toy_train(base, mesh=None, **kw):
    args = dict(seed=0, eval_freq=TOY_ITER, ckpt_freq=2 * TOY_ITER,
                n_eval_episodes=2, models_dir=base / "models",
                logs_dir=base / "logs", movies_dir=base / "movies",
                run_name="toy", verbose=False, record_every=1)
    args.update(kw)
    return runner.train(ShardToy(), TOY_CFG, mesh=mesh, **args)


# ------------------------------------------------------ one rank's cases

def rank_main(rank, init_file, inputs, out_dir):
    """Every multi-rank case on one rank of a WORLD-rank gloo world; the
    results go to out_dir/rank<rank>.npz (arrays) and .json."""
    from balance_robot_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", init_method=f"file://{init_file}",
                           world_size=WORLD, rank=rank)
    mesh = distributed.global_env_mesh()
    assert (mesh.rank, mesh.size) == (rank, WORLD)
    assert distributed.is_coordinator() == (rank == 0)
    arrays, facts = {}, {}

    x = torch.tensor([rank + 1.0], dtype=F64)
    facts["all_reduce"] = pm.all_reduce_sum_(x, mesh).item()
    # the gather: float32, int32 and bool rows, the env dim second
    n = 3
    rows = torch.arange(rank * n, (rank + 1) * n)
    parts = [(rows[None, :, None] * torch.tensor([1.5, -0.0])).float(),
             rows[None, :].int().expand(2, n), (rows % 2 == 0)[None, :]]
    for i, g in enumerate(pm.gather_rows(parts, mesh, dim=1)):
        arrays[f"gather/{i}"] = g.numpy()

    for name in TRAIN_CASES:
        params, metrics = train_case(name, mesh)
        arrays.update({f"{name}/{k}": v for k, v in params.items()})
        facts[name] = metrics

    # written by the test process meanwhile, with the one-process toy run
    # that the resume case starts from
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while not Path(inputs).exists():
        assert time.monotonic() < deadline, "no inputs"
        time.sleep(0.2)
    with np.load(inputs) as f:
        src = {k: f[k] for k in f.files}
    for name, priv in UPDATE_CASES.items():
        trainer = PPO(brt.make("Env03-v2" if priv else "Env01-v1",
                               device="cpu", dtype=F64),
                      PPOConfig(n_envs=UPDATE_B, n_steps=UPDATE_T,
                                minibatch_size=UPDATE_MB,
                                n_epochs=UPDATE_EPOCHS,
                                privileged_critic=priv))
        params = {k[len(name) + 8:]: v for k, v in src.items()
                  if k.startswith(f"{name}/params/")}
        ts = pm.shard_train_state(trainer.init(0, params=params), mesh,
                                  UPDATE_B)
        lo, hi = rank * UPDATE_B // WORLD, (rank + 1) * UPDATE_B // WORLD
        keys = ["obs", "actions", "logp", "adv", "ret", "done"] + (
            ["vobs"] if priv else [])
        traj = {k: torch.tensor(src[f"{name}/{k}"][:, lo:hi]) for k in keys}
        traj, _ = trainer._gather(ts, traj)
        perms = [torch.tensor(p) for p in src[f"{name}/perms"]]
        ts, epochs = trainer._update(ts, traj, traj["adv"], traj["ret"],
                                     perms=perms)
        arrays[f"{name}/epochs"] = epochs.numpy()
        for k, v in mlp.to_numpy_params(ts.net).items():
            arrays[f"{name}/params/{k}"] = v
        for p, (pname, _) in zip(ts.net.parameters(),
                                 ts.net.named_parameters()):
            for slot in ("exp_avg", "exp_avg_sq"):
                arrays[f"{name}/{slot}/{pname}"] = \
                    ts.opt.state[p][slot].numpy()

    base = Path(out_dir)
    # rank 0 alone writes: each rank is given a directory of its own
    _, history = toy_train(base / f"alone{rank}", mesh,
                           total_timesteps=3 * TOY_ITER)
    facts["alone_history"] = [row["steps"] for row in history]
    # the one-process run's resume file (at 2 iterations) resumed on the
    # mesh to 4 iterations; the mesh's resume file is compared with the
    # one-process run's to 4 and loaded into one process by the test
    _, history = toy_train(base / "resumed", mesh, resume=True,
                           total_timesteps=4 * TOY_ITER)
    facts["resumed_history"] = [row["steps"] for row in history]
    _, history = toy_train(base / f"wall{rank}", mesh, max_wall_s=0.0,
                           total_timesteps=10 * TOY_ITER, record_every=0)
    facts["wall_history"] = [row["steps"] for row in history]

    np.savez(base / f"rank{rank}.npz", **arrays)
    (base / f"rank{rank}.json").write_text(json.dumps(facts))
    torch.distributed.destroy_process_group()


def reference_main(out_file):
    """The one-process runs of TRAIN_CASES, saved to `out_file`."""
    torch.set_num_threads(1)
    arrays, facts = {}, {}
    for name in TRAIN_CASES:
        params, facts[name] = train_case(name)
        arrays.update({f"{name}/{k}": v for k, v in params.items()})
    np.savez(out_file, **arrays)
    Path(out_file).with_suffix(".json").write_text(json.dumps(facts))


# ------------------------------------------------------------ fixtures

def update_inputs(name, priv):
    """One trajectory, the params and JAX's permutations of an update case
    (numpy), with the JAX package's sharded `_update` of them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import balance_robot_tpu as jbrt
    from balance_robot_tpu.models import mlp as jmlp
    from balance_robot_tpu.parallel import mesh as jpm
    from balance_robot_tpu.train.ppo import PPO as JPPO
    from balance_robot_tpu.train.ppo import PPOConfig as JPPOConfig
    from balance_robot_tpu.train.ppo import TrainState as JTrainState

    T, B, N = UPDATE_T, UPDATE_B, UPDATE_T * UPDATE_B
    rng = np.random.default_rng(17 + priv)
    vf_in = 14 if priv else 6
    params = {k: np.asarray(v) for k, v in jmlp.init_params(
        jax.random.PRNGKey(3), 6, 2, vf_obs_dim=vf_in).items()}
    obs = rng.normal(size=(T, B, 6))
    src = {"obs": obs, "vobs": np.concatenate(
               [obs, rng.normal(size=(T, B, 8))], -1),
           "actions": rng.normal(size=(T, B, 2)) * 0.5,
           "adv": rng.normal(size=(T, B)), "done": rng.uniform(
               size=(T, B)) < 0.2}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    mean = jmlp.policy_mean(jp, jnp.asarray(obs))
    src["logp"] = np.asarray(jmlp.log_prob(mean, jp["log_std"],
                                           src["actions"])) \
        + rng.normal(size=(T, B)) * 0.5
    values = np.asarray(jmlp.value(jp, jnp.asarray(
        src["vobs"] if priv else obs)))
    src["ret"] = values + rng.normal(size=(T, B)) * 10.0

    jmesh = jpm.make_mesh(jax.devices()[:WORLD])
    env_axis = NamedSharding(jmesh, P(None, "env"))
    jppo = JPPO(jbrt.make("Env03-v2" if priv else "Env01-v1"), JPPOConfig(
        n_envs=B, n_steps=T, minibatch_size=UPDATE_MB, n_epochs=1,
        privileged_critic=priv))
    keys = ["obs", "actions", "logp"] + (["vobs"] if priv else [])
    jtraj = {k: jax.device_put(jnp.asarray(src[k]), env_axis) for k in keys}
    jadv, jret = (jax.device_put(jnp.asarray(src[k]), env_axis)
                  for k in ("adv", "ret"))
    jts = JTrainState(params=jax.device_put(jp, jpm.replicated(jmesh)),
                      opt_state=None, env_states=None, last_obs=None,
                      key=jax.random.PRNGKey(5), ep_ret=None, ep_len=None,
                      stat_sum_ret=None, stat_n_eps=None)
    jts = jts._replace(opt_state=jppo.optim.init(jts.params))
    update = jax.jit(jppo._update)
    perms, epochs = [], []
    with jmesh:
        for _ in range(UPDATE_EPOCHS):
            _, k_perm = jax.random.split(jts.key)
            perms.append(np.asarray(jax.random.permutation(
                jax.random.split(k_perm, 1)[0], N)))
            jts, metrics = update(jts, jtraj, jadv, jret)
            epochs.append([float(m) for m in metrics])
    assert len(jts.params["pi_w1"].sharding.device_set) == WORLD
    inner = jts.opt_state[1][0]
    ref = {"params": jts.params, "exp_avg": inner.mu,
           "exp_avg_sq": inner.nu}
    ref = {slot: {k: np.asarray(v) for k, v in tree.items()}
           for slot, tree in ref.items()}
    ref["epochs"] = np.array(epochs)
    flat = {f"{name}/{k}": v for k, v in src.items()}
    flat.update({f"{name}/params/{k}": v for k, v in params.items()})
    flat[f"{name}/perms"] = np.stack(perms)
    return flat, ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Runs the two-rank world and the one-process references (three
    processes at once) while this process computes the JAX side; returns
    the per-rank arrays and facts, the references and the directories."""
    import jax
    base = tmp_path_factory.mktemp("world")
    full = tmp_path_factory.mktemp("one_process")
    inputs = base / "inputs.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    commands = [[str(r), str(base / "rendezvous"), str(inputs), str(base)]
                for r in range(WORLD)] + [["reference", str(full / "ref.npz")]]
    procs = [subprocess.Popen([sys.executable, __file__, *args], env=env,
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in commands]
    try:
        jax.config.update("jax_enable_x64", True)
        try:
            flat, jax_ref = {}, {}
            for name, priv in UPDATE_CASES.items():
                src, jax_ref[name] = update_inputs(name, priv)
                flat.update(src)
        finally:
            jax.config.update("jax_enable_x64", False)
        # the one-process toy run whose resume file the ranks resume from,
        # and the one that goes on to 4 iterations
        toy_train(base / "resumed", total_timesteps=2 * TOY_ITER)
        toy_train(full, total_timesteps=4 * TOY_ITER)
        np.savez(base / "inputs.tmp.npz", **flat)
        os.replace(base / "inputs.tmp.npz", inputs)
        for args, p in zip(commands, procs):
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            assert p.returncode == 0, f"{args[0]} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    arrays = [dict(np.load(base / f"rank{r}.npz")) for r in range(WORLD)]
    facts = [json.loads((base / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    ref_arrays = dict(np.load(full / "ref.npz"))
    ref_facts = json.loads((full / "ref.json").read_text())
    ref = {name: ({k[len(name) + 1:]: v for k, v in ref_arrays.items()
                   if k.startswith(name + "/")}, ref_facts[name])
           for name in TRAIN_CASES}
    return dict(arrays=arrays, facts=facts, ref=ref, jax=jax_ref,
                base=base, full=full)


# ------------------------------------------------------- initialization

_INIT = r"""
import json, os, sys
import torch
import torch.distributed as dist
calls = []

def init_process_group(**kwargs):
    calls.append(["init", kwargs.get("backend"), torch.cuda.is_initialized()])
    if os.environ.get("FAIL_INIT"):
        raise RuntimeError("rendezvous failed")

dist.init_process_group = init_process_group
torch.cuda.set_device = lambda d: calls.append(
    ["set_device", d, torch.cuda.is_initialized()])
from balance_robot_tpu_torch.parallel import distributed
kwargs = json.loads(sys.argv[1])
try:
    distributed.initialize(**kwargs)
except RuntimeError as e:
    print(json.dumps({"raised": str(e), "calls": calls,
                      "initialized": distributed.is_initialized()}))
    sys.exit(0)
first = len(calls)
distributed.initialize(**kwargs)
print(json.dumps({"calls": calls, "again": len(calls) - first,
                  "initialized": distributed.is_initialized()}))
"""

_SIGNALS = ("BRT_MULTIHOST", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK",
            "RANK", "FAIL_INIT")
INIT_CASES = {
    # BRT_MULTIHOST=1 forces the call; NCCL selects the card first
    "forced": ({"BRT_MULTIHOST": "1"}, {},
               [["set_device", 0, False], ["init", "nccl", False]]),
    "forced-cpu": ({"BRT_MULTIHOST": "1"}, {"device": "cpu"},
                   [["init", "gloo", False]]),
    # no signal: nothing is called
    "no-signals": ({}, {}, []),
    # BRT_MULTIHOST=0 wins over torchrun's variables
    "disabled": ({"BRT_MULTIHOST": "0", "WORLD_SIZE": "2",
                  "MASTER_ADDR": "127.0.0.1"}, {}, []),
    # torchrun's environment: rank 1 selects cuda:1 before the init
    "torchrun": ({"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
                  "LOCAL_RANK": "1"}, {},
                 [["set_device", 1, False], ["init", "nccl", False]]),
    # a failed multi-rank init raises and leaves nothing initialized
    "fails": ({"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "FAIL_INIT": "1"}, {"device": "cpu"},
              [["init", "gloo", False]]),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_initialize_decides_from_the_environment(case):
    signals, kwargs, expect = INIT_CASES[case]
    env = {k: v for k, v in os.environ.items() if k not in _SIGNALS}
    env.update(signals, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _INIT, json.dumps(kwargs)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["calls"] == expect
    if case == "fails":
        assert out["raised"] == "rendezvous failed"
        assert not out["initialized"]
    else:
        assert out["again"] == 0 and out["initialized"]


# ----------------------------------------------------------- placement

def test_shard_batch_leaves_keeps_the_ranks_rows():
    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": torch.arange(5),
            "c": (torch.arange(6), torch.tensor(1.0))}
    for rank in range(3):
        out = pm.shard_batch_leaves(tree, pm.Mesh(rank=rank, size=3), 6)
        assert torch.equal(out["a"], tree["a"][2 * rank:2 * rank + 2])
        assert torch.equal(out["c"][0], tree["c"][0][2 * rank:2 * rank + 2])
        assert out["b"] is tree["b"] and out["c"][1] is tree["c"][1]


def test_an_uneven_batch_raises():
    mesh = pm.Mesh(rank=0, size=4)
    with pytest.raises(ValueError, match="do not split evenly"):
        pm.shard_batch_leaves({"a": torch.zeros(6)}, mesh, 6)
    ppo = PPO(ShardToy(), PPOConfig(n_envs=6, n_steps=2))
    with pytest.raises(ValueError, match="do not split evenly"):
        pm.shard_train_state(ppo.init(0), mesh, 6)


def test_off_policy_on_a_mesh_raises(tmp_path):
    from balance_robot_tpu_torch.train import factory
    env = brt.make("Env01-v2", device="cpu")
    trainer, cfg = factory.algorithm_factory("SAC", env, n_envs=4,
                                             buffer_size=64)
    mesh = pm.Mesh(rank=0, size=2)
    with pytest.raises(ValueError, match="shards only PPO"):
        runner.train(env, cfg, trainer=trainer, mesh=mesh,
                     models_dir=tmp_path / "m", logs_dir=tmp_path / "l")
    assert not (tmp_path / "m").exists()
    with pytest.raises(ValueError, match="only PPO's train state"):
        pm.shard_train_state(trainer.init(0), mesh, 4)


def test_a_shard_draws_the_global_batchs_rows():
    """The env's uniforms and the action noise of rank r of W are rows
    [r n, (r + 1) n) of the one-process draw from the same generator."""
    from balance_robot_tpu_torch.train.ppo import shard_env
    env = brt.make("Env01-v2", device="cpu")
    full = torch.Generator().manual_seed(4)
    want_u = torch.rand((6, 4), generator=full)
    want_n = torch.randn((6, 2), generator=full, dtype=F64)
    for rank in range(3):
        env.generator.manual_seed(4)
        shard = shard_env(env, rank, 3)
        assert shard.generator is env.generator and env.shard is None
        assert torch.equal(shard._noise(2, 4),
                           want_u[2 * rank:2 * rank + 2])
        noise = mlp.sample(torch.zeros(2, 2, dtype=F64),
                           torch.zeros(2, dtype=F64), env.generator,
                           (rank, 3))
        assert torch.equal(noise, want_n[2 * rank:2 * rank + 2])


# ------------------------------------------------------------ two ranks

def test_two_ranks_all_reduce_and_gather(world):
    assert [f["all_reduce"] for f in world["facts"]] == [3.0, 3.0]
    rows = torch.arange(WORLD * 3)
    want = [(rows[None, :, None] * torch.tensor([1.5, -0.0])).float(),
            rows[None, :].int().expand(2, -1), (rows % 2 == 0)[None, :]]
    for arrays in world["arrays"]:
        for i, w in enumerate(want):
            got = arrays[f"gather/{i}"]
            assert got.dtype == w.numpy().dtype
            np.testing.assert_array_equal(got, w.numpy())


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_two_rank_training_equals_one_process(world, case):
    ranks = [{k[len(case) + 1:]: v for k, v in a.items()
              if k.startswith(case + "/")} for a in world["arrays"]]
    ref_params, ref_metrics = world["ref"][case]
    assert sorted(ranks[0]) == sorted(ref_params)
    for k, v in ref_params.items():
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], v, rtol=0, atol=1e-12,
                                   err_msg=k)
    for facts in world["facts"]:
        metrics = facts[case]
        assert metrics == world["facts"][0][case]
        assert metrics["n_episodes"] == ref_metrics["n_episodes"]
        if case.endswith("env01-v1"):
            # every env completed an episode of 6 steps in 12
            assert metrics["n_episodes"] >= 16
        for k in ("loss", "pg_loss", "v_loss", "mean_ep_return"):
            assert np.isfinite(metrics[k]), k
            np.testing.assert_allclose(metrics[k], ref_metrics[k], rtol=0,
                                       atol=1e-12, err_msg=k)


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_sharded_update_matches_jax_sharded_update(world, case):
    ref = world["jax"][case]
    for arrays in world["arrays"]:
        np.testing.assert_allclose(arrays[f"{case}/epochs"], ref["epochs"],
                                   rtol=0, atol=1e-9)
        net = mlp.from_numpy_params({
            k[len(case) + 8:]: v for k, v in arrays.items()
            if k.startswith(f"{case}/params/")})
        names = {p: n for n, p in net.named_parameters()}
        jax_keys = {}
        for prefix in ("pi", "vf"):
            for key, name in mlp._TRUNK:
                layer = f"{prefix}_{name}"
                jax_keys[f"{prefix}_{key}"] = (f"{layer}.weight", True)
                jax_keys[f"{prefix}_{key.replace('w', 'b', 1)}"] = (
                    f"{layer}.bias", False)
        jax_keys["log_std"] = ("log_std", False)
        assert len(names) == len(jax_keys)
        for slot in ("params", "exp_avg", "exp_avg_sq"):
            for k, (pname, transpose) in jax_keys.items():
                if slot == "params":
                    mine = arrays[f"{case}/params/{k}"]
                else:
                    mine = arrays[f"{case}/{slot}/{pname}"]
                    mine = mine.T if transpose else mine
                np.testing.assert_allclose(mine, ref[slot][k], rtol=0,
                                           atol=1e-9, err_msg=f"{slot} {k}")


def _files(directory):
    return sorted(str(f.relative_to(directory))
                  for f in Path(directory).rglob("*") if f.is_file())


def test_runner_rank0_alone_writes(world):
    base = world["base"]
    assert _files(base / "alone1") == []
    written = _files(base / "alone0")
    for name in ("models/toy/best_model.npz", "models/toy/longest_model.npz",
                 "models/toy/final_model.npz", "models/toy/cp_24.npz",
                 "models/toy/resume_state.npz", "logs/toy.csv",
                 "movies/toy_12.npz"):
        assert name in written, name
    steps = [12, 24, 36]
    assert [f["alone_history"] for f in world["facts"]] == [steps, steps]


def test_runner_resume_state_is_global_and_loads_either_way(world):
    """The one-process resume file (2 iterations) resumed on two ranks to
    4 iterations ends on the one-process run's resume file to 4 iterations,
    key for key; and the two-rank file loads into one process."""
    ranked = world["base"] / "resumed/models/toy/resume_state.npz"
    single = world["full"] / "models/toy/resume_state.npz"
    with np.load(ranked) as a, np.load(single) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            if a[k].dtype.kind in "fc":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ts, steps = checkpoint.load_train_state(
        ranked, PPO(ShardToy(seed=9), TOY_CFG).init(5))
    assert steps == 4 * TOY_ITER and ts.last_obs.shape == (4, 6)
    assert [f["resumed_history"] for f in world["facts"]] == [[36, 48]] * 2


def test_runner_max_wall_stops_every_rank_together(world):
    # the budget is spent after the first iteration, by rank 0's clock
    assert [f["wall_history"] for f in world["facts"]] == [[12], [12]]
    assert _files(world["base"] / "wall1") == []
    final = checkpoint.load(world["base"] / "wall0/models/toy/final_model")
    _, steps = checkpoint.load_train_state(
        world["base"] / "wall0/models/toy/resume_state.npz",
        PPO(ShardToy(), TOY_CFG).init(0))
    assert steps == TOY_ITER and sorted(final)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference_main(sys.argv[2])
    else:
        rank_main(int(sys.argv[1]), *sys.argv[2:])
