"""The port's off-policy trainers (SAC, TD3, DDPG) against the JAX
package's, on the CPU.

Float64 on both sides, inputs from numpy seeds, the JAX package's params
from its own `_init_params(PRNGKey)` carried across (its log_alpha, a
float32 scalar even under x64, is widened to float64 so that both sides
compute alpha in the same precision). torch cannot replay `jax.random`,
so the port takes the JAX package's own draws through its test hooks:
`_update(idx=, normals=)` and `_collect(draws=)`.

  * the configs and the factory equal the JAX package's (`asdict`);
  * the forward passes (`_act`, `_sac_sample`, `_q` with and without the
    privileged features) agree to 1e-12;
  * four updates per algorithm from the same buffer agree to 1e-9 of each
    leaf's largest magnitude in every param, target, log_alpha, Adam moment
    and metric: the same formulas, summed in other orders. TD3's second and
    fourth updates skip the actor (policy_delay 2), so they cover Adam's
    step on zero gradients;
  * collection on Env01-v1 from the same start states fills the same
    buffer rows, to 1e-6 (obs are float32 by contract, and the actions of
    the second step read them), through a wrap of the buffer, a
    termination and two truncations;
  * the privileged critic and the warm starts (the ports of
    `tests/test_ppo.py:226-306`), and the checkpoints: nested round trips,
    either package reading the other's files, the committed off-policy
    models, and the resume state bit for bit.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import balance_robot_tpu as jbrt
from balance_robot_tpu.physics import step as jst
from balance_robot_tpu.train import checkpoint as jcheckpoint
from balance_robot_tpu.train import factory as jfactory
from balance_robot_tpu.train import offpolicy as joff

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.train import checkpoint, factory, offpolicy
from balance_robot_tpu_torch.train.offpolicy import OffPolicy

torch.set_num_threads(1)
F64 = torch.float64
ALGOS = ["SAC", "TD3", "DDPG"]
MODELS = Path(__file__).resolve().parents[1] / "models"
# the committed off-policy checkpoints and the env each was trained on
COMMITTED = {"Env01-v2_SAC": "SAC", "Env01-v2_TD3": "TD3",
             "Env01-v2_DDPG": "DDPG", "Env03-v2_SAC": "SAC",
             "Env03-v2_TD3": "TD3"}


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def numpy_tree(params):
    """The JAX params as numpy, log_alpha widened to float64."""
    tree = jax.tree.map(np.asarray, params)
    tree["log_alpha"] = np.float64(tree["log_alpha"])
    return tree


def jax_params(jtr, seed):
    """The JAX package's fresh params, with the targets its init adds."""
    p = numpy_tree(jtr._init_params(jax.random.PRNGKey(seed)))
    return {**p, "q1_t": p["q1"], "q2_t": p["q2"], "actor_t": p["actor"]}


def trainers(algo, env_id="Env01-v1", **overrides):
    """(JAX trainer, port trainer) of the same config."""
    jtr, jcfg = jfactory.algorithm_factory(algo, jbrt.make(env_id),
                                           **overrides)
    tr, cfg = factory.algorithm_factory(
        algo, brt.make(env_id, device="cpu", dtype=F64), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jtr, tr


def close(mine, ref, rel, what):
    """Leaf by leaf, within `rel` of each reference leaf's magnitude."""
    mine = checkpoint.flatten(mine, "", {})
    ref = checkpoint.flatten(ref, "", {})
    assert sorted(mine) == sorted(ref), what
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        np.testing.assert_allclose(mine[k], r, rtol=0,
                                   atol=rel * max(np.abs(r).max(), 1e-300),
                                   err_msg=f"{what} {k}")


# --------------------------------------------------------- configs, factory

@pytest.mark.parametrize("algo", ALGOS)
def test_default_config_matches_jax(algo):
    for overrides in ({}, dict(lr=5e-4, buffer_size=100, batch_size=8,
                               gamma=0.999, privileged_critic=True,
                               learning_starts=1, train_freq=2)):
        mine = offpolicy.default_config(algo.lower(), n_envs=4, **overrides)
        ref = joff.default_config(algo.lower(), n_envs=4, **overrides)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert (dataclasses.asdict(offpolicy.OffPolicyConfig())
            == dataclasses.asdict(joff.OffPolicyConfig()))
    with pytest.raises(ValueError):
        offpolicy.default_config("PPO")
    # the factory caps the off-policy envs at 256, as the JAX package's
    tr, cfg = factory.algorithm_factory(
        algo, brt.make("Env01-v1", device="cpu"), n_envs=1024, gamma=0.999)
    _, ref = jfactory.algorithm_factory(algo, jbrt.make("Env01-v1"),
                                        n_envs=1024, gamma=0.999)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert isinstance(tr, OffPolicy) and cfg.n_envs == 256


# ------------------------------------------------------------ forward passes

FWD = dict(n_envs=2, buffer_size=16, batch_size=8)


@pytest.mark.parametrize("algo", ALGOS)
def test_forward_passes_match_jax(x64, algo):
    jtr, tr = trainers(algo, **FWD)
    params = jax_params(jtr, 3)
    jp = jax.tree.map(jnp.asarray, params)
    net = offpolicy.from_numpy_params(params, algo, dtype=F64)
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(5, 6)) * 2
    key = jax.random.PRNGKey(8)
    normal = np.asarray(jax.random.normal(key, (5, 2)))
    o = torch.tensor(obs)
    with torch.no_grad():
        det = tr._act(net, o, deterministic=True).numpy()
        noisy = tr._act(net, o, torch.tensor(normal)).numpy()
    np.testing.assert_allclose(det, np.asarray(jtr._act(
        jp, jnp.asarray(obs), None, deterministic=True)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(noisy, np.asarray(jtr._act(
        jp, jnp.asarray(obs), key)), rtol=0, atol=1e-12)
    assert np.abs(det).max() <= 1.0 and np.abs(noisy).max() <= 1.0
    if algo == "SAC":
        a, logp = tr._sac_sample(net.actor, o, torch.tensor(normal))
        ja, jlogp = jtr._sac_sample(jp, jnp.asarray(obs), key)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp),
                                   rtol=0, atol=1e-12)
    act = rng.uniform(-1, 1, (5, 2))
    with torch.no_grad():
        q = tr._q(net.q1, o, torch.tensor(act), o[:, :0]).numpy()
    np.testing.assert_allclose(q, np.asarray(jtr._q(
        jp["q1"], jnp.asarray(obs), jnp.asarray(act))), rtol=0, atol=1e-12)


def test_privileged_q_matches_jax(x64):
    jtr, tr = trainers("SAC", "Env03-v2", privileged_critic=True, **FWD)
    assert tr.priv_dim == jtr.priv_dim == 8
    params = jax_params(jtr, 5)
    assert params["q1"][0]["w"].shape == (16, 256)
    net = offpolicy.from_numpy_params(params, "SAC", dtype=F64)
    rng = np.random.default_rng(6)
    obs, act, priv = (rng.normal(size=(5, n)) for n in (6, 2, 8))
    with torch.no_grad():
        q = tr._q(net.q2, *(torch.tensor(x) for x in (obs, act, priv)))
    ref = jtr._q(jax.tree.map(jnp.asarray, params["q2"]), jnp.asarray(obs),
                 jnp.asarray(act), jnp.asarray(priv))
    np.testing.assert_allclose(q.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


# ------------------------------------------------------------------ updates

def random_buffer(rng, cap, priv_dim):
    return dict(obs=rng.normal(size=(cap, 6)),
                act=rng.uniform(-1, 1, (cap, 2)), rew=rng.normal(size=cap),
                next_obs=rng.normal(size=(cap, 6)),
                done=(rng.uniform(size=cap) < 0.3).astype(np.float64),
                priv=rng.normal(size=(cap, priv_dim)),
                next_priv=rng.normal(size=(cap, priv_dim)))


def jax_train_state(jtr, params, buf, ptr):
    jp = jax.tree.map(jnp.asarray, params)
    return joff.OPTrainState(
        params=jp, opt_actor=jtr.opt_a.init(jp["actor"]),
        opt_critic=jtr.opt_c.init((jp["q1"], jp["q2"])),
        opt_alpha=jtr.opt_al.init(jp["log_alpha"]),
        buffer=joff.Buffer(ptr=jnp.int32(ptr), **{
            k: jnp.asarray(v) for k, v in buf.items()}),
        env_states=None, last_obs=None, key=None, steps=jnp.int32(0),
        grad_steps=jnp.int32(0))


def port_train_state(tr, params, buf, ptr):
    ts = tr.init(0, params=params)
    for name, value in buf.items():
        getattr(ts.buffer, name)[:] = torch.tensor(value)
    return ts._replace(ptr=ptr)


def jax_draws(jtr, key, ptr):
    """The batch indices and normals that the JAX package's `_update` draws
    from `key` (its `k_idx`, `k_t`, `k_a`)."""
    cfg = jtr.cfg
    k_idx, k_t, k_a = jax.random.split(key, 3)
    idx = jax.random.randint(k_idx, (cfg.batch_size,), 0,
                             max(min(ptr, cfg.buffer_size), 1))
    shape = (cfg.batch_size, 2)
    return (torch.tensor(np.asarray(idx)),
            (torch.tensor(np.asarray(jax.random.normal(k_t, shape))),
             torch.tensor(np.asarray(jax.random.normal(k_a, shape)))))


def moments(net, opt, names, slot):
    """An Adam slot of the port, in the JAX package's tree layout."""
    def of(p):
        return opt.state[p][slot].numpy()
    trees = [[{"w": of(layer.w), "b": of(layer.b)}
              for layer in getattr(net, name)] for name in names]
    return trees[0] if len(trees) == 1 else tuple(trees)


UPDATE_CASES = {
    # (algo, env, overrides, ptr): the buffer partly filled, or wrapped
    "SAC": ("SAC", "Env01-v1", {}, 40),
    "TD3": ("TD3", "Env01-v1", {}, 100),
    "DDPG": ("DDPG", "Env01-v1", dict(gamma=0.999), 64),
    "SAC-privileged": ("SAC", "Env03-v2", dict(privileged_critic=True), 50),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_four_updates_match_jax(x64, case):
    algo, env_id, overrides, ptr = UPDATE_CASES[case]
    jtr, tr = trainers(algo, env_id, n_envs=2, buffer_size=64, batch_size=16,
                       **overrides)
    params = jax_params(jtr, 11)
    buf = random_buffer(np.random.default_rng(12), 64, tr.priv_dim)
    jts = jax_train_state(jtr, params, buf, ptr)
    ts = port_train_state(tr, params, buf, ptr)
    jupdate = jax.jit(jtr._update)
    actor_moved = []
    for key in jax.random.split(jax.random.PRNGKey(13), 4):
        before = ts.net.actor[0].w.detach().clone()
        jts, jm = jupdate(jts, key)
        idx, normals = jax_draws(jtr, key, ptr)
        ts, m = tr._update(ts, idx=idx, normals=normals)
        actor_moved.append(not torch.equal(ts.net.actor[0].w, before))
        close({k: v.numpy() for k, v in m.items()},
              {k: np.asarray(v) for k, v in jm.items()}, 1e-9, "metrics")
    assert ts.grad_steps == int(jts.grad_steps) == 4
    close(offpolicy.to_numpy_params(ts.net), jts.params, 1e-9, "params")
    if algo == "SAC":
        # SAC's actor_t stays the initial actor
        close(offpolicy.to_numpy_params(ts.net)["actor_t"],
              params["actor"], 0.0, "actor_t")
    else:
        assert not np.array_equal(jts.params["actor_t"][0]["w"],
                                  params["actor"][0]["w"])
    for opt, jopt, names in ((ts.opt_actor, jts.opt_actor, ["actor"]),
                             (ts.opt_critic, jts.opt_critic, ["q1", "q2"])):
        inner = jopt[0]
        close(moments(ts.net, opt, names, "exp_avg"), inner.mu, 1e-9,
              f"{names} mu")
        close(moments(ts.net, opt, names, "exp_avg_sq"), inner.nu, 1e-9,
              f"{names} nu")
        # optax counts every step, zero gradients included
        assert int(inner.count) == 4 == int(
            opt.state[getattr(ts.net, names[0])[0].w]["step"])
    # the actor moves on every step: by its gradient every policy_delay-th
    # step, by Adam's momentum on the zero-gradient ones
    assert all(actor_moved)


# --------------------------------------------------------------- collection

def test_collect_matches_jax(x64):
    """Env01-v1, 3 envs, capacity 5 (wraps on the second step),
    learning_starts 3 (the first step is the warm-up's uniform actions, the
    second the policy's), episodes of 2 steps. Env 1 starts falling and
    terminates in the second step, where envs 0 and 2 truncate."""
    B = 3
    jtr, tr = trainers("SAC", n_envs=B, buffer_size=5, batch_size=4,
                       learning_starts=3)
    jenv = jtr.env
    jenv._pallas_cs = jax.jit(lambda phys, ctrl, fric: jst.control_step(
        phys, ctrl, jenv.params, friction=fric))
    jenv.max_episode_steps = tr.env.max_episode_steps = 2
    rng = np.random.default_rng(21)
    qpos = np.zeros((B, 9))
    pitch = np.radians([3.0, 49.0, -2.0])
    qpos[:, 3], qpos[:, 4] = np.cos(pitch / 2), np.sin(pitch / 2)
    qpos[:, 7:] = rng.uniform(-1, 1, (B, 2))
    qvel = rng.normal(size=(B, 8)) * [.01, .01, .01, .2, .2, .2, 2, 2]
    qvel[1, 3] = 3.0        # tipping past 50 degrees
    obs0 = rng.normal(size=(B, 6)).astype(np.float32)   # as the env's
    params = jax_params(jtr, 2)

    keys = jax.random.split(jax.random.PRNGKey(22), B)
    js = jax.vmap(lambda q, v, k: jenv.state_from_qpos(q, v, key=k))(
        jnp.asarray(qpos), jnp.asarray(qvel), keys)
    jts = jax_train_state(jtr, params, random_buffer(rng, 5, 0), 0)
    jts = jts._replace(env_states=js, last_obs=jnp.asarray(obs0),
                       key=jax.random.PRNGKey(23))
    draws, key = [], jts.key
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append({"noise": torch.tensor(np.asarray(
            jax.random.normal(k, (B, 2)))), "uniform": torch.tensor(
            np.asarray(jax.random.uniform(k, (B, 2), minval=-1.0,
                                          maxval=1.0)))})
    jts, jrew = jtr._collect(jts, 2)

    ts = port_train_state(tr, params, random_buffer(rng, 5, 0), 0)
    ts = ts._replace(env_states=tr.env.state_from_qpos(
        torch.tensor(qpos), torch.tensor(qvel)),
        last_obs=torch.tensor(obs0, dtype=F64))
    ts, rew = tr._collect(ts, 2, draws=draws)

    assert ts.ptr == int(jts.buffer.ptr) == 6 and ts.steps == 2
    # rows: 0 step 2 env 2 (wrapped), 1 and 2 step 1 envs 1 and 2, 3 and 4
    # step 2 envs 0 and 1
    for name in offpolicy.Buffer._fields:
        np.testing.assert_allclose(
            getattr(ts.buffer, name).numpy(),
            np.asarray(getattr(jts.buffer, name)), rtol=0, atol=1e-6,
            err_msg=name)
    # done holds terminations only; next_obs is the pre-reset obs where the
    # episode ended, the truncated rows 0 and 3 too, while every env goes
    # on from its reset obs (drawn from each package's own stream)
    np.testing.assert_array_equal(ts.buffer.done.numpy(), [0, 0, 0, 0, 1])
    np.testing.assert_array_equal(ts.buffer.act.numpy()[[1, 2]],
                                  draws[0]["uniform"].numpy()[1:])
    for row, env in ((0, 2), (3, 0), (4, 1)):
        assert not np.allclose(ts.buffer.next_obs[row].numpy(),
                               ts.last_obs[env].numpy()), row
    assert np.isfinite(float(rew)) and np.isfinite(float(jrew))


# --------------------------------------- privileged critic and warm starts

def test_privileged_critic_and_padded_warm_start(x64):
    """Env03-v2's privileged critic: Q reads 16 rows, the buffer keeps the
    features; two iterations stay finite. A symmetric checkpoint
    warm-starts it with zero rows on the features: Q unchanged where they
    are zero, equal to the JAX package's padded Q everywhere."""
    jtr, tr = trainers("SAC", "Env03-v2", n_envs=2, buffer_size=256,
                       batch_size=8, learning_starts=1, train_freq=2,
                       gradient_steps=1, privileged_critic=True)
    tr.env.use_fast_solver()
    assert tr.priv_dim == 8
    ts = tr.init(0)
    assert ts.net.q1[0].w.shape == (16, 256)
    assert ts.buffer.priv.shape == ts.buffer.next_priv.shape == (256, 8)
    for _ in range(2):
        ts, m = tr.iteration(ts)
    assert ts.ptr == 8 and ts.grad_steps == 4
    assert np.isfinite(float(m["critic_loss"]))
    assert all(torch.isfinite(p).all() for p in ts.net.parameters())
    assert ts.buffer.priv[:8].abs().sum() > 0

    sym = jax_params(jtr, 1)
    sym_q1 = [{**l, "w": l["w"][:8]} if i == 0 else l
              for i, l in enumerate(sym["q1"])]
    warm = {"actor": sym["actor"], "q1": sym_q1, "q2": sym["q2"],
            "log_alpha": sym["log_alpha"]}
    ts2 = tr.init(2, params=warm)
    assert ts2.net.q1[0].w.shape == (16, 256)
    assert not ts2.net.q1[0].w[8:].any()
    obs, act = torch.ones((3, 6), dtype=F64), torch.full((3, 2), 0.3,
                                                         dtype=F64)
    priv = torch.tensor(np.random.default_rng(3).normal(size=(3, 8)))
    jts2 = jtr.init(jax.random.PRNGKey(2), params=warm)
    with torch.no_grad():
        at_zero = tr._q(ts2.net.q1, obs, act, torch.zeros((3, 8), dtype=F64))
        padded = tr._q(ts2.net.q1, obs, act, priv)
    np.testing.assert_allclose(at_zero.numpy(), np.asarray(joff._apply_mlp(
        jax.tree.map(jnp.asarray, sym_q1),
        jnp.asarray(torch.cat((obs, act), -1).numpy()))[..., 0]),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(padded.numpy(), np.asarray(jtr._q(
        jts2.params["q1"], jnp.asarray(obs.numpy()), jnp.asarray(act.numpy()),
        jnp.asarray(priv.numpy()))), rtol=0, atol=1e-12)


def test_warm_start_reseeds_targets_and_refuses_other_nets():
    """The `-m` curriculum for SAC/TD3/DDPG: the online nets load, the
    targets re-seed from them, a symmetric run slices a privileged Q back;
    a PPO checkpoint raises (it has no actor/q1/q2), as in the JAX
    package."""
    env = brt.make("Env01-v1", device="cpu", dtype=F64)
    tr, _ = factory.algorithm_factory("TD3", env, n_envs=2, buffer_size=128,
                                      batch_size=8, learning_starts=1)
    saved = offpolicy.to_numpy_params(tr.init(0).net)
    saved["q1_t"] = [{k: v + 1.0 for k, v in l.items()} for l in saved["q1"]]
    ts = tr.init(9, params=saved)
    back = offpolicy.to_numpy_params(ts.net)
    for name in ("actor", "q1", "q2"):
        close(back[name], saved[name], 0.0, name)
    for target, source in (("q1_t", "q1"), ("q2_t", "q2"),
                           ("actor_t", "actor")):
        close(back[target], saved[source], 0.0, target)
    wide = dict(saved, q1=[{**saved["q1"][0], "w": np.concatenate(
        [saved["q1"][0]["w"], np.ones((8, 400))])}, *saved["q1"][1:]])
    assert tr.init(1, params=wide).net.q1[0].w.shape == (8, 400)
    with pytest.raises(ValueError, match="missing networks"):
        tr.init(1, params={"pi_w1": np.zeros((6, 64))})
    jtr, _ = jfactory.algorithm_factory("TD3", jbrt.make("Env01-v1"),
                                        n_envs=2, buffer_size=128)
    with pytest.raises(ValueError, match="missing networks"):
        jtr.init(jax.random.PRNGKey(1), params={"pi_w1": np.zeros((6, 64))})


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_cross_packages(tmp_path, algo):
    """A port-written params file has the JAX package's keys and shapes and
    loads through its `load_into`; a JAX-written one loads in the port."""
    jtr, tr = trainers(algo, n_envs=2, buffer_size=16)
    net = tr.init(0).net
    mine = offpolicy.to_numpy_params(net)
    checkpoint.save(tmp_path / "port", mine)
    back = checkpoint.load_into(tmp_path / "port", mine)
    close(back, mine, 0.0, "port round trip")
    jp = jtr._init_params(jax.random.PRNGKey(0))
    jp = {**jp, "q1_t": jp["q1"], "q2_t": jp["q2"], "actor_t": jp["actor"]}
    theirs = jcheckpoint.load_into(tmp_path / "port.npz", jp)
    close(theirs, mine, 0.0, "the JAX package reads the port's")
    flat = checkpoint.load(tmp_path / "port")
    committed = checkpoint.load(MODELS / f"Env01-v2_{algo}" / "best_model")
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in committed.items()}
    jcheckpoint.save(tmp_path / "jax", jp)
    port = offpolicy.from_numpy_params(checkpoint.load(tmp_path / "jax"),
                                       algo, dtype=F64)
    close(offpolicy.to_numpy_params(port), jax.tree.map(np.asarray, jp),
          0.0, "the port reads the JAX package's")


@pytest.mark.parametrize("name", list(COMMITTED))
def test_committed_models_load(x64, name):
    """Every committed off-policy checkpoint loads in the port, gives its
    arrays back, warm-starts a trainer of its env and acts as the JAX
    package's deterministic actor."""
    algo = COMMITTED[name]
    flat = checkpoint.load(MODELS / name / "best_model")
    net = offpolicy.from_numpy_params(flat, algo)
    back = checkpoint.flatten(offpolicy.to_numpy_params(net), "", {})
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # SAC's actor_t is its initial actor, not the trained one
    if algo == "SAC":
        assert np.abs(flat["actor/0/w"] - flat["actor_t/0/w"]).max() > 0.1
    env_id = name.rsplit("_", 1)[0]
    tr, _ = factory.algorithm_factory(
        algo, brt.make(env_id, device="cpu", dtype=F64), n_envs=2,
        buffer_size=16)
    ts = tr.init(0, params=flat)
    obs = torch.tensor(np.random.default_rng(1).normal(size=(4, 6)))
    jtr, _ = jfactory.algorithm_factory(algo, jbrt.make(env_id), n_envs=2,
                                        buffer_size=16)
    ref = jtr._act(jax.tree.map(jnp.asarray, offpolicy.nest(flat)),
                   jnp.asarray(obs.numpy()), None, deterministic=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            tr._act(ts.net, obs, deterministic=True).numpy(), np.asarray(ref),
            rtol=0, atol=1e-12)


SMALL = dict(n_envs=2, buffer_size=6, batch_size=4, learning_starts=1)


@pytest.mark.parametrize("algo", ["SAC", "TD3"])
def test_resume_state_round_trip(tmp_path, algo):
    """The resume file restores everything: the resumed iteration on a
    fresh trainer (another env instance, another seed) equals the
    uninterrupted one bit for bit, the buffer (wrapped: 8 transitions in 6
    rows) and the counts included."""
    path = tmp_path / "resume_state.npz"
    tr, cfg = factory.algorithm_factory(
        algo, brt.make("Env01-v1", device="cpu", dtype=F64), **SMALL)
    ts = tr.init(0)
    for _ in range(4):
        ts, _ = tr.iteration(ts)
    checkpoint.save_train_state(path, ts, steps=8)
    other, _ = factory.algorithm_factory(
        algo, brt.make("Env01-v1", device="cpu", dtype=F64, seed=5), **SMALL)
    ts2, steps = checkpoint.load_train_state(path, other.init(99))
    assert steps == 8 and ts2.ptr == 8 and ts2.grad_steps == 4
    ts_c, m1 = tr.iteration(ts)
    ts_r, m2 = other.iteration(ts2)
    for a, b in zip(ts_c.net.parameters(), ts_r.net.parameters()):
        assert torch.equal(a, b)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(ts_c.buffer, ts_r.buffer):
        assert torch.equal(a, b)
    for a, b in zip(ts_c.env_states.phys, ts_r.env_states.phys):
        assert torch.equal(a, b)
    assert (ts_c.ptr, ts_c.steps, ts_c.grad_steps) == (
        ts_r.ptr, ts_r.steps, ts_r.grad_steps) == (10, 5, 5)
    for opt in ("opt_actor", "opt_critic", "opt_alpha"):
        sa, sb = (getattr(t, opt).state_dict()["state"] for t in (ts_c, ts_r))
        assert sa.keys() == sb.keys()
        for i in sa:
            for slot in sa[i]:
                assert torch.equal(sa[i][slot], sb[i][slot]), (opt, slot)


def test_resume_state_mismatch(tmp_path):
    path = tmp_path / "s.npz"
    env = brt.make("Env01-v1", device="cpu")
    tr, cfg = factory.algorithm_factory("SAC", env, **SMALL)
    checkpoint.save_train_state(path, tr.init(0))
    for algo, overrides in (("SAC", dict(SMALL, buffer_size=8)),
                            ("SAC", dict(SMALL, n_envs=4)),
                            ("TD3", SMALL), ("PPO", dict(n_envs=2))):
        other, _ = factory.algorithm_factory(algo, env, **overrides)
        with pytest.raises(ValueError, match="configs must match"):
            checkpoint.load_train_state(path, other.init(0))
    ppo, _ = factory.algorithm_factory("PPO", env, n_envs=2, n_steps=2)
    checkpoint.save_train_state(path, ppo.init(0))
    with pytest.raises(ValueError, match="configs must match"):
        checkpoint.load_train_state(path, tr.init(0))
