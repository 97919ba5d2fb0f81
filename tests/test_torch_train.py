"""The port's PPO/A2C trainer against the JAX package's, on the CPU.

Float64 on both sides, inputs from numpy seeds. GAE on the same
trajectory agrees to 1e-12; one update (PPO with Adam and the ratio clip,
A2C with RMSprop, PPO with the privileged critic) from the same params, on
the same flat batch and in JAX's own permutations, agrees to 1e-9 in
every parameter, every optimizer moment and every epoch's losses: the
same formulas, summed in other orders. The optimizer chain (the global
norm clip on both sides of its bound, RMSprop with eps inside the root),
the explained variance and the mlp helpers are held to optax and the JAX
package directly; a real-env iteration and the train-state round trip run
on Env01-v1 at 2 envs x 2 steps.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import balance_robot_tpu as jbrt
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.train import factory as jfactory
from balance_robot_tpu.train.ppo import PPO as JPPO
from balance_robot_tpu.train.ppo import PPOConfig as JPPOConfig
from balance_robot_tpu.train.ppo import TrainState as JTrainState

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import checkpoint, factory, optim
from balance_robot_tpu_torch.train.offpolicy import OffPolicy
from balance_robot_tpu_torch.train.ppo import (PPO, PPOConfig,
                                               explained_variance)

torch.set_num_threads(1)
F64 = torch.float64
POLICY = (Path(__file__).resolve().parents[1] / "models" / "Env01-v2_PPO"
          / "best_model.npz")


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_params(seed, vf_obs_dim=6):
    p = jmlp.init_params(jax.random.PRNGKey(seed), 6, 2,
                         vf_obs_dim=vf_obs_dim)
    return {k: np.asarray(v) for k, v in p.items()}


def jax_layout(net, value_of):
    """{JAX params key: value_of(parameter) in the JAX layout}."""
    out = {}
    for prefix in ("pi", "vf"):
        for key, name in mlp._TRUNK:
            layer = getattr(net, f"{prefix}_{name}")
            out[f"{prefix}_{key}"] = value_of(layer.weight).T
            out[f"{prefix}_{key.replace('w', 'b', 1)}"] = value_of(layer.bias)
    out["log_std"] = value_of(net.log_std)
    return out


def port_trainer(env_id, cfg, params):
    ppo = PPO(brt.make(env_id, device="cpu", dtype=F64), cfg)
    return ppo, ppo.init(0, params=params)


def jax_state(params, jppo, key):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return JTrainState(params=jp, opt_state=jppo.optim.init(jp),
                       env_states=None, last_obs=None, key=key, ep_ret=None,
                       ep_len=None, stat_sum_ret=None, stat_n_eps=None)


# ------------------------------------------------------------------ GAE

def test_gae_matches_jax(x64):
    rng = np.random.default_rng(0)
    T, B = 5, 3
    traj = {"value": rng.normal(size=(T, B)),
            "reward": rng.normal(size=(T, B)),
            "done": rng.uniform(size=(T, B)) < 0.3}
    assert traj["done"].any() and not traj["done"].all()
    last_obs = rng.normal(size=(B, 6))
    params = jax_params(1)
    cfg = dict(n_envs=B, n_steps=T, gamma=0.97, gae_lambda=0.9)
    jppo = JPPO(jbrt.make("Env01-v1"), JPPOConfig(**cfg))
    jts = jax_state(params, jppo, jax.random.PRNGKey(0))._replace(
        last_obs=jnp.asarray(last_obs))
    jadv, jret = jppo._gae(jts, {k: jnp.asarray(v) for k, v in traj.items()})
    ppo, ts = port_trainer("Env01-v1", PPOConfig(**cfg), params)
    ts = ts._replace(last_obs=torch.tensor(last_obs))
    adv, ret = ppo._gae(ts, {k: torch.tensor(v) for k, v in traj.items()})
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=0,
                               atol=1e-12)


def test_explained_variance_matches_jax(x64):
    rng = np.random.default_rng(3)
    ret, val = rng.normal(size=(2, 6, 4)) * [[[2.0]], [[1.5]]]
    ref = 1.0 - jnp.var(jnp.asarray(ret - val)) / (
        jnp.var(jnp.asarray(ret)) + 1e-8)
    mine = explained_variance(torch.tensor(ret), torch.tensor(val))
    np.testing.assert_allclose(float(mine), float(ref), rtol=1e-14)


# --------------------------------------------------------------- update

UPDATE_CASES = {
    # PPO, Adam: returns far from the values, so the gradient norm is over
    # 0.5 and the clip scales it; old log-probs moved so that ratios leave
    # [0.8, 1.2]
    "ppo-adam-clipped": (dict(), "Env01-v1", 10.0, 1.0, True),
    # A2C, RMSprop, no advantage normalization: tiny advantages and returns
    # at the values, so the gradient norm stays under 0.5
    "a2c-rmsprop-unclipped": (
        dict(clip_range=None, normalize_advantage=False,
             optimizer="rmsprop", lr=7e-4, gae_lambda=1.0),
        "Env01-v1", 1e-3, 1e-3, False),
    # PPO with the privileged critic: the value net reads 14 inputs
    "ppo-privileged": (dict(privileged_critic=True), "Env03-v2", 10.0, 1.0,
                       True),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax(x64, case):
    overrides, env_id, ret_scale, adv_scale, clipped = UPDATE_CASES[case]
    T, B, mb, epochs = 4, 8, 8, 2
    N = T * B
    rng = np.random.default_rng(7)
    priv = overrides.get("privileged_critic", False)
    params = jax_params(2, vf_obs_dim=14 if priv else 6)
    obs = rng.normal(size=(T, B, 6))
    vobs = np.concatenate([obs, rng.normal(size=(T, B, 8))], -1)
    actions = rng.normal(size=(T, B, 2)) * 0.5
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    mean = jmlp.policy_mean(jp, jnp.asarray(obs))
    logp = np.asarray(jmlp.log_prob(mean, jp["log_std"], actions))
    logp = logp + rng.normal(size=(T, B)) * 0.5
    values = np.asarray(jmlp.value(jp, jnp.asarray(vobs if priv else obs)))
    adv = rng.normal(size=(T, B)) * adv_scale
    returns = values + rng.normal(size=(T, B)) * ret_scale
    traj = dict(obs=obs, actions=actions, logp=logp)
    if priv:
        traj["vobs"] = vobs

    # JAX: one epoch at a time, to read each epoch's losses; the
    # permutation of each is drawn as PPO._update draws it
    jppo = JPPO(jbrt.make(env_id), JPPOConfig(
        n_envs=B, n_steps=T, minibatch_size=mb, n_epochs=1, **overrides))
    jts = jax_state(params, jppo, jax.random.PRNGKey(5))
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    perms, jax_epochs = [], []
    for _ in range(epochs):
        _, k_perm = jax.random.split(jts.key)
        perms.append(np.asarray(jax.random.permutation(
            jax.random.split(k_perm, 1)[0], N)))
        jts, metrics = jppo._update(jts, jtraj, jnp.asarray(adv),
                                    jnp.asarray(returns))
        jax_epochs.append([float(m) for m in metrics])

    cfg = PPOConfig(n_envs=B, n_steps=T, minibatch_size=mb, n_epochs=epochs,
                    **overrides)
    ppo, ts = port_trainer(env_id, cfg, params)
    ttraj = {k: torch.tensor(v) for k, v in traj.items()}
    # the first minibatch's gradient norm is on the side this case claims
    first = {k: v.reshape(N, -1)[torch.tensor(perms[0][:mb])].squeeze(-1)
             for k, v in dict(ttraj, adv=torch.tensor(adv),
                              ret=torch.tensor(returns)).items()}
    ppo._loss(ts.net, first)[0].backward()
    norm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in ts.net.parameters()]))
    assert (float(norm) >= 0.5) == clipped, float(norm)
    ts.net.zero_grad()
    ts, epoch_metrics = ppo._update(
        ts, ttraj, torch.tensor(adv), torch.tensor(returns),
        perms=[torch.tensor(p) for p in perms])

    np.testing.assert_allclose(epoch_metrics.numpy(), np.array(jax_epochs),
                               rtol=0, atol=1e-9)
    mine = jax_layout(ts.net, lambda p: p.detach().numpy())
    for k, v in jts.params.items():
        np.testing.assert_allclose(mine[k], np.asarray(v), rtol=0, atol=1e-9,
                                   err_msg=k)
    inner = jts.opt_state[1][0]
    slots = ({"nu": inner.nu} if cfg.optimizer == "rmsprop" else
             {"exp_avg": inner.mu, "exp_avg_sq": inner.nu})
    for slot, ref in slots.items():
        mom = jax_layout(ts.net, lambda p: ts.opt.state[p][slot].numpy())
        for k, v in ref.items():
            np.testing.assert_allclose(mom[k], np.asarray(v), rtol=0,
                                       atol=1e-9, err_msg=f"{slot} {k}")
    if cfg.optimizer == "adam":
        assert int(inner.count) == epochs * (N // mb) == int(
            ts.opt.state[ts.net.log_std]["step"])


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("scale", [1e-2, 10.0], ids=["under", "over"])
def test_global_norm_clip_matches_optax(x64, scale):
    rng = np.random.default_rng(11)
    grads = [rng.normal(size=s) * scale for s in ((3, 4), (4,), (2,))]
    ref, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape, dtype=F64, requires_grad=True)
              for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.tensor(g)
    norm = optim.clip_grad_global_norm_(params, 0.5)
    assert (float(norm) >= 0.5) == (scale > 1)
    for p, r, g in zip(params, ref, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-14)
        if scale < 1:   # below the bound the gradient is left as it is
            np.testing.assert_array_equal(p.grad.numpy(), g)


def test_rmsprop_matches_optax(x64):
    rng = np.random.default_rng(12)
    p0 = rng.normal(size=5)
    tx = optax.rmsprop(7e-4, decay=0.99, eps=1e-5)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.tensor(p0, requires_grad=True)
    opt = optim.RMSprop([p], 7e-4, decay=0.99, eps=1e-5)
    for _ in range(4):
        g = rng.normal(size=5) * 1e-3
        upd, state = tx.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(opt.state[p]["nu"].numpy(),
                               np.asarray(state[0].nu), rtol=1e-14)


# ---------------------------------------------------------- mlp helpers

def test_mlp_helpers_match_jax(x64):
    params = jax_params(4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    log_std = np.array([0.3, -0.7])
    np.testing.assert_allclose(float(mlp.entropy(torch.tensor(log_std))),
                               float(jmlp.entropy(jnp.asarray(log_std))),
                               rtol=1e-15)
    for mine, ref in ((mlp.pad_privileged_critic(params, 14),
                       jmlp.pad_privileged_critic(jp, 14)),
                      (mlp.pad_privileged_actor(params, 14),
                       jmlp.pad_privileged_actor(jp, 14))):
        assert sorted(mine) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
    assert mlp.pad_privileged_critic(params, 6) is params

    wide = mlp.net2net_widen(params, np.random.default_rng(0), obs_dim=14,
                             hidden=256, vf_obs_dim=14)
    ref = jmlp.net2net_widen(jp, jax.random.PRNGKey(1), obs_dim=14,
                             hidden=256, vf_obs_dim=14)
    assert {k: v.shape for k, v in wide.items()} == {
        k: v.shape for k, v in ref.items()}
    obs = np.random.default_rng(5).normal(size=(32, 14))
    net, wnet = (mlp.from_numpy_params(p, dtype=F64) for p in (params, wide))
    o14, o6 = torch.tensor(obs), torch.tensor(obs[:, :6])
    with torch.no_grad():
        for f in ("policy_mean", "value"):
            base = getattr(net, f)(o6).numpy()
            np.testing.assert_allclose(getattr(wnet, f)(o14).numpy(), base,
                                       rtol=0, atol=1e-12)
            np.testing.assert_allclose(
                np.asarray(getattr(jmlp, f)(ref, jnp.asarray(obs))), base,
                rtol=0, atol=1e-12)
    # every new unit is alive: gradient reaches the new outgoing rows
    loss = (wnet.policy_mean(o14) ** 2).mean() + (wnet.value(o14) ** 2).mean()
    loss.backward()
    assert wnet.pi_out.weight.grad[:, 64:].abs().max() > 0
    assert wnet.vf_out.weight.grad[:, 64:].abs().max() > 0


def test_warm_start_pads_the_privileged_critic_exactly():
    """models/Env01-v2_PPO warm-starts the privileged-critic trainer on
    Env03-v2: vf_w1 grows from 6 to 14 rows, the new ones zero, and the
    value of the first obs is the unpadded critic's."""
    params = checkpoint.load(POLICY)
    ppo, ts = port_trainer("Env03-v2", PPOConfig(
        n_envs=4, n_steps=2, privileged_critic=True), params)
    w = ts.net.vf_l1.weight.detach()
    assert w.shape == (64, 14) and not w[:, 6:].any()
    base = mlp.from_numpy_params(params, dtype=F64)
    with torch.no_grad():
        padded = ts.net.value(ppo._vobs(ts.last_obs, ts.env_states))
        np.testing.assert_allclose(padded.numpy(),
                                   base.value(ts.last_obs).numpy(),
                                   rtol=1e-15, atol=0)
    # a privileged checkpoint run symmetric keeps its first 6 rows
    wide = mlp.pad_privileged_critic(params, 14)
    _, ts6 = port_trainer("Env03-v2", PPOConfig(n_envs=4, n_steps=2), wide)
    assert ts6.net.vf_l1.weight.shape == (64, 6)


# ------------------------------------------------- factory and real env

@pytest.mark.parametrize("name", ["PPO", "A2C", "SAC", "TD3", "DDPG"])
def test_factory_matches_jax(name):
    _, ref = jfactory.algorithm_factory(name, jbrt.make("Env01-v1"),
                                        n_envs=8)
    trainer, cfg = factory.algorithm_factory(
        name, brt.make("Env01-v1", device="cpu"), n_envs=8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    kind = PPO if name in ("PPO", "A2C") else OffPolicy
    assert isinstance(trainer, kind) and trainer.cfg == cfg
    assert factory.IMPLEMENTED == factory.KNOWN == jfactory.IMPLEMENTED


def test_factory_refuses_unknown_names():
    env = brt.make("Env01-v1", device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        factory.algorithm_factory("QMIX", env)


SMALL = PPOConfig(n_envs=2, n_steps=2, minibatch_size=4, n_epochs=1)


def test_one_iteration_on_env01():
    ppo = PPO(brt.make("Env01-v1", device="cpu", dtype=F64), SMALL)
    ts = ppo.init(0)
    w0 = ts.net.pi_l1.weight.detach().clone()
    ts, metrics = ppo.iteration(ts)
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    assert float(metrics["explained_variance"]) <= 1.0
    assert not torch.equal(ts.net.pi_l1.weight, w0)


def test_train_state_round_trip(tmp_path):
    """The resume file restores everything: the resumed iteration on a
    fresh trainer (another env instance, another seed) equals the
    uninterrupted one bit for bit."""
    path = tmp_path / "resume_state.npz"
    ppo = PPO(brt.make("Env01-v1", device="cpu", dtype=F64), SMALL)
    ts, _ = ppo.iteration(ppo.init(0))
    checkpoint.save_train_state(path, ts, steps=4)
    other = PPO(brt.make("Env01-v1", device="cpu", dtype=F64, seed=5), SMALL)
    ts2, steps = checkpoint.load_train_state(path, other.init(99))
    assert steps == 4
    ts_c, m1 = ppo.iteration(ts)
    ts_r, m2 = other.iteration(ts2)
    for a, b in zip(ts_c.net.parameters(), ts_r.net.parameters()):
        assert torch.equal(a, b)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(ts_c.env_states.phys, ts_r.env_states.phys):
        assert torch.equal(a, b)
    assert torch.equal(ts_c.gen.get_state(), ts_r.gen.get_state())


def test_train_state_config_mismatch(tmp_path):
    path = tmp_path / "s.npz"
    env = brt.make("Env01-v1", device="cpu")
    checkpoint.save_train_state(path, PPO(env, SMALL).init(0))
    for cfg in (dataclasses.replace(SMALL, n_envs=4),
                dataclasses.replace(SMALL, optimizer="rmsprop")):
        with pytest.raises(ValueError, match="configs must match"):
            checkpoint.load_train_state(path, PPO(env, cfg).init(0))
