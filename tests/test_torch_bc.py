"""The port's behavior cloning against the JAX package's (CPU, float64).

The same inputs through `balance_robot_tpu.train.bc` and
`balance_robot_tpu_torch.train.bc`:

  * the PD expert's actions at noise 0, exactly;
  * the expert rollout and its return-to-go on a recorded (reward, done)
    sequence, through each package's `collect` and `VecEnv` on a stub env
    that replays it, to 1e-12;
  * the loss and one Adam step of `fit` on the same batch and params: the
    batch indices and the initial params are drawn as the JAX package's
    `fit` draws them, and its params after one step are held to the port's
    to 1e-9.
"""

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.train import bc as jbc

from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import bc

torch.set_num_threads(1)
T, B = 40, 3
rng = np.random.default_rng(0)
REWARD = rng.normal(size=T).astype(np.float64)
DONE = rng.uniform(size=T) < 0.15      # episode ends at these global steps
DONE[[7, 8]] = True                   # two in a row


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_pd_expert_actions_match_jax(x64):
    obs = np.random.default_rng(1).normal(size=(64, 6)) * 2
    cfg = jbc.BCConfig(noise=0.0)
    ref = np.asarray(jbc.pd_expert_actions(jnp.asarray(obs),
                                           jax.random.PRNGKey(0), cfg))
    mine = bc.pd_expert_actions(torch.from_numpy(obs), bc.BCConfig(noise=0.0),
                                torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(mine, ref)
    assert np.abs(mine).max() == 1.0      # the clip is reached


# ----------------------------------- a stub env replaying (reward, done)

class JState(NamedTuple):
    key: jnp.ndarray
    g: jnp.ndarray          # global step, carried across resets


class JaxReplay:
    obs_dim, act_dim = 6, 2

    def reset(self, key):
        return JState(key, jnp.int64(0)), jnp.zeros(6)

    def step(self, s, action):
        obs = jnp.full(6, 0.01) * (s.g + 1) + 0.001 * action[0]
        return (s._replace(g=s.g + 1), obs, jnp.asarray(REWARD)[s.g],
                jnp.asarray(DONE)[s.g], jnp.bool_(False))

    def carry_across_reset(self, old, new):
        return new._replace(g=old.g)


class TState(NamedTuple):
    g: torch.Tensor


class TorchReplay:
    obs_dim, act_dim = 6, 2
    device, dtype = torch.device("cpu"), torch.float64

    def reset(self, n):
        return TState(torch.zeros(n, dtype=torch.int64)), torch.zeros(
            n, 6, dtype=torch.float64)

    def step(self, s, action, uniforms=None):
        obs = torch.full((len(s.g), 6), 0.01, dtype=torch.float64) * (
            s.g[:, None] + 1) + 0.001 * action[:, :1]
        return (s._replace(g=s.g + 1), obs, torch.from_numpy(REWARD)[s.g],
                torch.from_numpy(DONE)[s.g],
                torch.zeros(len(s.g), dtype=torch.bool))

    def carry_across_reset(self, old, new):
        return new._replace(g=old.g)


def test_collect_and_return_to_go_match_jax(x64):
    """gamma 0.9 makes each discounted term count; the episode ends cut
    the return-to-go as (1 - done) in float32 does in the JAX package."""
    cfg = jbc.BCConfig(episodes=B, steps=T, noise=0.0, gamma=0.9)
    ref = [np.asarray(a) for a in jbc.collect(JaxReplay(), cfg,
                                              jax.random.PRNGKey(0))]
    mine = [a.numpy() for a in bc.collect(
        TorchReplay(), bc.BCConfig(episodes=B, steps=T, noise=0.0,
                                   gamma=0.9),
        torch.Generator().manual_seed(0))]
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # the recursion itself, on the recorded sequence
    rtg = np.zeros(T)
    g = 0.0
    for t in reversed(range(T)):
        g = REWARD[t] + 0.9 * g * (1.0 - DONE[t])
        rtg[t] = g
    np.testing.assert_allclose(mine[2].reshape(T, B), rtg[:, None]
                               .repeat(B, 1), rtol=0, atol=1e-12)


def test_loss_and_one_adam_step_match_jax(x64, capsys):
    """JAX's fit with one step on given data, against the port's loss and
    fit_step on the batch and initial params that fit drew."""
    cfg = jbc.BCConfig(bc_steps=1, batch=64, lr=1e-3)
    r = np.random.default_rng(2)
    n = 500
    data = (r.normal(size=(n, 6)), r.uniform(-1, 1, (n, 2)),
            r.normal(size=n) * 50)
    env = TorchReplay()

    key = jax.random.PRNGKey(7)
    ref = jbc.fit(env, cfg, key, data=tuple(map(jnp.asarray, data)),
                  verbose=True)
    printed = capsys.readouterr().out.strip()
    # fit's own draws: split(key, 3) -> (data, init, loop); one more split
    # per step, then randint for the batch
    _, k_init, loop = jax.random.split(key, 3)
    init = jmlp.init_params(k_init, 6, 2)
    _, k = jax.random.split(loop)
    idx = np.asarray(jax.random.randint(k, (cfg.batch,), 0, n))

    net = mlp.from_numpy_params({k: np.asarray(v) for k, v in init.items()},
                                dtype=torch.float64)
    batch = [torch.from_numpy(a[idx]) for a in data]
    with torch.no_grad():
        total, l_pi, l_v = bc.loss(net, *batch)
    p = {k: jnp.asarray(v) for k, v in init.items()}
    ref_pi = float(jnp.mean((jmlp.policy_mean(p, data[0][idx])
                             - data[1][idx]) ** 2))
    ref_v = float(jnp.mean((jmlp.value(p, data[0][idx]) - data[2][idx]) ** 2))
    assert abs(float(l_pi) - ref_pi) <= 1e-12
    assert abs(float(l_v) - ref_v) <= 1e-9 * ref_v
    assert printed == (f"bc step 0: action MSE {float(l_pi):.5f} "
                       f"value MSE {float(l_v):.1f}")

    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr)   # as fit makes it
    bc.fit_step(net, opt, *batch)
    mine = mlp.to_numpy_params(net)
    for k in mine:
        if k != "log_std":
            np.testing.assert_allclose(mine[k], np.asarray(ref[k]), rtol=0,
                                       atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(np.asarray(ref["log_std"]),
                                  [cfg.log_std] * 2)


def test_fit_returns_a_warm_start():
    """The port's fit end to end on given data: PPO's params layout, the
    configured log_std, and a loss that falls."""
    r = np.random.default_rng(3)
    obs = torch.from_numpy(r.normal(size=(2048, 6)))
    act = bc.pd_expert_actions(obs, bc.BCConfig(noise=0.0), None)
    data = (obs, act, torch.zeros(2048, dtype=torch.float64))
    cfg = replace(bc.BCConfig(), bc_steps=200, batch=256, log_std=-0.7)
    gen = torch.Generator().manual_seed(0)
    params = bc.fit(TorchReplay(), cfg, gen, data=data)
    assert set(params) == set(mlp.to_numpy_params(mlp.ActorCritic()))
    np.testing.assert_array_equal(params["log_std"], [-0.7, -0.7])
    net = mlp.from_numpy_params(params, dtype=torch.float64)
    with torch.no_grad():
        err = ((net.policy_mean(obs) - act) ** 2).mean().item()
    assert err < 0.1 * (act ** 2).mean().item()
