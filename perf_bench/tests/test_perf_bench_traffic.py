"""The traffic's row order: a run with another order steps the same
episodes, each in another row, so that a seed moves no work."""

import torch

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.train import ppo

from perf_bench.recording import TrafficEnv, rows, rows_of


def episodes(order, n=4, steps=2):
    env = brt.make("Env03-v2", device="cpu", seed=0).use_fast_solver()
    twin = ppo.fork_env(TrafficEnv(env, torch.Generator().manual_seed(3), 6,
                                   order=order), 11)
    state, obs = twin.reset(n)
    out = []
    for i in range(steps):
        action = torch.tanh(obs[:, :2] + 0.1 * i)
        state, obs, reward, term, trunc = twin.step(state, action)
        out.append((state, obs, reward, term, trunc))
    return out


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def test_an_order_deals_the_same_episodes_to_other_rows():
    order = torch.tensor([2, 0, 3, 1])
    base, dealt = episodes(None), episodes(order)
    for b, d in zip(base, dealt):
        for x, y in zip(leaves(rows(b, order)), leaves(d)):
            assert torch.equal(x, y)
    # and the order moves the rows
    assert not torch.equal(base[-1][1], dealt[-1][1])


def test_rows_of_a_state():
    env = brt.make("Env01-v2", device="cpu", seed=0)
    state, _ = env.reset(5)
    assert rows_of(state) == 5
    assert all(x.shape[0] == 5 for x in leaves(rows(state,
                                                    torch.arange(5))))
