"""The JAX package's returns of move_probe members from the port's starts.

The port's `train/move_probe.py` resets its S = 4 starts from a generator
on the card seeded with 7, which the JAX tool's `jax.random` keys cannot
replay; so its returns and `runs/move_probe_r4d.log`'s come from other
episodes. EnvMove05-v1's step draws no noise, so the starts decide the
returns. This script runs the JAX tool's episode (`tools/move_probe.py`'s
`one`: the scripted policy, the return of the frozen-done episode, the
full horizon) through the JAX package on the CPU from those starts: the
4 x 13 reset uniforms in `chip_smoke.MOVE_PROBE_UNIFORMS` (read from the
card's generator; `chip_smoke.py` phase 13e checks them on every run) put
through the JAX reset's arithmetic in place of its keys' draws. It prints
each member's return per start and its mean; with `--x64`, the float64
means that `chip_smoke.MOVE_PROBE_JAX` holds the port's returns on the
card to.

Run:  JAX_PLATFORMS=cpu python tests/move_probe_reference.py [--x64]
(the members in `chip_smoke.MOVE_PROBE_JAX`, 700 steps in about 4 min a
family; `--x64` the same episodes in float64.)
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import balance_robot_tpu as jbrt  # noqa: E402
from balance_robot_tpu.envs.base import (  # noqa: E402
    scipy_euler_to_mj_quat_scrambled)
from test_torch_move_tools import jax_tool_defs  # noqa: E402


def uniforms():
    """(S, 13) float32: the port's reset draws of its S starts."""
    return np.array([[float.fromhex(x) for x in row]
                     for row in chip_smoke.MOVE_PROBE_UNIFORMS], np.float32)


def start(env, u):
    """The JAX reset (balance_robot_tpu/envs/move.py `reset`) with the
    13 uniforms `u` in place of its keys' draws: (state, obs)."""
    u = jnp.asarray(u, jnp.result_type(float))
    qpos = jnp.zeros(9).at[3].set(1.0) + (u[:9] * 0.02 - 0.01)
    qpos = qpos.at[2].set(0.0)
    quat = scipy_euler_to_mj_quat_scrambled(
        (u[9] - 0.5) * 2 * jnp.pi, (u[10] - 0.5) * 0.4, (u[11] - 0.5) * 0.4)
    qpos = qpos.at[3:7].set(jnp.stack(quat))
    state = env.state_from_qpos(qpos)._replace(
        last_pitch=jnp.zeros(()), has_last=jnp.asarray(False),
        target_wheel_speed=u[12] * 9.0 + 1.0 + 30.0, aux={})
    obs, state = env._obs(state)
    return state, obs


def returns(env, policy, grid, u, T):
    """(returns (G, S), lengths (G, S)): the tool's `one` over the flat
    batch of G members x S starts (member g's start s at g S + s)."""

    def one(row, u_row):
        state, obs = start(env, u_row)

        def body(carry, t):
            state, obs, ret, done = carry
            a = policy(row, obs, t)
            state2, obs2, r, term, trunc = env.step(state, a)
            keep = lambda A, B: jax.tree.map(  # noqa: E731
                lambda x, y: jnp.where(done, x, y), A, B)
            state = keep(state, state2)
            obs = jnp.where(done, obs, obs2)
            ret = ret + jnp.where(done, 0.0, r)
            done = done | term | trunc
            return (state, obs, ret, done), None

        zero = jnp.zeros((), jnp.result_type(float))
        (state, obs, ret, done), _ = jax.lax.scan(
            body, (state, obs, zero, jnp.asarray(False)), jnp.arange(T))
        return ret, state.t

    G, S = len(grid), len(u)
    rows = jnp.repeat(jnp.asarray(grid, jnp.float32), S, axis=0)
    us = jnp.tile(jnp.asarray(u), (G, 1))
    rets, lens = jax.jit(jax.vmap(one))(rows, us)
    return (np.asarray(rets).reshape(G, S), np.asarray(lens).reshape(G, S))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args(argv)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    env = jbrt.make("EnvMove05-v1").use_fast_solver()
    defs = jax_tool_defs()
    u = uniforms()
    for name, policy in (("CYCLE", defs["cycle_policy"]),
                         ("THRESH", defs["thresh_policy"])):
        members = [m for (family, m) in chip_smoke.MOVE_PROBE_JAX
                   if family == name]
        t0 = time.perf_counter()
        rets, lens = returns(env, policy, members, u, env.max_episode_steps)
        print(f"{name}: {len(members)} members x {len(u)} starts, "
              f"{env.max_episode_steps} steps, "
              f"{'float64' if args.x64 else 'float32'}, "
              f"{time.perf_counter() - t0:.1f} s")
        for m, r, n in zip(members, rets, lens):
            print(f"  {m}  mean {r.mean()!r}  returns "
                  f"{[float(x) for x in r]}  lengths {n.tolist()}")


if __name__ == "__main__":
    main()
