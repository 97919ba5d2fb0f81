"""The port's EnvMove05 research tools (`train/move_probe.py`,
`move_bc_init.py`, `make_inner_policy.py`) against the JAX tools and the JAX
package, on the CPU.

  * options: each parser against the JAX tool's own (less `--platform` and
    move_probe's `--pallas`, plus `--device`); make_inner_policy's default
    source is the tool's;
  * the scripted families: the port's CYCLE and THRESH policies against
    the JAX tool's own functions (run from its source lines) on every grid
    member and random obs, and the grids themselves;
  * the flat layout: member g's episode s at g S + s, every member on the
    same S starts;
  * a 3-step rollout of two THRESH members from two shared starts on
    EnvMove05-v1 (float64, fast grade) against the JAX tool's `one`,
    restated from those starts; kept short because the JAX wall scene
    compiles slowly;
  * move_bc_init: 5 Adam steps with injected draws against optax, the loss
    the tool's relative error; its file loads in the JAX package with
    log_std -1.5;
  * make_inner_policy writes a .brq.npz byte-equal to the committed asset.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import balance_robot_tpu as jbrt
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.train import checkpoint as jcheckpoint

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs import move
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import (make_inner_policy, move_bc_init,
                                           move_probe)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_move import (both_states, jax_move_env,  # noqa: E402
                             move_start_states)
from test_torch_run_tools import jax_tool_parser, options  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
DEVICE_OPTION = (None, None, ("cuda", "cpu"), False, None, "_StoreAction")


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def jax_tool_defs():
    """The JAX move_probe's policy functions and grids, from its source
    lines (`def cycle_policy` up to the loop that runs them)."""
    lines = (ROOT / "tools" / "move_probe.py").read_text().splitlines()
    first = next(i for i, s in enumerate(lines)
                 if s.startswith("def cycle_policy"))
    last = next(i for i, s in enumerate(lines) if s.startswith("for name"))
    scope = {"jax": jax, "jnp": jnp}
    exec("\n".join(lines[first:last]), scope)
    return scope


def test_move_probe_options_and_no_switch():
    jax_opts = options(jax_tool_parser("move_probe.py"))
    mine = options(move_probe.build_parser())
    assert mine.pop("--device") == DEVICE_OPTION
    for gone in ("--platform", "--pallas"):
        jax_opts.pop(gone)
    assert mine == jax_opts
    # the device of the tensors picks the physics
    assert "--pallas" in move_probe.__doc__
    assert "no switch" in move_probe.__doc__


def test_move_bc_init_and_make_inner_policy_options():
    mine = options(move_bc_init.build_parser())
    assert mine.pop("--device") == DEVICE_OPTION
    assert mine == options(jax_tool_parser("move_bc_init.py"))
    tool = (ROOT / "tools" / "make_inner_policy.py").read_text()
    assert f'else "{make_inner_policy.SOURCE}"' in tool
    args = make_inner_policy.build_parser().parse_args([])
    assert args.src == make_inner_policy.SOURCE


def test_scripted_families_are_the_jax_tools():
    ref = jax_tool_defs()
    assert move_probe.CYCLE_GRID == ref["cycle_grid"]
    assert move_probe.THRESH_GRID == ref["thresh_grid"]
    assert (len(ref["cycle_grid"]), len(ref["thresh_grid"])) == (64, 48)
    rng = np.random.default_rng(0)
    for mine, name, grid in ((move_probe.cycle_policy, "cycle_policy",
                              ref["cycle_grid"]),
                             (move_probe.thresh_policy, "thresh_policy",
                              ref["thresh_grid"])):
        p = np.asarray(grid, np.float32)
        obs = np.zeros((len(grid), 10), np.float32)
        # wheel speeds around every member's threshold and far from it
        obs[:, 0] = rng.uniform(-10, 50, len(grid)) / 170.0
        obs[:, 1] = rng.uniform(-1, 1, len(grid))
        for t in (0, 9, 10, 39, 119, 300, 699):
            want = jax.vmap(ref[name], in_axes=(0, 0, None))(
                jnp.asarray(p), jnp.asarray(obs), jnp.asarray(t))
            got = mine(torch.tensor(p), torch.tensor(obs), t)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} t={t}")


def test_flat_layout_puts_member_g_episode_s_at_g_s_plus_s():
    env = brt.make("EnvMove05-v1", device="cpu")
    S, grid = 3, move_probe.THRESH_GRID[:4]
    states, obs = env.reset(S)
    fs, fo, rows = move_probe.flat_batch(states, obs, grid, S)
    assert rows.shape == (len(grid) * S, 4) and fo.shape == (12, 10)
    for g in range(len(grid)):
        for s in range(S):
            i = g * S + s
            np.testing.assert_array_equal(rows[i], np.float32(grid[g]))
            np.testing.assert_array_equal(fo[i], obs[s])
            np.testing.assert_array_equal(fs.phys.qpos[i],
                                          states.phys.qpos[s])
            assert fs.target_wheel_speed[i] == states.target_wheel_speed[s]


def test_move_probe_rollout_is_the_jax_tools(x64):
    """2 THRESH members x 2 shared starts, 3 steps: the JAX tool's `one`
    (:59-76) from the same starts, flat as the tool lays them out."""
    T, S = 3, 2
    grid = [move_probe.THRESH_GRID[0], move_probe.THRESH_GRID[41]]
    jenv = jax_move_env()
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64).use_fast_solver()
    js, ts = both_states(jenv, env, *move_start_states(S))
    rets, lens = move_probe.rollout(env, move_probe.thresh_policy, grid, S,
                                    T, start=(ts, env._obs(ts)))
    policy = jax_tool_defs()["thresh_policy"]
    G = len(grid)
    s = jax.tree.map(lambda x: jnp.tile(x, (G,) + (1,) * (x.ndim - 1)), js)
    obs = jax.vmap(lambda x: jenv._obs(x)[0])(s)
    rows = jnp.repeat(jnp.asarray(grid, jnp.float32), S, axis=0)
    ret, done = jnp.zeros(G * S), jnp.zeros(G * S, bool)
    jstep = jax.vmap(jenv.step)
    for t in range(T):
        a = jax.vmap(policy, in_axes=(0, 0, None))(rows, obs, jnp.asarray(t))
        s2, obs2, r, term, trunc = jstep(s, a)
        s = jax.tree.map(lambda x, y: jnp.where(
            done.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), s, s2)
        obs = jnp.where(done[:, None], obs, obs2)
        ret = ret + jnp.where(done, 0.0, r)
        done = done | term | trunc
    assert rets.shape == lens.shape == (G, S)
    np.testing.assert_allclose(rets, np.asarray(ret).reshape(G, S), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(lens, np.asarray(s.t).reshape(G, S))
    assert (lens == T).all()
    # the members' actions differ, and so do their returns
    assert np.abs(rets[0] - rets[1]).min() > 1e-6



def test_move_probe_reference_runs_the_ports_episodes(x64):
    """tests/move_probe_reference.py, whose JAX returns 13e holds the
    port's to: from the port's reset draws its starts are the port's
    reset, and 3 steps of two members are the port's rollout (float64)."""
    import move_probe_reference as ref
    T, grid = 3, [move_probe.THRESH_GRID[0], move_probe.THRESH_GRID[41]]
    u = ref.uniforms()
    env = brt.make("EnvMove05-v1", device="cpu", dtype=F64).use_fast_solver()
    env._uniform = lambda *shape: torch.tensor(u, dtype=F64)
    states, obs = env.reset(len(u))
    jenv = jbrt.make("EnvMove05-v1").use_fast_solver()
    for i, row in enumerate(u):
        js, jobs = ref.start(jenv, row)
        np.testing.assert_allclose(states.phys.qpos[i],
                                   np.stack(js.phys.qpos), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(obs[i], jobs)
        assert float(js.target_wheel_speed) == pytest.approx(
            float(states.target_wheel_speed[i]), abs=1e-12)
        assert not bool(js.has_last) and not bool(states.has_last[i])
    rets, lens = move_probe.rollout(env, move_probe.thresh_policy, grid,
                                    len(u), T, start=(states, obs))
    jrets, jlens = ref.returns(jenv, jax_tool_defs()["thresh_policy"], grid,
                               u, T)
    np.testing.assert_allclose(rets, jrets, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(lens, jlens)
    # the members' actions differ, and so do their returns
    assert np.abs(rets[0] - rets[1]).max() > 1e-6


def jax_fit(params, draws, args):
    """tools/move_bc_init.py:51-74 with each step's (ws, obs[1]) given."""
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    losses = []
    for ws, yaw in draws:
        n = len(ws)
        obs = jnp.zeros((n, 10)).at[:, 0].set(ws / 170.0).at[:, 1].set(yaw)
        g = jax.nn.sigmoid((args.mid - ws) / args.width)
        lab = jnp.stack([args.a_lo + (args.a_hi - args.a_lo) * g,
                         jnp.zeros(n)], axis=-1)

        def loss_fn(p):
            err = (jmlp.policy_mean(p, obs) - lab) / (jnp.abs(lab) + 1e-2)
            return jnp.mean(err ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(loss)
    return params, losses


def test_move_bc_init_fit_is_optax_adam(x64, capsys):
    args = argparse.Namespace(mid=4.0, width=0.1, a_hi=1.0, a_lo=0.001)
    net = mlp.ActorCritic(10, 2, generator=torch.Generator().manual_seed(3),
                          dtype=F64)
    init = mlp.to_numpy_params(net)
    rng = np.random.default_rng(9)
    draws = [(rng.uniform(-20, 60, 512), rng.uniform(-1, 1, 512))
             for _ in range(5)]
    last = move_bc_init.fit(net, args, None, 5, given=[
        tuple(torch.tensor(x) for x in d) for d in draws])
    ref, losses = jax_fit({k: jnp.asarray(v) for k, v in init.items()},
                          [tuple(jnp.asarray(x) for x in d) for d in draws],
                          args)
    mine = mlp.to_numpy_params(net)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-9,
                                   err_msg=k)
        if k.startswith("vf_") or k == "log_std":
            np.testing.assert_array_equal(mine[k], init[k], err_msg=k)
    np.testing.assert_allclose(float(last), float(losses[-1]), rtol=1e-10)
    assert capsys.readouterr().out.splitlines() == [
        f"fit step 0: mse={float(losses[0]):.6f}",
        f"fit step 4: mse={float(losses[-1]):.6f}"]


def test_move_bc_init_output_loads_in_jax(tmp_path, capsys):
    out = tmp_path / "init" / "init.npz"
    params = move_bc_init.main([
        "--mid", "4.0", "--width", "0.1", "--a-hi", "1.0", "--a-lo", "0.001",
        "--steps", "2", "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line[:14] for line in lines[:2]] == ["fit step 0: ms",
                                                 "fit step 1: ms"]
    assert len(lines) == 2 + 11 + 1 and lines[-1] == f"saved -> {out}"
    assert lines[2].startswith("  ws=  -5.0  a0 fit=") and \
        "target=+1.0000" in lines[2]
    loaded = jcheckpoint.load(out)
    ref = jmlp.init_params(jax.random.PRNGKey(0), 10, 2)
    assert set(loaded) == set(ref)
    for k in ref:
        assert loaded[k].shape == ref[k].shape and loaded[k].dtype == \
            np.float32, k
        np.testing.assert_array_equal(loaded[k], params[k], err_msg=k)
    np.testing.assert_array_equal(loaded["log_std"], [-1.5, -1.5])
    obs = np.zeros((2, 10), np.float32)
    obs[:, 0] = np.array([0.0, 40.0]) / 170.0
    assert np.isfinite(np.asarray(jmlp.policy_mean(loaded, obs))).all()


def test_make_inner_policy_rebuilds_the_committed_asset(tmp_path,
                                                        monkeypatch, capsys):
    # by default it writes the file the move envs load
    assert make_inner_policy.ASSETS / "inner_policy.brq.npz" == \
        move.INNER_POLICY_ASSET
    assets = tmp_path / "assets"
    monkeypatch.setattr(make_inner_policy, "ASSETS", assets)
    monkeypatch.chdir(ROOT)
    path = make_inner_policy.main([])
    lines = capsys.readouterr().out.splitlines()
    assert path == assets / "inner_policy.brq.npz"
    assert lines[0] == f"wrote {assets / 'inner_policy.brq'}.npz"
    assert lines[1] == f"wrote {assets / 'inner_policy.tflite'}" or \
        lines[1].startswith("tflite export skipped: ")
    assert path.read_bytes() == move.INNER_POLICY_ASSET.read_bytes()
    assert not (assets / "_saved_model_tmp").exists()
