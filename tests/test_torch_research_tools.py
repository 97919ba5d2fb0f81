"""The port's Env03 research tools (`train/value_probe.py`,
`failure_forensics.py`, `recovery.py`, `oracle_probe.py`, `mpc_dagger.py`,
`bc_finetune.py`) against the JAX tools and the JAX package, on the CPU.

  * options: each module's parser against the JAX tool's own, built by
    running the tool's parser lines: the same options, kinds and defaults,
    less `--platform`, plus `--device`;
  * rollouts through the JAX Env03-v2 env in float64 from the states of
    `test_torch_env03.start` at t = 0 (a block that parks, an impact, a
    parked block that fires in step 2), the port fed the launch draws the
    JAX states' keys make (`jax_uniforms`, the key advanced as a live
    state's is): the value probe's record with a privileged (r3a) and a
    symmetric (r2i) critic, the forensics' step extras, a CEM generation of
    F = 2 states x P = 3 candidates over H = 3 steps (the states repeated,
    the draws repeated over P), and one replan's `exec_head`; each to 1e-9;
  * pure arithmetic against restatements of the tools' lines: the value
    probe's report, the score and elite update (ties in the scores, the std
    at ddof 0), `shift_plan`, bc_finetune's Adam steps with injected rows
    (MSE and KL anchors) against optax, its anchor collection;
  * the oracle's run on two banked states (the harvest stubbed): one draw
    table read by the policy's seed mean, every generation and the replay;
    the replay scores what its sequence scored; the dump's rows;
  * bc_finetune's ratchet on a stubbed eval, and the committed dagger set.

Every comparison through the JAX 14-dof step is in this file, at B = 3
and B = 6, so its compile is paid once per batch.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from balance_robot_tpu.envs import base as jbase
from balance_robot_tpu.models import mlp as jmlp
from balance_robot_tpu.train import checkpoint as jcheckpoint

import balance_robot_tpu_torch as brt
from balance_robot_tpu_torch.envs.env03 import Env03V2
from balance_robot_tpu_torch.models import mlp
from balance_robot_tpu_torch.train import (bc_finetune, checkpoint,
                                           failure_forensics, mpc_dagger,
                                           oracle_probe, recovery,
                                           value_probe)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_env03 import (jax_env, jax_state, jax_uniforms,  # noqa: E402
                              port_state, start)
from test_torch_run_tools import jax_tool_parser, options  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
B = 3
ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "models"
R2I = MODELS / "Env03-v2_r2i" / "best_model.npz"
R3A = MODELS / "Env03-v2_r3a" / "best_model.npz"
DAGGER_R5 = ROOT / "runs" / "dagger_mpc_r5.npz"
TOOLS = {value_probe: "value_probe.py",
         failure_forensics: "failure_forensics.py",
         oracle_probe: "oracle_probe.py", mpc_dagger: "mpc_dagger.py",
         bc_finetune: "bc_finetune.py"}


@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("module", list(TOOLS), ids=list(TOOLS.values()))
def test_the_options_are_the_jax_tools(module):
    jax_opts = options(jax_tool_parser(TOOLS[module]))
    mine = options(module.build_parser())
    assert mine.pop("--device") == (None, None, ("cuda", "cpu"), False,
                                    None, "_StoreAction")
    jax_opts.pop("--platform")
    assert mine == jax_opts


# ------------------------------------------------------------ shared starts

def t0_start():
    """start("Env03-v2") at t = 0: env 0's slow block parks in step 1, env
    1 is hit in step 1, env 2's parked block fires in step 2."""
    qpos, qvel, _, aux = start("Env03-v2")
    aux["delay_t0"] = np.array([0.0, 0.0, -0.4925], np.float32)
    return qpos, qvel, np.zeros(B, np.int32), aux


def both_starts(idx=slice(None), horizon=None):
    """(JAX env, its states, port env, its states, obs (n, 6) float32) of
    the t0_start envs `idx`, float64, the fast grade; `horizon` cuts both
    envs' episodes."""
    qpos, qvel, t, aux = t0_start()
    sel = np.arange(B)[idx]
    jenv = jax_env("Env03-v2")
    env = brt.make("Env03-v2", device="cpu", dtype=F64).use_fast_solver()
    if horizon is not None:
        jenv.max_episode_steps = env.max_episode_steps = horizon
    js = jax_state(qpos[sel], qvel[sel], t[sel],
                   {k: v[sel] for k, v in aux.items()},
                   jax.random.split(jax.random.PRNGKey(7), B)[sel])
    obs = np.random.default_rng(5).normal(size=(len(sel), 6)).astype(
        np.float32)
    return jenv, js, env, port_state(env, js), obs


def advance(keys):
    """The keys of JAX Env03 states after one step (`envs/env03.py:191`,
    then `:163`)."""
    return jax.vmap(lambda k: jax.random.split(
        jax.random.split(k, 4)[0])[0])(keys)


def key_rows(keys, steps):
    """(steps, n, 6): the launch draws of JAX states with `keys` in their
    next `steps` steps while they live."""
    rows = []
    for _ in range(steps):
        rows.append(jax_uniforms(keys))
        keys = advance(keys)
    return torch.stack(rows)


def jsel(mask, a, b):
    """`a` where `mask` (n,), else `b`, leaf by leaf of batched JAX
    states."""
    return jax.tree.map(lambda x, y: jnp.where(
        mask.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b)


def jparams(path):
    return {k: jnp.asarray(v, jnp.float64)
            for k, v in jcheckpoint.load(path).items()}


def jpitch(js):
    return jax.vmap(lambda s: jbase.pitch_of(s.phys.qpos))(js)


def jblock_dist(js):
    q = jnp.stack(js.phys.qpos, -1)
    return jnp.linalg.norm(q[:, 9:11] - q[:, 0:2], axis=-1)


# ------------------------------------------------------------ value probe

@pytest.mark.parametrize("path", [R3A, R2I], ids=["r3a", "r2i"])
def test_value_probe_record_is_the_jax_tools(x64, path):
    steps = 4
    jenv, js, env, states, obs0 = both_starts(horizon=steps)
    net = mlp.from_numpy_params(checkpoint.load(path), dtype=F64)
    use_priv = value_probe.critic_input(net, env)
    assert use_priv == (path == R3A)
    # tools/value_probe.py:91-121, a step at a time, the draws recorded
    p = jparams(path)
    jstep = jax.vmap(jenv.step)
    obs, done = jnp.asarray(obs0), jnp.zeros(B, bool)
    prev_parked = jnp.zeros(B, bool)
    ref, draws = [], []
    for _ in range(steps):
        draws.append(jax_uniforms(js.key))
        x = jnp.concatenate([obs, jax.vmap(jenv.privileged)(js)], -1) \
            if use_priv else obs
        v = jmlp.value(p, x)
        a = jnp.clip(jmlp.policy_mean(p, obs), -1.0, 1.0)
        js2, obs2, r, term, trunc = jstep(js, a)
        alive = ~done
        d2 = jblock_dist(js2)
        fired = prev_parked & (d2 < 0.5) & alive
        js, obs = jsel(done, js, js2), jnp.where(done[:, None], obs, obs2)
        ref.append((v, jnp.where(alive, r, 0.0), fired, alive))
        done = done | term | trunc
        prev_parked = jnp.where(alive, d2 > 2.0, prev_parked)
    V, R, F, A = value_probe.record(env, net, B, chunk=2,
                                    start=(states, torch.tensor(obs0)),
                                    uniforms=torch.stack(draws))
    jV, jR, jF, jA = (np.stack(x) for x in zip(*ref))
    assert V.shape == (steps, B)
    np.testing.assert_allclose(V, jV, rtol=0, atol=1e-9)
    np.testing.assert_allclose(R, jR, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(F, jF)
    np.testing.assert_array_equal(A, jA)
    # the launch of env 2's parked block, in step 2
    assert F[:, 2].tolist() == [False, True, False, False]


def jax_report(V, R, F, A, gamma, W):
    """tools/value_probe.py:135-178 as lines (less the header)."""
    T, B_ = V.shape
    lens = A.sum(0)
    G = np.zeros_like(R)
    acc = np.zeros(B_)
    for t in range(T - 1, -1, -1):
        acc = R[t] + gamma * acc * A[t]
        G[t] = acc
    mask = A.copy()
    for b in range(B_):
        mask[max(0, int(lens[b]) - 100):, b] = False
    m = mask.reshape(-1)
    ev = 1.0 - np.var(G.reshape(-1)[m] - V.reshape(-1)[m]) / (
        np.var(G.reshape(-1)[m]) + 1e-8)
    out = [f"explained variance of V vs discounted return-to-go "
           f"(gamma={gamma}, tails dropped): {ev:+.3f}"]
    pre = 5
    sur, die = [], []
    for b in range(B_):
        for t in np.nonzero(F[:, b])[0]:
            if t < pre or t + W >= T:
                continue
            (sur if A[t:t + W, b].all() else die).append(
                V[t - pre:t + W, b])
    for name, tr in (("survived window", sur), ("died in window", die)):
        if not tr:
            out.append(f"  launch-aligned V ({name}): none")
            continue
        tr = np.stack(tr)
        base = tr[:, :pre].mean()
        out.append(f"  launch-aligned V ({name}, n={len(tr)}): "
                   f"pre {base:7.1f}  launch+4 {tr[:, pre + 4].mean():7.1f}"
                   f"  launch+8 {tr[:, pre + 8].mean():7.1f}  "
                   f"launch+{W - 1} {tr[:, -1].mean():7.1f}")
        out.append(f"    anticipation dip by impact (~launch+8): "
                   f"{base - tr[:, pre + 8].mean():+.1f}")
    return out


def test_value_probe_report_is_the_jax_tools():
    """300 steps of 16 episodes: launches every 60 steps, 6 episodes die
    (two of them within a window of a launch), one launch too early and
    one too late for a whole trace."""
    rng = np.random.default_rng(0)
    T, n, W = 300, 16, 40
    lens = np.full(n, T)
    lens[:6] = [30, 95, 150, 171, 200, 290]
    A = np.arange(T)[:, None] < lens[None, :]
    R = np.where(A, rng.uniform(0.5, 1.0, (T, n)), 0.0)
    V = rng.normal(500, 50, (T, n)).astype(np.float32)
    F = np.zeros((T, n), bool)
    F[2::60] = True
    F[T - 10, 7] = True
    F &= A
    lines = value_probe.report(V, R, F, A, 0.999, W)
    assert lines == jax_report(V, R, F, A, 0.999, W)
    assert "none" not in " ".join(lines)
    none = value_probe.report(V, R, np.zeros_like(F), A, 0.99, W)
    assert none[1:] == ["  launch-aligned V (survived window): none",
                        "  launch-aligned V (died in window): none"]


# ------------------------------------------------------------ forensics

def test_forensics_step_extras_are_the_jax_tools(x64):
    steps = 4
    jenv, js, env, states, obs0 = both_starts(horizon=steps)
    params = checkpoint.load(R2I)
    net = mlp.from_numpy_params(params, dtype=F64)
    carry = failure_forensics.start_carry(states, torch.tensor(obs0))
    # tools/failure_forensics.py:60-112
    p = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    jstep = jax.vmap(jenv.step)
    ex = dict(n_fires=jnp.ones(B, jnp.int32),
              last_fire_t=jnp.zeros(B, jnp.int32), fail_pitch=jnp.zeros(B),
              fail_pdot=jnp.zeros(B), prev_pitch=jpitch(js),
              prev_parked=jnp.zeros(B, bool))
    obs, ret = jnp.asarray(obs0), jnp.zeros(B)
    done, t = jnp.zeros(B, bool), jnp.zeros(B, jnp.int32)
    for _ in range(steps):
        u = jax_uniforms(js.key)
        a = jnp.clip(jmlp.policy_mean(p, obs), -1.0, 1.0)
        js2, obs2, r, term, trunc = jstep(js, a)
        pitch2 = jpitch(js2)
        d2 = jblock_dist(js2)
        fired = ex["prev_parked"] & (d2 < 0.5)
        alive = ~done
        new_fail = alive & term
        pdot = (pitch2 - ex["prev_pitch"]) / 0.005
        ex = dict(
            n_fires=ex["n_fires"] + (fired & alive).astype(jnp.int32),
            last_fire_t=jnp.where(fired & alive, t + 1, ex["last_fire_t"]),
            fail_pitch=jnp.where(new_fail, pitch2, ex["fail_pitch"]),
            fail_pdot=jnp.where(new_fail, pdot, ex["fail_pdot"]),
            prev_pitch=jnp.where(alive, pitch2, ex["prev_pitch"]),
            prev_parked=jnp.where(alive, d2 > 2.0, ex["prev_parked"]))
        js, obs = jsel(done, js, js2), jnp.where(done[:, None], obs, obs2)
        ret = ret + jnp.where(done, 0.0, r)
        t = t + alive.astype(jnp.int32)
        done = done | term | trunc
        carry = failure_forensics.step(env, net, carry, u)
    mine = carry[5]
    for k, ref in ex.items():
        np.testing.assert_allclose(mine[k], np.asarray(ref), rtol=0,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(carry[2], ret, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(carry[3], done)
    np.testing.assert_array_equal(carry[4], t)
    np.testing.assert_allclose(carry[0].phys.qpos,
                               np.stack(js.phys.qpos, -1), rtol=0, atol=1e-10)
    # env 2's launch in step 2 is its second
    assert mine["n_fires"].tolist() == [1, 1, 2]
    assert mine["last_fire_t"].tolist() == [0, 0, 2]


def test_forensics_report_guards_and_counts():
    lens = np.array([1200, 1200, 310, 55, 1200, 700])
    rec = dict(lens=lens, ret=np.zeros(6), n_fires=np.array([16, 15, 4, 1,
                                                             16, 9]),
               last_fire=np.array([1150, 1140, 290, 0, 1160, 690]),
               fail_pitch=np.array([0, 0, 0.9, -0.9, 0, 0.88]),
               fail_pdot=np.array([0, 0, 3.0, -5.0, 0, 4.0]),
               attack_front=np.array([True] * 6))
    lines = failure_forensics.report(rec, 1200, "Env03-v2 m")
    assert lines[0] == ("Env03-v2 m: n=6 full-horizon 50.0%  (front 50.0% "
                        "n=6, back n/a n=0)")
    assert lines[1] == "failures: 3"
    assert lines[2] == ("  hits survived (n_fires at death): min 1 med 4 "
                        "max 9  (full-horizon episodes see ~16)")
    assert lines[4] == "  death pitch sign: +2 / -1   |pdot| med 4.0 rad/s"
    assert lines[5] == "  fraction dying within 0.2 s of a launch: 67%"
    assert lines[6] == ("  death-time histogram (steps): {'0-150': 1, "
                        "'150-300': 0, '300-450': 1, '450-600': 0, "
                        "'600-750': 1, '750-900': 0, '900-1050': 0, "
                        "'1050-1200': 0}")
    all_full = dict(rec, lens=np.full(6, 1200))
    assert failure_forensics.report(all_full, 1200, "x") == [
        "x: n=6 full-horizon 100.0%  (front 100.0% n=6, back n/a n=0)"]


# ------------------------------------------------------------ recovery / CEM

def jax_elite(cand, score, elite_frac):
    """tools/oracle_probe.py:170-180."""
    P = score.shape[1]
    k = max(1, int(P * elite_frac))
    elite_idx = jnp.argsort(-score, axis=1)[:, :k]
    elite = jnp.take_along_axis(cand, elite_idx[:, :, None, None], axis=1)
    bi = jnp.argmax(score, axis=1)
    return (elite.mean(axis=1), elite.std(axis=1) + 0.02, score.max(axis=1),
            cand[jnp.arange(cand.shape[0]), bi])


def test_score_and_elite_update_are_the_jax_tools(x64):
    rng = np.random.default_rng(2)
    F, P, H = 3, 8, 4
    mean, std = rng.uniform(-0.5, 0.5, (F, H, 2)), rng.uniform(0.1, 0.4,
                                                               (F, H, 2))
    eps = rng.normal(size=(F, P, H, 2))
    cand = recovery.candidates(*(torch.tensor(x) for x in (mean, std, eps)))
    np.testing.assert_array_equal(
        cand, jnp.clip(mean[:, None] + std[:, None] * eps, -1.0, 1.0))
    surv = rng.integers(0, 5, (F, P)).astype(np.int32)
    rec = rng.uniform(size=(F, P)) < 0.5
    pitch = rng.normal(size=(F, P)) * 0.3
    score = recovery.score(*(torch.tensor(x) for x in (surv, rec, pitch)))
    # tools/oracle_probe.py:116-119
    np.testing.assert_array_equal(
        score, surv.astype(np.float32) + 50.0 * rec.astype(np.float32)
        - np.abs(pitch))
    # ties: within a state, candidates of equal score keep their order
    score = np.array([[3, 1, 3, 2, 3, 0, 3, 1],
                      [0, 0, 0, 0, 0, 0, 0, 0],
                      [1, 5, 2, 5, 5, 4, 4, 3]], np.float64)
    for frac in (0.1, 0.25, 0.5):
        new_mean, new_std = recovery.elite_update(cand, torch.tensor(score),
                                                  frac)
        ref = jax_elite(jnp.asarray(cand.numpy()), jnp.asarray(score), frac)
        np.testing.assert_allclose(new_mean, ref[0], rtol=0, atol=1e-15)
        np.testing.assert_allclose(new_std, ref[1], rtol=0, atol=1e-15)
    # 2 of 8 at 0.25: state 0 takes candidates 0 and 2, state 2 takes 1, 3
    new_mean, new_std = recovery.elite_update(cand, torch.tensor(score), 0.25)
    for f, (i, j) in ((0, (0, 2)), (2, (1, 3))):
        np.testing.assert_allclose(new_mean[f], (cand[f, i] + cand[f, j]) / 2,
                                   rtol=0, atol=1e-15)
        np.testing.assert_allclose(new_std[f] - 0.02,
                                   (cand[f, i] - cand[f, j]).abs() / 2,
                                   rtol=0, atol=1e-15)


def test_cem_generation_is_the_jax_tools(x64):
    """F = 2 states (the impact and the launch) x P = 3, H = 3: the JAX
    `cem_generation` body with the states (and their keys) repeated; the
    port reads the keys' draws from one table repeated over P."""
    F, P, H, frac = 2, 3, 3, 0.67
    jenv, js, env, states, _ = both_starts(slice(1, 3))
    rng = np.random.default_rng(4)
    mean = rng.uniform(-0.5, 0.5, (F, H, 2))
    std = np.full((F, H, 2), 0.4)
    eps = rng.normal(size=(F, P, H, 2))
    # tools/oracle_probe.py:150-180, seq_rollout (:95-120) a step at a time
    cand = jnp.clip(mean[:, None] + std[:, None] * eps, -1.0, 1.0)
    s = jax.tree.map(lambda x: jnp.repeat(x, P, axis=0), js)
    acts = cand.reshape(F * P, H, 2)
    alive, surv = jnp.ones(F * P, bool), jnp.zeros(F * P, jnp.int32)
    jstep = jax.vmap(jenv.step)
    for t in range(H):
        s2, _, _, term, _ = jstep(s, acts[:, t])
        s = jsel(alive, s2, s)
        surv = surv + alive.astype(jnp.int32)
        alive = alive & ~term
    pitch = jpitch(s)
    rec = alive & (jnp.abs(pitch) < 0.25) & (jnp.abs(s.phys.qvel[3]) < 2.0)
    score = (surv.astype(jnp.float32) + 50.0 * rec.astype(jnp.float32)
             - jnp.abs(pitch)).reshape(F, P)
    ref_mean, ref_std, ref_best, ref_cand = jax_elite(cand, score, frac)

    table = key_rows(js.key, H)
    out = oracle_probe.cem_generation(
        env, states, *(torch.tensor(x) for x in (mean, std, eps)), table,
        frac)
    for mine, ref in zip(out[:3] + out[4:], (ref_mean, ref_std, ref_best,
                                             ref_cand)):
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out[3], rec.reshape(F, P).any(1))
    # every candidate lives through the 3 steps; the impact leaves the
    # pitch rate above 2 rad/s, so only the launch state recovers
    assert np.asarray(surv).min() == H
    assert out[3].tolist() == [False, True]


def test_oracle_reads_one_table_and_replays_its_best(tmp_path,
                                                     monkeypatch, capsys):
    """The harvest stubbed with two bank states (the impact and the
    launch): the policy's seed mean, both generations and the replay read
    the same launch draws for a state at the same step, and the replay
    scores what its sequence scored in its generation."""
    P, H, iters = 3, 2, 2
    qpos, qvel, _, aux = t0_start()

    def bank(env, params, episodes, seed, chunk, max_states):
        s = env.state_from_qpos(torch.tensor(qpos[1:]),
                                torch.tensor(qvel[1:]),
                                aux={k: v[1:] for k, v in aux.items()})
        return s, dict(episodes=episodes, n_fatal=2, n_bank=2,
                       full_rate=0.75, death_dt=np.array([9, 11]),
                       obs=torch.tensor(np.random.default_rng(1).normal(
                           size=(2, 6)), dtype=torch.float32))

    seen, tables = [], []
    step, draw = Env03V2.step, recovery.draw_table

    def spy(self, state, action, uniforms=None):
        seen.append(uniforms.clone())
        return step(self, state, action, uniforms)

    def counted(*args):
        tables.append(draw(*args))
        return tables[-1]

    monkeypatch.setattr(oracle_probe.harvest, "harvest_fatal_states", bank)
    monkeypatch.setattr(Env03V2, "step", spy)
    monkeypatch.setattr(recovery, "draw_table", counted)
    dump = tmp_path / "dagger.npz"
    res = oracle_probe.main([str(R2I), "--pop", str(P), "--horizon", str(H),
                             "--iters", str(iters), "--dump-dagger",
                             str(dump), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(tables) == 1 and tables[0].shape == (H, 2, 6)
    assert len(seen) == H * (2 + iters)
    parts = [seen[i * H:(i + 1) * H] for i in range(2 + iters)]
    for j in range(H):
        want = tables[0][j]
        for part in (parts[0], parts[-1]):       # the seed mean, the replay
            np.testing.assert_array_equal(part[j], want)
        for gen in parts[1:-1]:
            np.testing.assert_array_equal(gen[j], want.repeat_interleave(
                P, 0))
    np.testing.assert_allclose(res["score"], res["run_best_score"], rtol=0,
                               atol=1e-6)
    assert lines[:2] == [
        "harvest: 512 episodes, full-horizon 75.0%, fatal launches 2",
        "probing F=2 fatal states (policy died 10 steps after launch, "
        "median)"]
    assert [line[:7] for line in lines[2:4]] == ["[cem 0]", "[cem 1]"]
    assert lines[5].startswith("ORACLE: 2 fatal launches -> best sequence "
                               "recovers ")
    z = np.load(dump)
    n = int(z["n_traj"])
    assert n == res["recovered"].sum() and int(z["horizon"]) == H
    assert z["obs"].shape == (n * H, 6) and z["act"].shape == (n * H, 2)
    if n:
        # each trajectory starts from its state's banked obs
        first = z["obs_traj"][:, 0]
        banked = np.random.default_rng(1).normal(size=(2, 6)).astype(
            np.float32)[res["recovered"]]
        np.testing.assert_array_equal(first, banked)


# ------------------------------------------------------------ MPC expert

def test_mpc_exec_head_and_shift_plan_are_the_jax_tools(x64):
    """One replan of K = 2 steps at F = 3, env 2 already dead."""
    K, Hs = 2, 4
    jenv, js, env, states, obs0 = both_starts()
    rng = np.random.default_rng(6)
    mean = rng.uniform(-0.6, 0.6, (B, Hs, 2))
    alive0 = np.array([True, True, False])
    plan = mpc_dagger.Planner(env, None, key_rows(js.key, K), Hs, 0, K, 1,
                              0.125, 0.3)
    s, obs, alive, obs_k, act_k, alive_k = plan.exec_head(
        states, torch.tensor(obs0), torch.tensor(alive0), torch.tensor(mean),
        0)
    # tools/mpc_dagger.py:167-187
    jstep = jax.vmap(jenv.step)
    jobs, jalive, rows = jnp.asarray(obs0), jnp.asarray(alive0), []
    for j in range(K):
        a = jnp.asarray(mean[:, j])
        js2, obs2, _, term, _ = jstep(js, a)
        rows.append((jobs, a, jalive))
        js = jsel(jalive, js2, js)
        jobs = jnp.where(jalive[:, None], obs2, jobs)
        jalive = jalive & ~term
    np.testing.assert_allclose(s.phys.qpos, np.stack(js.phys.qpos, -1),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(s.phys.qvel, np.stack(js.phys.qvel, -1),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(obs, jobs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(alive, jalive)
    ref_obs, ref_act, ref_alive = (np.stack(x) for x in zip(*rows))
    np.testing.assert_allclose(obs_k, ref_obs, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(act_k, ref_act)
    np.testing.assert_array_equal(alive_k, ref_alive)
    # the dead env kept its state
    np.testing.assert_array_equal(s.phys.qpos[2], states.phys.qpos[2])

    std = rng.uniform(0.05, 0.3, (B, Hs, 2))
    m2, s2 = plan.shift_plan(torch.tensor(mean), torch.tensor(std))
    # tools/mpc_dagger.py:190-198
    np.testing.assert_array_equal(m2, np.concatenate(
        [mean[:, K:], np.repeat(mean[:, -1:], K, axis=1)], axis=1))
    np.testing.assert_array_equal(s2, np.concatenate(
        [std[:, K:], np.full((B, K, 2), 0.3)], axis=1))
    assert mpc_dagger.ceiling(0.84) == pytest.approx(0.98350, abs=5e-5)


# ------------------------------------------------------------ bc_finetune

def jax_clone(params, obs_d, act_d, obs_a, act_a, idx, n_d, frac, weight,
              kl, lr):
    """tools/bc_finetune.py:152-184 with the batches' rows given."""
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    log_std = params["log_std"]
    out = []
    for i_d, i_a in idx:
        o = jnp.concatenate([obs_d[i_d], obs_a[i_a]])
        a = jnp.concatenate([act_d[i_d], act_a[i_a]])

        def loss_fn(p):
            pred = jmlp.policy_mean(p, o)
            l_d = jnp.mean((pred[:n_d] - a[:n_d]) ** 2)
            if kl:
                inv_2var = 0.5 * jnp.exp(-2.0 * log_std)
                l_a = jnp.mean(jnp.sum(
                    ((pred[n_d:] - a[n_d:]) ** 2) * inv_2var, axis=-1))
            else:
                l_a = jnp.mean((pred[n_d:] - a[n_d:]) ** 2)
            return frac * l_d + (1 - frac) * weight * l_a, (l_d, l_a)

        (_, (l_d, l_a)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        out.append((l_d, l_a))
    return params, out


@pytest.mark.parametrize("kl", [False, True], ids=["mse", "kl"])
def test_bc_clone_steps_are_optax_adam(x64, kl):
    params = checkpoint.load(R2I)
    obs_d, act_d = bc_finetune.load_dagger([DAGGER_R5])
    rng = np.random.default_rng(8)
    obs_a = rng.normal(size=(40, 6)) * 0.5
    net = mlp.from_numpy_params(params, dtype=F64)
    with torch.no_grad():
        act_a = net.policy_mean(torch.tensor(obs_a)).clamp(-1, 1).numpy()
    batch, frac, weight, lr = 16, 0.3, 0.1, 3e-4
    clone = bc_finetune.Clone(net, *(torch.tensor(x) for x in (
        obs_d, act_d, obs_a, act_a)), batch, frac, lr, kl, weight)
    assert (clone.n_d, clone.n_a) == (4, 12)
    idx = [(rng.integers(0, len(obs_d), 4), rng.integers(0, 40, 12))
           for _ in range(5)]
    losses = [clone.train_step(None, tuple(torch.tensor(i) for i in ix))
              for ix in idx]
    ref, ref_losses = jax_clone(
        {k: jnp.asarray(v, jnp.float64) for k, v in params.items()},
        *(jnp.asarray(x, jnp.float64) for x in (obs_d, act_d, obs_a,
                                                act_a)),
        idx, 4, frac, weight, kl, lr)
    mine = mlp.to_numpy_params(net)
    for k in ref:
        np.testing.assert_allclose(mine[k], ref[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    for (l_d, l_a), (r_d, r_a) in zip(losses, ref_losses):
        np.testing.assert_allclose([float(l_d), float(l_a)],
                                   [float(r_d), float(r_a)], rtol=1e-10)
    for k in params:
        if k.startswith("vf_") or k == "log_std":
            np.testing.assert_array_equal(mine[k], params[k], err_msg=k)
        else:
            assert not np.array_equal(mine[k], params[k]), k


def test_bc_anchor_collection_is_the_jax_tools(x64):
    """3 steps at B = 3 (the horizon): the obs before every alive step,
    step by step; env 1's impact ends nothing within them."""
    steps = 3
    jenv, js, env, states, obs0 = both_starts(horizon=steps)
    params = checkpoint.load(R2I)
    p = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    # tools/bc_finetune.py:113-128
    jstep = jax.vmap(jenv.step)
    obs, done, draws, ref = jnp.asarray(obs0), jnp.zeros(B, bool), [], []
    for _ in range(steps):
        draws.append(jax_uniforms(js.key))
        a = jnp.clip(jmlp.policy_mean(p, obs), -1.0, 1.0)
        js2, obs2, _, term, trunc = jstep(js, a)
        ref.append(np.asarray(obs)[~np.asarray(done)])
        js = jsel(done, js, js2)
        obs = jnp.where(done[:, None], obs, obs2)
        done = done | term | trunc
    got = bc_finetune.collect_anchor(
        env, mlp.from_numpy_params(params, dtype=F64), B,
        start=(states, torch.tensor(obs0)), uniforms=torch.stack(draws))
    np.testing.assert_allclose(got, np.concatenate(ref), rtol=0, atol=1e-6)
    assert got.shape == (steps * B, 6)


def test_bc_ratchet_keeps_the_best_snapshot(tmp_path, monkeypatch, capsys):
    """Stubbed evals (init, steps 1, 3, 4, then the final): the tuple rule
    (full, ret) picks step 3, whose params are saved."""
    scores = iter([(0.5, 10.0), (0.6, 5.0), (0.6, 7.0), (0.6, 6.0),
                   (0.55, 9.0)])
    snaps, calls = [], []

    def fake_eval(env, act_fn, net, seed, n, max_steps=None):
        calls.append((seed, n))
        snaps.append(mlp.to_numpy_params(net))
        full, ret = next(scores)
        return full, ret, 7.0, None, None

    def fake_anchor(env, net, episodes, seed=0):
        assert (episodes, seed) == (3, 7)
        return torch.tensor(np.random.default_rng(0).normal(
            size=(30, 6)), dtype=torch.float32)

    monkeypatch.setattr(bc_finetune.selection, "paired_eval", fake_eval)
    monkeypatch.setattr(bc_finetune, "collect_anchor", fake_anchor)
    out = tmp_path / "bc"
    res = bc_finetune.main([
        str(R2I), "--dagger", str(DAGGER_R5), "--anchor-episodes", "3",
        "--steps", "5", "--batch", "32", "--eval-every", "2",
        "--select-episodes", "4", "--eval-episodes", "8", "--out", str(out),
        "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert calls == [(1, 4)] * 4 + [(0, 8)]
    assert lines[:3] == ["dagger set: 2368 pairs",
                         lines[1], "[bc  init] selection full=50.0% ret=10 "
                         "(4 paired episodes)"]
    assert lines[1].startswith("anchor set: 30 on-policy pairs (")
    sel = [line for line in lines if " selection " in line][1:]
    assert sel == ["[bc     1] selection full=60.0% ret=5  <-- new best",
                   "[bc     3] selection full=60.0% ret=7  <-- new best",
                   "[bc     4] selection full=60.0% ret=6"]
    assert "selection winner: step 3 full=60.0% ret=7" in lines
    assert lines[-2] == ("cloned policy: full=55.0% ret=9 len=7  (8 "
                         "episodes)")
    assert lines[-1] == f"saved -> {out / 'best_model.npz'}"
    assert res["best"] == (0.6, 7.0, 3)
    saved = checkpoint.load(out / "best_model.npz")
    for k in saved:
        np.testing.assert_array_equal(saved[k], snaps[2][k], err_msg=k)
        np.testing.assert_array_equal(saved[k], snaps[4][k], err_msg=k)
    assert not np.array_equal(saved["pi_w1"], snaps[3]["pi_w1"])
    assert bc_finetune.better((0.6, 8.0), (0.6, 7.0, 3))
    assert not bc_finetune.better((0.59, 99.0), (0.6, 7.0, 3))


def test_the_committed_dagger_set():
    obs, act = bc_finetune.load_dagger([DAGGER_R5])
    assert obs.shape == (2368, 6) and act.shape == (2368, 2)
    assert np.abs(act).max() <= 1.0
    obs2, _ = bc_finetune.load_dagger([DAGGER_R5, DAGGER_R5])
    assert len(obs2) == 2 * 2368
