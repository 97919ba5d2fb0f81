"""Training-loop services around the PPO iteration: eval gating, best-model
tracking, checkpoints, resume and stop-on-threshold.

Counterpart of `balance_robot_tpu/train/runner.py`, the reference's
callback stack:

  * EvalCallback: every `eval_freq` global env steps, evaluate the
    deterministic policy; save `best_model` on improvement;
  * StopTrainingOnRewardThreshold: stop once the eval return reaches the
    env's reward_threshold;
  * CheckpointCallback every `ckpt_freq` steps -> `cp_{steps}` and the
    resume state;
  * Monitor-style episode stats to a CSV (and TensorBoard where
    `torch.utils.tensorboard` imports).

The trainer is PPO (or A2C, a PPO with other settings) or an off-policy
trainer (`train/offpolicy.py`: SAC, TD3, DDPG). Both keep their nets in
`ts.net` and evaluate them with `trainer.evaluate(ts.net, n)`; the saved
params are the JAX package's layout of each (`mlp.to_numpy_params`, the
flat PPO dict, or `offpolicy.to_numpy_params`, the nested tree). An
off-policy run reports its critic loss as `loss` and `v_loss` and no
entropy (NaN), and records no trajectories.

Evaluation steps a copy of the env with its own generator, seeded from
seed + 1 (`ppo.fork_env`), so a run with evals and its resumed twin see
the same training streams. The iterations run without waiting for the
host; only the eval boundaries read the metrics.
"""

import pathlib
import time

import numpy as np

from ..models import mlp
from ..utils.guards import assert_finite_tree
from . import checkpoint as ckpt
from . import offpolicy
from .evaluation import ChunkedEvaluator
from .ppo import PPO, PPOConfig, deterministic_action

CSV_COLUMNS = ("steps", "wall_s", "mean_ep_return", "eval_return",
               "eval_len", "loss", "v_loss", "entropy")


def record_episode(env, net, max_steps=None):
    """One deterministic episode of `env` (reset from its generator) as a
    (T, nq) qpos trajectory and its length, for tools/replay.py: the
    headless counterpart of the reference's RecordVideo wrapper."""
    return ChunkedEvaluator(env, deterministic_action).record(net, max_steps)


def numpy_params(net):
    """The JAX package's params of a trainer's net: the flat PPO dict of an
    ActorCritic, the nested tree of the off-policy nets."""
    if isinstance(net, offpolicy.OffPolicyNets):
        return offpolicy.to_numpy_params(net)
    return mlp.to_numpy_params(net)


def _save(path, params, name):
    assert_finite_tree(params, name)
    ckpt.save(path, params)


def _save_resume(path, ts, steps):
    assert_finite_tree(ts.net, "params")
    ckpt.save_train_state(path, ts, steps=steps)


def train(env, config: PPOConfig, seed=0, total_timesteps=int(1e10),
          eval_freq=20_000, ckpt_freq=40_000, n_eval_episodes=5,
          reward_threshold=None, models_dir="models", logs_dir="logs",
          run_name=None, init_params=None, max_wall_s=None, verbose=True,
          resume=False, trainer=None, movies_dir="movies", record_every=0):
    """Returns (best_params, history): the best eval's params dict (numpy)
    and the CSV rows. SB3-default semantics throughout.

    `resume=True` restores the whole train state and the global step count
    from `<models_dir>/<run_name>/resume_state.npz` if present. `trainer`
    replaces the default PPO trainer (A2C, SAC, TD3 or DDPG from
    `factory`; `config` is then its config)."""
    cfg = config
    ppo = trainer if trainer is not None else PPO(env, cfg)
    ts = ppo.init(seed, params=init_params)

    run_name = run_name or f"{env.id}_PPO"
    mdir = pathlib.Path(models_dir) / run_name
    mdir.mkdir(parents=True, exist_ok=True)
    resume_path = mdir / "resume_state.npz"
    resumed_steps = 0
    if resume and resume_path.exists():
        ts, resumed_steps = ckpt.load_train_state(resume_path, ts)
        if verbose:
            print(f"[{run_name}] resumed at step {resumed_steps} "
                  f"from {resume_path}", flush=True)
    steps = resumed_steps
    threshold = (reward_threshold if reward_threshold is not None
                 else getattr(env, "reward_threshold", None))
    steps_per_iter = cfg.n_envs * (cfg.train_freq if isinstance(
        ppo, offpolicy.OffPolicy) else cfg.n_steps)
    next_eval = steps + eval_freq
    next_ckpt = steps + ckpt_freq
    history = []
    t0 = time.time()
    # best-model tracking starts from the initial params: a warm-started or
    # resumed run never overwrites a better earlier best_model with a worse
    # one (SB3's EvalCallback starts at -inf and can regress the artifact)
    best_params = numpy_params(ts.net)
    if init_params is not None or steps:
        b_ret, b_len = ppo.evaluate(ts.net, n_eval_episodes)
        best, best_len = float(b_ret), float(b_len)
        if verbose:
            print(f"[{run_name}] warm-start eval: ret={best:.1f} "
                  f"len={best_len:.0f}", flush=True)
    else:
        best, best_len = -np.inf, -np.inf

    ldir = pathlib.Path(logs_dir)
    ldir.mkdir(parents=True, exist_ok=True)
    logf = open(ldir / f"{run_name}.csv", "a")
    if logf.tell() == 0:
        logf.write(",".join(CSV_COLUMNS) + "\n")
    try:
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(log_dir=str(ldir / "tb" / run_name))
    except ImportError:
        tb = None
    try:
        while steps < total_timesteps:
            ts, metrics = ppo.iteration(ts)
            steps += steps_per_iter
            if steps >= next_ckpt:
                _save(mdir / f"cp_{steps}", numpy_params(ts.net),
                      "params")
                _save_resume(resume_path, ts, steps)
                next_ckpt += ckpt_freq
            if steps >= next_eval:
                next_eval += eval_freq
                eval_ret, eval_len = ppo.evaluate(ts.net, n_eval_episodes)
                eval_ret, eval_len = float(eval_ret), float(eval_len)
                m = {k: float(v) for k, v in metrics.items()}
                # off-policy metrics: the critic loss stands for both losses
                m.setdefault("mean_ep_return", float("nan"))
                m.setdefault("loss", m.get("critic_loss", float("nan")))
                m.setdefault("v_loss", m.get("critic_loss", float("nan")))
                m.setdefault("entropy", float("nan"))
                wall = time.time() - t0
                row = dict(steps=steps, wall_s=round(wall, 1),
                           mean_ep_return=round(m["mean_ep_return"], 2),
                           eval_return=round(eval_ret, 2),
                           eval_len=round(eval_len, 1), loss=m["loss"],
                           v_loss=m["v_loss"], entropy=m["entropy"])
                history.append(row)
                logf.write(",".join(str(row[c]) for c in CSV_COLUMNS)
                           + "\n")
                logf.flush()
                if tb is not None:
                    tb.add_scalar("rollout/ep_rew_mean",
                                  row["mean_ep_return"], steps)
                    tb.add_scalar("eval/mean_reward", eval_ret, steps)
                    tb.add_scalar("eval/mean_ep_length", row["eval_len"],
                                  steps)
                    tb.add_scalar("train/loss", m["loss"], steps)
                    tb.add_scalar("train/value_loss", m["v_loss"], steps)
                    tb.add_scalar("train/entropy_loss", -m["entropy"], steps)
                    if "explained_variance" in m:       # PPO / A2C
                        tb.add_scalar("train/explained_variance",
                                      m["explained_variance"], steps)
                    tb.add_scalar("time/fps", steps / max(wall, 1e-9), steps)
                    tb.flush()
                if verbose:
                    print(f"[{run_name}] steps={steps} wall={wall:.0f}s "
                          f"train_ep_ret={m['mean_ep_return']:.1f} "
                          f"eval_ret={eval_ret:.1f} eval_len={eval_len:.0f}",
                          flush=True)
                if eval_ret > best:
                    best = eval_ret
                    best_params = numpy_params(ts.net)
                    _save(mdir / "best_model", best_params, "params")
                # a trajectory every `record_every` evals -> movies/ (the
                # reference's RecordVideo analogue; tools/replay.py renders),
                # of the on-policy trainers only, as in the JAX package
                if (record_every and len(history) % record_every == 0
                        and isinstance(ppo, PPO)):
                    qpos, ep_len = record_episode(ppo.eval_env, ts.net)
                    mv = pathlib.Path(movies_dir)
                    mv.mkdir(parents=True, exist_ok=True)
                    np.savez(mv / f"{run_name}_{steps}.npz",
                             qpos=qpos[:max(ep_len, 1)])
                # survival-selected artifact (the reference's human gate is
                # "balances consistently", i.e. episode length)
                if eval_len > best_len:
                    best_len = eval_len
                    _save(mdir / "longest_model", numpy_params(ts.net),
                          "params")
                if threshold is not None and eval_ret >= threshold:
                    if verbose:
                        print(f"[{run_name}] reward threshold {threshold} "
                              "reached — stopping", flush=True)
                    break
            if max_wall_s is not None and time.time() - t0 > max_wall_s:
                if verbose:
                    print(f"[{run_name}] wall-clock budget reached",
                          flush=True)
                break
    finally:
        logf.close()
        if tb is not None:
            tb.close()
    _save(mdir / "final_model", numpy_params(ts.net), "params")
    # leave the resume state at every exit, whatever the checkpoint cadence
    _save_resume(resume_path, ts, steps)
    return best_params, history
