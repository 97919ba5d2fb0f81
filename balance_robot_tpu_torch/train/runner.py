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

With a `mesh` (`parallel/mesh.py`, PPO / A2C only, as in the JAX package)
every rank runs the iterations on its shard; rank 0 alone evaluates and
writes the CSV, TensorBoard, checkpoints, models, the resume state and
movies. The eval's result and every stop decision (the reward threshold,
the wall-clock budget, the step budget) are rank 0's, broadcast, so all
ranks leave the loop at the same iteration: a rank that left alone would
hang the others at their next collective. The resume file keeps the
global layout (the env states gathered from every rank), so a W-rank
resume file loads into a one-process run and the other way round; each
rank reads it and keeps its rows. Every rank checks the (replicated)
params for finiteness before a save, so a poisoned net stops all ranks
at once.
"""

import pathlib
import time

import numpy as np

from ..models import mlp
from ..parallel import mesh as pm
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


def _save(path, params, name, write=True):
    assert_finite_tree(params, name)
    if write:
        ckpt.save(path, params)


def _save_resume(path, ts, steps, write=True):
    """The resume state, in the global layout: with a mesh, a collective
    (every rank gathers), and rank 0 writes."""
    assert_finite_tree(ts.net, "params")
    ts = pm.gather_train_state(ts)
    if write:
        ckpt.save_train_state(path, ts, steps=steps)


def train(env, config: PPOConfig, seed=0, total_timesteps=int(1e10),
          eval_freq=20_000, ckpt_freq=40_000, n_eval_episodes=5,
          reward_threshold=None, models_dir="models", logs_dir="logs",
          run_name=None, init_params=None, max_wall_s=None, verbose=True,
          mesh=None, resume=False, trainer=None, movies_dir="movies",
          record_every=0):
    """Returns (best_params, history): the best eval's params dict (numpy)
    and the CSV rows. SB3-default semantics throughout.

    `resume=True` restores the whole train state and the global step count
    from `<models_dir>/<run_name>/resume_state.npz` if present. `trainer`
    replaces the default PPO trainer (A2C, SAC, TD3 or DDPG from
    `factory`; `config` is then its config). `mesh`
    (`parallel.distributed.global_env_mesh()`) shards a PPO / A2C run over
    the ranks (see the module docstring); every rank calls `train`, and
    all return the same params and rows (but for their `wall_s`)."""
    cfg = config
    ppo = trainer if trainer is not None else PPO(env, cfg)
    if mesh is not None and not isinstance(ppo, PPO):
        raise ValueError(
            f"{type(ppo).__name__} cannot run on a mesh: the JAX package "
            "shards only PPO's TrainState (PPO / A2C); an off-policy "
            "trainer runs in one process")
    lead = mesh is None or mesh.rank == 0
    say = verbose and lead
    ts = ppo.init(seed, params=init_params)

    run_name = run_name or f"{env.id}_PPO"
    mdir = pathlib.Path(models_dir) / run_name
    if lead:
        mdir.mkdir(parents=True, exist_ok=True)
    resume_path = mdir / "resume_state.npz"
    resumed_steps = 0
    if resume and resume_path.exists():
        ts, resumed_steps = ckpt.load_train_state(resume_path, ts)
        if say:
            print(f"[{run_name}] resumed at step {resumed_steps} "
                  f"from {resume_path}", flush=True)
    if mesh is not None:
        ts = pm.shard_train_state(ts, mesh, cfg.n_envs)

    def agree(*values):
        """Rank 0's values on every rank (as they are without a mesh)."""
        return values if mesh is None else pm.agree(values, mesh)

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
        b_ret, b_len = (ppo.evaluate(ts.net, n_eval_episodes) if lead
                        else (0.0, 0.0))
        best, best_len = agree(float(b_ret), float(b_len))
        if say:
            print(f"[{run_name}] warm-start eval: ret={best:.1f} "
                  f"len={best_len:.0f}", flush=True)
    else:
        best, best_len = -np.inf, -np.inf

    logf = tb = None
    if lead:
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
        stop = agree(steps >= total_timesteps)[0]
        while not stop:
            ts, metrics = ppo.iteration(ts)
            steps += steps_per_iter
            if steps >= next_ckpt:
                _save(mdir / f"cp_{steps}", numpy_params(ts.net),
                      "params", lead)
                _save_resume(resume_path, ts, steps, lead)
                next_ckpt += ckpt_freq
            reached = False
            if steps >= next_eval:
                next_eval += eval_freq
                eval_ret, eval_len = (
                    ppo.evaluate(ts.net, n_eval_episodes) if lead
                    else (0.0, 0.0))
                eval_ret, eval_len = agree(float(eval_ret), float(eval_len))
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
                if logf is not None:
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
                if say:
                    print(f"[{run_name}] steps={steps} wall={wall:.0f}s "
                          f"train_ep_ret={m['mean_ep_return']:.1f} "
                          f"eval_ret={eval_ret:.1f} eval_len={eval_len:.0f}",
                          flush=True)
                if eval_ret > best:
                    best = eval_ret
                    best_params = numpy_params(ts.net)
                    _save(mdir / "best_model", best_params, "params", lead)
                # a trajectory every `record_every` evals -> movies/ (the
                # reference's RecordVideo analogue; tools/replay.py renders),
                # of the on-policy trainers only, as in the JAX package
                if (lead and record_every
                        and len(history) % record_every == 0
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
                          "params", lead)
                reached = threshold is not None and eval_ret >= threshold
                if reached and say:
                    print(f"[{run_name}] reward threshold {threshold} "
                          "reached — stopping", flush=True)
            out_of_time = (max_wall_s is not None
                           and time.time() - t0 > max_wall_s)
            if out_of_time and say and not reached:
                print(f"[{run_name}] wall-clock budget reached", flush=True)
            stop = agree(reached or out_of_time
                         or steps >= total_timesteps)[0]
    finally:
        if logf is not None:
            logf.close()
        if tb is not None:
            tb.close()
    _save(mdir / "final_model", numpy_params(ts.net), "params", lead)
    # leave the resume state at every exit, whatever the checkpoint cadence
    _save_resume(resume_path, ts, steps, lead)
    return best_params, history
