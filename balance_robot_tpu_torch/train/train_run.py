"""Launch a PPO training run.

Counterpart of `tools/train_run.py`, with its options, defaults, artifacts
and last line. The env is `brt.make(env_id)` at the solver grade of
`--solver`: `fast` is the training grade (Newton 4 / line search 6),
`turbo` is Newton 2 / line search 4 (`physics.fast_solver(params, 2, 4)`),
`exact` leaves the registered params. `--privileged-actor` trains a
teacher: the env is wrapped in `envs/privileged.PrivilegedObsEnv`, whose
obs is [obs, privileged(state)], and a 6-obs `--init` gets zero weights on
the new input rows (`mlp.pad_privileged_actor`), so the teacher starts as
exactly the incumbent. `runner.train` writes `models/<run-name>/` and
`logs/` in the working directory: `best_model`, `longest_model`,
`final_model`, `cp_<steps>` every 2 x `--eval-freq` steps and the resume
state.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left at
its default it is the card, and it raises where there is no GPU. The
JAX tool's `--physics {pallas,xla}` has no counterpart: the device of the
state tensors picks the physics (CUDA tensors launch the scene's kernel,
CPU tensors take its plain PyTorch version), and there is no switch.

Run:  python -m balance_robot_tpu_torch.train.train_run Env03-v2 \\
          --privileged-actor --init models/Env03-v2_r2i/best_model.npz \\
          --gamma 0.999 --lr 1e-4 --run-name Env03-v2_teacher
      (`--device cpu` rehearses it on the CPU, at a few envs and steps)
"""

import argparse

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.privileged import PrivilegedObsEnv
from ..models import mlp
from ..physics import fast_solver
from . import checkpoint, runner
from .ppo import PPOConfig

# the turbo grade's iteration counts (the JAX tool's)
TURBO = dict(newton_iters=2, ls_iters=4)


def build_parser():
    """Every option and default of `tools/train_run.py`, with `--device`
    in place of `--platform` and no `--physics`."""
    p = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.train_run",
        description="Launch a PPO training run.")
    p.add_argument("env_id")
    p.add_argument("--envs", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--mb", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None)
    p.add_argument("--resume", action="store_true",
                   help="exact restart from <models>/<run-name>/"
                        "resume_state.npz (params + optimizer + env states + "
                        "generators + step counter)")
    p.add_argument("--max-steps", type=int, default=int(3e7))
    p.add_argument("--max-wall", type=float, default=None)
    p.add_argument("--run-name", default=None)
    p.add_argument("--eval-freq", type=int, default=200_000)
    p.add_argument("--eval-episodes", type=int, default=5)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--ent-coef", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--solver", choices=("fast", "turbo", "exact"),
                   default="fast",
                   help="constraint-solver grade: exact = the registered "
                        "iteration counts; fast = training (Newton 4 / line "
                        "search 6); turbo = Newton 2 / line search 4")
    p.add_argument("--privileged-critic", action="store_true",
                   help="asymmetric actor-critic: the value net also sees "
                        "the env's privileged features (training only)")
    p.add_argument("--privileged-actor", action="store_true",
                   help="TEACHER mode: the actor also sees the privileged "
                        "features (obs = [obs, privileged]); the label "
                        "source of DAgger distillation (train/"
                        "distill_teacher.py). Never exported.")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the envs and the nets run (default: the "
                        "GPU; raises without one)")
    return p


def make_env(env_id, solver, device, privileged_actor=False):
    """The training env of `env_id` at the grade `solver`, wrapped in
    PrivilegedObsEnv for a teacher."""
    env = brt.make(env_id, device=device)
    if solver == "fast":
        env.use_fast_solver()
    elif solver == "turbo":
        env.params = fast_solver(env.params, **TURBO)
    return PrivilegedObsEnv(env) if privileged_actor else env


def config(args):
    """The PPOConfig of parsed `args` (the JAX tool's fields)."""
    return PPOConfig(n_envs=args.envs, n_steps=args.steps,
                     minibatch_size=args.mb, n_epochs=args.epochs,
                     gamma=args.gamma, ent_coef=args.ent_coef, lr=args.lr,
                     privileged_critic=args.privileged_critic)


def warm_start(path, env, privileged_actor):
    """The `--init` params for `env`: a 6-obs checkpoint padded with zero
    rows on a teacher's privileged inputs."""
    init = checkpoint.load(path)
    if privileged_actor:
        init = mlp.pad_privileged_actor(init, env.obs_dim)
    return init


def run(args):
    """The run for parsed `args`; returns runner.train's (best params,
    history)."""
    env = make_env(args.env_id, args.solver, resolve_device(args.device),
                   args.privileged_actor)
    init = (warm_start(args.init, env, args.privileged_actor)
            if args.init else None)
    best, hist = runner.train(
        env, config(args), seed=args.seed, total_timesteps=args.max_steps,
        eval_freq=args.eval_freq, ckpt_freq=2 * args.eval_freq,
        n_eval_episodes=args.eval_episodes, init_params=init,
        max_wall_s=args.max_wall, resume=args.resume,
        run_name=args.run_name, models_dir="models", logs_dir="logs")
    print("done; best saved under models/")
    return best, hist


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
