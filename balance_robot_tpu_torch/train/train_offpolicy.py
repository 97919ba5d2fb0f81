"""Launch an off-policy (SAC / TD3 / DDPG) training run.

Counterpart of `tools/train_offpolicy.py`, with its options, defaults,
artifacts and last line. `cli train -a SAC` runs the factory's defaults
(one update per env step); this driver also sets the knobs of the
update-to-data ratio. With `--envs` parallel envs, one iteration collects
`--envs` transitions and runs `--grad-steps` updates of `--batch` rows
from a buffer of `--buffer` rows, so the ratio is grad_steps / envs (SB3's
single-env default is 1 / 1). No update runs before `--learning-starts`
transitions (summed over the envs) are in the buffer. The factory caps the
env count at 256, as the JAX package's does: a larger `--envs` runs 256
envs. `runner.train` writes `models/<run-name>/` (default
`<env>_<algo>`) and `logs/`, with `cp_<steps>` every 4 x `--eval-freq`
steps.

`--init` warm-starts from a checkpoint file of the same algorithm
(`offpolicy.nest` reads its flat keys); the JAX tool raises there, since
its trainer cannot read a checkpoint file. `--device cuda|cpu` takes the
place of `--platform`: left at its default it is the card, and it raises
where there is no GPU. The JAX tool's `--physics {pallas,xla}` has no
counterpart: CUDA tensors launch the scene's kernel, CPU tensors take its
plain PyTorch version, and there is no switch.

Run:  python -m balance_robot_tpu_torch.train.train_offpolicy SAC Env01-v2 \\
          --envs 64 --grad-steps 8 --max-steps 3000000 --max-wall 1800
"""

import argparse

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from . import checkpoint, runner
from .factory import algorithm_factory


def build_parser():
    """Every option and default of `tools/train_offpolicy.py`, with
    `--device` in place of `--platform` and no `--physics`."""
    p = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.train_offpolicy",
        description="Launch an off-policy (SAC/TD3/DDPG) training run.")
    p.add_argument("algo", choices=("SAC", "TD3", "DDPG"))
    p.add_argument("env_id")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--grad-steps", type=int, default=8,
                   help="gradient updates per vectorized env step")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--buffer", type=int, default=1_000_000)
    p.add_argument("--lr", type=float, default=None,
                   help="override the per-algo SB3 default")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--learning-starts", type=int, default=10_000,
                   help="random-action warmup in TRANSITIONS (SB3 SAC "
                        "default 100 is tuned for 1 env; a vectorized run "
                        "fills that in <1 iteration)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default=None)
    p.add_argument("--resume", action="store_true",
                   help="exact restart from <models>/<run-name>/"
                        "resume_state.npz (params + opts + replay buffer "
                        "pointer state)")
    p.add_argument("--max-steps", type=int, default=int(5e6))
    p.add_argument("--max-wall", type=float, default=None)
    p.add_argument("--eval-freq", type=int, default=100_000)
    p.add_argument("--eval-episodes", type=int, default=16)
    p.add_argument("--run-name", default=None)
    p.add_argument("--solver", choices=("fast", "exact"), default="fast")
    p.add_argument("--privileged-critic", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the envs, the nets and the buffer live "
                        "(default: the GPU; raises without one)")
    return p


def trainer_of(args, env):
    """(trainer, config) of parsed `args` on `env`, through the factory."""
    overrides = dict(gradient_steps=args.grad_steps, batch_size=args.batch,
                     buffer_size=args.buffer, gamma=args.gamma,
                     learning_starts=args.learning_starts,
                     privileged_critic=args.privileged_critic)
    if args.lr is not None:
        overrides["lr"] = args.lr
    return algorithm_factory(args.algo, env, n_envs=args.envs, **overrides)


def run(args):
    """The run for parsed `args`; returns runner.train's (best params,
    history)."""
    env = brt.make(args.env_id, device=resolve_device(args.device))
    if args.solver == "fast":
        env.use_fast_solver()
    trainer, cfg = trainer_of(args, env)
    init = checkpoint.load(args.init) if args.init else None
    run_name = args.run_name or f"{args.env_id}_{args.algo}"
    best, hist = runner.train(
        env, cfg, seed=args.seed, total_timesteps=args.max_steps,
        eval_freq=args.eval_freq, ckpt_freq=4 * args.eval_freq,
        n_eval_episodes=args.eval_episodes, init_params=init,
        max_wall_s=args.max_wall, trainer=trainer, run_name=run_name,
        resume=args.resume, models_dir="models", logs_dir="logs")
    print(f"done; artifacts under models/{run_name}/")
    return best, hist


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
