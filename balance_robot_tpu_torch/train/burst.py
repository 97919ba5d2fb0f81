"""The burst ratchet: short PPO bursts from the incumbent, dense snapshots,
and selection by a large paired evaluation.

Counterpart of `tools/burst_refine.py`, the workflow that made the flagship
(`models/Env03-v2_r2a` ... `r2i`): PPO at the flagship's quality level
degrades over long runs but improves over its first few million steps, so
each burst runs PPO from the current best, snapshots every `--snap-steps`,
and evaluates every snapshot on the same episodes (`selection.paired_eval`
at `--seed`); a snapshot that beats the incumbent becomes the next burst's
start. With `--confirm` a win must also clear `--min-win` (default: 2
standard errors of the incumbent's rate, `selection.auto_min_win`) on a
disjoint confirm set (seed + 7919), and a pooled fresh-seed gate (seeds +
1009 and + 2003, winner against incumbent) can revert the artifact at the
end. A burst with no win decays the learning rate by `--lr-decay`.

The training env may be hardened (`envs/hardened.py`: `--train-block-speed`,
`--train-block-delay`, `--train-back-frac`, `--survival-reward`) and may
replay fatal states (`--failure-replay N`: at the top of every burst, N
episodes of the current best are harvested, `train/harvest.py`, seed + 55
+ b, and `--replay-frac` of the training resets start from the bank);
selection and evaluation always run on the standard env at the
training-grade solver. Every burst runs a fresh `PPO` from `init(seed +
100 + b, params=best)`.

It writes `best_model.npz` (the flat params of either package) and
`burst_history.json` in the JAX tool's schema: `best` (score, ret, src;
cscore, pooled and reverted_by_gate where they apply), `history` (burst,
steps, lr, full, ret, len; confirm and rejected where they apply),
`accepted` and `min_win`, and prints the JAX tool's progress lines.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.burst \\
          --init models/Env03-v2_PPO/best_model.npz \\
          --out models/Env03-v2_r6a --confirm
      (`--device cpu` rehearses it on the CPU, at a few envs and steps)
"""

import argparse
import json
import pathlib
import time

import numpy as np

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.hardened import ReplayResetEnv, harden
from ..models import mlp
from . import checkpoint as ckpt
from . import harvest, selection
from .ppo import PPO, PPOConfig

# seed offsets of the JAX tool's key sets
CONFIRM_SEED = 7919
GATE_SEEDS = (1009, 2003)
REPLAY_SEED = 55
BURST_SEED = 100


def build_parser():
    """Every option and default of `tools/burst_refine.py`, with `--device`
    in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.burst",
        description="Iterated burst fine-tuning with large-eval selection.")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", default="models/Env03-v2_r2b")
    ap.add_argument("--bursts", type=int, default=6)
    ap.add_argument("--burst-steps", type=int, default=12_000_000)
    ap.add_argument("--snap-steps", type=int, default=1_000_000)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--lr-decay", type=float, default=0.7,
                    help="lr multiplier applied after a burst with no "
                         "improvement")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--ent-coef", type=float, default=0.0,
                    help="entropy bonus (the converged policy's std is "
                         "~0.03; the deterministic selection eval guards "
                         "the reported metric)")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--mb", type=int, default=1024)
    ap.add_argument("--gamma", type=float, default=0.999)
    ap.add_argument("--eval-episodes", type=int, default=512)
    ap.add_argument("--confirm", action="store_true",
                    help="accept a paired-eval win only if it also holds "
                         "on a disjoint confirm set (seed + 7919)")
    ap.add_argument("--min-win", type=float, default=None,
                    help="with --confirm: the margin over the incumbent "
                         "required on both sets, as a full-horizon "
                         "fraction (default: 2 standard errors of the "
                         "incumbent's eval)")
    ap.add_argument("--no-final-gate", action="store_true",
                    help="skip the pooled fresh-seed final gate (winner "
                         "against incumbent on seeds + 1009 and + 2003; "
                         "the artifact reverts unless the winner pools at "
                         "least as high)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-wall", type=float, default=7200)
    ap.add_argument("--train-block-speed", type=float, default=None,
                    help="train against faster blocks (selection and eval "
                         "stay standard)")
    ap.add_argument("--train-block-delay", type=float, default=None,
                    help="train with a shorter respawn delay (selection "
                         "and eval stay standard)")
    ap.add_argument("--train-back-frac", type=float, default=None,
                    help="P(attack side = back) of the training env's "
                         "slots (selection and eval stay 50/50)")
    ap.add_argument("--survival-reward", action="store_true",
                    help="train with reward 1.0 per alive step (selection "
                         "and eval keep the reference reward)")
    ap.add_argument("--failure-replay", type=int, default=0,
                    help="harvest fatal pre-impact states of the current "
                         "best over this many episodes at the top of every "
                         "burst and start --replay-frac of the training "
                         "resets from them")
    ap.add_argument("--replay-frac", type=float, default=0.25)
    ap.add_argument("--privileged-critic", action="store_true",
                    help="the value net also sees the block's kinematics "
                         "and the attack side (training only)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the nets run (default: the "
                         "GPU; raises without one)")
    return ap


def _make_env(env_id, device, seed):
    return brt.make(env_id, device=device, seed=seed).use_fast_solver()


def _write(path, record):
    path.write_text(json.dumps(record, indent=1))


def run(args):
    """The ratchet for parsed `args`. Returns {"history": what
    burst_history.json holds, "params": the artifact's params, "banks": the
    bank size of every burst's failure replay, "snapshots": the last
    burst's [(steps, params)]}."""
    device = resolve_device(args.device)
    env = _make_env(args.env, device, args.seed)     # selection / eval
    hardened = (args.train_block_speed is not None
                or args.train_block_delay is not None
                or args.train_back_frac is not None
                or args.survival_reward or args.failure_replay > 0)
    train_env = (harden(_make_env(args.env, device, args.seed),
                        args.train_block_speed, args.train_block_delay,
                        args.train_back_frac, args.survival_reward)
                 if hardened else env)
    max_steps = env.max_episode_steps
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def big_eval(params, seed=args.seed):
        """(full-horizon rate, mean return, mean length) on the episodes of
        `seed`: paired across snapshots."""
        ev_env, act, policy = selection.act_fn_for(params, env)
        return selection.paired_eval(ev_env, act, policy, seed,
                                     args.eval_episodes)[:3]

    t0 = time.time()
    init_params = best_params = ckpt.load(args.init)
    score0 = big_eval(best_params)
    best = dict(score=score0[0], ret=score0[1], src=str(args.init))
    min_win = args.min_win
    if min_win is None:
        min_win = selection.auto_min_win(score0[0], args.eval_episodes)
        p0 = min(max(score0[0], 0.05), 0.95)
        print(f"[burst] auto min_win = 2*SE = {100 * min_win:.2f} pts "
              f"(p={100 * p0:.1f}%, n={args.eval_episodes})", flush=True)
    if args.confirm:
        c0 = big_eval(best_params, args.seed + CONFIRM_SEED)
        best["cscore"] = c0[0]
        print(f"[burst] init confirm set: full={100 * c0[0]:.1f}%",
              flush=True)
    # the artifact exists even if every burst is dry
    ckpt.save(out_dir / "best_model", best_params)
    print(f"[burst] init {args.init}: full={100 * score0[0]:.1f}% "
          f"ret={score0[1]:.0f} len={score0[2]:.0f}", flush=True)

    lr = args.lr
    history, banks, snaps = [], [], []
    for b in range(args.bursts):
        if time.time() - t0 > args.max_wall:
            print("[burst] wall budget reached", flush=True)
            break
        cfg = PPOConfig(n_envs=args.envs, n_steps=args.steps,
                        minibatch_size=args.mb, n_epochs=args.epochs,
                        gamma=args.gamma, lr=lr, ent_coef=args.ent_coef,
                        privileged_critic=args.privileged_critic)
        burst_env = train_env
        if args.failure_replay:
            # the bank tracks the failures of the latest best
            bank, info = harvest.harvest_fatal_states(
                env, best_params, episodes=args.failure_replay,
                seed=args.seed + REPLAY_SEED + b)
            banks.append(info["n_bank"])
            print(f"[replay] bank: {info['n_bank']} fatal states from "
                  f"{info['episodes']} episodes (full-horizon "
                  f"{100 * info['full_rate']:.1f}%)", flush=True)
            if info["n_bank"]:
                burst_env = ReplayResetEnv(train_env, bank, info["obs"],
                                           args.replay_frac)
        ppo = PPO(burst_env, cfg)
        ts = ppo.init(args.seed + BURST_SEED + b, params=best_params)
        spi = cfg.n_envs * cfg.n_steps
        snaps, steps, next_snap = [], 0, args.snap_steps
        while steps < args.burst_steps:
            ts, metrics = ppo.iteration(ts)
            steps += spi
            if steps >= next_snap:
                snaps.append((steps, mlp.to_numpy_params(ts.net)))
                next_snap += args.snap_steps
                print(f"[burst {b}] {steps / 1e6:5.2f}M train: "
                      f"ev={float(metrics['explained_variance']):+.3f} "
                      f"ent={float(metrics['entropy']):+.2f}", flush=True)
        del ppo, ts
        improved = False
        for s_steps, params in snaps:
            full, ret, length = big_eval(params)
            tag = ""
            if full > best["score"] + (min_win if args.confirm else 0.0):
                if args.confirm:
                    cfull = big_eval(params, args.seed + CONFIRM_SEED)[0]
                    # the margin must hold on the disjoint set too
                    if cfull < best["cscore"] + min_win:
                        print(f"[burst {b}] {s_steps / 1e6:5.1f}M primary "
                              f"win {100 * full:.1f}% did NOT confirm "
                              f"({100 * cfull:.1f}% < "
                              f"{100 * best['cscore']:.1f}% + "
                              f"{100 * min_win:.1f}) — rejected",
                              flush=True)
                        history.append(dict(burst=b, steps=s_steps, lr=lr,
                                            full=full, ret=ret, len=length,
                                            confirm=cfull, rejected=True))
                        continue
                    best_c = cfull
                else:
                    best_c = None
                best = dict(score=full, ret=ret, src=f"burst{b}@{s_steps}")
                if best_c is not None:
                    best["cscore"] = best_c
                best_params = params
                ckpt.save(out_dir / "best_model", params)
                improved = True
                tag = ("  <-- new best (confirmed)" if args.confirm
                       else "  <-- new best")
            print(f"[burst {b} lr={lr:.1e}] {s_steps / 1e6:5.1f}M "
                  f"full={100 * full:5.1f}% ret={ret:7.0f} "
                  f"len={length:6.0f}{tag}", flush=True)
            history.append(dict(burst=b, steps=s_steps, lr=lr, full=full,
                                ret=ret, len=length))
        if not improved:
            lr *= args.lr_decay
            print(f"[burst {b}] no improvement -> lr {lr:.2e}", flush=True)
        _write(out_dir / "burst_history.json",
               dict(best=best, history=history))

    # the pooled fresh-seed gate: winner against incumbent on two fresh
    # disjoint episode sets; the winner keeps the artifact only if it pools
    # at least as high
    accepted = best["src"] != str(args.init)
    if accepted and args.confirm and not args.no_final_gate:
        pooled = {}
        for name, p in (("incumbent", init_params), ("winner", best_params)):
            pooled[name] = float(np.mean(
                [big_eval(p, args.seed + s)[0] for s in GATE_SEEDS]))
            print(f"[gate] {name} pooled fresh-seed "
                  f"(2x{args.eval_episodes}): {100 * pooled[name]:.1f}%",
                  flush=True)
        if pooled["winner"] < pooled["incumbent"]:
            print(f"[gate] winner pooled {100 * pooled['winner']:.1f}% < "
                  f"incumbent {100 * pooled['incumbent']:.1f}% — REVERTING "
                  "artifact to the incumbent", flush=True)
            ckpt.save(out_dir / "best_model", init_params)
            best_params = init_params
            best = dict(score=score0[0], ret=score0[1], src=str(args.init),
                        reverted_by_gate=True)
            accepted = False
        best["pooled"] = pooled
    record = dict(best=best, history=history, accepted=accepted,
                  min_win=min_win)
    _write(out_dir / "burst_history.json", record)
    print(f"[burst] DONE accepted={accepted} best={best} "
          f"wall={time.time() - t0:.0f}s", flush=True)
    print(f"[burst] final artifact: {out_dir / 'best_model.npz'}",
          flush=True)
    return dict(history=record, params=best_params, banks=banks,
                snapshots=snaps)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the ratchet."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
