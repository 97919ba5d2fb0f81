"""Oracle recoverability probe for the Env03 block envs: of the block
launches the policy dies to, how many are physically recoverable at all?

Counterpart of `tools/oracle_probe.py`, with its options, defaults and
output lines:

  1. harvest (`train/harvest.py`): the policy's fatal pre-impact states
     (at most `--max-fatal`) and the obs each snapshot's step emitted;
  2. CEM over open-loop action sequences of `--horizon` steps from each of
     the F states, `--pop` candidates per state: the mean starts from the
     policy's own closed-loop actions, the std at `--init-std`; each of
     `--iters` generations rolls all F x P candidates as one flat batch and
     refits mean and std to the elites (`train/recovery.py`). The host
     keeps each state's best sequence over all generations;
  3. the best sequences are replayed at batch F: the recoverable share,
     and with `--dump-dagger` the (obs, action) pairs of the replays that
     recovered, each obs the one the policy would have acted on (the
     banked snapshot obs, then the obs each step emitted).

Every rollout from a bank state reads its launch draws from one table of
(`--horizon`, F, 6) uniforms drawn once from `--seed` + 999, the seed of
the CEM noise too (`recovery.draw_table`): as the JAX states' own keys do,
it gives all candidates of a state, every generation and the replay the
same launches. K2's bits for an env do not depend on the batch (each of
its instantiations takes its row sums as 32 lanes would), so a replay at
batch F gives the bits its sequence scored in a generation's batch of F x
P.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.oracle_probe \\
          models/Env03-v2_PPO/best_model.npz --episodes 512 --pop 128 \\
          --iters 8 --dump-dagger runs/dagger.npz
"""

import argparse

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt
from . import harvest, recovery


def build_parser():
    """Every option and default of `tools/oracle_probe.py`, with
    `--device` in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.oracle_probe",
        description="Oracle recoverability probe (CEM from fatal states).")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--episodes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--horizon", type=int, default=100,
                    help="CEM action-sequence length (control steps; launch->"
                         "impact is ~8, recovery a few dozen)")
    ap.add_argument("--pop", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--elite-frac", type=float, default=0.1)
    ap.add_argument("--init-std", type=float, default=0.4)
    ap.add_argument("--max-fatal", type=int, default=256,
                    help="cap on fatal states probed (keeps F*P bounded)")
    ap.add_argument("--dump-dagger", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the policy run (default: the "
                         "GPU; raises without one)")
    return ap


@torch.no_grad()
def cem_generation(env, states, mean, std, eps, table, elite_frac):
    """One generation from the F `states`: candidates (F, P, H, 2) from
    mean / std (F, H, 2) and the noise `eps` (F, P, H, 2), rolled as one
    batch of F x P with `table` (H, F, 6) repeated over the candidates.
    Returns (mean, std, best score (F,), any candidate recovered (F,), the
    best candidate (F, H, 2))."""
    F, P, H = eps.shape[:3]
    cand = recovery.candidates(mean, std, eps)
    out = recovery.rollout(env, recovery.repeat(states, P), None,
                           table.repeat_interleave(P, 1),
                           actions=cand.reshape(F * P, H, 2))
    score = out["score"].reshape(F, P)
    new_mean, new_std = recovery.elite_update(cand, score, elite_frac)
    best = score.max(1).values
    best_cand = cand[torch.arange(F, device=cand.device), score.argmax(1)]
    return (new_mean, new_std, best,
            out["recovered"].reshape(F, P).any(1), best_cand)


def dagger_pairs(obs0, emitted, actions, rec):
    """The pairs of the replays that recovered: (obs (R H, 6), act (R H,
    2), obs_traj (R, H, 6), act_traj (R, H, 2)); each obs is the one before
    its action: the banked `obs0` (F, 6), then `emitted` (F, H, 6) shifted
    right by one step."""
    pre = np.concatenate([obs0[:, None], emitted[:, :-1]], axis=1)
    obs_np, act_np = pre[rec], actions[rec]
    return (obs_np.reshape(-1, obs_np.shape[-1]),
            act_np.reshape(-1, act_np.shape[-1]), obs_np, act_np)


@torch.no_grad()
def run(args):
    """The probe for parsed `args`. Returns None where the harvest banked no
    state, else a dict: F, `run_best_score` (each state's best over the
    generations), and the replay's `score` and `recovered` (F,)."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device)
    env.use_fast_solver()
    params = ckpt.load(args.model)
    H = args.horizon
    net = mlp.from_numpy_params(params, device=env.device, dtype=env.dtype)

    fatal_states, info = harvest.harvest_fatal_states(
        env, params, episodes=args.episodes, seed=args.seed,
        chunk=args.chunk, max_states=args.max_fatal)
    print(f"harvest: {args.episodes} episodes, full-horizon "
          f"{100 * info['full_rate']:.1f}%, fatal launches {info['n_fatal']}",
          flush=True)
    if info["n_bank"] == 0:
        print("no failures to probe")
        return None
    F = info["n_bank"]
    fatal_obs = info["obs"]
    print(f"probing F={F} fatal states (policy died "
          f"{np.median(info['death_dt']):.0f} steps after launch, median)",
          flush=True)

    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed + 999)
    table = recovery.draw_table(H, F, gen, env.dtype)
    # the CEM mean starts from the policy's closed-loop actions
    mean = recovery.rollout(env, fatal_states, fatal_obs, table, net=net,
                            tail=H)["actions"]
    std = torch.full_like(mean, args.init_std)
    rec_union = np.zeros(F, bool)
    run_best_score = np.full(F, -np.inf, np.float32)
    run_best_act = mean.cpu().numpy()
    for it in range(args.iters):
        eps = torch.randn((F, args.pop, H, 2), generator=gen,
                          device=env.device, dtype=env.dtype)
        mean, std, best, rec_any, bcand = cem_generation(
            env, fatal_states, mean, std, eps, table, args.elite_frac)
        rec_union |= rec_any.cpu().numpy()
        best = best.cpu().numpy()
        upd = best > run_best_score
        run_best_score = np.where(upd, best, run_best_score)
        run_best_act[upd] = bcand.cpu().numpy()[upd]
        print(f"[cem {it}] population-recoverable "
              f"{100 * rec_union.mean():.0f}%  best-score med "
              f"{np.median(best):.0f}", flush=True)

    out = recovery.rollout(
        env, fatal_states, None, table,
        actions=torch.as_tensor(run_best_act, device=env.device))
    surv, rec = out["surv"].cpu().numpy(), out["recovered"].cpu().numpy()
    print(f"\nORACLE: {F} fatal launches -> best sequence recovers "
          f"{rec.sum()} ({100 * rec.mean():.0f}%); any-candidate-seen "
          f"{100 * rec_union.mean():.0f}%")
    print(f"  surviving full CEM horizon: {100 * (surv >= H).mean():.0f}%")
    print("  -> ceiling estimate: current full-horizon rate + "
          "recoverable fraction of the loss mass")

    if args.dump_dagger:
        obs, act, obs_traj, act_traj = dagger_pairs(
            fatal_obs.cpu().numpy(), out["emitted"].cpu().numpy(),
            run_best_act, rec)
        np.savez(args.dump_dagger, obs=obs, act=act, obs_traj=obs_traj,
                 act_traj=act_traj, n_traj=int(rec.sum()), horizon=H)
        print(f"dagger data ({int(rec.sum())} trajs) -> {args.dump_dagger}")
    return dict(F=F, run_best_score=run_best_score,
                score=out["score"].cpu().numpy(), recovered=rec)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and probe."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
