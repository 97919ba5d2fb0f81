"""Closed-loop recovery expert for the Env03 block envs (MPC-DAgger):
receding-horizon CEM from the policy's fatal states, whose executed
(obs, action) stream is the demonstration `train/bc_finetune.py` clones.

Counterpart of `tools/mpc_dagger.py`, with its options, defaults and
output lines. After the harvest (`train/harvest.py`), all F fatal states
are planned at once:

  * a plan is `--plan-h` actions, scored by rolling them open-loop and then
    `--tail-h` steps of the policy (a plan counts only if it hands off into
    a state the policy can continue from); score and elite update are
    `train/recovery.py`'s, each CEM iteration one flat batch of F x
    `--pop` rollouts;
  * the first plan is the policy's own closed-loop actions, the std
    `--init-std`; each replan runs `--iters` CEM iterations, executes the
    plan's first `--exec-k` actions on the F states (`exec_head`),
    recording (obs, action, alive) before each step, then drops the
    executed head, repeats the last action into the tail and refills the
    tail's std with `--init-std` (`shift_plan`);
  * after (`--replay-steps` // K) x K steps: the survived and recovered
    shares, the alive curve, the pooled ceiling (1 - 0.0065 (1 - r))^16,
    and the pairs of the experts that recovered into `--dump`.

The launch draws come from one table of (R + plan-h + tail-h, F, 6)
uniforms drawn once from `--seed` + 999, the seed of the CEM noise too,
indexed by the step counted from the snapshot: a plan made at replan step
s reads rows s ... s + plan-h + tail-h - 1, and `exec_head` executes on
rows s ... s + K - 1, as the JAX planner rolls each state's own future
key (`recovery.py`). The obs are threaded from the harvest's banked
snapshot obs through the steps that advanced each state, never
recomputed (the fd pitch_dot is stateful).

`--dump` defaults to runs/dagger_mpc.npz, under the working directory.
`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU.

Run:  python -m balance_robot_tpu_torch.train.mpc_dagger \\
          models/Env03-v2_r2f/best_model.npz --episodes 512 --pop 64 \\
          --iters 2 --plan-h 25 --exec-k 4 --replay-steps 148 \\
          --dump runs/dagger_mpc.npz
"""

import argparse
import time

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt
from . import harvest, recovery
from .harvest import _where

H_LAUNCH = 0.0065      # the incumbent's death hazard per launch
LAUNCHES = 16          # launches in a full-horizon episode


def build_parser():
    """Every option and default of `tools/mpc_dagger.py`, with `--device`
    in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.mpc_dagger",
        description="Closed-loop recovery expert (receding-horizon CEM).")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--episodes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-fatal", type=int, default=128)
    ap.add_argument("--plan-h", type=int, default=20,
                    help="CEM lookahead (control steps)")
    ap.add_argument("--tail-h", type=int, default=60,
                    help="policy-controlled tail appended to every plan "
                         "rollout before scoring: a plan is only good if it "
                         "hands off into a state the POLICY can continue from "
                         "(that handoff is the thing BC must learn)")
    ap.add_argument("--exec-k", type=int, default=4,
                    help="steps executed per replan — the feedback interval")
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--iters", type=int, default=2,
                    help="CEM iters per replan")
    ap.add_argument("--elite-frac", type=float, default=0.125)
    ap.add_argument("--init-std", type=float, default=0.3)
    ap.add_argument("--replay-steps", type=int, default=148,
                    help="total expert steps per state (multiple of exec-k)")
    ap.add_argument("--dump", default="runs/dagger_mpc.npz")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs and the policy run (default: the "
                         "GPU; raises without one)")
    return ap


class Planner:
    """The planning steps of one expert run on `env` with the policy `net`,
    `table` (steps, F, 6) the bank's launch draws."""

    def __init__(self, env, net, table, plan_h, tail_h, exec_k, pop,
                 elite_frac, init_std):
        self.env, self.net, self.table = env, net, table
        self.Hs, self.Ht, self.K, self.P = plan_h, tail_h, exec_k, pop
        self.elite_frac, self.init_std = elite_frac, init_std

    @torch.no_grad()
    def policy_plan(self, states, obs):
        """The policy's closed-loop actions (F, Hs, 2) from the bank: the
        first CEM mean."""
        return recovery.rollout(self.env, states, obs, self.table[:self.Hs],
                                net=self.net, tail=self.Hs)["actions"]

    @torch.no_grad()
    def cem_iter(self, states, obs, mean, std, eps, s):
        """One CEM iteration at replan step s with the noise `eps` (F, P,
        Hs, 2): every candidate plan is rolled with its policy tail from
        its state, as one batch of F x P. Returns the new (mean, std)."""
        F, P = eps.shape[:2]
        cand = recovery.candidates(mean, std, eps)
        score = recovery.rollout(
            self.env, recovery.repeat(states, P), recovery.repeat(obs, P),
            self.table[s:s + self.Hs + self.Ht].repeat_interleave(P, 1),
            actions=cand.reshape(F * P, self.Hs, 2), net=self.net,
            tail=self.Ht)["score"].reshape(F, P)
        return recovery.elite_update(cand, score, self.elite_frac)

    @torch.no_grad()
    def exec_head(self, states, obs, alive, mean, s):
        """Execute the plan's first K actions on the F states from replan
        step s; an env that is dead keeps its state and obs. Returns
        (states, obs, alive, and per step the obs before it (K, F, 6), the
        action (K, F, 2) and whether the env was alive before it (K, F))."""
        rows = []
        for j in range(self.K):
            a = mean[:, j]
            states2, obs2, _, term, _ = self.env.step(states, a,
                                                      self.table[s + j])
            rows.append((obs, a, alive))
            states = _where(alive, states2, states)
            obs = _where(alive, obs2, obs)
            alive = alive & ~term
        obs_k, act_k, alive_k = (torch.stack(x) for x in zip(*rows))
        return states, obs, alive, obs_k, act_k, alive_k

    def shift_plan(self, mean, std):
        """Receding horizon: drop the executed head, repeat the last action
        into the tail, and refill the tail's std with init_std."""
        K = self.K
        mean2 = torch.cat([mean[:, K:], mean[:, -1:].expand(-1, K, -1)], 1)
        std2 = torch.cat([std[:, K:], torch.full_like(std[:, :K],
                                                      self.init_std)], 1)
        return mean2, std2


def ceiling(r):
    """The pooled full-horizon rate if every launch the incumbent dies to
    (hazard H_LAUNCH) were survived with probability r."""
    return (1.0 - H_LAUNCH * (1.0 - r)) ** LAUNCHES


@torch.no_grad()
def run(args):
    """The expert for parsed `args`. Returns None where the harvest banked
    no state, else a dict: F, R, `survived` and `recovered` (F,), and
    `keep` (R, F), the (step, state) pairs dumped."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device)
    env.use_fast_solver()
    params = ckpt.load(args.model)
    Hs, Ht, K = args.plan_h, args.tail_h, args.exec_k
    net = mlp.from_numpy_params(params, device=env.device, dtype=env.dtype)

    t0 = time.time()
    bank, info = harvest.harvest_fatal_states(
        env, params, episodes=args.episodes, seed=args.seed,
        max_states=args.max_fatal)
    print(f"harvest: full-horizon {100 * info['full_rate']:.1f}%, "
          f"bank {info['n_bank']} fatal launches ({time.time() - t0:.0f}s)",
          flush=True)
    if info["n_bank"] == 0:
        print("nothing to plan from")
        return None
    F = info["n_bank"]

    R = (args.replay_steps // K) * K
    gen = torch.Generator(device=env.device)
    gen.manual_seed(args.seed + 999)
    plan = Planner(env, net, recovery.draw_table(R + Hs + Ht, F, gen,
                                                 env.dtype),
                   Hs, Ht, K, args.pop, args.elite_frac, args.init_std)
    # the banked obs of each snapshot's own step: recomputed from the bare
    # state, the fd pitch_dot would read 0 mid-incident
    obs, states = info["obs"], bank
    alive = torch.ones(F, dtype=torch.bool, device=env.device)
    mean = plan.policy_plan(states, obs)
    std = torch.full_like(mean, args.init_std)
    obs_rows, act_rows, alive_rows = [], [], []
    t0 = time.time()
    for step in range(0, R, K):
        for _ in range(args.iters):
            eps = torch.randn((F, args.pop, Hs, 2), generator=gen,
                              device=env.device, dtype=env.dtype)
            mean, std = plan.cem_iter(states, obs, mean, std, eps, step)
        states, obs, alive, obs_k, act_k, alive_k = plan.exec_head(
            states, obs, alive, mean, step)
        mean, std = plan.shift_plan(mean, std)
        obs_rows.append(obs_k.cpu().numpy())
        act_rows.append(act_k.cpu().numpy())
        alive_rows.append(alive_k.cpu().numpy())
        if (step // K) % 8 == 0:
            print(f"[mpc {step:3d}/{R}] expert-alive "
                  f"{100 * alive.float().mean().item():.0f}%  "
                  f"({time.time() - t0:.0f}s)", flush=True)

    recovered = recovery.recovered(states, alive)[0].cpu().numpy()
    surv = alive.cpu().numpy()
    print(f"\nMPC expert: {F} fatal launches -> survived {R} steps: "
          f"{surv.sum()} ({100 * surv.mean():.0f}%), recovered upright: "
          f"{recovered.sum()} ({100 * recovered.mean():.0f}%)")
    # the alive curve separates clearing the killing launch (~64 steps
    # covers the median death lag) from surviving the follow-on launches
    alive_curve = np.concatenate(alive_rows, axis=0)     # (R, F) pre-step
    for t in (48, 64, 96, R - 1):
        if t < alive_curve.shape[0]:
            print(f"  alive@{t + 1:3d} steps: "
                  f"{100 * alive_curve[t].mean():.0f}%")
    for name, r in (("survived-window", surv.mean()),
                    ("recovered-upright", recovered.mean())):
        print(f"  pooled ceiling if policy matched expert ({name} "
              f"r={100 * r:.0f}%): {100 * ceiling(r):.1f}% "
              f"[(1 - {H_LAUNCH}*(1-r))^{LAUNCHES}]")

    obs_all = np.concatenate(obs_rows, axis=0)      # (R, F, 6)
    act_all = np.concatenate(act_rows, axis=0)      # (R, F, 2)
    keep = alive_curve & recovered[None, :]         # successful experts only
    obs_np, act_np = obs_all[keep], act_all[keep]
    np.savez(args.dump, obs=obs_np, act=act_np,
             n_traj=int(recovered.sum()), replay_steps=R,
             expert_survival=float(surv.mean()),
             expert_recovered=float(recovered.mean()))
    print(f"dagger data: {obs_np.shape[0]} (obs, act) pairs from "
          f"{int(recovered.sum())} recovery demonstrations -> {args.dump}")
    return dict(F=F, R=R, survived=surv, recovered=recovered, keep=keep)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and run the expert."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
