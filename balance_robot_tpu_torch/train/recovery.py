"""What the oracle recoverability probe and the MPC recovery expert share:
rollouts from banked fatal states with the alive mask frozen, the
recovery test, the score, and the CEM elite update.

Counterpart of the rollout and CEM pieces of `tools/oracle_probe.py`
(`seq_rollout` :95-120, `policy_rollout` :123-147, `cem_generation`
:150-180) and `tools/mpc_dagger.py` (`plan_score_rollout` :95-128,
`policy_plan` :131-151, `cem_iter` :153-164):

  * a rollout steps every env each control step and keeps the new state
    (and obs) only where the env is still alive; an env is alive until a
    step terminates it; `surv` counts its alive steps;
  * recovered: alive, |pitch| < 0.25 and |qvel[3]| (the pitch rate) < 2.0
    at the end;
  * score: surv + 50 x recovered - |pitch| at the end;
  * the elite update: the k = max(1, int(P x elite_frac)) best candidates
    of each state (a stable sort, so ties keep the candidates' order),
    their mean and their population std (ddof 0) + 0.02.

Frozen noise. In the JAX package every env state carries its own key and
each Env03 step splits it for its launch draws, so every candidate rolled
from a repeated fatal state meets the same future launches, in every
generation and in the replay. The port's envs draw from the env's
generator instead; here the launch draws come from a table (steps, F, 6)
drawn once per bank (`draw_table`), row t for control step t counted from
the snapshot, repeated over a state's candidates. An env that
is dead reads on down the table where the JAX state's key would stand
still; a dead env's state is frozen either way.
"""

import torch

from ..envs.base import pitch_of, tree_map
from .harvest import _where
from .ppo import deterministic_action

RECOVER_PITCH = 0.25
RECOVER_PITCH_RATE = 2.0
RECOVERY_BONUS = 50.0
STD_FLOOR = 0.02


def draw_table(steps, n, gen, dtype):
    """(steps, n, 6) launch uniforms from the generator `gen`: row t holds
    the draws of control step t of n states."""
    return torch.rand((steps, n, 6), generator=gen, device=gen.device,
                      dtype=dtype)


def repeat(x, P):
    """Each of the F states (or rows of a tensor) P times in a row: (F P,
    ...), candidate p of state f at f P + p, as `jnp.repeat(x, P)`."""
    return tree_map(lambda t: t.repeat_interleave(P, 0), x)


def recovered(states, alive):
    """(recovered (B,) bool, pitch (B,)): alive, upright and slow."""
    pitch = pitch_of(states.phys.qpos)
    rec = alive & (pitch.abs() < RECOVER_PITCH) & (
        states.phys.qvel[:, 3].abs() < RECOVER_PITCH_RATE)
    return rec, pitch


def score(surv, rec, pitch):
    """surv + 50 x recovered - |pitch|, in the pitch's dtype."""
    return (surv.to(pitch.dtype) + RECOVERY_BONUS * rec.to(pitch.dtype)
            - pitch.abs())


def rollout(env, states, obs, table, actions=None, net=None, tail=0):
    """Roll `actions` (B, H, 2) open-loop, then `tail` steps of `net`'s
    clipped mean on the threaded obs, with step t's launch draws from
    `table[t]` (B, 6). `obs` (B, 6) may be None where no policy acts.

    Returns a dict: at the end `states`, `obs`, `alive`, `surv` (int32),
    `recovered` and `score`; per step the `actions` taken (B, T, 2) and the
    obs each step `emitted`, unmasked (B, T, 6)."""
    n_open = 0 if actions is None else actions.shape[1]
    B = table.shape[1]
    alive = torch.ones(B, dtype=torch.bool, device=table.device)
    surv = torch.zeros(B, dtype=torch.int32, device=table.device)
    acts, emitted = [], []
    for t in range(n_open + tail):
        a = actions[:, t] if t < n_open else deterministic_action(net, obs)
        states2, obs2, _, term, _ = env.step(states, a, table[t])
        states = _where(alive, states2, states)
        if obs is not None:
            obs = _where(alive, obs2, obs)
        surv = surv + alive.to(torch.int32)
        alive = alive & ~term
        acts.append(a)
        emitted.append(obs2)
    rec, pitch = recovered(states, alive)
    return dict(states=states, obs=obs, alive=alive, surv=surv,
                recovered=rec, score=score(surv, rec, pitch),
                actions=torch.stack(acts, 1), emitted=torch.stack(emitted, 1))


def candidates(mean, std, eps):
    """clip(mean + std x eps, -1, 1): (F, P, H, 2) from (F, H, 2) and eps
    (F, P, H, 2)."""
    return (mean[:, None] + std[:, None] * eps).clamp(-1.0, 1.0)


def elite_update(cand, score, elite_frac):
    """(mean, std) (F, H, 2) of the k best candidates of each state by
    `score` (F, P)."""
    k = max(1, int(score.shape[1] * elite_frac))
    idx = torch.argsort(-score, dim=1, stable=True)[:, :k]
    elite = torch.take_along_dim(cand, idx[:, :, None, None], dim=1)
    return elite.mean(1), elite.std(1, correction=0) + STD_FLOOR
