"""Holding what the timed path produced to the plain reference.

The dynamics are chaotic, so free-running trajectories in float32 and in
float64 part for a real reason. The comparison therefore follows the
program step by step: each sampled env step is run again by the reference
(`reference.envs`, in float64) from the program's own input state, the
action and the harness's uniforms of that step, and the program's output of
the step is held to the reference's. A gap is the largest |program -
reference| / (1 + |reference|) over every element compared (for the state
after the physics, the 90th percentile over envs of each env's largest gap;
see `row_gap_quantile`); a flag count is the number of envs whose done
flags (or Env03's block events) differ where the reference's decision lies
further than FLAG_MARGIN from its threshold.

Each driver's `compare` gives its cell's numbers; `verdict(...)` holds each
to its limit. The control puts the reference, computed in bfloat16, in the
program's place (`candidate_from_reference`).
"""

import math
import sys

import torch

FLOAT_FIELDS = ("qpos", "qvel", "ws", "last_pitch", "target_wheel_speed",
                "target_yaw")
# a decision this close to its threshold may flip on rounding (radians for
# the pitch, m/s for the block's park speed)
FLAG_MARGIN = 1e-4
# the envs' quantile that the state's numbers read (see row_gap_quantile)
ROW_QUANTILE = 0.9


def state_dict(s):
    """The port's EnvState as the reference's dict of tensors."""
    d = dict(qpos=s.phys.qpos, qvel=s.phys.qvel, ws=s.phys.warmstart,
             t=s.t, last_pitch=s.last_pitch, last_t=s.last_t,
             has_last=s.has_last, target_wheel_speed=s.target_wheel_speed,
             target_yaw=s.target_yaw)
    d.update(s.aux)
    return d


def cast(d, dtype):
    """`d` with its physical fields in `dtype`; times, counts and flags
    keep theirs."""
    return {k: v.to(dtype) if k in FLOAT_FIELDS else v for k, v in d.items()}


def cat(dicts):
    return {k: torch.cat([d[k] for d in dicts]) for k in dicts[0]}


def gap(cand, truth):
    """max |cand - truth| / (1 + |truth|); inf where anything is not
    finite; 0 for nothing compared."""
    if truth.numel() == 0:
        return 0.0
    cand = cand.to(torch.float64)
    truth = truth.to(torch.float64)
    g = (cand - truth).abs() / (1.0 + truth.abs())
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
    return float(g.max())


def program_step(rec):
    """The program's outputs of one recorded env step, as a dict."""
    state2, obs, reward, terminated, truncated = rec["out"]
    return dict(state_dict(state2), obs=obs, reward=reward,
                terminated=terminated, truncated=truncated)


def reference_step(ref_env, pre, action, u, dtype, phys=None):
    """The reference's outputs of one env step from `pre` (a dict in any
    dtype), computed in `dtype`; with its decision margins."""
    post, obs, reward, terminated, truncated, margin = ref_env.step(
        cast(pre, dtype), action.to(dtype), u.to(dtype),
        None if phys is None else tuple(p.to(dtype) for p in phys))
    return dict(post, obs=obs, reward=reward, terminated=terminated,
                truncated=truncated, margin=margin)


def row_gap_quantile(cand, truth, q=ROW_QUANTILE):
    """The q-quantile over rows (envs) of each row's largest gap: where a
    contact switches within a control step, float32 and float64 part for a
    real reason in a few envs, and the largest gap swings with them from
    seed to seed; a fault, or a lower precision, moves most rows."""
    if truth.numel() == 0:
        return 0.0
    g = (cand.to(torch.float64) - truth.to(torch.float64)).abs() / (
        1.0 + truth.to(torch.float64).abs())
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
    rows = g.max(-1).values.sort().values
    return float(rows[max(0, math.ceil(q * rows.numel()) - 1)])


def step_numbers(cand, truth):
    """{qpos_p90, qvel_p90, obs, reward, flags} of a candidate step against
    the reference's (batched dicts)."""
    decided = truth["margin"] > FLAG_MARGIN
    differ = ((cand["terminated"] != truth["terminated"])
              | (cand["truncated"] != truth["truncated"])
              | (cand["t"] != truth["t"]))
    if "delay_started" in truth:
        differ = differ | (cand["delay_started"] != truth["delay_started"])
    return dict(qpos_p90=row_gap_quantile(cand["qpos"], truth["qpos"]),
                qvel_p90=row_gap_quantile(cand["qvel"], truth["qvel"]),
                obs=gap(cand["obs"], truth["obs"]),
                reward=gap(cand["reward"], truth["reward"]),
                flags=int((differ & decided).sum()))


def column_gaps(cand, truth):
    """The largest gap of each column (a list), for the run's log."""
    g = (cand.to(torch.float64) - truth).abs() / (1.0 + truth.abs())
    return [float(x) for x in g.max(0).values]


def stepped(ref_env, records, control=False):
    """step_numbers over the recorded steps, batched into one reference
    call. With `control`, the candidate is the reference in bfloat16. The
    largest qpos and qvel gap of each column goes to standard error."""
    pre = cat([state_dict(r["pre"]) for r in records])
    action = torch.cat([r["action"] for r in records])
    u = torch.cat([r["u"] for r in records])
    truth = reference_step(ref_env, pre, action, u, torch.float64)
    cand = (candidate_from_reference(ref_env, pre, action, u) if control
            else cat([program_step(r) for r in records]))
    for k in ("qpos", "qvel"):
        print(f"{'control' if control else 'program'} {k} gap by column: "
              + " ".join(f"{g:.3g}" for g in column_gaps(cand[k],
                                                         truth[k])),
              file=sys.stderr)
    return step_numbers(cand, truth)


def candidate_from_reference(ref_env, pre, action, u,
                             dtype=torch.bfloat16):
    """The control: the reference in the program's place, in the nearest
    precision below float32 (the physics keeps its state in it; see
    `reference.envs.bfloat16_state`)."""
    return reference_step(ref_env, pre, action, u, dtype)


def reset_violations(ref_env, records):
    """The number of envs, over the records of `VecEnv.step`, that break
    auto-reset: where an episode runs on, the state and obs the env step
    returned must pass unchanged; where it ended, a fresh episode must take
    its place, and the pre-reset obs must be reported as terminal."""
    bad = 0
    for r in records:
        env_out = program_step(r)
        vec, vo = state_dict(r["vec_state"]), r["vec_out"]
        done = env_out["terminated"] | env_out["truncated"]
        B = done.shape[0]
        differs = torch.zeros(B, dtype=torch.bool, device=done.device)
        for k, v in vec.items():
            differs |= (v != env_out[k]).reshape(B, -1).any(-1)
        differs |= (vo.obs != env_out["obs"]).any(-1)
        wrong = ((vo.done != done) | (vo.terminal_obs != env_out["obs"])
                 .any(-1) | (~done & differs)
                 | (done & ~ref_env.fresh(cast(vec, torch.float64),
                                          vo.obs.to(torch.float64))))
        bad += int(wrong.sum())
    return bad


def fresh_violations(ref_env, starts):
    """The number of episodes, over the (state, obs) of each reset in
    `starts`, that do not start fresh as the reference's reset makes them:
    the start that the stepped comparison, following the program's own
    states, does not see."""
    bad = 0
    for state, obs in starts:
        bad += int((~ref_env.fresh(cast(state_dict(state), torch.float64),
                                   obs.to(torch.float64))).sum())
    return bad


def mean_gap(cand, obs, params, clip, control=False):
    """max |cand - mean(obs)| of the policy's mean (clipped to [-1, 1]
    with `clip`) against the reference's, in float64; with `control`, the
    candidate is the reference's mean in bfloat16."""
    from .reference import mlp
    obs = obs.to(params["pi_w1"].device)

    def act(p, dtype):
        m = mlp.policy_mean({k: v.to(dtype) for k, v in p.items()},
                            obs.to(dtype))
        return m.clamp(-1.0, 1.0) if clip else m

    truth = act(params, torch.float64)
    if control:
        cand = act(params, torch.bfloat16)
    cand = cand.to(truth.device, torch.float64)
    g = (cand - truth).abs()
    return float(torch.where(torch.isfinite(g), g,
                             torch.full_like(g, math.inf)).max())


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit fails."""
    rows = [(name, value, limits.get(name)) for name, value in
            numbers.items()]
    ok = all(limit is not None and value <= limit
             for _, value, limit in rows)
    return ok, rows
