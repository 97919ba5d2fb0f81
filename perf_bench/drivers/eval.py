"""The flagship's selection eval: 512 fresh deterministic episodes from a seed
through `selection.paired_eval` and the `ChunkedEvaluator`, back to back.

Each eval forks the env with its own seed, resets its episodes, and steps
them by the policy's clipped mean to the horizon, in chunks with one host
sync each. The episodes come from the traffic's `pool_seed`, not the run's:
the k-th eval of every run resets the same episodes and fires the same
blocks at them, dealt to the rows in an order drawn from the run's seed
(`recording.TrafficEnv`'s `order`). So a seed moves neither the work nor
the contacts, which set K2's time; it moves where each episode runs and
which steps are held to the reference. The window ends at the
first chunk boundary (or the end of an eval) after `--seconds`; the eval in
progress then runs to its end outside the window, so that its returns and
lengths can be held to the reference too.

Traffic: pool_seed, n_envs, horizon, chunk, warmup_steps (a short eval of
the same shapes in set-up), sampled_steps, traced_from / traced_steps
(steps of the first eval).
"""

import math
import time
from types import SimpleNamespace

import torch

from .. import check, program, window as win
from ..recording import Recorder, TrafficEnv
from ..reference import envs as ref_envs, mlp as ref_mlp


class Clock:
    """Times the window's chunk boundaries from the evaluator's calls of
    its act fn: the first call of a chunk comes after the host synced on
    the chunk before."""

    def __init__(self, chunk, on_close):
        self.chunk = chunk
        self.on_close = on_close
        self.i = 0              # steps of the eval in progress
        self.done = 0           # steps of the evals completed
        self.t0 = self.deadline = None
        self.end = None         # (time, steps) at the close
        self.span = None
        self.traced = None

    def open(self, seconds):
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def _boundary(self, steps):
        if self.t0 is not None and self.end is None:
            now = time.perf_counter()
            if now >= self.deadline:
                self.end = (now, steps)
                self.on_close()

    def step(self):
        if self.i and self.i % self.chunk == 0:
            self._boundary(self.done + self.i)
        if self.span is not None and self.done == 0:
            first, last = self.traced
            if self.i == first:
                self.span.start()
            elif self.i == last:
                self.span.stop()
        self.i += 1

    def eval_done(self):
        self.done += self.i
        self.i = 0
        self._boundary(self.done)


def setup(ctx):
    from balance_robot_tpu_torch.train import selection
    tr, dev = ctx.traffic, ctx.device
    pool = tr["pool_seed"]
    env = program.make_env(ctx, program.derive(pool, 1))
    env, act_fn, policy = selection.act_fn_for(program.load_params(ctx.config),
                                               env)
    rec = Recorder(tr["sampled_steps"], program.derive(ctx.seed, 2))

    def close():
        rec.on = False

    clock = Clock(tr["chunk"], close)
    order = torch.randperm(
        tr["n_envs"], generator=program.generator(program.derive(ctx.seed, 6),
                                                  "cpu")).to(dev)
    tenv = TrafficEnv(env, program.generator(program.derive(pool, 3), dev),
                      ref_envs.load(env.id).n_uniforms, rec, order=order)

    def act(params, obs):
        clock.step()
        rec.begin()
        a = act_fn(params, obs)
        rec.put(obs=obs, act=a)
        return a

    st = SimpleNamespace(env=env, rec=rec, clock=clock, tenv=tenv, act=act,
                         policy=policy, evals=[], selection=selection)
    rec.on = False
    selection.paired_eval(tenv, act, policy, program.derive(pool, 5),
                          tr["n_envs"], max_steps=tr["warmup_steps"],
                          chunk=tr["chunk"])
    clock.i = 0
    rec.on = True
    return st


def window(ctx, st):
    tr = ctx.traffic
    clock = st.clock
    if ctx.trace:
        from ..tracing import TracedSpan
        clock.span = TracedSpan()
        clock.traced = (tr["traced_from"],
                        tr["traced_from"] + tr["traced_steps"])
    st.starts = st.tenv.starts = []
    program.sync(ctx.device)
    clock.open(ctx.seconds)
    k = 0
    while clock.end is None:
        st.rec.every_step = []
        _, _, _, rets, lens = st.selection.paired_eval(
            st.tenv, st.act, st.policy,
            program.derive(ctx.traffic["pool_seed"], 100 + k),
            tr["n_envs"], max_steps=tr["horizon"], chunk=tr["chunk"])
        st.evals.append((rets, lens, st.rec.every_step))
        clock.eval_done()
        k += 1
    st.rec.every_step = None
    t1, steps = clock.end
    seconds = t1 - clock.t0
    B = tr["n_envs"]
    return dict(e2e=dict(env_steps_per_s=win.rate(B * steps, seconds)),
                attempted=B * steps, failed=0, seconds=seconds, steps=steps,
                env_steps=B * steps,
                traced_steps=tr["traced_steps"] if ctx.trace else None,
                trace=clock.span.read() if clock.span is not None else None)


def bookkeeping(steps, n, max_steps, dtype):
    """The evaluator's returns and lengths worked out again from every
    step's (reward, terminated, truncated): a done episode is frozen, and
    reaching max_steps truncates. Returns (returns in `dtype`, lengths,
    the sum of |reward| each return accumulated, in float64)."""
    ret = torch.zeros(n, dtype=dtype)
    scale = torch.zeros(n, dtype=torch.float64)
    t = torch.zeros(n, dtype=torch.int64)
    done = torch.zeros(n, dtype=torch.bool)
    for r, term, trunc in steps:
        r = r.cpu()
        ret += torch.where(done, 0.0, r.to(dtype))
        scale += torch.where(done, 0.0, r.to(torch.float64).abs())
        t += (~done).to(torch.int64)
        done = done | term.cpu() | trunc.cpu() | (t >= max_steps)
    return ret, t, scale


def episode_numbers(evals, max_steps, control=False):
    """{returns, lengths} of every eval: the largest |return - the
    reference's| over 1 + the sum of |reward| it accumulated (the scale of
    a float32 sum's rounding, which a return's cancellations do not
    shrink), and the lengths that differ. With `control`, the candidate is
    the bookkeeping in bfloat16."""
    worst, wrong = 0.0, 0
    for rets, lens, steps in evals:
        ret, t, scale = bookkeeping(steps, len(rets), max_steps,
                                    torch.float64)
        if control:
            rets, lens, _ = bookkeeping(steps, len(rets), max_steps,
                                        torch.bfloat16)
        g = (torch.as_tensor(rets).to(torch.float64) - ret).abs() / (
            1.0 + scale)
        worst = max(worst, float(torch.where(torch.isfinite(g), g,
                                             torch.full_like(g, math.inf))
                                 .max()))
        wrong += int((torch.as_tensor(lens).to(torch.int64) != t).sum())
    return dict(returns=worst, lengths=wrong)


def compare(ctx, st, res):
    records = st.rec.sampled()
    evals = st.evals
    st.tenv = st.policy = st.act = None
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref_env = program.reference_env(ctx, st.env.id)
    params = ref_mlp.load(program.policy_path(ctx.config), torch.float64,
                          ctx.device)
    numbers = check.stepped(ref_env, records, ctx.control)
    numbers["mean"] = check.mean_gap(
        None if ctx.control else torch.cat([r["act"] for r in records]),
        torch.cat([r["obs"] for r in records]), params, clip=True,
        control=ctx.control)
    numbers.update(episode_numbers(evals, ctx.traffic["horizon"],
                                   ctx.control))
    if not ctx.control:
        numbers["reset"] = check.fresh_violations(ref_env, st.starts)
    return numbers
