"""The interactive test loop at B = 1: `cli._run_episodes` with the
policy's act fn `cli._policy_act`, as `cli test` runs it, episodes back to
back.

The loop calls its act fn once per control step, right after
`obs[0].cpu()` has synchronised; the harness hands it an act fn that reads
the host clock at each call and then calls the port's. A step is the
interval between two consecutive calls, so the loop is timed as it is, with
no edit to it. The window ends at the first call after `--seconds`: that
call raises `Closed`, which ends the loop there. Its episode lines go to a
buffer.

Traffic: grade (the registered, exact grade of `cli test`), warmup_steps,
sampled_steps, traced_from / traced_steps.
"""

import contextlib
import io
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import check, program, window as win
from ..recording import Recorder, TrafficEnv
from ..reference import envs as ref_envs, mlp as ref_mlp


class Closed(Exception):
    """Raised by the act fn to end the loop at a step boundary."""


def setup(ctx):
    from balance_robot_tpu_torch import cli
    tr, dev = ctx.traffic, ctx.device
    env = program.make_env(ctx, program.derive(ctx.seed, 1))
    act_fn = cli._policy_act(program.load_params(ctx.config), env)
    rec = Recorder(tr["sampled_steps"], program.derive(ctx.seed, 2))
    tenv = TrafficEnv(env, program.generator(program.derive(ctx.seed, 3), dev),
                      ref_envs.load(env.id).n_uniforms, rec)
    st = SimpleNamespace(env=env, tenv=tenv, rec=rec, cli=cli, stamps=[],
                         limit=None, deadline=None, span=None, traced=None,
                         out=io.StringIO())

    def act(obs):
        now = time.perf_counter()
        n = len(st.stamps)
        if st.deadline is not None and now >= st.deadline:
            st.stamps.append(now)
            raise Closed
        if st.limit is not None and n >= st.limit:
            raise Closed
        st.stamps.append(now)
        if st.span is not None:
            if n == st.traced[0]:
                st.span.start()
            elif n == st.traced[1]:
                st.span.stop()
        rec.begin()
        a = act_fn(obs)
        rec.put(obs=obs, act=a)
        return a

    st.act = act
    rec.on = False
    st.limit = tr["warmup_steps"]
    loop(st)
    st.stamps, st.limit = [], None
    rec.on = True
    return st


def loop(st):
    with contextlib.redirect_stdout(st.out):
        try:
            st.cli._run_episodes(st.tenv, st.act, 10 ** 9,
                                 st.env.max_episode_steps)
        except Closed:
            pass


def window(ctx, st):
    tr = ctx.traffic
    if ctx.trace:
        from ..tracing import TracedSpan
        st.span = TracedSpan()
        st.traced = (tr["traced_from"], tr["traced_from"] + tr["traced_steps"])
    program.sync(ctx.device)
    st.starts = st.tenv.starts = []
    st.deadline = time.perf_counter() + ctx.seconds
    loop(st)
    steps = win.intervals_between(st.stamps)
    return dict(e2e=dict(step_ms_p95=1e3 * win.percentile(steps, 95)),
                attempted=len(steps), failed=0,
                seconds=st.stamps[-1] - st.stamps[0], steps=len(steps),
                env_steps=len(steps), step_s=steps,
                traced_steps=tr["traced_steps"] if ctx.trace else None,
                trace=st.span.read() if st.span is not None else None)


def compare(ctx, st, res):
    records = st.rec.sampled()
    st.tenv = st.act = None
    ref_env = program.reference_env(ctx, st.env.id)
    params = ref_mlp.load(program.policy_path(ctx.config), torch.float64,
                          ctx.device)
    numbers = check.stepped(ref_env, records, ctx.control)
    numbers["mean"] = check.mean_gap(
        None if ctx.control else torch.as_tensor(
            np.stack([r["act"] for r in records])),
        torch.as_tensor(np.stack([r["obs"] for r in records])), params,
        clip=False, control=ctx.control)
    if not ctx.control:
        numbers["reset"] = check.fresh_violations(ref_env, st.starts)
    return numbers
