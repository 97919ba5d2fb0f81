"""Data collection: B envs stepped by the policy, as the trainer's rollout
and the JAX package's headline benchmark step them.

Each step: the policy's mean and a Gaussian sample (`mlp.ActorCritic`),
then `VecEnv.step` with auto-reset on the sample clipped to [-1, 1]. No
host sync inside the window but at its end: the window ends at the first
step after `--seconds`, once the card has finished every step enqueued.

Traffic (workloads/<cell>.json): n_envs, warmup_steps, sampled_steps (the
steps held to the reference), traced_from / traced_steps (the profiled span
of a `--trace 1` run).
"""

import time
from types import SimpleNamespace

import torch

from .. import check, program, window as win
from ..recording import Recorder, TrafficEnv
from ..reference import envs as ref_envs, mlp as ref_mlp


def setup(ctx):
    from balance_robot_tpu_torch.envs.vector import VecEnv
    from balance_robot_tpu_torch.models import mlp
    tr, dev = ctx.traffic, ctx.device
    env = program.make_env(ctx, program.derive(ctx.seed, 1))
    rec = Recorder(tr["sampled_steps"], program.derive(ctx.seed, 2))
    tenv = TrafficEnv(env, program.generator(program.derive(ctx.seed, 3),
                                             dev),
                      ref_envs.load(env.id).n_uniforms, rec)
    vec = VecEnv(tenv, tr["n_envs"])
    net = mlp.from_numpy_params(program.load_params(ctx.config), device=dev,
                                dtype=env.dtype)
    st = SimpleNamespace(env=env, rec=rec, vec=vec, net=net,
                         noise=program.generator(program.derive(ctx.seed, 4),
                                                 dev))
    with torch.no_grad():
        st.states, st.obs = vec.reset()
        rec.on = False
        for _ in range(tr["warmup_steps"]):
            step(st)
        rec.on = True
    return st


def step(st):
    st.rec.begin()
    mean = st.net.policy_mean(st.obs)
    actions = st.net.sample(mean, st.noise)
    st.rec.put(obs=st.obs, mean=mean)
    st.states, out = st.vec.step(st.states, actions.clamp(-1.0, 1.0))
    st.rec.put(vec_state=st.states, vec_out=out)
    st.obs = out.obs


def window(ctx, st):
    tr = ctx.traffic
    span = None
    if ctx.trace:
        from ..tracing import TracedSpan
        span = TracedSpan()
        first, last = tr["traced_from"], tr["traced_from"] + tr["traced_steps"]
    n = 0
    with torch.no_grad():
        program.sync(ctx.device)
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while True:
            if span is not None and n == first:
                span.start()
            step(st)
            n += 1
            if span is not None and n == last:
                span.stop()
            if time.perf_counter() >= deadline and (span is None
                                                    or n >= last):
                break
        program.sync(ctx.device)
        seconds = time.perf_counter() - t0
    B = tr["n_envs"]
    return dict(e2e=dict(env_steps_per_s=win.rate(B * n, seconds)),
                attempted=B * n,
                failed=0, seconds=seconds, steps=n, env_steps=B * n,
                traced_steps=tr["traced_steps"] if ctx.trace else None,
                trace=span.read() if span is not None else None)


def compare(ctx, st, res):
    records = st.rec.sampled()
    st.vec = st.net = st.states = st.obs = None
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    ref_env = program.reference_env(ctx, st.env.id)
    params = ref_mlp.load(program.policy_path(ctx.config), torch.float64,
                          ctx.device)
    numbers = check.stepped(ref_env, records, ctx.control)
    numbers["mean"] = check.mean_gap(
        None if ctx.control else torch.cat([r["mean"] for r in records]),
        torch.cat([r["obs"] for r in records]), params, clip=False,
        control=ctx.control)
    if not ctx.control:
        numbers["reset"] = check.reset_violations(ref_env, records)
    return numbers
