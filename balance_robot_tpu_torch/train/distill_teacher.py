"""DAgger distillation: a privileged-obs teacher into a 6-obs student.

Counterpart of `tools/distill_teacher.py`, with its options, defaults,
output lines and artifacts. The teacher (a checkpoint trained with
`train/train_run.py --privileged-actor`, or any 6-obs policy) sees the
block (`envs/privileged.py`); the student keeps the robot's 6-obs
interface (`--student-priv`: it also sees [obs, privileged], the clone
that warm-starts a wide privileged PPO run). Each iteration:

  * `collect`: `--collect-steps` steps of `--envs` envs (a `VecEnv` at the
    training-grade solver; CUDA tensors launch the scene's kernel). At
    each step the driver is the teacher with probability beta (one draw
    per env) and the student otherwise, both by their clipped means, plus
    `--noise` x a standard normal, clipped to [-1, 1]; every visited
    state is labelled with the teacher's clipped mean and its value. beta
    is 1 for the first `--beta0` iterations and 0 after them;
  * the held-out gap: the student's clipped mean against the fresh labels,
    before it trains on them;
  * `insert`: the rows go into a rolling buffer of `--cap` rows on the
    device, at (n + arange(rows)) % cap;
  * `update`: max(1, epochs x rows // mb) Adam steps (optax's defaults: b1
    0.9, b2 0.999, eps 1e-8, no clipping, lr `--lr`) on minibatches of
    `--mb` rows drawn uniformly from the rows written so far; the loss is
    the MSE of the student's mean against the labels, plus `--vf-coef` x
    the MSE of its value against the teacher's. A parameter that the loss
    does not reach takes a zero gradient and steps, as optax's does.

Every `--eval-every` iterations and after the last, a paired eval of
`--eval-episodes` episodes of the student's view (`selection.paired_eval`
at `--seed`: the same episodes every time) scores the student by its
full-horizon share, then its mean return; a better score saves
`best_model.npz`. `final_model.npz` is the last student. A fresh student
(no `--init`, `--student-hidden` units) inherits the teacher's log_std.

`--device cuda|cpu` takes the place of the JAX tool's `--platform`: left
at its default it is the card, and it raises where there is no GPU. The
tool's use of its Pallas kernel on a TPU alone has no counterpart: CUDA
tensors launch the kernel, CPU tensors take its plain PyTorch version.

Run:  python -m balance_robot_tpu_torch.train.distill_teacher \\
          --teacher models/Env03-v2_teacher/best_model.npz \\
          --init models/Env03-v2_PPO/best_model.npz \\
          --out models/Env03-v2_dagger_r4
"""

import argparse
import pathlib
import time

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..envs.privileged import PrivilegedObsEnv
from ..envs.vector import VecEnv
from ..models import mlp
from . import checkpoint as ckpt
from . import selection
from .ppo import deterministic_action


def build_parser():
    """Every option and default of `tools/distill_teacher.py`, with
    `--device` in place of `--platform`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.distill_teacher",
        description="DAgger distillation: privileged-obs teacher -> "
                    "deployment 6-obs student.")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--teacher", required=True,
                    help="label source: a 6-obs policy OR a privileged-"
                         "actor (obs+priv input) checkpoint of any hidden "
                         "width")
    ap.add_argument("--init", default=None,
                    help="student init checkpoint; omit with "
                         "--student-hidden to distill into a freshly "
                         "initialized net")
    ap.add_argument("--student-hidden", type=int, default=None,
                    help="fresh student hidden width (with --init absent)")
    ap.add_argument("--student-priv", action="store_true",
                    help="the STUDENT also sees [obs, privileged]: the "
                         "clone of the incumbent into a wide privileged "
                         "net, the warm start for teacher-v2 PPO")
    ap.add_argument("--out", required=True)
    ap.add_argument("--vf-coef", type=float, default=0.0,
                    help="also clone the teacher's VALUE head (weight of "
                         "the value-MSE term); a clone that warm-starts a "
                         "PPO run needs it")
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--collect-steps", type=int, default=64,
                    help="control steps per DAgger iteration per env")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--beta0", type=int, default=1,
                    help="the first N iterations drive with the TEACHER's "
                         "actions (the classic DAgger beta schedule); after "
                         "that the student drives its own distribution")
    ap.add_argument("--noise", type=float, default=0.05,
                    help="exploration noise on the DRIVING action (labels "
                         "stay deterministic)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=4,
                    help="update epochs per iteration (each epoch = one "
                         "pass worth of minibatches of the fresh rows)")
    ap.add_argument("--mb", type=int, default=4096)
    ap.add_argument("--cap", type=int, default=4_000_000,
                    help="aggregated-dataset capacity (rolling)")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--eval-episodes", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-wall", type=float, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the envs, the nets and the buffer live "
                         "(default: the GPU; raises without one)")
    return ap


def better(full, ret, best):
    """Whether an eval (full-horizon share, mean return) beats `best`: a
    higher share, or the same share and a higher return."""
    return full > best["full"] or (full == best["full"] and ret > best["ret"])


class DAgger:
    """The collect / insert / update steps of one distillation, on `env`
    (an env of the 6-obs interface with privileged features) and the
    teacher's numpy params, at B = `envs` and T = `collect_steps`."""

    def __init__(self, env, teacher, envs, collect_steps, noise=0.05,
                 student_priv=False, cap=4_000_000, vf_coef=0.0, epochs=4,
                 mb=4096):
        self.env, self.B, self.T = env, envs, collect_steps
        self.vec = VecEnv(env, envs)
        self.device, self.dtype = env.device, env.dtype
        self.obs_dim, self.act_dim = env.obs_dim, env.act_dim
        self.t_in = np.shape(teacher["pi_w1"])[0]
        if self.t_in not in (env.obs_dim, env.obs_dim + env.priv_dim):
            raise ValueError(f"teacher input width {self.t_in} matches "
                             "neither obs nor obs+priv")
        self.teacher = mlp.from_numpy_params(teacher, device=self.device,
                                             dtype=self.dtype)
        self.student_priv = student_priv
        self.s_in = env.obs_dim + (env.priv_dim if student_priv else 0)
        self.noise, self.cap, self.vf_coef = noise, cap, vf_coef
        self.epochs, self.mb = epochs, mb
        zeros = dict(dtype=self.dtype, device=self.device)
        self.buf_obs = torch.zeros((cap, self.s_in), **zeros)
        self.buf_act = torch.zeros((cap, self.act_dim), **zeros)
        self.buf_val = torch.zeros((cap,), **zeros)
        self.n = 0

    @torch.no_grad()
    def collect(self, student, states, obs, gen, beta, drive=None,
                noise=None):
        """T steps of every env from (states, obs) -> (states, obs, the
        student's inputs (T*B, s_in), the labels (T*B, act_dim), the
        teacher's values (T*B,)). `drive` (T, B, 1) bool and `noise` (T,
        B, act_dim) replace the draws from `gen` of the driver and of the
        exploration noise."""
        rows = []
        for t in range(self.T):
            obs = obs.to(self.dtype)
            aug = torch.cat((obs, self.env.privileged(states).to(self.dtype)),
                            -1)
            t_obs = aug if self.t_in > self.obs_dim else obs
            t_act = self.teacher.policy_mean(t_obs).clamp(-1.0, 1.0)
            s_obs = aug if self.student_priv else obs
            s_act = student.policy_mean(s_obs).clamp(-1.0, 1.0)
            d = (torch.rand((self.B, 1), generator=gen, device=self.device,
                            dtype=self.dtype) < beta
                 if drive is None else drive[t].to(self.device))
            z = (torch.randn(t_act.shape, generator=gen, device=self.device,
                             dtype=self.dtype)
                 if noise is None else noise[t].to(self.device, self.dtype))
            act = (torch.where(d, t_act, s_act) + self.noise * z).clamp(
                -1.0, 1.0)
            rows.append((s_obs, t_act, self.teacher.value(t_obs)))
            states, out = self.vec.step(states, act)
            obs = out.obs
        d_obs, d_act, d_val = (torch.cat(x) for x in zip(*rows))
        return states, obs.to(self.dtype), d_obs, d_act, d_val

    def insert(self, d_obs, d_act, d_val):
        """Write the rows into the rolling buffer; returns the rows held."""
        idx = (self.n + torch.arange(len(d_obs), device=self.device)) \
            % self.cap
        self.buf_obs[idx] = d_obs
        self.buf_act[idx] = d_act
        self.buf_val[idx] = d_val
        self.n = min(self.n + len(d_obs), self.cap)
        return self.n

    def n_minibatches(self):
        """The fixed minibatch count per update, sized by the fresh rows."""
        return max(1, self.epochs * self.T * self.B // self.mb)

    def loss(self, student, o, a, v):
        loss = ((student.policy_mean(o) - a) ** 2).mean()
        if self.vf_coef:
            loss = loss + self.vf_coef * ((student.value(o) - v) ** 2).mean()
        return loss

    def update(self, student, opt, gen, idx=None):
        """`n_minibatches()` Adam steps of `opt` on `student`; `idx` (n_mb,
        mb) replaces the draws from `gen` of the buffer rows. Returns the
        mean loss (a 0-dim tensor)."""
        params = list(student.parameters())
        losses = []
        for i in range(self.n_minibatches()):
            rows = (torch.randint(0, self.n, (self.mb,), generator=gen,
                                  device=self.device)
                    if idx is None else idx[i].to(self.device))
            loss = self.loss(student, self.buf_obs[rows], self.buf_act[rows],
                             self.buf_val[rows])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def gap(self, student, d_obs, d_act):
        """The student's clipped mean against the labels, MSE."""
        return ((student.policy_mean(d_obs).clamp(-1.0, 1.0) - d_act) ** 2
                ).mean()


def make_student(args, s_in, act_dim, teacher, device, dtype):
    """The student: `--init`, or a fresh net of `--student-hidden` units
    from seed + 7 with the teacher's log_std."""
    if args.init:
        params = ckpt.load(args.init)
        if params["pi_w1"].shape[0] != s_in:
            raise ValueError(f"student init width "
                             f"{params['pi_w1'].shape[0]} != {s_in}")
        return mlp.from_numpy_params(params, device=device, dtype=dtype)
    if not args.student_hidden:
        raise ValueError("--init or --student-hidden required")
    net = mlp.ActorCritic(s_in, act_dim, hidden=args.student_hidden,
                          vf_obs_dim=s_in,
                          generator=torch.Generator().manual_seed(
                              args.seed + 7), dtype=dtype).to(device)
    with torch.no_grad():
        net.log_std.copy_(torch.as_tensor(np.asarray(teacher["log_std"])))
    return net


def run(args):
    """The distillation for parsed `args`. Returns {"best": the best
    eval's dict(full, ret, it), "student": the final student net,
    "dagger": the DAgger object}."""
    device = resolve_device(args.device)
    env = brt.make(args.env, device=device, seed=args.seed + 1)
    env.use_fast_solver()
    max_steps = env.max_episode_steps
    teacher = ckpt.load(args.teacher)
    dag = DAgger(env, teacher, args.envs, args.collect_steps, args.noise,
                 args.student_priv, args.cap, args.vf_coef, args.epochs,
                 args.mb)
    student = make_student(args, dag.s_in, env.act_dim, teacher, device,
                           env.dtype)
    opt = torch.optim.Adam(student.parameters(), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the selection eval rolls the student's view of the env
    eval_env = PrivilegedObsEnv(env) if args.student_priv else env

    def big_eval(net):
        return selection.paired_eval(eval_env, deterministic_action, net,
                                     args.seed, args.eval_episodes,
                                     max_steps)[:3]

    def save(name):
        ckpt.save(out_dir / name, mlp.to_numpy_params(student))

    t0 = time.time()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    states, obs = dag.vec.reset()
    full0, ret0, len0 = big_eval(student)
    best = dict(full=full0, ret=ret0, it=-1)
    save("best_model")
    print(f"[dagger] init {args.init}: full={100 * full0:.1f}% "
          f"ret={ret0:.0f} len={len0:.0f}", flush=True)
    for it in range(args.iters):
        if args.max_wall and time.time() - t0 > args.max_wall:
            print("[dagger] wall budget reached", flush=True)
            break
        beta = 1.0 if it < args.beta0 else 0.0
        states, obs, d_obs, d_act, d_val = dag.collect(student, states, obs,
                                                       gen, beta)
        # the imitation gap on the fresh on-policy rows, before the student
        # trains on them
        gap = float(dag.gap(student, d_obs, d_act))
        n = dag.insert(d_obs, d_act, d_val)
        loss = dag.update(student, opt, gen)
        print(f"[dagger {it}] beta={beta:.0f} buffer={n} "
              f"heldout-gap={gap:.5f} train-loss={float(loss):.5f}",
              flush=True)
        if (it + 1) % args.eval_every == 0 or it == args.iters - 1:
            full, ret, lens = big_eval(student)
            mark = ""
            if better(full, ret, best):
                best = dict(full=full, ret=ret, it=it)
                save("best_model")
                mark = "  <-- new best"
            print(f"[dagger {it}] eval full={100 * full:.1f}% ret={ret:.0f} "
                  f"len={lens:.0f}{mark}", flush=True)
    save("final_model")
    print(f"[dagger] best: it={best['it']} full={100 * best['full']:.1f}% "
          f"ret={best['ret']:.0f} -> {out_dir}/best_model.npz", flush=True)
    return dict(best=best, student=student, dagger=dag)


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and distill."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
