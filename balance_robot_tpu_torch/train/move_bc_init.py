"""Fit the EnvMove05 deployment MLP to a scripted wheel-speed threshold
policy (the best THRESH member of `train/move_probe.py`): the BC warm start
of a PPO run toward the registered 900 reward.

Counterpart of `tools/move_bc_init.py`, with its options, defaults and
output lines. The policy reads only obs[0] = wheel_speed / 170 (obs[1] =
yaw / 45 maps to a1 = 0; the lidar slots are zero as built), so this is a
1-D fit of a0(ws) = a_lo + (a_hi - a_lo) sigmoid((mid - ws) / width), with
ws ~ U(-20, 60) and obs[1] ~ U(-1, 1), 4096 obs per step, `--steps` Adam
steps (lr 1e-3, optax's defaults). The loss is the squared relative error
(residual / (|target| + 0.01)): the reward's harvest term goes as 1 / a0,
so a0 needs ~1e-3 absolute precision near the small a_lo plateau. Only
the policy mean's layers step (the value net keeps its zero gradient).
Then `log_std` is stamped with `--log-std` (a PPO warm start samples with
std = exp(log_std); SB3's 0 would wash out the limit cycle), the file is
written with `checkpoint.save`, and the fit is printed along ws.

The fresh net is the port's (torch's orthogonal init from a generator
seeded with `--seed`; the draws from one seeded with `--seed` + 1), so its
weights differ from a JAX run's; the function it fits is the same.
`--device cuda|cpu` is the port's own option (the JAX tool forces the
CPU): left at its default it is the card, and it raises where there is no
GPU.

Run:  python -m balance_robot_tpu_torch.train.move_bc_init --mid 4.0 \\
          --width 0.1 --a-hi 1.0 --a-lo 0.001 \\
          --out models/EnvMove05-v1_bcinit/init.npz
"""

import argparse
import pathlib

import numpy as np
import torch

from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt

OBS_DIM = 10
N_OBS = 4096
WS_RANGE = (-20.0, 60.0)


def build_parser():
    """Every option and default of `tools/move_bc_init.py`, and
    `--device`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.move_bc_init",
        description="Fit the EnvMove05 MLP to a scripted THRESH policy.")
    ap.add_argument("--mid", type=float, required=True,
                    help="threshold [rad/s]")
    ap.add_argument("--width", type=float, required=True)
    ap.add_argument("--a-hi", type=float, required=True)
    ap.add_argument("--a-lo", type=float, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--log-std", type=float, default=-1.5)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the fit runs (default: the GPU; raises "
                         "without one)")
    return ap


def target_a0(ws, mid, width, a_hi, a_lo):
    """The scripted policy's a0 at wheel speed `ws` (a tensor)."""
    return a_lo + (a_hi - a_lo) * torch.sigmoid((mid - ws) / width)


def batch(ws, yaw, args):
    """(obs (n, 10), labels (n, 2)) for wheel speeds `ws` and obs[1]
    values `yaw`."""
    obs = torch.zeros((len(ws), OBS_DIM), dtype=ws.dtype, device=ws.device)
    obs[:, 0] = ws / 170.0
    obs[:, 1] = yaw
    lab = torch.stack((target_a0(ws, args.mid, args.width, args.a_hi,
                                 args.a_lo), torch.zeros_like(ws)), -1)
    return obs, lab


def loss_fn(net, obs, lab):
    """The mean squared relative error of the policy mean."""
    err = (net.policy_mean(obs) - lab) / (lab.abs() + 1e-2)
    return (err ** 2).mean()


def draws(gen, dtype):
    """One step's (ws, obs[1]) draws from `gen`."""
    u = torch.rand((2, N_OBS), generator=gen, device=gen.device, dtype=dtype)
    lo, hi = WS_RANGE
    return lo + (hi - lo) * u[0], 2.0 * u[1] - 1.0


def fit(net, args, gen, steps, given=None):
    """`steps` Adam steps of the policy mean's layers; `given` (a list of
    (ws, yaw) per step) replaces the draws. Prints the tool's fit lines;
    returns the last loss."""
    params = [p for name, p in net.named_parameters()
              if name.startswith("pi_")]
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    dtype = net.log_std.dtype
    for i in range(steps):
        ws, yaw = draws(gen, dtype) if given is None else given[i]
        loss = loss_fn(net, *batch(ws, yaw, args))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 500 == 0 or i == steps - 1:
            print(f"fit step {i}: mse={loss.item():.6f}", flush=True)
    return loss.detach()


def run(args):
    """The fit for parsed `args`; returns the saved numpy params."""
    device = resolve_device(args.device)
    net = mlp.ActorCritic(OBS_DIM, 2, generator=torch.Generator().manual_seed(
        args.seed)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    fit(net, args, gen, args.steps)
    params = mlp.to_numpy_params(net)
    params["log_std"] = np.full((2,), args.log_std, np.float32)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ckpt.save(out.with_suffix(""), params)
    # the fit along the 1-D section that matters
    ws = torch.linspace(-5, 45, 11, device=device)
    obs, lab = batch(ws, torch.zeros_like(ws), args)
    with torch.no_grad():
        pred = net.policy_mean(obs).cpu().numpy()
    for w, p, t in zip(ws.cpu().numpy(), pred, lab[:, 0].cpu().numpy()):
        print(f"  ws={w:6.1f}  a0 fit={p[0]:+.4f} target={t:+.4f}  "
              f"a1={p[1]:+.4f}")
    print(f"saved -> {out}")
    return params


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and fit."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
