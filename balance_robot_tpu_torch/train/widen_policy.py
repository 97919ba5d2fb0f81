"""A function-preserving wide (and optionally privileged-input) copy of a
trained checkpoint: the warm start of a wide teacher's PPO run.

Counterpart of `tools/widen_policy.py`, with its options, defaults, check
and output line. `mlp.net2net_widen` widens both trunks to `--hidden`
units and, with `--priv`, the inputs to [obs, privileged] of `--env`:
new input rows are zero, new hidden units get small random incoming
weights (a numpy generator seeded with `--seed`) and zero outgoing ones.
The copy is checked on 64 standard normal inputs (a torch generator seeded
with 1) on the chosen device, in float64: its policy mean within 1e-5 and
its value within 1e-4 of the original's on the original's input columns.
Then it is written with `checkpoint.save` to `--out`.

The draws are not the JAX tool's (`jax.random` streams cannot be replayed
here), so the new units' weights differ from a JAX run's; the function the
copy computes is the same.

`--device cuda|cpu` is the port's own option (the JAX tool forces the
CPU): left at its default it is the card, and it raises where there is no
GPU.

Run:  python -m balance_robot_tpu_torch.train.widen_policy \\
          models/Env03-v2_PPO/best_model.npz --env Env03-v2 --priv \\
          --hidden 256 --out models/x/wide_init.npz
"""

import argparse
import pathlib

import numpy as np
import torch

import balance_robot_tpu_torch as brt
from ..device import resolve_device
from ..models import mlp
from . import checkpoint as ckpt


def build_parser():
    """Every option and default of `tools/widen_policy.py`, and
    `--device`."""
    ap = argparse.ArgumentParser(
        prog="python -m balance_robot_tpu_torch.train.widen_policy",
        description="A function-preserving wide copy of a checkpoint.")
    ap.add_argument("model")
    ap.add_argument("--env", default="Env03-v2")
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--priv", action="store_true",
                    help="widen the input to [obs, privileged] too")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the check runs (default: the GPU; raises "
                         "without one)")
    return ap


def check_exact(wide, params, x):
    """Raise unless `wide` computes `params`' policy mean (within 1e-5)
    and value (within 1e-4) on the inputs `x` (N, wide input width), read
    by the original on its own input columns. Both nets run in float64:
    the check holds the construction, not the order in which float32
    products of 64 and 256 terms are summed (values reach ~1200, where one
    float32 ulp is 1.2e-4)."""
    new, old = (mlp.from_numpy_params(p, device=x.device,
                                      dtype=torch.float64)
                for p in (wide, params))
    x = x.double()
    with torch.no_grad():
        np.testing.assert_allclose(
            new.policy_mean(x).cpu().numpy(),
            old.policy_mean(x[:, :np.shape(params["pi_w1"])[0]])
            .cpu().numpy(), atol=1e-5)
        np.testing.assert_allclose(
            new.value(x).cpu().numpy(),
            old.value(x[:, :np.shape(params["vf_w1"])[0]]).cpu().numpy(),
            atol=1e-4)


def run(args):
    """Widen, check and write for parsed `args`; returns the wide params."""
    device = resolve_device(args.device)
    env = brt.env_class(args.env)
    in_dim = env.obs_dim + (env.priv_dim if args.priv else 0)
    params = ckpt.load(args.model)
    wide = mlp.net2net_widen(params, np.random.default_rng(args.seed),
                             obs_dim=in_dim, hidden=args.hidden,
                             vf_obs_dim=in_dim)
    gen = torch.Generator(device=device).manual_seed(1)
    check_exact(wide, params, torch.randn((64, in_dim), generator=gen,
                                          device=device))
    old_in = params["pi_w1"].shape[0]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    ckpt.save(out.with_suffix(""), wide)
    print(f"exact wide copy: in {old_in}->{in_dim}, hidden "
          f"{params['pi_w1'].shape[1]}->{args.hidden} -> {out}")
    return wide


def main(argv=None):
    """Parse `argv` (default: sys.argv[1:]) and widen."""
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
