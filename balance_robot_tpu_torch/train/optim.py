"""The trainer's optimizer chain: global-norm clip, then Adam or RMSprop.

Counterpart of `optax.chain(clip_by_global_norm(max_norm), adam | rmsprop)`
in `balance_robot_tpu/train/ppo.py`, with optax 0.2.6's update rules:

  * the clip scales every gradient by max_norm / norm only where norm >=
    max_norm, and leaves it as it is below
    (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 always). The
    decision stays on the device: no host sync per minibatch;
  * Adam (eps 1e-5, eps_root 0) is `torch.optim.Adam`: the same formula;
  * RMSprop (SB3's A2C: decay 0.99, eps 1e-5) puts eps inside the square
    root and starts the second moment at 0, as `optax.rmsprop` does
    (`torch.optim.RMSprop` adds eps outside), so it is written here.

`state_arrays` / `load_state_arrays` carry an optimizer's state by
parameter name, for the resume file (`checkpoint.save_train_state`).
"""

import numpy as np
import torch


def clip_grad_global_norm_(params, max_norm):
    """Clip the gradients of `params` in place by their global norm, as
    optax.clip_by_global_norm. Returns the norm (a 0-dim tensor)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # below the bound the scale is exactly 1: the gradients stay as they are
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))
    return norm


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps): nu <- (1 - decay) g^2 + decay nu,
    p <- p - lr * g / sqrt(nu + eps); nu starts at 0."""

    def __init__(self, params, lr, decay=0.99, eps=1e-5):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1 - group["decay"]) * p.grad.square()
                         + group["decay"] * nu)
                p.add_(torch.rsqrt(nu + group["eps"]) * p.grad,
                       alpha=-group["lr"])


def make(config, params):
    """The inner optimizer of `config` (a PPOConfig) over `params`."""
    if config.optimizer == "rmsprop":
        return RMSprop(params, config.lr, decay=0.99, eps=1e-5)
    if config.optimizer != "adam":
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return torch.optim.Adam(params, lr=config.lr, eps=config.adam_eps)


def state_arrays(opt, net):
    """{"opt/<parameter name>/<state key>": numpy array} of `opt`'s state
    for the parameters of `net`."""
    out = {}
    for name, p in net.named_parameters():
        for key, value in opt.state.get(p, {}).items():
            out[f"opt/{name}/{key}"] = (
                value.detach().cpu().numpy() if torch.is_tensor(value)
                else np.asarray(value))
    return out


def load_state_arrays(opt, net, arrays):
    """Restore the state that `state_arrays` wrote (the entries of `arrays`
    under "opt/") for the parameters of `net` that `opt` steps, each value
    on its parameter's device and in its dtype as
    `Optimizer.load_state_dict` puts it. Raises ValueError when a name or a
    shape does not match `net`."""
    params = dict(net.named_parameters())
    index = {id(p): i for i, p in enumerate(
        p for group in opt.param_groups for p in group["params"])}
    state = {}
    for key, value in arrays.items():
        if not key.startswith("opt/"):
            continue
        name, slot = key[4:].rsplit("/", 1)
        p = params.get(name)
        if p is None or (value.ndim and value.shape != tuple(p.shape)):
            raise ValueError(f"optimizer state {key} {value.shape} does not "
                             "fit the net")
        if id(p) in index:      # another optimizer's parameter otherwise
            state.setdefault(index[id(p)], {})[slot] = torch.from_numpy(
                np.array(value))
    sd = opt.state_dict()
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
