"""Actor-critic MLP matching SB3's PPO `MlpPolicy` defaults.

Counterpart of `balance_robot_tpu/models/mlp.py`: separate pi / vf tanh
trunks (64-64 by default), a diagonal Gaussian with a state-independent
learned log_std, orthogonal init with gains sqrt(2) (hidden), 0.01 (action
head) and 1.0 (value head).

The JAX package keeps params as a flat dict of numpy-compatible arrays with
weights of shape (in, out) (`obs @ W`); `nn.Linear` stores (out, in), so
`from_numpy_params` / `to_numpy_params` transpose. Every PPO
`models/*/best_model.npz` loads through them unchanged.
"""

import math

import numpy as np
import torch
from torch import nn

_TRUNK = (("w1", "l1"), ("w2", "l2"), ("wout", "out"))


class ActorCritic(nn.Module):
    def __init__(self, obs_dim=6, act_dim=2, hidden=64, vf_obs_dim=None,
                 generator=None, device=None, dtype=torch.float32):
        """vf_obs_dim > obs_dim makes an asymmetric (privileged) critic whose
        value trunk reads extra features after the obs."""
        super().__init__()
        vf_obs_dim = obs_dim if vf_obs_dim is None else vf_obs_dim
        kw = dict(device=device, dtype=dtype)
        self.pi_l1 = nn.Linear(obs_dim, hidden, **kw)
        self.pi_l2 = nn.Linear(hidden, hidden, **kw)
        self.pi_out = nn.Linear(hidden, act_dim, **kw)
        self.vf_l1 = nn.Linear(vf_obs_dim, hidden, **kw)
        self.vf_l2 = nn.Linear(hidden, hidden, **kw)
        self.vf_out = nn.Linear(hidden, 1, **kw)
        self.log_std = nn.Parameter(torch.zeros(act_dim, **kw))
        gains = {"pi_l1": math.sqrt(2), "pi_l2": math.sqrt(2), "pi_out": 0.01,
                 "vf_l1": math.sqrt(2), "vf_l2": math.sqrt(2), "vf_out": 1.0}
        with torch.no_grad():
            for name, gain in gains.items():
                layer = getattr(self, name)
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                layer.bias.zero_()

    def policy_mean(self, obs):
        h = torch.tanh(self.pi_l1(obs))
        h = torch.tanh(self.pi_l2(h))
        return self.pi_out(h)

    def value(self, obs):
        h = torch.tanh(self.vf_l1(obs))
        h = torch.tanh(self.vf_l2(h))
        return self.vf_out(h)[..., 0]

    def forward(self, obs):
        """(mean, log_std, value), the export graph's output triple."""
        return self.policy_mean(obs), self.log_std, self.value(obs)

    def log_prob(self, mean, actions):
        return log_prob(mean, self.log_std, actions)

    def sample(self, mean, generator=None):
        return sample(mean, self.log_std, generator)

    def deployable_params(self, obs_dim=None):
        """Numpy params with a privileged critic sliced back to the actor's
        obs width; the action outputs are untouched."""
        params = to_numpy_params(self)
        obs_dim = params["pi_w1"].shape[0] if obs_dim is None else obs_dim
        if params["vf_w1"].shape[0] > obs_dim:
            params["vf_w1"] = params["vf_w1"][:obs_dim]
        return params


def log_prob(mean, log_std, actions):
    z = (actions - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def sample(mean, log_std, generator=None):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise


def from_numpy_params(d, device=None, dtype=torch.float32):
    """ActorCritic from the JAX package's params dict (pi_w1 ... log_std),
    with its widths read from the arrays."""
    obs_dim, hidden = np.shape(d["pi_w1"])
    net = ActorCritic(obs_dim=obs_dim, act_dim=np.shape(d["pi_wout"])[1],
                      hidden=hidden, vf_obs_dim=np.shape(d["vf_w1"])[0],
                      device=device, dtype=dtype)
    with torch.no_grad():
        for prefix in ("pi", "vf"):
            for key, name in _TRUNK:
                layer = getattr(net, f"{prefix}_{name}")
                layer.weight.copy_(torch.as_tensor(
                    np.asarray(d[f"{prefix}_{key}"]).T))
                layer.bias.copy_(torch.as_tensor(
                    np.asarray(d[f"{prefix}_{key.replace('w', 'b', 1)}"])))
        net.log_std.copy_(torch.as_tensor(np.asarray(d["log_std"])))
    return net


def to_numpy_params(net):
    """The JAX package's params dict (numpy, (in, out) weights) of `net`."""
    out = {}
    for prefix in ("pi", "vf"):
        for key, name in _TRUNK:
            layer = getattr(net, f"{prefix}_{name}")
            out[f"{prefix}_{key}"] = layer.weight.detach().cpu().numpy().T
            out[f"{prefix}_{key.replace('w', 'b', 1)}"] = \
                layer.bias.detach().cpu().numpy()
    out["log_std"] = net.log_std.detach().cpu().numpy()
    return out
