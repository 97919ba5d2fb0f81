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
        return deployable_params(to_numpy_params(self), obs_dim)


def log_prob(mean, log_std, actions):
    z = (actions - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def entropy(log_std):
    """Entropy of the diagonal Gaussian: a function of log_std alone."""
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum()


def sample(mean, log_std, generator=None):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise


# ---------------------------------------- warm starts on the numpy params dict

def _pad_rows(params, key, n_rows):
    w = np.asarray(params[key])
    if w.shape[0] >= n_rows:
        return params
    pad = np.zeros((n_rows - w.shape[0], w.shape[1]), w.dtype)
    return {**params, key: np.concatenate([w, pad], 0)}


def pad_privileged_critic(params, vf_obs_dim):
    """Widen a symmetric critic to vf_obs_dim input rows with zero weights
    on the new (privileged) rows: the padded value is exactly the original
    wherever it is evaluated, and gradient reaches the new rows from the
    first update."""
    return _pad_rows(params, "vf_w1", vf_obs_dim)


def pad_privileged_actor(params, pi_obs_dim):
    """Widen a 6-obs actor to pi_obs_dim input rows with zero weights on the
    new rows: the warm start of a privileged-obs teacher
    (envs/privileged.py)."""
    return _pad_rows(params, "pi_w1", pi_obs_dim)


def net2net_widen(params, rng, obs_dim=None, hidden=256, vf_obs_dim=None,
                  init_scale=1e-2):
    """Function-preserving widening (Net2Net) of a trained params dict into
    a wider, optionally wider-input net with exactly the same outputs:
    existing weights are copied block-wise, new input rows are zero, and
    new hidden units get small random incoming weights (from the numpy
    Generator `rng`) and zero outgoing weights, so every new unit receives
    gradient from the first update."""
    obs_dim = obs_dim or np.shape(params["pi_w1"])[0]
    vf_obs_dim = vf_obs_dim or max(obs_dim, np.shape(params["vf_w1"])[0])

    def widen_trunk(prefix, in_new):
        w1, b1 = (np.asarray(params[f"{prefix}_{k}"]) for k in ("w1", "b1"))
        w2, b2 = (np.asarray(params[f"{prefix}_{k}"]) for k in ("w2", "b2"))
        wo = np.asarray(params[f"{prefix}_wout"])
        in_old, h_old = w1.shape
        if in_new < in_old or hidden < h_old:
            raise ValueError(f"{prefix}: cannot narrow ({in_old}, {h_old}) "
                             f"to ({in_new}, {hidden})")
        W1 = init_scale * rng.standard_normal((in_new, hidden))
        W1[:, :h_old] = 0.0
        W1[:in_old, :h_old] = w1
        W2 = init_scale * rng.standard_normal((hidden, hidden))
        # new h1 units must not reach the old h2 units (exactness)
        W2[:, :h_old] = 0.0
        W2[:h_old, :h_old] = w2
        B1, B2 = np.zeros(hidden), np.zeros(hidden)
        B1[:h_old], B2[:h_old] = b1, b2
        WO = np.zeros((hidden, wo.shape[1]))
        WO[:h_old] = wo
        dt = w1.dtype
        return {f"{prefix}_w1": W1.astype(dt), f"{prefix}_b1": B1.astype(dt),
                f"{prefix}_w2": W2.astype(dt), f"{prefix}_b2": B2.astype(dt),
                f"{prefix}_wout": WO.astype(dt),
                f"{prefix}_bout": params[f"{prefix}_bout"]}

    out = dict(params)
    out.update(widen_trunk("pi", obs_dim))
    out.update(widen_trunk("vf", vf_obs_dim))
    return out


def deployable_params(params, obs_dim=None):
    """A params dict with a privileged critic sliced back to `obs_dim` input
    rows (default: the actor's width); no-op for a symmetric critic."""
    obs_dim = np.shape(params["pi_w1"])[0] if obs_dim is None else obs_dim
    if np.shape(params["vf_w1"])[0] <= obs_dim:
        return params
    return {**params, "vf_w1": np.asarray(params["vf_w1"])[:obs_dim]}


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
    """The JAX package's params dict (numpy, (in, out) weights) of `net`: a
    copy, which later updates of the net leave as it is."""
    def array(p):
        return p.detach().cpu().numpy().copy()

    out = {}
    for prefix in ("pi", "vf"):
        for key, name in _TRUNK:
            layer = getattr(net, f"{prefix}_{name}")
            out[f"{prefix}_{key}"] = array(layer.weight.T)
            out[f"{prefix}_{key.replace('w', 'b', 1)}"] = array(layer.bias)
    out["log_std"] = array(net.log_std)
    return out
