"""The 64-64 actor-critic of SB3's PPO `MlpPolicy`, written out plainly.

Parameters are a dict of tensors in the checkpoints' layout (weights
(in, out), `obs @ W`): pi_w1, pi_b1, pi_w2, pi_b2, pi_wout, pi_bout, the same
for vf_, and log_std. The policy's tanh trunk gives the mean that the
benchmark holds the port's to.
"""

import numpy as np
import torch


def load(path, dtype, device):
    """The parameters of a checkpoint file (.npz), in `dtype` on `device`."""
    with np.load(path) as f:
        return {k: torch.as_tensor(f[k]).to(device, dtype) for k in f.files}


def _trunk(p, prefix, x):
    h = torch.tanh(x @ p[f"{prefix}_w1"] + p[f"{prefix}_b1"])
    h = torch.tanh(h @ p[f"{prefix}_w2"] + p[f"{prefix}_b2"])
    return h @ p[f"{prefix}_wout"] + p[f"{prefix}_bout"]


def policy_mean(p, obs):
    return _trunk(p, "pi", obs)
