"""Checkpoints: params as a flat npz, the JAX package's layout.

Counterpart of `balance_robot_tpu/train/checkpoint.py` (`save` / `load`).
Flat dicts of arrays save as they are; nested dicts and lists (the
off-policy nets' lists of layer dicts) flatten to path-joined keys
('actor/0/w'). `models.mlp.from_numpy_params` turns a loaded PPO dict into
the port's ActorCritic.
"""

import pathlib

import numpy as np
import torch


def _flatten(tree, prefix, out):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            _flatten(v, name, out)
        elif torch.is_tensor(v):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def _npz_path(path):
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save(path, params):
    path = pathlib.Path(_npz_path(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(params, "", {}))


def load(path):
    """A dict of numpy arrays; nested saves come back with path-joined
    keys."""
    with np.load(_npz_path(path)) as f:
        return {k: f[k] for k in f.files}
