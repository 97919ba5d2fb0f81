"""Checkpoints: params as a flat npz in the JAX package's layout, and the
trainer's resume state.

Counterpart of `balance_robot_tpu/train/checkpoint.py`. Flat dicts of
arrays save as they are; nested dicts and lists (the off-policy nets'
lists of layer dicts) flatten to path-joined keys ('actor/0/w'), and named
tuples by field name. `models.mlp.from_numpy_params` turns a loaded PPO
dict into the port's ActorCritic, so `best_model`, `longest_model`,
`final_model` and `cp_*` files load in either package.

The resume file (`save_train_state`) is the port's own layout: the net's
state dict, the optimizer's state by parameter name, the env states, the
last obs, the episode statistics, both generators' states and
`__steps__`. It cannot read the JAX package's `resume_state.npz`, nor the
JAX package this one: torch's generators and `jax.random` keys are
different streams, so neither could continue the other's run exactly.
"""

import pathlib

import numpy as np
import torch

from . import optim


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    return enumerate(tree)


def flatten(tree, prefix, out):
    """Add the leaves of `tree` to `out` as numpy arrays under their
    path-joined keys (below `prefix`); returns `out`."""
    items = _items(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flatten(v, name, out)
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
    np.savez(path, **flatten(params, "", {}))


def load(path):
    """A dict of numpy arrays; nested saves come back with path-joined
    keys."""
    with np.load(_npz_path(path)) as f:
        return {k: f[k] for k in f.files}


def _restore(like, flat, prefix):
    """`like`'s tree with each leaf taken from flat[path], on the leaf's
    device and in its dtype (tensors) or as numpy arrays."""
    if isinstance(like, (dict, list, tuple)):
        leaves = {k: _restore(v, flat, f"{prefix}/{k}" if prefix else str(k))
                  for k, v in _items(like)}
        if isinstance(like, dict):
            return leaves
        if hasattr(like, "_fields"):
            return type(like)(**leaves)
        return type(like)(leaves.values())
    value = flat[prefix]
    if torch.is_tensor(like):
        return torch.as_tensor(value).to(like.device, like.dtype)
    return value


def load_into(path, tree_like):
    """Restore a nested tree saved by `save`, using `tree_like` (a tree of
    the same structure, e.g. freshly initialized params) for structure."""
    return _restore(tree_like, load(path), "")


def _train_tree(ts):
    """The arrays of a TrainState that the resume file holds, but the
    optimizer's (by parameter name, `optim.state_arrays`)."""
    return {"net": ts.net.state_dict(), "env_states": ts.env_states,
            "last_obs": ts.last_obs, "ep_ret": ts.ep_ret, "ep_len": ts.ep_len,
            "stat_sum_ret": ts.stat_sum_ret, "stat_n_eps": ts.stat_n_eps,
            "gen": ts.gen.get_state(), "env_gen": ts.env_gen.get_state()}


def save_train_state(path, ts, steps=0):
    """The whole resume state of a `train.ppo.TrainState` and the global
    step count, as one npz (see the module docstring)."""
    path = pathlib.Path(_npz_path(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = flatten(_train_tree(ts), "", {})
    arrays.update(optim.state_arrays(ts.opt, ts.net))
    np.savez(path, __steps__=np.int64(steps),
             __optimizer__=np.str_(type(ts.opt).__name__), **arrays)


def load_train_state(path, ts_like):
    """Restore a state saved by `save_train_state` into `ts_like`, a
    TrainState that `PPO.init` built with the same config; its net,
    optimizer and generators take the saved values in place. Returns (ts,
    steps). Raises ValueError when the file does not fit `ts_like`."""
    path = _npz_path(path)
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files}
    steps = int(saved.pop("__steps__", 0))
    kind = str(saved.pop("__optimizer__", ""))
    like = flatten(_train_tree(ts_like), "", {})
    mine = {k: v for k, v in saved.items() if not k.startswith("opt/")}
    bad = sorted(set(like) ^ set(mine)) or [
        k for k in like if like[k].shape != mine[k].shape]
    if bad or kind != type(ts_like.opt).__name__:
        raise ValueError(
            f"resume state at {path} does not fit this trainer (optimizer "
            f"{kind} against {type(ts_like.opt).__name__}; arrays "
            f"{bad[:4]}) — configs must match")
    tree = _restore(_train_tree(ts_like), saved, "")
    ts_like.net.load_state_dict(tree["net"])
    optim.load_state_arrays(ts_like.opt, ts_like.net, saved)
    ts_like.gen.set_state(tree["gen"].cpu())
    ts_like.env_gen.set_state(tree["env_gen"].cpu())
    return ts_like._replace(
        env_states=tree["env_states"], last_obs=tree["last_obs"],
        ep_ret=tree["ep_ret"], ep_len=tree["ep_len"],
        stat_sum_ret=tree["stat_sum_ret"],
        stat_n_eps=tree["stat_n_eps"]), steps
