"""Checkpoints: params as a flat npz in the JAX package's layout, and the
trainer's resume state.

Counterpart of `balance_robot_tpu/train/checkpoint.py`. Flat dicts of
arrays save as they are; nested dicts and lists (the off-policy nets'
lists of layer dicts) flatten to path-joined keys ('actor/0/w'), and named
tuples by field name. `models.mlp.from_numpy_params` turns a loaded PPO
dict into the port's ActorCritic, so `best_model`, `longest_model`,
`final_model` and `cp_*` files load in either package, and
`train.offpolicy.from_numpy_params` does the same for the nested tree.

The resume file (`save_train_state`) is the port's own layout: the net's
state dict, the optimizers' state by parameter name, the env states, the
last obs, both generators' states and `__steps__`; for PPO also the
episode statistics, for the off-policy trainers the buffer's rows written
so far, `ptr`, the env-step and update counts. `__optimizer__` names the
trainer's kind (PPO's optimizer class, or SAC / TD3 / DDPG and the
buffer's capacity). It cannot read the JAX package's `resume_state.npz`,
nor the JAX package this one: torch's generators and `jax.random` keys
are different streams, so neither could continue the other's run exactly.
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


def _off_policy(ts):
    return hasattr(ts, "buffer")


def _kind(ts):
    """The trainer's kind: PPO's optimizer class, or the off-policy
    algorithm and its buffer's capacity."""
    if _off_policy(ts):
        return f"{ts.net.algo} buffer {len(ts.buffer.rew)}"
    return type(ts.opt).__name__


def _optimizers(ts):
    return ((ts.opt_actor, ts.opt_critic, ts.opt_alpha) if _off_policy(ts)
            else (ts.opt,))


def _train_tree(ts):
    """The arrays of a train state that the resume file holds, but the
    optimizers' (by parameter name, `optim.state_arrays`). An off-policy
    buffer holds its min(ptr, capacity) rows written so far."""
    tree = {"net": ts.net.state_dict(), "env_states": ts.env_states,
            "last_obs": ts.last_obs, "gen": ts.gen.get_state(),
            "env_gen": ts.env_gen.get_state()}
    if _off_policy(ts):
        n = min(ts.ptr, len(ts.buffer.rew))
        tree.update(buffer=type(ts.buffer)(*(t[:n] for t in ts.buffer)),
                    ptr=np.int64(ts.ptr),
                    steps=np.int64(ts.steps),
                    grad_steps=np.int64(ts.grad_steps))
    else:
        tree.update(ep_ret=ts.ep_ret, ep_len=ts.ep_len,
                    stat_sum_ret=ts.stat_sum_ret, stat_n_eps=ts.stat_n_eps)
    return tree


def save_train_state(path, ts, steps=0):
    """The whole resume state of a `train.ppo.TrainState` or a
    `train.offpolicy.OPTrainState` and the global step count, as one npz
    (see the module docstring)."""
    path = pathlib.Path(_npz_path(path))
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = flatten(_train_tree(ts), "", {})
    for opt in _optimizers(ts):
        arrays.update(optim.state_arrays(opt, ts.net))
    np.savez(path, __steps__=np.int64(steps),
             __optimizer__=np.str_(_kind(ts)), **arrays)


def load_train_state(path, ts_like):
    """Restore a state saved by `save_train_state` into `ts_like`, a train
    state that the same trainer's `init` built with the same config; its
    net, optimizers, generators and buffer take the saved values in place.
    Returns (ts, steps). Raises ValueError when the file does not fit
    `ts_like`."""
    path = _npz_path(path)
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files}
    steps = int(saved.pop("__steps__", 0))
    kind = str(saved.pop("__optimizer__", ""))
    off = _off_policy(ts_like)
    if off and kind == _kind(ts_like) and "ptr" in saved:
        # the buffer rows saved are as many as its ptr had written
        cap = len(ts_like.buffer.rew)
        ts_like = ts_like._replace(ptr=min(int(saved["ptr"]), cap))
    like = flatten(_train_tree(ts_like), "", {})
    mine = {k: v for k, v in saved.items() if not k.startswith("opt/")}
    bad = sorted(set(like) ^ set(mine)) or [
        k for k in like if like[k].shape != mine[k].shape]
    if bad or kind != _kind(ts_like):
        raise ValueError(
            f"resume state at {path} does not fit this trainer (kind "
            f"{kind} against {_kind(ts_like)}; arrays {bad[:4]}) — configs "
            "must match")
    tree = _restore(_train_tree(ts_like), saved, "")
    ts_like.net.load_state_dict(tree["net"])
    for opt in _optimizers(ts_like):
        optim.load_state_arrays(opt, ts_like.net, saved)
    ts_like.gen.set_state(tree["gen"].cpu())
    ts_like.env_gen.set_state(tree["env_gen"].cpu())
    ts = ts_like._replace(env_states=tree["env_states"],
                          last_obs=tree["last_obs"])
    if off:
        for rows, value in zip(ts.buffer, tree["buffer"]):
            rows[:len(value)] = value
        return ts._replace(ptr=int(tree["ptr"]), steps=int(tree["steps"]),
                           grad_steps=int(tree["grad_steps"])), steps
    return ts._replace(
        ep_ret=tree["ep_ret"], ep_len=tree["ep_len"],
        stat_sum_ret=tree["stat_sum_ret"],
        stat_n_eps=tree["stat_n_eps"]), steps
