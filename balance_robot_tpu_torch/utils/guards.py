"""NaN/Inf guards for the env step and for what gets saved.

Counterpart of `balance_robot_tpu/utils/guards.py`. The step is pure, so
the only runtime corruption it can suffer is numeric: `checked_step`
names the first non-finite field after a step instead of letting it spread
through the batch, and `assert_finite_tree` keeps a poisoned net or
optimizer state from being written to disk (the runner calls it before
every save).

Usage:
    step = checked_step(env)        # debug and CI runs
    state, obs, reward, term, trunc = step(state, action)
"""

import numpy as np
import torch

from ..train.checkpoint import flatten


def checked_step(env):
    """`env.step` followed by finiteness checks on the post-step qpos,
    qvel, obs and reward, read with one host sync. Raises
    FloatingPointError naming the first check that fails."""

    def step(state, action, uniforms=None):
        out = env.step(state, action, uniforms)
        state, obs, reward = out[0], out[1], out[2]
        checks = {"non-finite qpos after physics step": state.phys.qpos,
                  "non-finite qvel after physics step": state.phys.qvel,
                  "non-finite observation": obs,
                  "non-finite reward": reward}
        ok = torch.stack([torch.isfinite(v).all()
                          for v in checks.values()]).tolist()
        for name, good in zip(checks, ok):
            if not good:
                raise FloatingPointError(name)
        return out

    return step


def assert_finite_tree(tree, name="tree"):
    """Host-side finiteness sweep over a tree of tensors or arrays (dicts,
    lists, named tuples; a module by its state dict). Raises
    FloatingPointError listing the path of every bad leaf."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    bad = [path for path, leaf in flatten(tree, "", {}).items()
           if np.issubdtype(leaf.dtype, np.floating)
           and not np.isfinite(leaf).all()]
    if bad:
        raise FloatingPointError(f"non-finite values in {name} at: "
                                 + ", ".join(bad))
