"""The traffic's draws, and what the timed path produced at sampled steps.

`TrafficEnv` wraps the port's env. Each step it draws the step's uniforms
(the noise of Env01-v2's pitch reads, the launch of Env03-v2's block) from
the harness's own generator, seeded from `--seed`, and hands them to the
env's `step(..., uniforms=)`: the benchmark makes the inputs, and the
reference gets the same ones. Resets draw from the env's own generator.
Everything else is the env's (`__getattr__`), and `rewrap` lets
`ppo.fork_env` fork the wrapped env. With an `order` (a permutation of the
batch's rows), the fresh episodes of a reset and each step's uniforms are
dealt to the rows in that order: a run with another order steps the same
episodes, each in another row. Where `starts` is a list, each reset's
output is kept in it, for the check of the episodes' starts.

`Recorder` keeps references to the tensors of the steps it samples: the
env's input state, the action and uniforms, and what the step returned.
The env's step makes new tensors and changes none of its inputs, so a
reference costs the device nothing.
"""

import torch

from .window import Reservoir


class Recorder:
    """The steps the comparison reads. `begin()` opens step i; `put(...)`
    adds to the open step when it is sampled. `k` None keeps every step;
    otherwise a uniform sample of k (`window.Reservoir`, seeded)."""

    def __init__(self, k=None, seed=0):
        self.reservoir = None if k is None else Reservoir(k, seed)
        self.steps = {}
        self.n = 0
        self.current = None
        self.on = True
        # (reward, terminated, truncated) of every env step, where a list
        self.every_step = None

    def begin(self):
        i = self.n
        self.n += 1
        self.current = None
        if not self.on:
            return
        keep = True
        if self.reservoir is not None:
            keep, dropped = self.reservoir.offer(i)
            if dropped is not None:
                del self.steps[dropped]
        if keep:
            self.current = self.steps[i] = {"index": i}

    def put(self, **items):
        if self.current is not None:
            self.current.update(items)

    def sampled(self):
        return [self.steps[i] for i in sorted(self.steps)]


def rows(tree, order):
    """The rows `order` of every tensor of a (named) tuple or dict of
    batch-first tensors, such as the port's EnvState."""
    if isinstance(tree, dict):
        return {k: rows(v, order) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [rows(v, order) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(
            parts)
    return tree[order] if torch.is_tensor(tree) else tree


def rows_of(tree):
    """The batch size of a (named) tuple or dict of batch-first tensors."""
    while not torch.is_tensor(tree):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else \
            tree[0]
    return tree.shape[0]


class TrafficEnv:
    def __init__(self, env, generator, n_uniforms, recorder=None,
                 order=None):
        """`order`: a permutation of the batch's rows (a tensor on the
        env's device), or None."""
        self._env = env
        self._gen = generator
        self._n_uniforms = n_uniforms
        self._recorder = recorder
        self._order = order
        # where a list: every reset's (state, obs) is kept in it
        self.starts = None

    def __getattr__(self, name):
        return getattr(self._env, name)

    def rewrap(self, env):
        twin = TrafficEnv(env, self._gen, self._n_uniforms, self._recorder,
                          self._order)
        twin.starts = self.starts
        return twin

    def _dealt(self, batch):
        """`batch` with its rows in the order, where there is one."""
        if self._order is None:
            return batch
        if len(self._order) != rows_of(batch):
            raise ValueError(f"an order of {len(self._order)} rows for a "
                             f"batch of {rows_of(batch)}")
        return rows(batch, self._order)

    def reset(self, n):
        out = self._dealt(self._env.reset(n))
        if self.starts is not None:
            self.starts.append(out)
        return out

    def step(self, state, action, uniforms=None):
        if uniforms is None:
            uniforms = self._dealt(torch.rand(
                (action.shape[0], self._n_uniforms), generator=self._gen,
                device=self._env.device, dtype=self._env.dtype))
        rec = self._recorder
        out = self._env.step(state, action, uniforms)
        if rec is not None:
            rec.put(pre=state, action=action, u=uniforms, out=out)
            if rec.every_step is not None:
                rec.every_step.append(out[2:5])
        return out
