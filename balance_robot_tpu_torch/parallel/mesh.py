"""The env mesh over the ranks of `torch.distributed`, and its collectives.

Counterpart of `balance_robot_tpu/parallel/mesh.py`. The JAX package lays
the env batch over a 1-D `'env'` mesh of devices and replicates the params;
XLA inserts the collectives. Here the mesh is a group of ranks, one process
each: rank r steps the contiguous rows [r * n, (r + 1) * n) of the global
batch of W * n envs, and the net, the optimizer and the generators are
replicated.

How the trainer learns its shard: `shard_train_state` broadcasts the
global train state from rank 0 (so that replication is a fact, not an
assumption), cuts the env-batch leaves to the rank's rows and sets
`ts.mesh`; `PPO.iteration` runs its sharded path wherever `ts.mesh` is set
(`train/ppo.py` says what that path gathers and why the update runs
replicated). `gather_train_state` is the inverse, for the resume file,
which keeps the global layout.

Randomness does not depend on the sharding: every draw of the env's and
of the trainer's generators is made at the global batch on every rank, from
identically seeded generators, and the rank keeps its own rows
(`global_draw`). A W-rank run therefore equals the one-process run of the
same seed. Without that, ranks that share a seed would draw the same action
noise and the same resets for every shard.

Collectives are all_reduce(SUM) and broadcast only: gloo has no all_gather
for CUDA tensors, so `gather_rows` sums zero-filled buffers in which each
rank wrote its own rows (x + 0 is exact), and the same code serves NCCL,
gloo on the CPU and gloo on the card. CPU tensors (Adam's step counts, the
generators' states, the runner's decisions) go through a gloo group of the
same ranks, `Mesh.control`, since NCCL takes CUDA tensors only.
"""

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..envs.base import tree_map


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks over the axis `axis`; this process is
    `rank`. `group` carries the data collectives (None: the default group),
    `control` the CPU tensors (a gloo group of the same ranks). A mesh made
    without `torch.distributed` has one rank and runs no collective."""
    rank: int = 0
    size: int = 1
    axis: str = "env"
    group: Any = None
    control: Any = None

    @property
    def distributed(self):
        return dist.is_available() and dist.is_initialized()

    @property
    def shard(self):
        """(rank, size): what `global_draw` takes."""
        return (self.rank, self.size)


def make_mesh(group=None, axis="env"):
    """The mesh over the ranks of `group` (default: every rank of the
    initialized process group; one rank where none is initialized). Every
    rank of the group must call it: it makes the gloo control group."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group needs torch.distributed to be "
                             "initialized")
        return Mesh(axis=axis)
    control = group
    if dist.get_backend(group) != "gloo":
        ranks = None if group is None else dist.get_process_group_ranks(group)
        control = dist.new_group(ranks=ranks, backend="gloo")
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                axis=axis, group=group, control=control)


# ------------------------------------------------------------ collectives

def _group(mesh, t):
    return mesh.group if t.is_cuda else mesh.control


def _as_reducible(t):
    # bool has no sum in every backend; uint8 has the same bytes
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def broadcast_(t, mesh, src=0):
    """Rank `src`'s values of tensor `t` on every rank, in place."""
    if mesh.distributed:
        group = _group(mesh, t)
        root = src if group is None else dist.get_global_rank(group, src)
        dist.broadcast(_as_reducible(t), src=root, group=group)
    return t


def all_reduce_sum_(t, mesh):
    """The sum of `t` over the ranks, in place."""
    if mesh.distributed:
        dist.all_reduce(_as_reducible(t), group=_group(mesh, t))
    return t


def agree(values, mesh):
    """Rank 0's `values` (a sequence of floats) on every rank: the
    runner's decisions (the eval's result, whether to stop)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    return broadcast_(t, mesh).tolist()


def gather_rows(tensors, mesh, dim=0):
    """Every rank's rows of each tensor, concatenated in rank order along
    the env dim `dim` (the same for all): the global batch, on every rank,
    contiguous. One all_reduce(SUM) per dtype, into a zero-filled buffer
    (world, rows, columns) in which each rank wrote its own slice, so the
    values are copied bit for bit."""
    if not mesh.distributed:
        return [t.contiguous() for t in tensors]
    out = [None] * len(tensors)
    by_kind = {}
    for i, t in enumerate(tensors):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_kind.values():
        moved = [tensors[i].movedim(dim, 0) for i in idx]
        n = moved[0].shape[0]
        if any(m.shape[0] != n for m in moved):
            raise ValueError("gather_rows: the tensors disagree on the "
                             f"number of rows along dim {dim}")
        cols = [m[0].numel() for m in moved]
        local = torch.cat([m.reshape(n, -1) for m in moved], 1)
        buf = local.new_zeros((mesh.size,) + tuple(local.shape))
        buf[mesh.rank] = local
        all_reduce_sum_(buf, mesh)
        flat = buf.reshape(mesh.size * n, -1)
        for i, m, part in zip(idx, moved, flat.split(cols, 1)):
            out[i] = part.reshape((mesh.size * n,) + tuple(m.shape[1:])) \
                .movedim(0, dim).contiguous()
    return out


def global_draw(draw, shape, shard):
    """`draw(shape)` as a slice of the global batch's draw: with `shard`
    = (rank, size), draws shape[0] x size rows and returns the rank's
    shape[0] of them; with None, draws `shape`."""
    if shard is None:
        return draw(tuple(shape))
    rank, size = shard
    n = shape[0]
    return draw((n * size,) + tuple(shape[1:]))[rank * n:(rank + 1) * n]


# ------------------------------------------------------------ placement

def _rows(n_rows, mesh):
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} envs do not split evenly over "
                         f"{mesh.size} ranks")
    n = n_rows // mesh.size
    return mesh.rank * n, n


def shard_batch_leaves(tree, mesh, batch_size):
    """The rank's rows of every leaf whose leading dim is `batch_size`;
    every other leaf unchanged."""
    lo, n = _rows(batch_size, mesh)

    def place(x):
        if hasattr(x, "shape") and len(x.shape) >= 1 \
                and x.shape[0] == batch_size:
            return x[lo:lo + n]
        return x

    return tree_map(place, tree)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _with_leaves(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _replicate(ts, mesh):
    """Rank 0's global train state on every rank: the net, the optimizer's
    state in the net's parameter order, both generators, the env states and
    the episode statistics."""
    params = list(ts.net.parameters())
    for p in params:
        broadcast_(p.data, mesh)
    for p in params:
        state = ts.opt.state.get(p, {})
        for key in sorted(state):
            if torch.is_tensor(state[key]):
                broadcast_(state[key], mesh)
    for gen in (ts.gen, ts.env_gen):
        gen.set_state(broadcast_(gen.get_state(), mesh))
    for t in _leaves((ts.env_states, ts.last_obs, ts.ep_ret, ts.ep_len,
                      ts.stat_sum_ret, ts.stat_n_eps)):
        broadcast_(t, mesh)


def shard_train_state(ts, mesh, n_envs):
    """PPO's TrainState on `mesh`: rank 0's state replicated, then the
    rank's rows of env_states, last_obs, ep_ret and ep_len, with `mesh`
    set so that the trainer steps its shard. Raises ValueError for an
    off-policy train state (the JAX package shards PPO's only) and where
    n_envs does not split evenly over the ranks."""
    if not hasattr(ts, "ep_ret"):
        raise ValueError("only PPO's train state is sharded, as in the JAX "
                         "package; an off-policy trainer runs in one process")
    _rows(n_envs, mesh)
    _replicate(ts, mesh)
    return ts._replace(
        env_states=shard_batch_leaves(ts.env_states, mesh, n_envs),
        last_obs=shard_batch_leaves(ts.last_obs, mesh, n_envs),
        ep_ret=shard_batch_leaves(ts.ep_ret, mesh, n_envs),
        ep_len=shard_batch_leaves(ts.ep_len, mesh, n_envs),
        mesh=mesh)


def gather_train_state(ts):
    """The global train state of a sharded one (every rank's rows in rank
    order), with no mesh: the layout of the resume file. A collective:
    every rank of the mesh calls it. A train state on no mesh (an
    off-policy one included) is returned as it is."""
    if getattr(ts, "mesh", None) is None:
        return ts
    local = (ts.env_states, ts.last_obs, ts.ep_ret, ts.ep_len)
    leaves = _leaves(local)
    env_states, last_obs, ep_ret, ep_len = _with_leaves(
        local, gather_rows(leaves, ts.mesh))
    return ts._replace(env_states=env_states, last_obs=last_obs,
                       ep_ret=ep_ret, ep_len=ep_len, mesh=None)
