"""Collective communication.

Port of ``ray_tpu/parallel/collectives.py``. Two planes:

1. **Device plane, on rank lists.** The JAX package's collectives wrap
   ``jax.lax`` primitives inside ``shard_map``, where each device runs the
   body on its own chunk. The port is single-controller
   (``parallel.mesh``): a body sees the chunks of the ranks along one mesh
   axis as one list in mesh order, and each collective maps such a list
   to a list, result ``i`` on the device of chunk ``i``. On one card the
   moves are no-ops; across cards they are peer copies. All of them are
   differentiable, as ``torch`` ops. Results on one device may share
   storage (``psum`` on one card gives every rank the same tensor): treat
   them as read-only, as JAX's arrays are. ``shard`` and ``unshard`` take
   the place of ``shard_map``'s in and out specs.

   **Across processes** (``group=``, the ``process_group.AxisGroup`` of
   an axis whose places lie in different processes: ``Mesh.group``) the
   list holds this process's one chunk and the collective runs on the
   subgroup. Each is a ``torch.autograd.Function`` with its conjugate
   backward: ``all_gather`` and ``reduce_scatter`` each other's, a
   ``ppermute`` (a ring shift) the reverse permutation, ``all_to_all`` and
   ``regroup`` the inverse exchange, and ``psum`` a ``psum``, its exact
   VJP. That last is right only where the processes' results flow on
   into different work. Where each process carries its own replica of
   the sum into replicated work (the residual stream of a
   tensor-parallel block, whose loss every tp process computes alike), a
   ``psum`` backward counts each gradient once a process. Megatron's
   conjugate pair is the answer there: ``reduce_from_group`` (``g``:
   all-reduce forward, the identity backward) at the exit of a tp region
   and ``copy_to_group`` (``f``: the identity forward, all-reduce
   backward) where a replicated activation enters one; likewise
   ``gather_from_group`` gathers forward and keeps this process's piece
   of the gradient backward.

2. **Host plane (numpy arrays and CPU tensors, control data).** A copy of
   the JAX package's actor-group collectives with the surface of the
   reference's ``ray.util.collective`` (``init_collective_group``,
   ``allreduce``, ...): groups keyed by name, ranks are threads or actors
   of this process, and a rendezvous per operation reduces with numpy.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Device plane: lists of per-rank chunks along one mesh axis
# ---------------------------------------------------------------------------


def shard(x: torch.Tensor, devices: list, dim: int) -> list:
    """``x`` cut into ``len(devices)`` equal chunks along ``dim``, chunk
    ``i`` on ``devices[i]`` (``shard_map``'s in spec for one axis)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible "
                         f"by {n} ranks")
    return [c.to(dev) for c, dev in zip(x.chunk(n, dim=dim), devices)]


def unshard(xs: list, dim: int, device=None) -> torch.Tensor:
    """The chunks joined along ``dim`` on ``device`` (default: the first
    chunk's), the inverse of ``shard``."""
    device = device if device is not None else xs[0].device
    return torch.cat([x.to(device) for x in xs], dim=dim)


# ---------------------------------------------------------------------------
# Across processes: one chunk a process, the collective on a subgroup
# ---------------------------------------------------------------------------


def _one(xs: list, group) -> torch.Tensor:
    if len(xs) != 1:
        raise ValueError(f"a collective on {group} takes this process's one "
                         f"chunk, got {len(xs)}")
    return xs[0]


def _gather(x: torch.Tensor, group, dim: int, tiled: bool) -> torch.Tensor:
    pieces = group.pg.all_gather_flat(x, group).view(group.size, *x.shape)
    if not tiled:
        return pieces.movedim(0, dim).contiguous()
    return torch.cat(pieces.unbind(0), dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int,
                 tiled: bool) -> torch.Tensor:
    n = group.size
    if tiled and x.shape[dim] % n:
        raise ValueError(f"scatter axis of size {x.shape[dim]} not "
                         f"divisible by {n} ranks")
    pieces = x.chunk(n, dim=dim) if tiled else x.unbind(dim)
    out = group.pg.reduce_scatter_flat(torch.stack(pieces), group)
    return out.view(pieces[0].shape)


def _own_piece(x: torch.Tensor, group, dim: int, tiled: bool):
    if not tiled:
        return x.select(dim, group.index).contiguous()
    return x.chunk(group.size, dim=dim)[group.index].contiguous()


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return group.pg.all_reduce(x.detach().clone(), op, group=group)


def _all_to_all(x: torch.Tensor, group, split: int,
                concat: int) -> torch.Tensor:
    n = group.size
    pieces = x.chunk(n, dim=split)
    count = pieces[0].numel()
    got = group.pg.all_to_all_flat(
        torch.cat([p.reshape(-1) for p in pieces]), [count] * n,
        [count] * n, group)
    return torch.cat(got.view(n, *pieces[0].shape).unbind(0), dim=concat)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    me = group.index
    sends = {d: x for s, d in perm if s == me}
    recvs = {s: (x.shape, x.dtype, x.device) for s, d in perm if d == me}
    got = group.pg.exchange(sends, recvs, group)
    return next(iter(got.values())) if got else torch.zeros_like(x)


def _exchange(x: torch.Tensor, group, dim: int, send: list, recv: list,
              width: int) -> torch.Tensor:
    """Ranges of ``x`` along ``dim`` to the processes of ``group`` in one
    ``all_to_all``: ``send[j]`` the (offset, width) pieces of ``x`` for
    process ``j``, ``recv[i]`` where in the result (``width`` along
    ``dim``, zero elsewhere) what process ``i`` sends lands, in the same
    order."""
    x = x.movedim(dim, -1)
    rest = x.shape[:-1]
    n_rest = math.prod(rest)
    pieces = [x[..., a:a + w].reshape(-1) for to in send for a, w in to]
    got = group.pg.all_to_all_flat(
        torch.cat(pieces) if pieces else x.new_empty(0),
        [n_rest * sum(w for _, w in to) for to in send],
        [n_rest * sum(w for _, w in frm) for frm in recv], group)
    out = x.new_zeros(*rest, width)
    at = 0
    for frm in recv:
        for a, w in frm:
            out[..., a:a + w] = got[at:at + n_rest * w].view(*rest, w)
            at += n_rest * w
    return out.movedim(-1, dim)


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums the gradient over the
    processes and keeps this one's piece (a reduce-scatter), or, with
    ``keep_piece``, keeps its piece alone (``gather_from_group``)."""

    @staticmethod
    def forward(ctx, x, group, dim, tiled, keep_piece):
        ctx.args = (group, dim, tiled, keep_piece)
        return _gather(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        group, dim, tiled, keep_piece = ctx.args
        back = _own_piece if keep_piece else _scatter_sum
        return back(g, group, dim, tiled), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, tiled):
        ctx.args = (group, dim, tiled)
        return _scatter_sum(x, group, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        group, dim, tiled = ctx.args
        return _gather(g, group, dim, tiled), None, None, None


class _AllReduce(torch.autograd.Function):
    """The sum over the processes; the backward is the same sum
    (``psum``'s VJP) or, with ``identity_backward``, the identity
    (``reduce_from_group``)."""

    @staticmethod
    def forward(ctx, x, group, identity_backward):
        ctx.args = (group, identity_backward)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        group, identity = ctx.args
        return (g if identity else _all_reduce(g, group)), None, None


class _Copy(torch.autograd.Function):
    """The identity; the backward sums the gradient over the processes
    (``copy_to_group``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Permute(torch.autograd.Function):
    """``ppermute`` across processes; the backward sends the gradient
    back along the reversed pairs."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.args = (group, perm)
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        group, perm = ctx.args
        return _permute(g, group, [(d, s) for s, d in perm]), None, None


class _AllToAll(torch.autograd.Function):
    """The tiled ``all_to_all``; the backward is the inverse one."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.args = (group, split, concat)
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, split, concat = ctx.args
        return _all_to_all(g, group, concat, split), None, None, None


class _Exchange(torch.autograd.Function):
    """``_exchange``; the backward moves the gradient's pieces back."""

    @staticmethod
    def forward(ctx, x, group, dim, send, recv, width):
        ctx.args = (group, dim, send, recv, x.shape[dim])
        return _exchange(x, group, dim, send, recv, width)

    @staticmethod
    def backward(ctx, g):
        group, dim, send, recv, width = ctx.args
        return (_exchange(g, group, dim, recv, send, width),
                None, None, None, None, None)


def reduce_from_group(xs: list, group) -> list:
    """Megatron's ``g``: the sum over ``group``'s processes forward, the
    identity backward (module docstring)."""
    return [_AllReduce.apply(_one(xs, group), group, True)]


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: the identity forward, the sum over ``group``'s
    processes backward (module docstring)."""
    return _Copy.apply(x, group)


def gather_from_group(xs: list, *, gather_axis: int = 0, tiled: bool = True,
                      group) -> list:
    """All-gather over ``group`` whose backward keeps this process's piece
    of the gradient: for a tensor whose consumers every process of the
    group runs alike (module docstring)."""
    return [_AllGather.apply(_one(xs, group), group, gather_axis, tiled,
                             True)]


# ---------------------------------------------------------------------------
# Rank lists (and, with group=, across processes)
# ---------------------------------------------------------------------------


def _on_ranks(values, xs: list) -> list:
    return [v.to(x.device) for v, x in zip(values, xs)]


def _reduce(xs: list, op) -> torch.Tensor:
    home = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = op(total, x.to(home))
    return total


def psum(xs: list, *, group=None) -> list:
    if group is not None:
        return [_AllReduce.apply(_one(xs, group), group, False)]
    total = _reduce(xs, torch.add)
    return _on_ranks([total] * len(xs), xs)


def pmean(xs: list) -> list:
    total = _reduce(xs, torch.add) / len(xs)
    return _on_ranks([total] * len(xs), xs)


def pmax(xs: list, *, group=None) -> list:
    """The maximum over the ranks (across processes, no gradient)."""
    if group is not None:
        return [_all_reduce(_one(xs, group), group, "max")]
    top = _reduce(xs, torch.maximum)
    return _on_ranks([top] * len(xs), xs)


def all_gather(xs: list, *, gather_axis: int = 0, tiled: bool = True,
               group=None) -> list:
    """Every rank gets all chunks joined along ``gather_axis`` (stacked on
    a new axis there when not ``tiled``)."""
    if group is not None:
        return [_AllGather.apply(_one(xs, group), group, gather_axis, tiled,
                                 False)]
    join = torch.cat if tiled else torch.stack
    home = xs[0].device
    full = join([x.to(home) for x in xs], dim=gather_axis)
    return _on_ranks([full] * len(xs), xs)


def reduce_scatter(xs: list, *, scatter_axis: int = 0,
                   tiled: bool = True, group=None) -> list:
    """The sum over ranks, rank ``i`` keeping its ``i``-th piece along
    ``scatter_axis`` (an axis of size n that is dropped, when not
    ``tiled``)."""
    if group is not None:
        return [_ReduceScatter.apply(_one(xs, group), group, scatter_axis,
                                     tiled)]
    n = len(xs)
    total = _reduce(xs, torch.add)
    if tiled:
        if total.shape[scatter_axis] % n:
            raise ValueError(f"scatter axis of size "
                             f"{total.shape[scatter_axis]} not divisible by "
                             f"{n} ranks")
        pieces = total.chunk(n, dim=scatter_axis)
    else:
        pieces = total.unbind(dim=scatter_axis)
    return _on_ranks(pieces, xs)


def ppermute(xs: list, perm, *, group=None) -> list:
    """``perm``: (source, destination) pairs. Rank ``d`` receives rank
    ``s``'s chunk; a rank that receives nothing gets zeros, as in
    ``lax.ppermute``. Across processes a process's sends and receives are
    posted at once (no pair deadlocks on their order)."""
    if group is not None:
        return [_Permute.apply(_one(xs, group), group,
                               tuple(map(tuple, perm)))]
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def ring_shift(xs: list, *, shift: int = 1, group=None) -> list:
    """Shift values around the ring: rank ``(i + shift) % n`` receives rank
    ``i``'s chunk (the building block of ring attention)."""
    n = len(xs) if group is None else group.size
    return ppermute(xs, [(i, (i + shift) % n) for i in range(n)],
                    group=group)


def all_to_all(xs: list, *, split_axis: int, concat_axis: int,
               tiled: bool = True, group=None) -> list:
    """Rank ``i`` splits its chunk into n pieces along ``split_axis``; rank
    ``j`` receives piece ``j`` of every rank, joined in rank order along
    ``concat_axis`` (tiled; only the tiled form is ported)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    n = len(xs) if group is None else group.size
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(f"split axis of size {x.shape[split_axis]} not "
                             f"divisible by {n} ranks")
    if group is not None:
        return [_AllToAll.apply(_one(xs, group), group, split_axis,
                                concat_axis)]
    pieces = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([p[j].to(xs[j].device) for p in pieces],
                      dim=concat_axis) for j in range(n)]


def _overlaps(have: list, lo: int, hi: int) -> list:
    """(rank, start, stop) of every chunk's part of [lo, hi), in rank
    order."""
    return [(i, max(lo, a), min(hi, b)) for i, (a, b) in enumerate(have)
            if max(lo, a) < min(hi, b)]


def _regroup_across(x, have, want, dim, group):
    """``regroup`` of this process's chunk over ``group``: one exchange,
    each process sending every other the parts of its range they want."""
    me = group.index
    a0 = have[me][0]
    send = [[(a - a0, b - a) for lo, hi in ranges
             for i, a, b in _overlaps(have, lo, hi) if i == me]
            for ranges in want]
    recv, at = [[] for _ in have], 0
    for lo, hi in want[me]:
        parts = _overlaps(have, lo, hi)
        if sum(b - a for _, a, b in parts) != hi - lo:
            raise ValueError(f"the ranges {have} do not cover {(lo, hi)}")
        for i, a, b in parts:
            recv[i].append((at, b - a))
            at += b - a
    dim = dim % x.dim()
    return _Exchange.apply(x, group, dim, send, recv, at)


def regroup(xs: list, have: list, want: list, *, dim: int = -1,
            group=None) -> list:
    """Ranges of one index space moved between ranks: chunk ``i`` holds
    indices ``have[i]`` (a ``(start, stop)`` range) along ``dim``; rank
    ``j`` gets the ranges ``want[j]`` (a list of them, joined in order),
    assembled from the pieces of the chunks that overlap them, on rank
    ``j``'s device. The uneven counterpart of a tiled ``all_to_all``
    (GSPMD's reshard between two cuts of one dimension). Across processes
    (``have`` and ``want`` still list every rank's) the backward moves
    the gradient's pieces back."""
    if group is not None:
        return [_regroup_across(_one(xs, group), have, want, dim, group)]
    out = []
    for j, ranges in enumerate(want):
        pieces = []
        for lo, hi in ranges:
            got = [x.narrow(dim, max(lo, a) - a, min(hi, b) - max(lo, a))
                   .to(xs[j].device)
                   for x, (a, b) in zip(xs, have) if max(lo, a) < min(hi, b)]
            if sum(p.shape[dim] for p in got) != hi - lo:
                raise ValueError(f"the ranges {have} do not cover "
                                 f"{(lo, hi)}")
            pieces += got
        out.append(pieces[0] if len(pieces) == 1
                   else torch.cat(pieces, dim=dim))
    return out


def logsumexp(xs: list, *, reduce=psum, group=None) -> list:
    """The log-sum-exp over the last axis of a tensor cut along it, chunk
    ``i`` on rank ``i``: each rank's own, combined with ``reduce`` (the
    sum over the ranks) of their exponentials about the ranks' detached
    maximum (over ``group``'s processes when the ranks are processes).
    The result does not depend on the shift, so its gradient,
    ``exp(x - lse)`` on each chunk, needs none through the maximum. One
    chunk gives ``torch.logsumexp`` exactly."""
    local = [torch.logsumexp(x, dim=-1) for x in xs]
    top = pmax([v.detach() for v in local], group=group)
    sums = reduce([torch.exp(v - m) for v, m in zip(local, top)])
    return [m + torch.log(s) for m, s in zip(top, sums)]


def axis_index(xs: list) -> list:
    """Each rank's index along the axis."""
    return list(range(len(xs)))


def axis_size(xs: list, *, group=None) -> int:
    return group.size if group is not None else len(xs)


# ---------------------------------------------------------------------------
# Host plane: actor collective groups (reference: ray.util.collective)
# ---------------------------------------------------------------------------


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"


_REDUCERS = {
    ReduceOp.SUM: lambda arrs: np.sum(arrs, axis=0),
    ReduceOp.PRODUCT: lambda arrs: np.prod(arrs, axis=0),
    ReduceOp.MAX: lambda arrs: np.max(arrs, axis=0),
    ReduceOp.MIN: lambda arrs: np.min(arrs, axis=0),
}


def _host_array(tensor):
    """A CPU tensor or array-like as a numpy array (None stays None)."""
    if tensor is None:
        return None
    if isinstance(tensor, torch.Tensor):
        if tensor.device.type != "cpu":
            raise ValueError(f"host collectives take CPU tensors, got one on "
                             f"{tensor.device}")
        return tensor.detach().numpy()
    return np.asarray(tensor)


def _like(result, tensor):
    """``result`` as a tensor when the caller gave one, else as numpy."""
    if not isinstance(tensor, torch.Tensor):
        return result
    if isinstance(result, list):
        return [torch.from_numpy(r) for r in result]
    return torch.from_numpy(np.asarray(result))


def _private_copy(x):
    """Copy combine() results so each rank owns its buffer (in-place math
    on one rank's result must not corrupt another's)."""
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, list):
        return [_private_copy(e) for e in x]
    return x


@dataclass
class _GroupState:
    name: str
    world_size: int
    backend: str
    lock: threading.Lock
    cv: threading.Condition
    # per-collective rendezvous state, keyed by op sequence number
    contributions: dict
    results: dict
    seq: dict


class GroupManager:
    """Host-collective group registry (reference: ``GroupManager`` at
    ``util/collective/collective.py:40``). Local-mode rendezvous barrier +
    numpy reduction; ranks may be any threads or actors in this
    process."""

    def __init__(self):
        self._groups: dict[str, _GroupState] = {}
        self._lock = threading.Lock()

    def create(self, name: str, world_size: int, backend: str = "local"):
        with self._lock:
            if name in self._groups:
                raise ValueError(f"Collective group {name!r} already exists")
            lock = threading.Lock()
            self._groups[name] = _GroupState(
                name=name, world_size=world_size, backend=backend, lock=lock,
                cv=threading.Condition(lock), contributions={}, results={},
                seq={},
            )

    def get(self, name: str) -> _GroupState:
        with self._lock:
            if name not in self._groups:
                raise KeyError(f"No collective group {name!r}")
            return self._groups[name]

    def destroy(self, name: str):
        with self._lock:
            self._groups.pop(name, None)

    def _rendezvous(self, group: str, rank: int, key: str, value, combine,
                    timeout: float = 60.0):
        """Generic barrier: all ranks contribute; ``combine`` runs once on
        the full contribution dict; every rank receives a private copy of
        the result (each rank owns its output buffer).

        Each rank's n-th call with a given ``key`` joins epoch n, so
        back-to-back collectives on the same group can't cross-talk even
        if a fast rank starts the next op before slow ranks finish this
        one. On timeout the rank withdraws its contribution and rolls back
        its epoch, so a retry re-joins the same epoch instead of
        desynchronizing the group.
        """
        g = self.get(group)
        with g.cv:
            epoch = g.seq.get((key, rank), 0)
            g.seq[(key, rank)] = epoch + 1
            op_id = (key, epoch)
            bucket = g.contributions.setdefault(op_id, {})
            if rank in bucket:
                raise RuntimeError(
                    f"rank {rank} contributed twice to {op_id} in {group!r}"
                )
            bucket[rank] = value
            if len(bucket) == g.world_size:
                g.results[op_id] = [combine(bucket), 0]
                del g.contributions[op_id]
                g.cv.notify_all()
            else:
                while op_id not in g.results:
                    if not g.cv.wait(timeout=timeout):
                        # withdraw cleanly so a retry can rejoin this epoch
                        still = g.contributions.get(op_id)
                        if still is not None:
                            still.pop(rank, None)
                            if not still:
                                del g.contributions[op_id]
                        g.seq[(key, rank)] = epoch
                        raise TimeoutError(
                            f"collective {key!r} timed out in group "
                            f"{group!r} (rank {rank}, epoch {epoch}, "
                            f"{len(g.contributions.get(op_id, {}))}/"
                            f"{g.world_size} arrived)"
                        )
            slot = g.results[op_id]
            slot[1] += 1
            if slot[1] == g.world_size:  # last rank out frees the slot
                del g.results[op_id]
            return _private_copy(slot[0])


_group_manager = GroupManager()


def group_manager() -> GroupManager:
    return _group_manager


def init_collective_group(world_size: int, rank: int, *,
                          group_name: str = "default", backend: str = "local"):
    """Declarative group creation (reference ``collective.py:120``). Safe
    to call from every rank; the first caller creates the group."""
    try:
        _group_manager.create(group_name, world_size, backend)
    except ValueError:
        pass
    return rank


def destroy_collective_group(group_name: str = "default"):
    _group_manager.destroy(group_name)


def allreduce(tensor, rank: int, *, group_name: str = "default",
              op: str = ReduceOp.SUM):
    arr = _host_array(tensor)
    result = _group_manager._rendezvous(
        group_name, rank, f"allreduce_{op}",
        arr, lambda bucket: _REDUCERS[op](np.stack(list(bucket.values()))),
    )
    return _like(result, tensor)


def allgather(tensor, rank: int, *, group_name: str = "default"):
    arr = _host_array(tensor)
    result = _group_manager._rendezvous(
        group_name, rank, "allgather",
        arr, lambda bucket: [bucket[r] for r in sorted(bucket)],
    )
    return _like(result, tensor)


def broadcast(tensor, rank: int, *, src_rank: int = 0,
              group_name: str = "default"):
    arr = _host_array(tensor)
    result = _group_manager._rendezvous(
        group_name, rank, "broadcast",
        arr, lambda bucket: bucket[src_rank],
    )
    return _like(result, tensor)


def reducescatter(tensor, rank: int, *, group_name: str = "default",
                  op: str = ReduceOp.SUM):
    arr = _host_array(tensor)

    def combine(bucket):
        full = _REDUCERS[op](np.stack(list(bucket.values())))
        return np.array_split(full, len(bucket), axis=0)

    chunks = _group_manager._rendezvous(
        group_name, rank, f"reducescatter_{op}", arr, combine,
    )
    return _like(chunks[rank], tensor)


def barrier(rank: int, *, group_name: str = "default"):
    _group_manager._rendezvous(group_name, rank, "barrier", None,
                               lambda bucket: True)
