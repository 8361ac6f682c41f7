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

2. **Host plane (numpy arrays and CPU tensors, control data).** A copy of
   the JAX package's actor-group collectives with the surface of the
   reference's ``ray.util.collective`` (``init_collective_group``,
   ``allreduce``, ...): groups keyed by name, ranks are threads or actors
   of this process, and a rendezvous per operation reduces with numpy.
"""

from __future__ import annotations

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


def _on_ranks(values, xs: list) -> list:
    return [v.to(x.device) for v, x in zip(values, xs)]


def _reduce(xs: list, op) -> torch.Tensor:
    home = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = op(total, x.to(home))
    return total


def psum(xs: list) -> list:
    total = _reduce(xs, torch.add)
    return _on_ranks([total] * len(xs), xs)


def pmean(xs: list) -> list:
    total = _reduce(xs, torch.add) / len(xs)
    return _on_ranks([total] * len(xs), xs)


def pmax(xs: list) -> list:
    top = _reduce(xs, torch.maximum)
    return _on_ranks([top] * len(xs), xs)


def all_gather(xs: list, *, gather_axis: int = 0, tiled: bool = True) -> list:
    """Every rank gets all chunks joined along ``gather_axis`` (stacked on
    a new axis there when not ``tiled``)."""
    join = torch.cat if tiled else torch.stack
    home = xs[0].device
    full = join([x.to(home) for x in xs], dim=gather_axis)
    return _on_ranks([full] * len(xs), xs)


def reduce_scatter(xs: list, *, scatter_axis: int = 0,
                   tiled: bool = True) -> list:
    """The sum over ranks, rank ``i`` keeping its ``i``-th piece along
    ``scatter_axis`` (an axis of size n that is dropped, when not
    ``tiled``)."""
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


def ppermute(xs: list, perm) -> list:
    """``perm``: (source, destination) pairs. Rank ``d`` receives rank
    ``s``'s chunk; a rank that receives nothing gets zeros, as in
    ``lax.ppermute``."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def ring_shift(xs: list, *, shift: int = 1) -> list:
    """Shift values around the ring: rank ``(i + shift) % n`` receives rank
    ``i``'s chunk (the building block of ring attention)."""
    n = len(xs)
    return ppermute(xs, [(i, (i + shift) % n) for i in range(n)])


def all_to_all(xs: list, *, split_axis: int, concat_axis: int,
               tiled: bool = True) -> list:
    """Rank ``i`` splits its chunk into n pieces along ``split_axis``; rank
    ``j`` receives piece ``j`` of every rank, joined in rank order along
    ``concat_axis`` (tiled; only the tiled form is ported)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    n = len(xs)
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(f"split axis of size {x.shape[split_axis]} not "
                             f"divisible by {n} ranks")
    pieces = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([p[j].to(xs[j].device) for p in pieces],
                      dim=concat_axis) for j in range(n)]


def regroup(xs: list, have: list, want: list, *, dim: int = -1) -> list:
    """Ranges of one index space moved between ranks: chunk ``i`` holds
    indices ``have[i]`` (a ``(start, stop)`` range) along ``dim``; rank
    ``j`` gets the ranges ``want[j]`` (a list of them, joined in order),
    assembled from the pieces of the chunks that overlap them, on rank
    ``j``'s device. The uneven counterpart of a tiled ``all_to_all``
    (GSPMD's reshard between two cuts of one dimension)."""
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


def logsumexp(xs: list, *, reduce=psum) -> list:
    """The log-sum-exp over the last axis of a tensor cut along it, chunk
    ``i`` on rank ``i``: each rank's own, combined with ``reduce`` (the
    sum over the ranks) of their exponentials about the ranks' detached
    maximum. The result does not depend on the shift, so its gradient,
    ``exp(x - lse)`` on each chunk, needs none through the maximum. One
    chunk gives ``torch.logsumexp`` exactly."""
    local = [torch.logsumexp(x, dim=-1) for x in xs]
    top = pmax([v.detach() for v in local])
    sums = reduce([torch.exp(v - m) for v, m in zip(local, top)])
    return [m + torch.log(s) for m, s in zip(top, sums)]


def axis_index(xs: list) -> list:
    """Each rank's index along the axis."""
    return list(range(len(xs)))


def axis_size(xs: list) -> int:
    return len(xs)


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
