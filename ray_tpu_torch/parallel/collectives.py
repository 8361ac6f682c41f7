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
   list holds this process's ``k`` chunks along the axis, global indices
   ``group.index·k`` to ``group.index·k + k - 1`` of the ``n = k·size``
   (``k = 1`` where the axis spans the processes one index each; more
   where the process boundary cuts it, ``parallel.mesh``), and the
   collective runs on those chunks and on the subgroup: ``psum`` and
   ``pmax`` reduce the chunks here (``local_sum``), run one subgroup
   collective and give each place the result (a sum of 16-bit floats
   runs in float32 and is rounded once, here as on one process, so that
   the sums across processes hold the rank list's however the processes
   group the ranks); ``all_gather`` joins them
   here and gathers the processes' blocks (process-major, local-minor:
   the global index); ``reduce_scatter`` sums here, reduce-scatters the
   processes' blocks and splits this one (``local_split``); ``ppermute``
   moves between the chunks here and posts one exchange to each other
   process; ``all_to_all`` and ``regroup`` exchange with every process
   at once. Each is a ``torch.autograd.Function`` with its conjugate
   backward: ``all_gather`` and ``reduce_scatter`` each other's, a
   ``ppermute`` (a ring shift) the reverse permutation, ``all_to_all``
   and ``regroup`` the inverse exchange, and ``psum`` a ``psum``, its
   exact VJP. That last is right only where the processes' results flow
   on into different work. Where each process carries its own replica of
   the sum into replicated work (the residual stream of a
   tensor-parallel block, whose loss every tp process computes alike), a
   ``psum`` backward counts each gradient once a process. Megatron's
   conjugate pair is the answer there: ``reduce_from_group`` (``g``:
   all-reduce forward, the identity across processes backward) at the
   exit of a tp region and ``copy_to_group`` (``f``: the identity
   forward, all-reduce backward) where a replicated activation enters
   one; likewise ``gather_from_group`` gathers forward and keeps this
   process's block of the gradient backward. Within a process the ``k``
   chunks' parts are the rank-list collective's, differentiated as it
   is.

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
# Across processes: this process's k chunks, the collective on a subgroup
# ---------------------------------------------------------------------------


def _accumulator(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum accumulates in: float32 for 16-bit floats."""
    return torch.float32 if dtype in (torch.float16, torch.bfloat16) \
        else dtype


def _sum(xs: list) -> torch.Tensor:
    """The sum of ``xs`` on the first one's device, 16-bit floats added
    in float32 and rounded once: the rank-list sum and the sum across
    processes then differ only in float32's last bits, whatever the
    processes' grouping of the ranks."""
    acc = _accumulator(xs[0].dtype)
    return _reduce([x.to(acc) for x in xs], torch.add).to(xs[0].dtype)


def local_sum(xs: list) -> torch.Tensor:
    """The sum of this process's chunks on the first one's device, in the
    accumulator's dtype (``_sum``), before the subgroup's all-reduce or
    reduce-scatter (a module attribute, so that a fault check can skip
    it)."""
    acc = _accumulator(xs[0].dtype)
    return _reduce([x.to(acc) for x in xs], torch.add)


def local_split(x: torch.Tensor, k: int, dim: int, tiled: bool) -> list:
    """This process's block of a reduce-scatter's result as its ``k``
    places' pieces, in order: ``k`` chunks along ``dim``, or its ``k``
    slices there when not ``tiled`` (a module attribute, so that a fault
    check can reorder them)."""
    return list(x.chunk(k, dim=dim)) if tiled else list(x.unbind(dim))


def _join(xs, dim: int, tiled: bool) -> torch.Tensor:
    """This process's chunks as one block: joined along ``dim``, or
    stacked on a new axis there when not ``tiled``."""
    home = xs[0].device
    xs = [x.to(home) for x in xs]
    if not tiled:
        return torch.stack(xs, dim=dim)
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=dim)


def _grads_home(g, xs_devices) -> tuple:
    return tuple(g.to(d) for d in xs_devices)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The processes' blocks ``x`` joined along ``dim`` in group order."""
    pieces = group.pg.all_gather_flat(x, group).view(group.size, *x.shape)
    return torch.cat(pieces.unbind(0), dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over the processes, this one keeping its block along
    ``dim``."""
    n = group.size
    if x.shape[dim] % n:
        raise ValueError(f"scatter axis of size {x.shape[dim]} not "
                         f"divisible by {n} processes")
    pieces = x.chunk(n, dim=dim)
    out = group.pg.reduce_scatter_flat(torch.stack(pieces), group)
    return out.view(pieces[0].shape)


def _own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(group.size, dim=dim)[group.index].contiguous()


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return group.pg.all_reduce(x.detach().clone(), op, group=group)


class _AllGather(torch.autograd.Function):
    """This process's chunks joined and gathered over the processes along
    ``dim``; the backward sums the gradient over the processes and keeps
    this one's block (a reduce-scatter), or, with ``keep_piece``, keeps
    its block alone (``gather_from_group``), then splits it into the
    chunks' pieces (``local_split``)."""

    @staticmethod
    def forward(ctx, group, dim, tiled, keep_piece, *xs):
        ctx.args = (group, dim, tiled, keep_piece, [x.device for x in xs])
        return _gather(_join(xs, dim, tiled), group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, tiled, keep_piece, devices = ctx.args
        block = (_own_block if keep_piece else _scatter_sum)(g, group, dim)
        pieces = local_split(block, len(devices), dim, tiled)
        return (None,) * 4 + tuple(p.contiguous().to(d)
                                   for p, d in zip(pieces, devices))


class _ReduceScatter(torch.autograd.Function):
    """The chunks summed here and over the processes, each place keeping
    its piece along ``dim``; the backward gathers the gradient."""

    @staticmethod
    def forward(ctx, group, dim, tiled, *xs):
        ctx.args = (group, dim, tiled, [x.device for x in xs])
        n = len(xs) * group.size
        total = local_sum(xs)
        if tiled and total.shape[dim] % n or \
                not tiled and total.shape[dim] != n:
            raise ValueError(f"scatter axis of size {total.shape[dim]} does "
                             f"not divide over {n} ranks")
        block = _scatter_sum(total, group, dim).to(xs[0].dtype)
        return tuple(p.contiguous().to(d) for p, d in zip(
            local_split(block, len(xs), dim, tiled), ctx.args[3]))

    @staticmethod
    def backward(ctx, *gs):
        group, dim, tiled, devices = ctx.args
        full = _gather(_join(gs, dim, tiled), group, dim)
        return (None,) * 3 + _grads_home(full, devices)


class _AllReduce(torch.autograd.Function):
    """The sum of the chunks here and over the processes; the backward is
    the same sum (``psum``'s VJP) or, with ``identity_backward``, the
    identity across processes (``reduce_from_group``), each chunk taking
    the gradient of the sum."""

    @staticmethod
    def forward(ctx, group, identity_backward, *xs):
        ctx.args = (group, identity_backward, [x.device for x in xs])
        return _all_reduce(local_sum(xs), group).to(xs[0].dtype)

    @staticmethod
    def backward(ctx, g):
        group, identity, devices = ctx.args
        return (None, None) + _grads_home(
            g if identity else _all_reduce(g, group), devices)


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


def _permute(xs: list, group, perm) -> list:
    """``ppermute`` over the global indices of this process's chunks:
    moves between them here, and one exchange carrying every chunk bound
    for each other process (the pairs in ``perm``'s order, which sender
    and receiver read alike)."""
    k, me = len(xs), group.index
    out = [None] * k
    sends, recvs = {}, {}
    for s, d in perm:
        src, dst = divmod(s, k), divmod(d, k)
        if src[0] == me and dst[0] == me:
            out[dst[1]] = xs[src[1]].to(xs[dst[1]].device)
        elif src[0] == me:
            sends.setdefault(dst[0], []).append(xs[src[1]])
        elif dst[0] == me:
            recvs.setdefault(src[0], []).append(dst[1])
    if not sends and not recvs:
        return [torch.zeros_like(x) if o is None else o
                for o, x in zip(out, xs)]
    like = xs[0]
    got = group.pg.exchange(
        {q: torch.cat([t.reshape(-1) for t in ts])
         for q, ts in sends.items()},
        {q: ((len(js) * like.numel(),), like.dtype, like.device)
         for q, js in recvs.items()}, group)
    for q, js in recvs.items():
        for j, piece in zip(js, got[q].split(like.numel())):
            out[j] = piece.view(like.shape).to(xs[j].device)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


class _Permute(torch.autograd.Function):
    """``ppermute`` across processes; the backward sends the gradient
    back along the reversed pairs."""

    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.args = (group, perm)
        return tuple(_permute(list(xs), group, perm))

    @staticmethod
    def backward(ctx, *gs):
        group, perm = ctx.args
        return (None, None) + tuple(
            _permute(list(gs), group, [(d, s) for s, d in perm]))


def _all_to_all(xs: list, group, split: int, concat: int) -> list:
    """The tiled ``all_to_all`` over the ``n = k·size`` global ranks:
    every chunk cut into ``n`` pieces along ``split``; piece ``j`` of
    every chunk, joined in global order along ``concat``, to rank ``j``.
    One exchange: to each process the pieces of its ``k`` ranks from
    each chunk here."""
    k, m = len(xs), group.size
    n = k * m
    home = xs[0].device
    pieces = [x.to(home).chunk(n, dim=split) for x in xs]
    shape = pieces[0][0].shape
    send = torch.stack([pieces[i][q * k + j] for q in range(m)
                        for i in range(k) for j in range(k)])
    count = k * k * math.prod(shape)
    got = group.pg.all_to_all_flat(send, [count] * m, [count] * m, group)
    got = got.view(m, k, k, *shape)
    return [torch.cat([got[q, i, j] for q in range(m) for i in range(k)],
                      dim=concat).to(xs[j].device) for j in range(k)]


class _AllToAll(torch.autograd.Function):
    """The tiled ``all_to_all``; the backward is the inverse one."""

    @staticmethod
    def forward(ctx, group, split, concat, *xs):
        ctx.args = (group, split, concat)
        return tuple(_all_to_all(list(xs), group, split, concat))

    @staticmethod
    def backward(ctx, *gs):
        group, split, concat = ctx.args
        return (None,) * 3 + tuple(_all_to_all(list(gs), group, concat,
                                               split))


def _exchange(x: torch.Tensor, group, dim: int, send: list, recv: list,
              width: int) -> torch.Tensor:
    """Ranges of ``x`` along ``dim`` to the processes of ``group`` in one
    ``all_to_all``: ``send[j]`` the (offset, width) pieces of ``x`` for
    process ``j``, ``recv[i]`` where in the result (``width`` along
    ``dim``, zero elsewhere) what process ``i`` sends lands, in the same
    order, added up where pieces land on one range (the backward of
    ranges that several ranks want)."""
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
            out[..., a:a + w] += got[at:at + n_rest * w].view(*rest, w)
            at += n_rest * w
    return out.movedim(-1, dim)


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


def _on_places(y: torch.Tensor, xs: list) -> list:
    return [y.to(x.device) for x in xs]


def reduce_from_group(xs: list, group) -> list:
    """Megatron's ``g``: the sum over this process's chunks and
    ``group``'s processes forward, the identity across processes
    backward (module docstring)."""
    return _on_places(_AllReduce.apply(group, True, *xs), xs)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: the identity forward, the sum over ``group``'s
    processes backward (module docstring)."""
    return _Copy.apply(x, group)


def gather_from_group(xs: list, *, gather_axis: int = 0, tiled: bool = True,
                      group) -> list:
    """All-gather over this process's chunks and ``group``'s processes
    whose backward keeps this process's block of the gradient: for a
    tensor whose consumers every process of the group runs alike (module
    docstring)."""
    return _on_places(_AllGather.apply(group, gather_axis, tiled, True, *xs),
                      xs)


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
        return _on_places(_AllReduce.apply(group, False, *xs), xs)
    total = _sum(xs)
    return _on_ranks([total] * len(xs), xs)


def pmean(xs: list) -> list:
    total = _reduce(xs, torch.add) / len(xs)
    return _on_ranks([total] * len(xs), xs)


def pmax(xs: list, *, group=None) -> list:
    """The maximum over the ranks (across processes, no gradient)."""
    if group is not None:
        top = _reduce([x.detach() for x in xs], torch.maximum)
        return _on_places(_all_reduce(top, group, "max"), xs)
    top = _reduce(xs, torch.maximum)
    return _on_ranks([top] * len(xs), xs)


def all_gather(xs: list, *, gather_axis: int = 0, tiled: bool = True,
               group=None) -> list:
    """Every rank gets all chunks joined along ``gather_axis`` (stacked on
    a new axis there when not ``tiled``)."""
    if group is not None:
        return _on_places(_AllGather.apply(group, gather_axis, tiled, False,
                                           *xs), xs)
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
        return list(_ReduceScatter.apply(group, scatter_axis, tiled, *xs))
    n = len(xs)
    total = _sum(xs)
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
        return list(_Permute.apply(group, tuple(map(tuple, perm)), *xs))
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for o, x in zip(out, xs)]


def ring_shift(xs: list, *, shift: int = 1, group=None) -> list:
    """Shift values around the ring: rank ``(i + shift) % n`` receives rank
    ``i``'s chunk (the building block of ring attention)."""
    n = axis_size(xs, group=group)
    return ppermute(xs, [(i, (i + shift) % n) for i in range(n)],
                    group=group)


def all_to_all(xs: list, *, split_axis: int, concat_axis: int,
               tiled: bool = True, group=None) -> list:
    """Rank ``i`` splits its chunk into n pieces along ``split_axis``; rank
    ``j`` receives piece ``j`` of every rank, joined in rank order along
    ``concat_axis`` (tiled; only the tiled form is ported)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    n = axis_size(xs, group=group)
    for x in xs:
        if x.shape[split_axis] % n:
            raise ValueError(f"split axis of size {x.shape[split_axis]} not "
                             f"divisible by {n} ranks")
    if group is not None:
        return list(_AllToAll.apply(group, split_axis, concat_axis, *xs))
    pieces = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([p[j].to(xs[j].device) for p in pieces],
                      dim=concat_axis) for j in range(n)]


def _overlaps(have: list, lo: int, hi: int) -> list:
    """(rank, start, stop) of every chunk's part of [lo, hi), in rank
    order."""
    return [(i, max(lo, a), min(hi, b)) for i, (a, b) in enumerate(have)
            if max(lo, a) < min(hi, b)]


def _regroup_across(xs, have, want, dim, group):
    """``regroup`` of this process's ``k`` chunks over ``group``: joined
    into the process's one range (the chunks' ranges must be adjacent),
    one exchange, each process sending every other the parts of its range
    they want, and the result split into the ``k`` places' wants."""
    k, me = len(xs), group.index
    mine = have[me * k:(me + 1) * k]
    if any(a[1] != b[0] for a, b in zip(mine, mine[1:])):
        raise ValueError(f"the ranges {mine} of one process are not "
                         "adjacent")
    have = [(have[p * k][0], have[p * k + k - 1][1])
            for p in range(group.size)]
    wants = [want[p * k:(p + 1) * k] for p in range(group.size)]
    want = [[r for ranges in w for r in ranges] for w in wants]
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
    dim = dim % xs[0].dim()
    out = _Exchange.apply(_join(xs, dim, True), group, dim, send, recv, at)
    widths = [sum(hi - lo for lo, hi in ranges) for ranges in wants[me]]
    return [p.to(x.device) for p, x in zip(out.split(widths, dim=dim), xs)]


def regroup(xs: list, have: list, want: list, *, dim: int = -1,
            group=None) -> list:
    """Ranges of one index space moved between ranks: chunk ``i`` holds
    indices ``have[i]`` (a ``(start, stop)`` range) along ``dim``; rank
    ``j`` gets the ranges ``want[j]`` (a list of them, joined in order),
    assembled from the pieces of the chunks that overlap them, on rank
    ``j``'s device. The uneven counterpart of a tiled ``all_to_all``
    (GSPMD's reshard between two cuts of one dimension). Across processes
    (``have`` and ``want`` still list every global rank's; this process's
    chunks the adjacent ranges of its ranks) the backward moves the
    gradient's pieces back."""
    if group is not None:
        return _regroup_across(xs, have, want, dim, group)
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
    """The number of ranks along the axis: the chunks here, times the
    processes of ``group``."""
    return len(xs) * (group.size if group is not None else 1)


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
