"""The transport between rank processes: a ``torch.distributed`` process
group over ``tcp://localhost:<port>``.

The counterpart of ``jax.distributed.initialize``
(``ray_tpu/train/worker_group.py:39-41``). The single-controller mesh
(``parallel.mesh``) and its rank-list collectives stay the plane inside a
process; this module carries the collectives between processes, on the
whole group or on a subgroup, one line of a mesh axis whose places are in
different processes (``AxisGroup``, made by ``mesh_layout``):

- ``all_reduce`` (sum, max, or the sum divided for a mean: gloo has no
  AVG on every build), ``broadcast`` and ``all_gather_object``;
- ``all_gather_flat`` and ``reduce_scatter_flat`` into and out of flat
  tensors, ``exchange`` (point-to-point sends and receives posted as one
  ``batch_isend_irecv``, so that no pair of ranks deadlocks on the order
  of blocking sends; a ring shift is one of them; under NCCL every line
  has run a first collective before, ``mesh_layout``) and ``all_to_all_flat``
  (uneven splits), each counted by kind in ``stats``;
- ``all_reduce_grads``: the gradients in flat buckets, one collective per
  bucket rather than one per leaf (a leaf at least a bucket's size is
  reduced in place, by itself), timed on the device by CUDA events, so
  that the host need not wait for the card;
- ``check_same``: a gathered per-leaf checksum, so that ranks that would
  train from different states raise before the first step.

Backends. NCCL carries CUDA tensors between cards; it refuses two ranks on
one GPU, so ``init_process_group`` raises before it starts when the world
is larger than the cards this host has (it never falls back to gloo).
gloo carries CPU tensors, and here CUDA tensors too: each is staged
explicitly through one pinned host buffer, a round of at most
``BUCKET_BYTES`` at a time (copied to the host, reduced, gathered or sent
there, copied back; ``ProcessGroup._run``), and the staging's seconds
and bytes are counted in ``stats``. The NCCL path across several cards
is written but has only run with one rank: the machine it was checked on
has one card.
"""

from __future__ import annotations

import datetime
import itertools
import math
import random
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import ProcessLayout, split_axes

# collectives and the rendezvous fail after this long without progress
DEFAULT_TIMEOUT_S = 300.0
# bytes of one gradient bucket, and the most staged at once (a round)
BUCKET_BYTES = 1 << 28
# the collectives on flat tensors, each counted in ``stats`` under its name
KINDS = ("all_gather", "reduce_scatter", "all_reduce", "send_recv",
         "all_to_all")
# subgroups by their ranks, made once per process group (dist.new_group),
# and the lines whose communicator a first collective has built (NCCL)
_LINES: dict = {}
_WARM: set = set()


def _ephemeral_low() -> int:
    """The first port of the kernel's ephemeral range (Linux's default
    where it cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago (bound and
    released), for a world's rendezvous. Drawn at random below the
    kernel's ephemeral range: a port bound as port 0 comes from that
    range, where an outgoing connection or another process's bind to
    port 0 can take it in the seconds before rank 0 binds it. Bound as
    port 0 if no drawn port is free."""
    low = _ephemeral_low()
    draw = random.SystemRandom()
    for _ in range(32):
        port = draw.randrange(max(1024, low // 2), low)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _check_card(use_gpu: bool) -> None:
    if use_gpu and not torch.cuda.is_available():
        raise RuntimeError(
            "use_gpu=True but torch.cuda.is_available() is False; pass "
            "ScalingConfig(use_gpu=False) to run the ranks on the CPU")


def rank_device(rank: int, use_gpu: bool) -> torch.device:
    """The device of rank ``rank``: card ``rank % device_count`` with
    ``use_gpu`` (raising without a card: a rank never falls back to the
    CPU), else the CPU."""
    if not use_gpu:
        return torch.device("cpu")
    _check_card(use_gpu)
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_backend(backend: str, world_size: int, use_gpu: bool) -> None:
    """Raise for a world this host cannot run over ``backend``: NCCL needs
    a card per rank (it refuses two ranks on one GPU; use gloo there), and
    ``use_gpu`` needs a card."""
    if backend == "nccl":
        if not use_gpu:
            raise ValueError("backend 'nccl' needs use_gpu=True")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise RuntimeError(
                f"NCCL cannot run {world_size} ranks on {cards} card(s): it "
                "needs a card per rank and refuses two ranks on one GPU; "
                "pass backend='gloo' to put several ranks on one card, or "
                "ScalingConfig(use_gpu=False) to run them on the CPU")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    _check_card(use_gpu)


def _nbytes(ins: list, outs: list | None) -> int:
    """The bytes in and out of a collective (``outs`` None: in place)."""
    return sum(t.numel() * t.element_size()
               for t in ins + (ins if outs is None else outs))


def _cuts(n: int, step: int | None) -> list:
    """[a, b) ranges of ``step`` elements covering ``n`` (``step`` None:
    the whole)."""
    if step is None:
        return [(0, n)]
    return [(a, min(a + step, n)) for a in range(0, n, step)]


class ProcessGroup:
    """This process's membership of the group: ``rank`` of
    ``world_size``, its ``device``, and the collectives between the
    ranks. ``stats`` counts the seconds in the gradient all-reduce, in
    each kind of collective on flat tensors (``KINDS``: calls, seconds,
    and the bytes in and out of this rank) and in gloo's staging through
    host memory."""

    def __init__(self, backend: str, rank: int, world_size: int,
                 device: torch.device):
        self.backend, self.rank, self.world_size = backend, rank, world_size
        self.device = torch.device(device)
        self._stats = {"grad_all_reduces": 0, "grad_all_reduce_s": 0.0,
                       "grad_bytes": 0, "staging_s": 0.0, "staged_bytes": 0}
        for kind in KINDS:
            self._stats.update({f"{kind}_calls": 0, f"{kind}_s": 0.0,
                                f"{kind}_bytes": 0})
        self._pinned: dict[torch.dtype, torch.Tensor] = {}
        # (start, end) CUDA events of gradient all-reduces not yet read
        self._pending: list = []

    @property
    def stats(self) -> dict:
        """The counts, the all-reduces still running on the card waited
        for first (read it after the step, whose results the caller reads
        anyway)."""
        for start, end in self._pending:
            end.synchronize()
            self._stats["grad_all_reduce_s"] += start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self._stats

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _pinned_buffer(self, dtype: torch.dtype, numel: int) -> torch.Tensor:
        """The first ``numel`` elements of this dtype's staging buffer
        (pinned where a card is), grown to the largest round staged so
        far: at most ``BUCKET_BYTES``."""
        buf = self._pinned.get(dtype)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype,
                              pin_memory=torch.cuda.is_available())
            self._pinned[dtype] = buf
        return buf[:numel]

    def _stage(self, fn, ins: list, outs: list | None) -> None:
        """One round through the staging buffer: ``ins`` copied to host
        tensors of their shapes, ``fn(host_ins, host_outs)`` on those,
        ``outs`` (None: in place on ``ins``) copied back; the copies
        timed."""
        t0 = time.perf_counter()
        both = ins if outs is None else ins + outs
        sizes = [t.numel() for t in both]
        host = [h.view(t.shape) for h, t in zip(self._pinned_buffer(
            both[0].dtype, sum(sizes)).split(sizes), both)]
        for h, t in zip(host, ins):
            h.copy_(t)
        h_ins = host[:len(ins)]
        h_outs = h_ins if outs is None else host[len(ins):]
        t1 = time.perf_counter()
        fn(h_ins, h_outs)
        t2 = time.perf_counter()
        for t, h in zip(ins if outs is None else outs, h_outs):
            t.copy_(h)
        if both[0].device.type == "cuda":
            torch.cuda.current_stream(both[0].device).synchronize()
        self._stats["staging_s"] += t1 - t0 + time.perf_counter() - t2
        self._stats["staged_bytes"] += _nbytes(ins, outs)

    def _run(self, kind: str | None, rounds, ins: list,
             outs: list | None = None) -> None:
        """A collective from the tensors ``ins`` into ``outs`` (None: in
        place on ``ins``; one dtype), timed and counted under ``kind``
        (None: not by kind). ``rounds(step)`` yields its rounds, each
        ``(fn, ins, outs)``: ``fn(ins, outs)`` on views of the tensors,
        each view at most ``step`` elements along its cut; with ``step``
        None, one round of the whole tensors, run as it is. Under gloo,
        CUDA tensors go through the staging buffer a round at a time:
        ``step`` is ``BUCKET_BYTES`` in elements, which the builder
        divides by the views that stand side by side in a round, so that
        no round stages more; every rank of the group derives the same
        cut."""
        t0 = time.perf_counter()
        both = ins + (outs or [])
        if any(self._staged(t) for t in both):
            step = BUCKET_BYTES // both[0].element_size()
            for fn, r_ins, r_outs in rounds(step):
                self._stage(fn, r_ins, r_outs)
        else:
            for fn, r_ins, r_outs in rounds(None):
                fn(r_ins, r_ins if r_outs is None else r_outs)
        if kind is not None:
            self._stats[f"{kind}_calls"] += 1
            self._stats[f"{kind}_s"] += time.perf_counter() - t0
            self._stats[f"{kind}_bytes"] += _nbytes(ins, outs)

    def _in_place(self, kind: str | None, collective,
                  flat: torch.Tensor) -> None:
        """``collective(t)`` in place on the flat ``flat``, a bucket at a
        time when staged."""
        def rounds(step):
            for a, b in _cuts(flat.numel(), step):
                yield lambda ins, outs: collective(ins[0]), [flat[a:b]], None
        self._run(kind, rounds, [flat])

    def _reduce_flat(self, flat: torch.Tensor, group=None) -> None:
        handle = None if group is None else group.handle
        self._in_place(None, lambda t: dist.all_reduce(t, group=handle),
                       flat)

    # --- collectives ---

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum", *,
                   group=None):
        """``tensor`` summed (``op="sum"``), maximized (``"max"``) or
        averaged (``"mean"``: the sum divided by the group's size) over
        the ranks of ``group`` (an ``AxisGroup``; default: every rank), in
        place; returns it."""
        if op not in ("sum", "mean", "max"):
            raise ValueError(f"unknown op {op!r}")
        handle = None if group is None else group.handle
        flat = tensor.view(-1) if tensor.is_contiguous() else \
            tensor.contiguous().view(-1)
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._in_place("all_reduce", lambda t: dist.all_reduce(
            t, op=red, group=handle), flat)
        if flat.data_ptr() != tensor.data_ptr():
            tensor.copy_(flat.view_as(tensor))
        if op == "mean":
            tensor.div_(self.world_size if group is None else group.size)
        return tensor

    def all_gather_flat(self, x: torch.Tensor, group) -> torch.Tensor:
        """The flat ``x`` of every rank of ``group``, in its order: one
        tensor [size · numel]. Staged, a round is a range of ``x`` and
        that range of every rank's piece of the result."""
        x = x.contiguous().view(-1)
        out = torch.empty(group.size * x.numel(), dtype=x.dtype,
                          device=x.device)
        rows = out.view(group.size, x.numel())

        def run(ins, outs):
            dist.all_gather_into_tensor(outs[0].view(-1), ins[0],
                                        group=group.handle)

        def rounds(step):
            for a, b in _cuts(x.numel(), step and max(
                    1, step // (group.size + 1))):
                yield run, [x[a:b]], [rows[:, a:b]]
        self._run("all_gather", rounds, [x], [out])
        return out

    def reduce_scatter_flat(self, x: torch.Tensor, group) -> torch.Tensor:
        """The flat ``x`` summed over the ranks of ``group``, this rank
        keeping its piece: [numel / size]. Staged, a round is a range of
        the result and that range of each rank's piece of ``x``."""
        x = x.contiguous().view(-1)
        if x.numel() % group.size:
            raise ValueError(f"{x.numel()} elements do not divide over "
                             f"{group.size} ranks")
        out = torch.empty(x.numel() // group.size, dtype=x.dtype,
                          device=x.device)
        rows = x.view(group.size, out.numel())

        def run(ins, outs):
            dist.reduce_scatter_tensor(outs[0], ins[0].view(-1),
                                       group=group.handle)

        def rounds(step):
            for a, b in _cuts(out.numel(), step and max(
                    1, step // (group.size + 1))):
                yield run, [rows[:, a:b]], [out[a:b]]
        self._run("reduce_scatter", rounds, [x], [out])
        return out

    def exchange(self, sends: dict, recvs: dict, group) -> dict:
        """Point-to-point along ``group``: ``sends`` maps a destination
        (an index of the group) to a tensor, ``recvs`` a source to the
        shape, dtype and device of what it sends; all posted as one
        ``batch_isend_irecv`` and waited for. Returns source -> received
        tensor. Staged, round ``j`` posts the ``j``-th range of every
        tensor that has one: a send and its receive are cut alike."""
        got = {src: torch.empty(shape, dtype=dtype, device=device)
               for src, (shape, dtype, device) in recvs.items()}
        posts = [(dist.isend, group.ranks[d], sends[d].contiguous().view(-1))
                 for d in sorted(sends)]
        posts += [(dist.irecv, group.ranks[s], got[s].view(-1))
                  for s in sorted(got)]

        def post(live):
            def run(ins, outs):
                host = {dist.isend: iter(ins), dist.irecv: iter(outs)}
                ops = [dist.P2POp(op, next(host[op]), peer, group.handle)
                       for op, peer, _ in live]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return run

        def rounds(step):
            cuts = [_cuts(t.numel(), step and max(1, step // (2 * group.size)))
                    for _, _, t in posts]
            for j in range(max(map(len, cuts), default=0)):
                live = [(op, peer, t[c[j][0]:c[j][1]])
                        for (op, peer, t), c in zip(posts, cuts)
                        if j < len(c)]
                yield (post(live),
                       [t for op, _, t in live if op is dist.isend],
                       [t for op, _, t in live if op is dist.irecv])
        self._run("send_recv", rounds, [t for op, _, t in posts
                                        if op is dist.isend],
                  [t for op, _, t in posts if op is dist.irecv])
        return got

    def all_to_all_flat(self, x: torch.Tensor, in_splits: list,
                        out_splits: list, group) -> torch.Tensor:
        """``x`` (flat) cut into ``in_splits`` elements, piece ``j`` to
        rank ``j`` of ``group``; returns what every rank sent here, joined
        in rank order (``out_splits`` elements from each). Staged, round
        ``j`` moves the ``j``-th range of every piece (the ranks agree on
        the number of rounds by a max over the group first)."""
        x = x.contiguous().view(-1)
        out = torch.empty(sum(out_splits), dtype=x.dtype, device=x.device)

        def run(i_splits, o_splits):
            return lambda ins, outs: dist.all_to_all_single(
                outs[0], ins[0], list(o_splits), list(i_splits),
                group=group.handle)

        def rounds(step):
            if step is None:
                yield run(in_splits, out_splits), [x], [out]
                return
            step = max(1, step // (2 * group.size))
            n = torch.tensor([-(-max(list(in_splits) + list(out_splits),
                                     default=0)
                                // step)])
            dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group.handle)
            for j in range(int(n)):
                a = j * step
                i_sub = [min(max(s - a, 0), step) for s in in_splits]
                o_sub = [min(max(s - a, 0), step) for s in out_splits]
                send = torch.cat([p[a:a + w] for p, w in zip(
                    x.split(list(in_splits)), i_sub)])
                recv = torch.empty(sum(o_sub), dtype=x.dtype,
                                   device=x.device)
                yield run(i_sub, o_sub), [send], [recv]
                for p, piece in zip(out.split(list(out_splits)),
                                    recv.split(o_sub)):
                    p[a:a + piece.numel()].copy_(piece)
        self._run("all_to_all", rounds, [x], [out])
        return out

    def broadcast(self, tensor: torch.Tensor, src: int = 0):
        """``tensor`` of rank ``src`` copied to every rank, in place."""
        flat = tensor.view(-1) if tensor.is_contiguous() else \
            tensor.contiguous().view(-1)
        self._in_place(None, lambda t: dist.broadcast(t, src=src), flat)
        if flat.data_ptr() != tensor.data_ptr():
            tensor.copy_(flat.view_as(tensor))
        return tensor

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def all_reduce_grads(self, grads: list, group=None) -> None:
        """Sum ``grads`` (distinct tensors, in the same order on every
        rank) over the ranks of ``group`` (an ``AxisGroup``; default:
        every rank) in place. Leaves are packed by dtype into flat buckets
        of ``BUCKET_BYTES`` (one copy in, one collective and one copy out
        per bucket); a leaf of at least a bucket's size is reduced
        in place by itself. On the card its seconds (``stats``) run from
        the end of the kernels queued before it (the backward) to the end
        of its own, by CUDA events: the host does not wait here."""
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t_start = time.perf_counter()
        big, small = [], {}
        for g in grads:
            if g.numel() * g.element_size() >= BUCKET_BYTES and \
                    g.is_contiguous():
                big.append(g)
            else:
                small.setdefault(g.dtype, []).append(g)
        for g in big:
            self._reduce_flat(g.view(-1), group)
        for leaves in small.values():
            bucket, nbytes = [], 0
            for g in leaves + [None]:
                if g is not None and (not bucket or nbytes + g.numel() *
                                      g.element_size() <= BUCKET_BYTES):
                    bucket.append(g)
                    nbytes += g.numel() * g.element_size()
                    continue
                flat = torch.cat([x.reshape(-1) for x in bucket])
                self._reduce_flat(flat, group)
                for x, piece in zip(bucket, flat.split(
                        [x.numel() for x in bucket])):
                    x.copy_(piece.view_as(x))
                bucket, nbytes = ([g], g.numel() * g.element_size()) \
                    if g is not None else ([], 0)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((start, end))
        else:
            self._stats["grad_all_reduce_s"] += time.perf_counter() - t_start
        self._stats["grad_all_reduces"] += 1
        self._stats["grad_bytes"] += sum(g.numel() * g.element_size()
                                         for g in grads)

    def check_same(self, named: list) -> None:
        """Raise unless the ranks hold equal tensors wherever they hold one
        name (``named``: (name, tensor) pairs; a placed leaf's chunk is
        named by its index range, so replicas of one range are compared
        and the chunks of other ranges are not), by a gathered per-leaf
        checksum: the float32 sum and 2-norm of each."""
        with torch.no_grad():
            sums = [torch.stack([t.sum(dtype=torch.float32),
                                 torch.linalg.vector_norm(
                                     t, dtype=torch.float32)])
                    for _, t in named]
        mine = dict(zip([n for n, _ in named],
                        torch.stack(sums).cpu().tolist() if sums else []))
        every = self.all_gather_object(mine)
        bad = sorted({name for other in every for name, a in mine.items()
                      if name in other and other[name] != a})
        if bad:
            raise RuntimeError(
                f"rank {self.rank}: the ranks' states differ before the "
                f"first step (checksums of {bad[:8]}"
                f"{' ...' if len(bad) > 8 else ''} differ); every rank must "
                "start from the same state (the same init seed)")

    def destroy(self) -> None:
        _LINES.clear()
        _WARM.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


class AxisGroup:
    """One line of a mesh axis whose places lie in different processes:
    the processes along ``axis`` (``ranks``, global ranks in the axis'
    order) at this process's index of every other spanned axis, this
    process at ``index`` of ``size``. ``handle`` is the
    ``torch.distributed`` group (None: the whole world); ``pg`` runs the
    collectives."""

    def __init__(self, pg, axis: str, ranks: tuple, handle):
        self.pg, self.axis, self.ranks, self.handle = pg, axis, ranks, handle
        self.size = len(ranks)
        self.index = ranks.index(pg.rank)

    def __repr__(self) -> str:
        return (f"AxisGroup({self.axis!r}, ranks={list(self.ranks)}, "
                f"index={self.index})")


def _line(ranks: tuple, world: int):
    """The group of ``ranks`` (None for the whole world), made by
    ``dist.new_group`` the first time: every process asks for every line
    in one order, as ``new_group`` requires, whether or not it is in
    it."""
    if len(ranks) == world:
        return None
    if ranks not in _LINES:
        _LINES[ranks] = dist.new_group(list(ranks))
    return _LINES[ranks]


def _warm(pg, ranks: tuple, handle) -> None:
    """Under NCCL, one small all-reduce on the line ``ranks`` the first
    time this process meets it. NCCL builds a group's communicator at
    its first collective, and a ``batch_isend_irecv`` that comes first
    must be posted by every rank of the group, which the 1F1B's first
    ticks are not (on three or more stages only stages 0 and 1 post).
    Every process warms its lines in the order every process made them,
    so no two processes wait on each other's lines in turn. gloo needs
    none."""
    if getattr(pg, "backend", None) != "nccl" or ranks in _WARM:
        return
    dist.all_reduce(torch.zeros(1, device=pg.device), group=handle)
    _WARM.add(ranks)


def mesh_layout(pg, axes: dict) -> ProcessLayout:
    """This process's part of the global mesh ``axes`` when ``pg``'s
    ranks share it (``parallel.mesh.split_axes``): its index along each
    spanned axis, a cut one too (the rank unravelled over the spanned
    axes, row-major) and its ``AxisGroup`` on each. Every process makes
    the subgroups of every line, in the same order, then (under NCCL)
    runs a first collective on each of its own lines, in that order
    (``_warm``)."""
    local, procs = split_axes(axes, pg.world_size)
    names = list(procs)
    sizes = [procs[a] for a in names]
    grid = np.arange(pg.world_size).reshape(sizes) if names else None
    coords = dict(zip(names, map(int, np.unravel_index(pg.rank, sizes)))) \
        if names else {}
    groups, mine = {}, []
    for i, axis in enumerate(names):
        others = [range(n) for j, n in enumerate(sizes) if j != i]
        for at in itertools.product(*others):
            index = list(at)
            index.insert(i, slice(None))
            ranks = tuple(int(r) for r in grid[tuple(index)])
            handle = _line(ranks, pg.world_size)
            if pg.rank in ranks:
                groups[axis] = AxisGroup(pg, axis, ranks, handle)
                mine.append((ranks, handle))
    assert math.prod(sizes) == pg.world_size
    for ranks, handle in mine:
        _warm(pg, ranks, handle)
    return ProcessLayout(rank=pg.rank, world=pg.world_size, local=local,
                         procs=procs, index=coords, groups=groups)


def init_process_group(backend: str, rank: int, world_size: int, port: int,
                       *, use_gpu: bool = True,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessGroup:
    """Join the group of ``world_size`` ranks as ``rank`` over
    ``tcp://localhost:<port>`` (rank 0 serves the rendezvous there), with
    ``backend`` "nccl" or "gloo", and return this rank's
    ``ProcessGroup``. With ``use_gpu`` (the default; ``False`` for a rank
    on the CPU) the rank's card (``rank_device``) becomes the current
    device first."""
    check_backend(backend, world_size, use_gpu)
    device = rank_device(rank, use_gpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessGroup(backend, rank, world_size, device)
