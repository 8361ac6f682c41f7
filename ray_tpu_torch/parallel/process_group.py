"""The transport between rank processes: a ``torch.distributed`` process
group over ``tcp://localhost:<port>``.

The counterpart of ``jax.distributed.initialize``
(``ray_tpu/train/worker_group.py:39-41``). The single-controller mesh
(``parallel.mesh``) and its rank-list collectives stay the plane inside a
process; this module carries the few collectives the train harness needs
between processes, one process per index of the global mesh's ``dp``
axis:

- ``all_reduce`` (sum, then divide for a mean: gloo has no AVG on every
  build), ``broadcast`` and ``all_gather_object``;
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
explicitly through one pinned host buffer (copied to the host, reduced or
broadcast there, copied back), and the staging's seconds and bytes are
counted in ``stats``. The NCCL path across several cards is written but
has only run with one rank: the machine it was checked on has one card.
"""

from __future__ import annotations

import datetime
import socket
import time

import torch
import torch.distributed as dist

# collectives and the rendezvous fail after this long without progress
DEFAULT_TIMEOUT_S = 300.0
# bytes of one gradient bucket (and of the largest piece staged at once)
BUCKET_BYTES = 1 << 28


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago (bound as port 0
    and released)."""
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


class ProcessGroup:
    """This process's membership of the group: ``rank`` of
    ``world_size``, its ``device``, and the collectives between the
    ranks. ``stats`` counts the seconds in the gradient all-reduce and in
    gloo's staging through host memory."""

    def __init__(self, backend: str, rank: int, world_size: int,
                 device: torch.device):
        self.backend, self.rank, self.world_size = backend, rank, world_size
        self.device = torch.device(device)
        self._stats = {"grad_all_reduces": 0, "grad_all_reduce_s": 0.0,
                       "grad_bytes": 0, "staging_s": 0.0, "staged_bytes": 0}
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
        """The first ``numel`` elements of this dtype's pinned staging
        buffer, grown to the largest piece staged so far."""
        buf = self._pinned.get(dtype)
        if buf is None or buf.numel() < numel:
            buf = torch.empty(numel, dtype=dtype, pin_memory=True)
            self._pinned[dtype] = buf
        return buf[:numel]

    def _on_flat(self, collective, flat: torch.Tensor) -> None:
        """``collective(t)`` (in place) on a contiguous 1-d tensor; a CUDA
        tensor under gloo goes through the pinned buffer a bucket at a
        time, the staging timed."""
        if not self._staged(flat):
            collective(flat)
            return
        step = BUCKET_BYTES // flat.element_size()
        for piece in flat.split(step):
            t0 = time.perf_counter()
            host = self._pinned_buffer(piece.dtype, piece.numel())
            host.copy_(piece)
            t1 = time.perf_counter()
            collective(host)
            t2 = time.perf_counter()
            piece.copy_(host)
            torch.cuda.current_stream(piece.device).synchronize()
            self._stats["staging_s"] += t1 - t0 + time.perf_counter() - t2
            self._stats["staged_bytes"] += 2 * piece.numel() * \
                piece.element_size()

    def _reduce_flat(self, flat: torch.Tensor) -> None:
        self._on_flat(dist.all_reduce, flat)

    # --- collectives ---

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
        """``tensor`` summed (``op="sum"``) or averaged (``"mean"``: the
        sum divided by the world size) over the ranks, in place; returns
        it."""
        if op not in ("sum", "mean"):
            raise ValueError(f"unknown op {op!r}")
        flat = tensor.view(-1) if tensor.is_contiguous() else \
            tensor.contiguous().view(-1)
        self._reduce_flat(flat)
        if flat.data_ptr() != tensor.data_ptr():
            tensor.copy_(flat.view_as(tensor))
        if op == "mean":
            tensor.div_(self.world_size)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0):
        """``tensor`` of rank ``src`` copied to every rank, in place."""
        flat = tensor.view(-1) if tensor.is_contiguous() else \
            tensor.contiguous().view(-1)
        self._on_flat(lambda t: dist.broadcast(t, src=src), flat)
        if flat.data_ptr() != tensor.data_ptr():
            tensor.copy_(flat.view_as(tensor))
        return tensor

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def all_reduce_grads(self, grads: list) -> None:
        """Sum ``grads`` (distinct tensors, in the same order on every
        rank) over the ranks in place. Leaves are packed by dtype into flat
        buckets of ``BUCKET_BYTES`` (one copy in, one collective and one
        copy out per bucket); a leaf of at least a bucket's size is reduced
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
            self._reduce_flat(g.view(-1))
        for leaves in small.values():
            bucket, nbytes = [], 0
            for g in leaves + [None]:
                if g is not None and (not bucket or nbytes + g.numel() *
                                      g.element_size() <= BUCKET_BYTES):
                    bucket.append(g)
                    nbytes += g.numel() * g.element_size()
                    continue
                flat = torch.cat([x.reshape(-1) for x in bucket])
                self._reduce_flat(flat)
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
        """Raise unless every rank holds the same tensors ``named`` ((name,
        tensor) pairs, in the same order on every rank), by a gathered
        per-leaf checksum: the float32 sum and 2-norm of each."""
        with torch.no_grad():
            sums = [torch.stack([t.sum(dtype=torch.float32),
                                 torch.linalg.vector_norm(
                                     t, dtype=torch.float32)])
                    for _, t in named]
        mine = torch.stack(sums).cpu().tolist() if sums else []
        every = self.all_gather_object(mine)
        bad = sorted({name for other in every
                      for (name, _), a, b in zip(named, mine, other)
                      if a != b})
        if bad or any(len(o) != len(mine) for o in every):
            raise RuntimeError(
                f"rank {self.rank}: the ranks' states differ before the "
                f"first step (checksums of {bad[:8]}"
                f"{' ...' if len(bad) > 8 else ''} differ); every rank must "
                "start from the same state (the same init seed)")

    def destroy(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


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
