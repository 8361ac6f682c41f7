"""Host-level collective communication between actors and tasks.

Reference analog: ``python/ray/util/collective/`` (``GroupManager:40``,
``init_collective_group:120``, ``allreduce:258``, ``send:531``), which
wraps NCCL and Gloo. This is the port's host data plane, as JAX's is:
device collectives between rank processes stay in ``parallel/`` (over
``torch.distributed``). Arrays are numpy arrays or torch tensors (a CUDA
tensor is copied to the host first, a bf16 one promoted to float32);
results are numpy arrays, as JAX's.

Two backends. ``"actor"``: rendezvous through a named coordinator actor
a group, with numpy reductions. ``"tcp"``: the actor only pairs the
ranks' listener addresses; the bytes then move peer to peer through the
port's copy of the C++ TCP ring (``_private/tcp_collective.py``).

API parity: init_collective_group, allreduce, allgather, reducescatter,
broadcast, barrier, send/recv (point-to-point).
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.tcp_collective import TcpGroup, host_array

_REDUCERS = {
    "sum": lambda arrs: np.sum(arrs, axis=0),
    "prod": lambda arrs: np.prod(arrs, axis=0),
    "max": lambda arrs: np.max(arrs, axis=0),
    "min": lambda arrs: np.min(arrs, axis=0),
}


class _Coordinator:
    """Rendezvous actor: collects per-rank contributions round by round,
    computes the collective, and hands each rank its share."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.rounds: dict = {}     # (op_name, round_id) -> {rank: array}
        self.results: dict = {}    # (op_name, round_id) -> result
        self.mailbox: dict = {}    # (src, dst, tag) -> value
        self.rdv_pending: dict = {}  # rank -> [(uid, addr)], FIFO
        self.rdv_done: dict = {}     # uid -> [addr by rank]
        # contribute() runs on concurrent actor threads (max_concurrency>1)
        self._lock = threading.Lock()

    def contribute(self, op_name, round_id, rank, value, spec=None):
        key = (op_name, round_id)
        with self._lock:
            slot = self.rounds.setdefault(key, {})
            slot[rank] = value
            if len(slot) == self.world_size and key in self.rounds:
                self.results[key] = self._compute(op_name, slot, spec)
                del self.rounds[key]
        return True

    def fetch(self, op_name, round_id, rank):
        key = (op_name, round_id)
        with self._lock:
            if key not in self.results:
                return False, None
            result = self.results[key]
        out = result[rank] if op_name.startswith("reducescatter") else result
        return True, out

    def gc_round(self, op_name, round_id):
        with self._lock:
            self.results.pop((op_name, round_id), None)
        return True

    def _compute(self, op_name, slot, spec):
        values = [slot[r] for r in sorted(slot)]
        if op_name.startswith("allreduce"):
            return _REDUCERS[spec or "sum"](
                [np.asarray(v) for v in values])
        if op_name.startswith("allgather"):
            return list(values)
        if op_name.startswith("reducescatter"):
            reduced = _REDUCERS[spec or "sum"](
                [np.asarray(v) for v in values])
            return np.array_split(reduced, self.world_size)
        if op_name.startswith("broadcast"):
            return values[int(spec or 0)]
        if op_name.startswith("barrier"):
            return True
        raise ValueError(op_name)

    def post(self, src, dst, tag, value):
        with self._lock:
            self.mailbox[(src, dst, tag)] = value
        return True

    def take(self, src, dst, tag):
        with self._lock:
            if (src, dst, tag) in self.mailbox:
                return True, self.mailbox.pop((src, dst, tag))
        return False, None

    # -- address rendezvous (epoch-based, safe across group re-init) ----
    # A plain collective round would be wrong here: this named actor
    # outlives group incarnations, and a re-init with the same group name
    # must not see a previous incarnation's frozen round-0 result. Each
    # caller posts (rank, addr, uid); an epoch freezes when every rank
    # has one queued entry, and results are keyed by the per-incarnation
    # uid, so overlapping incarnations pair up FIFO per rank.

    def rdv_post(self, rank, addr, uid):
        with self._lock:
            pending = self.rdv_pending
            pending.setdefault(rank, []).append((uid, addr))
            if all(pending.get(r) for r in range(self.world_size)):
                entries = [pending[r].pop(0)
                           for r in range(self.world_size)]
                peers = [a for _, a in entries]
                for u, _ in entries:
                    self.rdv_done[u] = peers
        return True

    def rdv_fetch(self, uid):
        with self._lock:
            if uid in self.rdv_done:
                return True, self.rdv_done.pop(uid)
        return False, None

    def rdv_abandon(self, rank, uid):
        """Withdraw a posted-but-unpaired entry (caller timed out). This
        keeps a crashed/given-up incarnation from sitting at the head of
        the rank's FIFO and poisoning every later epoch with a dead
        address."""
        with self._lock:
            q = self.rdv_pending.get(rank, [])
            self.rdv_pending[rank] = [(u, a) for (u, a) in q if u != uid]
            self.rdv_done.pop(uid, None)
        return True


class CollectiveGroup:
    def __init__(self, group_name: str, world_size: int, rank: int):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._round = 0
        name = f"__collective_{group_name}"
        try:
            self.coord = ray_tpu_torch.get_actor(name)
        except ValueError:
            cls = ray_tpu_torch.remote(_Coordinator)
            try:
                self.coord = cls.options(name=name,
                                         max_concurrency=max(
                                             4, world_size)).remote(world_size)
            except ValueError:
                self.coord = ray_tpu_torch.get_actor(name)

    def _collective(self, op: str, value, spec=None, timeout=60.0):
        round_id = self._round
        self._round += 1
        ray_tpu_torch.get(self.coord.contribute.remote(
            op, round_id, self.rank, value, spec))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ok, out = ray_tpu_torch.get(self.coord.fetch.remote(
                op, round_id, self.rank))
            if ok:
                if self.rank == 0:
                    # rank 0 GCs the round after a grace period; cheap and
                    # avoids unbounded result growth
                    self._maybe_gc(op, round_id)
                return out
            time.sleep(0.002)
        raise TimeoutError(
            f"collective {op} round {round_id} timed out in "
            f"group {self.group_name!r}")

    def _maybe_gc(self, op, round_id, keep: int = 8):
        if round_id >= keep:
            self.coord.gc_round.remote(op, round_id - keep)

    # -- the API (numpy or torch in, numpy out) -------------------------
    def allreduce(self, array, op: str = "sum"):
        return self._collective("allreduce", host_array(array), op)

    def allgather(self, array) -> list:
        return self._collective("allgather", host_array(array))

    def reducescatter(self, array, op: str = "sum"):
        return self._collective("reducescatter", host_array(array), op)

    def broadcast(self, array, src_rank: int = 0):
        return self._collective("broadcast", host_array(array),
                                str(src_rank))

    def barrier(self):
        return self._collective("barrier", self.rank)

    def send(self, array, dst_rank: int, tag: int = 0):
        ray_tpu_torch.get(self.coord.post.remote(
            self.rank, dst_rank, tag, host_array(array)))

    def recv(self, src_rank: int, tag: int = 0, timeout: float = 60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ok, value = ray_tpu_torch.get(self.coord.take.remote(
                src_rank, self.rank, tag))
            if ok:
                return value
            time.sleep(0.002)
        raise TimeoutError(f"recv from rank {src_rank} timed out")

    def destroy(self):
        """Release backend resources (no-op for the actor backend; the
        named coordinator outlives incarnations by design)."""


class TcpCollectiveGroup(CollectiveGroup):
    """Direct rank-to-rank data plane over the C++ TCP backend (the
    port's ``csrc/host/tcp_collective.cc``): ring allreduce etc. without
    the coordinator-actor hop. The actor is used ONCE, for address
    rendezvous; all tensor bytes then move peer-to-peer.

    Analog of the reference's gloo collective group
    (``collective_group/gloo_collective_group.py``) with the rendezvous
    store replaced by the named coordinator actor.
    """

    def __init__(self, group_name: str, world_size: int, rank: int):
        super().__init__(group_name, world_size, rank)
        # Bind the listener FIRST (ephemeral port), then advertise the
        # actually-bound address — no reserve/close/rebind race.
        tcp = TcpGroup.listen(rank, world_size)
        host = "127.0.0.1"
        uid = uuid.uuid4().hex
        ray_tpu_torch.get(self.coord.rdv_post.remote(
            rank, f"{host}:{tcp.port}", uid))
        deadline = time.monotonic() + 60.0
        while True:
            ok, peers = ray_tpu_torch.get(self.coord.rdv_fetch.remote(uid))
            if ok:
                break
            if time.monotonic() > deadline:
                # withdraw our entry so this incarnation can't poison
                # later epochs with a dead listener address
                ray_tpu_torch.get(self.coord.rdv_abandon.remote(rank, uid))
                raise TimeoutError(
                    f"collective group {group_name!r} rendezvous timed out")
            time.sleep(0.002)
        self._tcp = tcp.connect([str(a) for a in peers])

    def allreduce(self, array, op: str = "sum"):
        return self._tcp.allreduce(array, op)

    def allgather(self, array) -> list:
        return self._tcp.allgather(array)

    def reducescatter(self, array, op: str = "sum"):
        return self._tcp.reducescatter(array, op)

    def broadcast(self, array, src_rank: int = 0):
        return self._tcp.broadcast(array, src_rank)

    def barrier(self):
        self._tcp.barrier()
        return True

    def send(self, array, dst_rank: int, tag: int = 0):
        self._tcp.send(array, dst_rank, tag)

    def recv(self, src_rank: int, tag: int = 0, timeout: float = 60.0):
        return self._tcp.recv(src_rank, tag, timeout=timeout)

    def destroy(self):
        self._tcp.destroy()


_groups = threading.local()


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default",
                          backend: str = "actor") -> CollectiveGroup:
    """``backend="actor"``: rendezvous-actor star (works anywhere, object
    path). ``backend="tcp"``: C++ ring collectives over direct sockets —
    the high-bandwidth host data plane."""
    if backend == "tcp":
        group = TcpCollectiveGroup(group_name, world_size, rank)
    else:
        group = CollectiveGroup(group_name, world_size, rank)
    if not hasattr(_groups, "groups"):
        _groups.groups = {}
    _groups.groups[group_name] = group
    return group


def get_group(group_name: str = "default") -> CollectiveGroup:
    groups = getattr(_groups, "groups", {})
    if group_name not in groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return groups[group_name]


def allreduce(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(array, op)


def allgather(array, group_name: str = "default"):
    return get_group(group_name).allgather(array)


def reducescatter(array, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).reducescatter(array, op)


def broadcast(array, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank)


def barrier(group_name: str = "default"):
    return get_group(group_name).barrier()


def send(array, dst_rank: int, group_name: str = "default", tag: int = 0):
    """Point-to-point send (reference: collective.py:531)."""
    return get_group(group_name).send(array, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout: float = 60.0):
    """Point-to-point receive; returns the array."""
    return get_group(group_name).recv(src_rank, tag, timeout)
