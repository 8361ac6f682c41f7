"""Checkpointing: asynchronous saves with top-k retention, placed
restores.

Port of ``ray_tpu/train/checkpoint.py`` (Orbax there) with ``torch.save``.
One file per step, ``<step>.pt``, written under a temporary name and
renamed, so a partly written file is never listed. A save writes global
arrays, as Orbax does: a placed leaf (``ShardedTensor``) is assembled
from one chunk of each index range. A state cut across processes (a
leaf cut over a mesh axis whose places lie in several processes,
``parallel.mesh``) is written as Orbax writes each device's shards
(``ray_tpu/train/checkpoint.py:1-8``): each process writes its own
chunks, each under its index range, to ``<step>.proc<rank>of<world>.pt``.
Such a save restores, as Orbax's does, onto any layout: ``restore``
assembles each leaf from the chunks of every process's file, whole in
one process (no ``shardings``) or into the index ranges of the places of
another mesh, of any world, by copies alone (bit for bit). A missing
file, a missing chunk, or index ranges that do not tile a leaf raise,
naming the leaf; nothing is padded. ``all_steps`` and ``latest_step``
list a per-process save once every process's file of it is on disk. An
asynchronous save copies the
state to the host before ``save`` returns (the trainer updates its
tensors in place, so a later step would otherwise tear the write) and
writes it on one background thread. Retention keeps the newest
``max_to_keep`` steps, as Orbax does without a metric. ``restore(...,
shardings=)`` places every restored leaf by a tree of ``NamedSharding``s
(``Trainer.state_shardings()``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.sharding import (ShardedTensor, device_put,
                                             map_trees)
from ray_tpu_torch.train.optim import tree_leaves
from ray_tpu_torch.train.state import TrainState

# the marker of a leaf saved as this process's chunks
_CHUNKS = "__chunks__"
# a per-process file: <step>.proc<rank>of<world>.pt
_PROC_FILE = re.compile(r"(\d+)\.proc(\d+)of(\d+)\.pt")


def _as_tree(state: Any):
    """A ``TrainState`` as a dictionary of its fields (no copies, unlike
    ``dataclasses.asdict``); any other state as it is."""
    if isinstance(state, TrainState):
        return {f.name: getattr(state, f.name)
                for f in dataclasses.fields(state)}
    return state


def _range_key(idx) -> str:
    return ",".join(f"{s.start}:{s.stop}" for s in idx)


def _host(x):
    """A host copy of a tensor or of a placed tensor's global value; of a
    tensor cut across processes, this process's distinct chunks by index
    range."""
    if isinstance(x, ShardedTensor):
        if not x.sharding.spans_processes():
            return x.unshard(device="cpu")
        indices = x.sharding.indices(x.shape)
        return {_CHUNKS: list(x.shape), "dtype": str(x.dtype).split(".")[-1],
                "chunks": {_range_key(indices[place]):
                           c.detach().to("cpu", copy=True)
                           for place, c in x.distinct()}}
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def _process(tree) -> tuple | None:
    """(rank, world) of this process when a leaf of ``tree`` (placed
    tensors or shardings) is cut across processes, else None."""
    for x in tree_leaves(tree):
        sharding = getattr(x, "sharding", x)
        if hasattr(sharding, "spans_processes") and \
                sharding.spans_processes():
            layout = sharding.mesh.layout
            return layout.rank, layout.world
    return None


def _to_host(state: Any) -> dict:
    """A host copy of ``state`` that later in-place updates cannot touch,
    every leaf global or, cut across processes, this process's chunks."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _host(node)
    return {"train_state": isinstance(state, TrainState),
            "tree": walk(_as_tree(state))}


def _range(key: str) -> tuple:
    """A chunk's index range from its key: ((start, stop), ...)."""
    return tuple(tuple(int(x) for x in part.split(":"))
                 for part in key.split(",")) if key else ()


def _check_tiles(path: str, shape, keys) -> None:
    """Raise, naming the leaf, unless the saved ranges ``keys`` tile
    ``shape``: along each dimension their intervals cut [0, n) into
    pieces without gap or overlap, and every block of that grid is
    saved."""
    ranges = [_range(k) for k in keys]
    grid = [sorted({r[d] for r in ranges}) for d in range(len(shape))]
    for d, pieces in enumerate(grid):
        bounds = [0] + [x for piece in pieces for x in piece] + [shape[d]]
        if any(a != b for a, b in zip(bounds[::2], bounds[1::2])):
            raise ValueError(
                f"{path}: the saved chunks {sorted(keys)} do not tile dim "
                f"{d} of the {list(shape)} leaf (a chunk is missing, or "
                "the files come from different saves)")
    missing = set(itertools.product(*grid)) - set(ranges)
    if missing:
        raise ValueError(f"{path}: the checkpoint holds no chunk "
                         f"{_range_key([slice(*r) for r in sorted(missing)[0]])}"
                         f" of the {list(shape)} leaf ({len(missing)} "
                         "missing)")


def _assemble(leaf: dict, idx, device) -> torch.Tensor:
    """The index range ``idx`` (slices) of a leaf saved as chunks, on
    ``device``: the saved chunk of that range as it is, else a block
    filled by copies of the parts of the chunks that overlap it."""
    key = _range_key(idx)
    if key in leaf["chunks"]:
        return leaf["chunks"][key].to(device, copy=True)
    out = torch.empty([s.stop - s.start for s in idx],
                      dtype=getattr(torch, leaf["dtype"]), device=device)
    for k, chunk in leaf["chunks"].items():
        have = _range(k)
        lo = [max(s.start, a) for s, (a, _) in zip(idx, have)]
        hi = [min(s.stop, b) for s, (_, b) in zip(idx, have)]
        if all(a < b for a, b in zip(lo, hi)):
            out[tuple(slice(a - s.start, b - s.start) for a, b, s in
                      zip(lo, hi, idx))] = chunk[tuple(
                          slice(a - h[0], b - h[0]) for a, b, h in
                          zip(lo, hi, have))]
    return out


def _place(leaf, sharding, device):
    """A restored leaf on ``device`` (``sharding`` None) or placed by
    ``sharding``: a global tensor by ``device_put``; a leaf saved as
    chunks assembled whole (then placed, on a mesh within this process)
    or, cut across processes, each index range of this process's places
    assembled at its place, places with one range on one device sharing
    one tensor."""
    if not isinstance(leaf, dict):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return leaf.to(device) if sharding is None else \
            device_put(leaf, sharding)
    shape = leaf[_CHUNKS]
    whole = tuple(slice(0, n) for n in shape)
    if sharding is None:
        return _assemble(leaf, whole, device)
    if not sharding.spans_processes():
        return device_put(_assemble(leaf, whole, "cpu"), sharding)
    made, chunks = {}, []
    for idx, dev in zip(sharding.indices(shape),
                        sharding.mesh.devices.ravel()):
        key = (_range_key(idx), str(dev))
        if key not in made:
            made[key] = _assemble(leaf, idx, dev)
        chunks.append(made[key])
    return ShardedTensor(shape, getattr(torch, leaf["dtype"]), sharding,
                         chunks)


def _merge(trees: list, path: str = "state"):
    """One tree from the trees of every process's file: a leaf saved as
    chunks gathers every file's chunks (replicas of a range are one
    chunk) and must tile its shape; any other leaf is the first file's
    (every process saved the same global value)."""
    first = trees[0]
    if isinstance(first, dict) and _CHUNKS not in first:
        return {k: _merge([t[k] for t in trees], f"{path}.{k}")
                for k in first}
    if isinstance(first, dict):
        chunks = {}
        for t in trees:
            for k, c in t["chunks"].items():
                chunks.setdefault(k, c)
        _check_tiles(path, first[_CHUNKS], chunks)
        return {**first, "chunks": chunks}
    return first


def _check_like(got, want, path="state"):
    """Raise unless ``got`` has ``want``'s structure, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: checkpoint keys do not match target")
        for k in want:
            _check_like(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (torch.Tensor, ShardedTensor)):
        if isinstance(got, dict) and _CHUNKS in got:
            if tuple(got[_CHUNKS]) == tuple(want.shape) and \
                    got["dtype"] == str(want.dtype).split(".")[-1]:
                return
            raise ValueError(f"{path}: checkpoint holds chunks of "
                             f"{got[_CHUNKS]} {got['dtype']}, target "
                             f"{tuple(want.shape)} {want.dtype}")
        if not isinstance(got, torch.Tensor) or got.shape != want.shape \
                or got.dtype != want.dtype:
            raise ValueError(f"{path}: checkpoint holds "
                             f"{getattr(got, 'shape', got)} "
                             f"{getattr(got, 'dtype', '')}, target "
                             f"{tuple(want.shape)} {want.dtype}")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1) \
            if async_save else None
        self._pending: list[Future] = []

    def _path(self, step: int, process: tuple | None = None) -> Path:
        if process is None:
            return self.directory / f"{step}.pt"
        return self.directory / f"{step}.proc{process[0]}of{process[1]}.pt"

    def _write(self, step: int, payload: dict, process) -> None:
        path = self._path(step, process)
        tmp = path.with_name(f".{path.name}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if self.max_to_keep:
            for old in self.all_steps(process)[:-self.max_to_keep]:
                self._path(old, process).unlink(missing_ok=True)

    def save(self, step: int, state: Any, *, metrics: dict | None = None,
             force: bool = False) -> bool:
        """Save ``state`` (a ``TrainState`` or a dictionary of tensors) as
        ``step``. The host copy is made before this returns; with
        ``async_save`` the write happens on the background thread.
        ``metrics`` are stored beside the state; ``force`` is accepted for
        the JAX signature (every call saves). A state cut across processes
        is saved by every process, each its own chunks (module
        docstring)."""
        del force
        process = _process(_as_tree(state))
        payload = _to_host(state)
        payload["metrics"] = metrics
        if self._writer is None:
            self._write(step, payload, process)
        else:
            self._pending.append(self._writer.submit(self._write, step,
                                                     payload, process))
        return True

    def _scan(self) -> tuple:
        """The steps saved whole, and the per-process files: (step,
        world) -> {rank: path}."""
        whole, procs = set(), {}
        for p in self.directory.glob("*.pt"):
            m = _PROC_FILE.fullmatch(p.name)
            if m:
                step, rank, world = map(int, m.groups())
                procs.setdefault((step, world), {})[rank] = p
            elif p.name[:-3].isdigit():
                whole.add(int(p.name[:-3]))
        return whole, procs

    def _process_files(self, step: int) -> list:
        """The files of a per-process save of ``step``, in rank order;
        raises if one of the world's is missing."""
        found = {world: files for (s, world), files in self._scan()[1].items()
                 if s == step}
        if not found:
            raise FileNotFoundError(f"No checkpoint of step {step} under "
                                    f"{self.directory}")
        if len(found) > 1:
            raise ValueError(f"step {step} under {self.directory} was saved "
                             f"by worlds {sorted(found)}")
        (world, files), = found.items()
        missing = [self._path(step, (r, world)).name for r in range(world)
                   if r not in files]
        if missing:
            raise FileNotFoundError(
                f"step {step} under {self.directory} lacks the per-process "
                f"files {missing}: its leaves cut across processes cannot "
                "be assembled")
        return [files[r] for r in range(world)]

    def restore(self, step: int | None = None, *, target: Any = None,
                shardings: Any = None, device="cuda") -> Any:
        """Restore ``step`` (default: the latest) onto ``device``, or, with
        ``shardings`` (a tree of ``NamedSharding``s of the state's
        structure), each leaf placed by its sharding on the devices of its
        mesh (``parallel.sharding.device_put``). A state saved across
        processes restores onto any layout and world: each leaf is
        assembled from every process's chunks (module docstring), whole
        or, on a mesh across processes, the ranges of this process's
        places. ``target`` (a state of the same structure, plain, placed
        or on the meta device) is checked against the checkpoint's
        structure, shapes and dtypes."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoints under {self.directory}")
        if self._path(step).exists():
            payloads = [torch.load(self._path(step), map_location="cpu",
                                   weights_only=True)]
        else:
            payloads = [torch.load(p, map_location="cpu", weights_only=True,
                                   mmap=True)
                        for p in self._process_files(step)]
        payload = payloads[0]
        tree = _merge([p["tree"] for p in payloads])
        if target is not None:
            _check_like(tree, _as_tree(target))
        dev = resolve_device(device) if shardings is None else None
        tree = map_trees(
            lambda leaf, *sh: _place(leaf, sh[0] if sh else None, dev),
            tree, *(() if shardings is None else (_as_tree(shardings),)),
            is_leaf=lambda x: isinstance(x, torch.Tensor) or (
                isinstance(x, dict) and _CHUNKS in x))
        return TrainState(**tree) if payload["train_state"] else tree

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self, process: tuple | None = None) -> list[int]:
        """The saved steps: each step saved whole, or by every process
        of a world (``process`` (rank, world): the steps with that
        process's file, what its retention deletes)."""
        whole, procs = self._scan()
        if process is not None:
            return sorted(step for (step, world), ranks in procs.items()
                          if world == process[1] and process[0] in ranks)
        return sorted(whole | {step for (step, world), ranks in procs.items()
                               if len(ranks) == world})

    def wait(self):
        """Block until pending asynchronous saves are on disk; raise the
        first error one of them hit."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self):
        self.wait()
        if self._writer is not None:
            self._writer.shutdown()
