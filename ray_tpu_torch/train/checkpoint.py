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
chunks, each under its index range, to ``<step>.proc<rank>of<world>.pt``,
and ``restore(shardings=)`` reads back the chunks of this process's
places, bit for bit on the same layout. An asynchronous save copies the
state to the host before ``save`` returns (the trainer updates its
tensors in place, so a later step would otherwise tear the write) and
writes it on one background thread. Retention keeps the newest
``max_to_keep`` steps, as Orbax does without a metric. ``restore(...,
shardings=)`` places every restored leaf by a tree of ``NamedSharding``s
(``Trainer.state_shardings()``).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.sharding import (ShardedTensor, device_put,
                                             map_trees)
from ray_tpu_torch.train.optim import tree_leaves, tree_map
from ray_tpu_torch.train.state import TrainState

# the marker of a leaf saved as this process's chunks
_CHUNKS = "__chunks__"


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


def _place(leaf, sharding):
    """A restored leaf placed by ``sharding``: a global tensor by
    ``device_put``, saved chunks each at the places of its index
    range."""
    if not isinstance(leaf, dict):
        return device_put(leaf, sharding) if isinstance(
            leaf, torch.Tensor) else leaf
    shape = leaf[_CHUNKS]
    made, chunks = {}, []
    for idx, dev in zip(sharding.indices(shape),
                        sharding.mesh.devices.ravel()):
        key = (_range_key(idx), str(dev))
        if key not in made:
            if key[0] not in leaf["chunks"]:
                raise ValueError(f"the checkpoint holds no chunk {key[0]} of "
                                 f"a {shape} leaf: restore on the layout it "
                                 "was saved from")
            made[key] = leaf["chunks"][key[0]].to(dev)
        chunks.append(made[key])
    return ShardedTensor(shape, getattr(torch, leaf["dtype"]), sharding,
                         chunks)


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

    def restore(self, step: int | None = None, *, target: Any = None,
                shardings: Any = None, device="cuda") -> Any:
        """Restore ``step`` (default: the latest) onto ``device``, or, with
        ``shardings`` (a tree of ``NamedSharding``s of the state's
        structure), each leaf placed by its sharding on the devices of its
        mesh (``parallel.sharding.device_put``); a state saved across
        processes restores through the shardings of its layout, each
        process reading its own chunks. ``target`` (a state of the same
        structure, plain, placed or on the meta device) is checked against
        the checkpoint's structure, shapes and dtypes."""
        self.wait()
        process = None if shardings is None else _process(
            _as_tree(shardings))
        if step is None:
            step = self.latest_step(process)
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoints under {self.directory}")
        payload = torch.load(self._path(step, process), map_location="cpu",
                             weights_only=True)
        tree = payload["tree"]
        if target is not None:
            _check_like(tree, _as_tree(target))
        if shardings is None:
            dev = resolve_device(device)
            tree = tree_map(lambda t: t.to(dev), tree)
        else:
            tree = map_trees(_place, tree, _as_tree(shardings),
                             is_leaf=lambda x: isinstance(
                                 x, torch.Tensor) or (isinstance(x, dict)
                                                      and _CHUNKS in x))
        return TrainState(**tree) if payload["train_state"] else tree

    def latest_step(self, process: tuple | None = None) -> int | None:
        steps = self.all_steps(process)
        return steps[-1] if steps else None

    def all_steps(self, process: tuple | None = None) -> list[int]:
        """The saved steps (``process``: those with that process's
        file)."""
        return sorted(int(p.name.split(".")[0])
                      for p in self.directory.glob("*.pt")
                      if p.name.split(".")[0].isdigit() and
                      p == self._path(int(p.name.split(".")[0]), process))

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
