"""Checkpointing: asynchronous saves with top-k retention, placed
restores.

Port of ``ray_tpu/train/checkpoint.py`` (Orbax there) with ``torch.save``.
One file per step, ``<step>.pt``, written under a temporary name and
renamed, so a partly written file is never listed. A save writes global
arrays, as Orbax does: a placed leaf (``ShardedTensor``) is assembled
from one chunk of each index range. An asynchronous save copies the
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
from ray_tpu_torch.parallel.sharding import ShardedTensor, place_tree
from ray_tpu_torch.train.optim import tree_map
from ray_tpu_torch.train.state import TrainState


def _as_tree(state: Any):
    """A ``TrainState`` as a dictionary of its fields (no copies, unlike
    ``dataclasses.asdict``); any other state as it is."""
    if isinstance(state, TrainState):
        return {f.name: getattr(state, f.name)
                for f in dataclasses.fields(state)}
    return state


def _global_host(x):
    """A host copy of a tensor or of a placed tensor's global value."""
    if isinstance(x, ShardedTensor):
        return x.unshard(device="cpu")
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def _to_host(state: Any) -> dict:
    """A host copy of ``state`` that later in-place updates cannot touch,
    every leaf global."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _global_host(node)
    return {"train_state": isinstance(state, TrainState),
            "tree": walk(_as_tree(state))}


def _check_like(got, want, path="state"):
    """Raise unless ``got`` has ``want``'s structure, shapes and dtypes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: checkpoint keys do not match target")
        for k in want:
            _check_like(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (torch.Tensor, ShardedTensor)):
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

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def _write(self, step: int, payload: dict) -> None:
        tmp = self.directory / f".{step}.pt.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                self._path(old).unlink(missing_ok=True)

    def save(self, step: int, state: Any, *, metrics: dict | None = None,
             force: bool = False) -> bool:
        """Save ``state`` (a ``TrainState`` or a dictionary of tensors) as
        ``step``. The host copy is made before this returns; with
        ``async_save`` the write happens on the background thread.
        ``metrics`` are stored beside the state; ``force`` is accepted for
        the JAX signature (every call saves)."""
        del force
        payload = _to_host(state)
        payload["metrics"] = metrics
        if self._writer is None:
            self._write(step, payload)
        else:
            self._pending.append(self._writer.submit(self._write, step,
                                                     payload))
        return True

    def restore(self, step: int | None = None, *, target: Any = None,
                shardings: Any = None, device="cuda") -> Any:
        """Restore ``step`` (default: the latest) onto ``device``, or, with
        ``shardings`` (a tree of ``NamedSharding``s of the state's
        structure), each leaf placed by its sharding on the devices of its
        mesh (``parallel.sharding.device_put``). ``target`` (a state
        of the same structure, plain, placed or on the meta device) is
        checked against the checkpoint's structure, shapes and dtypes."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoints under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        tree = payload["tree"]
        if target is not None:
            _check_like(tree, _as_tree(target))
        if shardings is None:
            dev = resolve_device(device)
            tree = tree_map(lambda t: t.to(dev), tree)
        else:
            tree = place_tree(tree, _as_tree(shardings))
        return TrainState(**tree) if payload["train_state"] else tree

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

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
