"""DataIterator: per-consumer batch iteration with the device feed.

Port of ``ray_tpu/data/iterator.py`` (reference:
``python/ray/data/iterator.py``, ``DataIterator:60``). The JAX package's
iterator reads blocks from its object store; the port's reads an iterable
of numpy column dicts (``{"tokens": array, ...}``, equal-length columns),
so a rank's dataset shard is a list of such blocks. ``iter_batches``
re-batches them to a fixed size with the JAX package's carry and
``drop_last`` (``:26``).

``iter_torch_batches`` is the counterpart of ``iter_jax_batches``
(``:58``): where JAX's ``device_put`` is asynchronous, the port copies
each batch from pinned host memory on a side CUDA stream, ``prefetch``
batches ahead, and makes the consumer's stream wait on the copy's event
before it hands the batch over, so the copy of the next batch overlaps
the current step and no step reads a batch whose copy has not finished.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _concat(blocks: list) -> dict:
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def _rows(batch: dict) -> int:
    return len(next(iter(batch.values())))


class DataIterator:
    """Batches over ``blocks``: an iterable of numpy column dicts (a list,
    to iterate more than once)."""

    def __init__(self, blocks: Iterable[dict]):
        self._blocks = blocks

    def iter_batches(self, *, batch_size: int | None = None,
                     drop_last: bool = False) -> Iterator[dict]:
        """Column-dict numpy batches, re-batched to ``batch_size`` (the
        blocks as they are when None)."""
        carry: dict | None = None
        for block in self._blocks:
            batch = {k: np.asarray(v) for k, v in block.items()}
            if not batch or _rows(batch) == 0:
                continue
            if batch_size is None:
                yield batch
                continue
            if carry is not None:
                batch = _concat([carry, batch])
                carry = None
            n = _rows(batch)
            start = 0
            while n - start >= batch_size:
                yield {k: v[start:start + batch_size]
                       for k, v in batch.items()}
                start += batch_size
            if start < n:
                carry = {k: v[start:] for k, v in batch.items()}
        if carry is not None and not drop_last:
            yield carry

    def iter_torch_batches(self, *, batch_size: int | None = None,
                           drop_last: bool = True,
                           dtypes: dict | None = None, device="cuda",
                           prefetch: int = 1) -> Iterator[dict]:
        """Batches as tensors on ``device`` (``dtypes``: column -> torch
        dtype, cast on the host), with ``prefetch`` copies in flight. On
        a card each copy runs from pinned memory on a side stream; on the
        CPU each batch is a tensor of its own memory."""
        device = resolve_device(device)
        stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

        def host(k, v):
            t = torch.from_numpy(np.array(v, copy=True))
            if dtypes and k in dtypes:
                t = t.to(dtypes[k])
            return t

        def transfer(batch: dict):
            if stream is None:
                return {k: host(k, v) for k, v in batch.items()}, None
            with torch.cuda.stream(stream):
                out = {k: host(k, v).pin_memory().to(device,
                                                     non_blocking=True)
                       for k, v in batch.items()}
                ready = torch.cuda.Event()
                ready.record(stream)
            return out, ready

        def hand_over(item):
            out, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in out.values():
                    # the allocator must not reuse a batch's memory while
                    # the consumer's stream may still read it
                    t.record_stream(consumer)
            return out

        window: deque = deque()
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            window.append(transfer(batch))
            if len(window) > prefetch:
                yield hand_over(window.popleft())
        while window:
            yield hand_over(window.popleft())
