"""DataIterator: per-consumer batch iteration with the device feed.

Port of ``ray_tpu/data/iterator.py`` (reference:
``python/ray/data/iterator.py``, ``DataIterator:60``). It reads what it
is given in order: ``RefBundle``s, whose blocks it reads from the object
store as JAX's does (``Dataset.iterator()``, ``streaming_split``), or
blocks themselves, numpy column dicts (``{"tokens": array, ...}``) or
lists of rows (a rank's feed from the driver; a list of blocks to iterate
more than once). ``iter_batches`` re-batches them to a fixed size with
JAX's carry and ``drop_last`` (``:26``); ``iter_rows`` yields each row.

``iter_torch_batches`` is the counterpart of ``iter_jax_batches``
(``:58``), on the card and with ``drop_last=True`` by default: where
JAX's ``device_put`` is asynchronous, the port copies each batch from
pinned host memory on a side CUDA stream, ``prefetch`` batches ahead, and
makes the consumer's stream wait on the copy's event before it hands the
batch over, so the copy of the next batch overlaps the current step and
no step reads a batch whose copy has not finished. JAX's CPU
``iter_torch_batches`` (``:89``: ``drop_last=False``, no device) is
``device="cpu", drop_last=False``. Every column is copied before
``torch.from_numpy``, so a tensor owns its memory: a block read from the
shared-memory store is never aliased (``:101-108``).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks
from ray_tpu_torch.data.execution import RefBundle


class DataIterator:
    """Batches over ``bundles``: an iterable of ``RefBundle``s or of blocks
    (module docstring)."""

    def __init__(self, bundles: Iterable):
        self._bundles = bundles

    def _blocks(self) -> Iterator:
        for item in self._bundles:
            if isinstance(item, RefBundle):
                for ref in item.refs:
                    yield ray_tpu_torch.get(ref)
            else:
                yield item

    def _close(self):
        """End the source's execution early (a ``streaming_split``'s pump),
        where it has one."""
        close = getattr(self._bundles, "close", None)
        if close is not None:
            close()

    def iter_batches(self, *, batch_size: int | None = None,
                     drop_last: bool = False) -> Iterator[dict]:
        """Column-dict numpy batches, re-batched to ``batch_size`` (the
        blocks as they are when None)."""
        carry: dict | None = None
        for block in self._blocks():
            batch = BlockAccessor.for_block(block).to_batch()
            if not batch:
                continue
            if batch_size is None:
                yield batch
                continue
            if carry is not None:
                batch = concat_blocks([carry, batch])
                carry = None
            n = len(next(iter(batch.values())))
            start = 0
            while n - start >= batch_size:
                yield {k: v[start:start + batch_size]
                       for k, v in batch.items()}
                start += batch_size
            if start < n:
                carry = {k: v[start:] for k, v in batch.items()}
        if carry is not None and not drop_last:
            yield carry

    def iter_rows(self) -> Iterator:
        """Each row of each block, in order (a dict for a column block)."""
        for block in self._blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_torch_batches(self, *, batch_size: int | None = None,
                           drop_last: bool = True,
                           dtypes: dict | None = None, device="cuda",
                           prefetch: int = 1) -> Iterator[dict]:
        """Batches as tensors on ``device`` (``dtypes``: column -> torch
        dtype, cast on the host), with ``prefetch`` copies in flight. On
        a card each copy runs from pinned memory on a side stream; on the
        CPU each batch is a tensor of its own memory."""
        import torch

        from ray_tpu_torch._device import resolve_device

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
