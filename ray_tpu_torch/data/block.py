"""Blocks: the unit of data exchanged between operators.

Port of ``ray_tpu/data/block.py`` (reference: Ray Data blocks,
``python/ray/data/_internal/block_builder.py``). A block is a column dict
of numpy arrays (the layout the device feed copies to the card without
conversion) or a list of Python rows for non-tabular data. Blocks live in
the object store as ObjectRefs.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np


class BlockAccessor:
    """Uniform view over the two block layouts (rows list | column dict)."""

    def __init__(self, block):
        self.block = block

    @staticmethod
    def for_block(block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        b = self.block
        if isinstance(b, dict):
            if not b:
                return 0
            return len(next(iter(b.values())))
        return len(b)

    def size_bytes(self) -> int:
        b = self.block
        if isinstance(b, dict):
            return int(sum(np.asarray(v).nbytes for v in b.values()))
        return int(sum(getattr(x, "nbytes", 64) for x in b)) if b else 0

    def iter_rows(self) -> Iterable[Any]:
        b = self.block
        if isinstance(b, dict):
            keys = list(b)
            n = self.num_rows()
            for i in range(n):
                yield {k: b[k][i] for k in keys}
        else:
            yield from b

    def to_batch(self) -> dict:
        """Column-dict batch (numpy arrays)."""
        b = self.block
        if isinstance(b, dict):
            return {k: np.asarray(v) for k, v in b.items()}
        if not b:
            return {}
        first = b[0]
        if isinstance(first, dict):
            keys = list(first)
            return {k: np.asarray([row[k] for row in b]) for k in keys}
        return {"item": np.asarray(b)}

    def to_rows(self) -> list:
        if isinstance(self.block, dict):
            return list(self.iter_rows())
        return list(self.block)

    def slice(self, start: int, end: int):
        b = self.block
        if isinstance(b, dict):
            return {k: v[start:end] for k, v in b.items()}
        return b[start:end]


def batch_to_block(batch) -> Any:
    """Normalize a user map_batches return into a block."""
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, list):
        return batch
    if isinstance(batch, np.ndarray):
        return {"item": batch}
    raise TypeError(
        f"map_batches must return dict/list/ndarray, got {type(batch)}")


def concat_blocks(blocks: list):
    if not blocks:
        return []
    if isinstance(blocks[0], dict):
        keys = list(blocks[0])
        return {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in keys}
    out = []
    for b in blocks:
        out.extend(b)
    return out
