"""GroupedData: the result of ``Dataset.groupby(key)``.

Port of ``ray_tpu/data/grouped.py`` (reference:
``python/ray/data/grouped_data.py``: sum/min/max/mean/std/count,
``aggregate``, ``map_groups``). The aggregate runs in two phases: per-block
partials as tasks, merged by key on the driver (one tuple a key a block),
so the dataset never materializes in one place; ``map_groups`` is an
exchange, blocks hash-partitioned by key in map tasks and each partition's
whole groups handed to one reduce task.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.aggregate import (AggregateFn, Count, Max, Mean,
                                          Min, Std, Sum)
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks


def _block_partials(block, key, aggs):
    """Task: per-group partial aggregates for one block."""
    acc = BlockAccessor.for_block(block)
    batch = acc.to_batch()
    keys = np.asarray(batch[key])
    out = {}
    # group rows of this block by key value
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    boundaries = np.flatnonzero(
        np.concatenate(([True], sorted_keys[1:] != sorted_keys[:-1])))
    for bi, start in enumerate(boundaries):
        end = boundaries[bi + 1] if bi + 1 < len(boundaries) else len(keys)
        idx = order[start:end]
        kval = sorted_keys[start]
        kval = kval.item() if hasattr(kval, "item") else kval
        partials = []
        for agg in aggs:
            col = np.asarray(batch[agg.on])[idx] if agg.on else idx
            partials.append(agg.partial(col))
        out[kval] = partials
    return out


def _partition_by_key(block, key, n_parts):
    """Exchange map task: split one block into n_parts pieces by key
    hash, so every row of a group lands in the same reduce partition."""
    acc = BlockAccessor.for_block(block)
    batch = acc.to_batch()
    keys = np.asarray(batch[key])
    assign = np.asarray(
        [hash(v.item() if hasattr(v, "item") else v) % n_parts
         for v in keys])
    parts = []
    for p in range(n_parts):
        idx = np.flatnonzero(assign == p)
        parts.append({k: np.asarray(v)[idx] for k, v in batch.items()})
    return parts if n_parts > 1 else parts[0]


def _group_map(fn, key, *pieces):
    """Reduce task: concat this partition's pieces, then apply fn per
    whole group."""
    block = concat_blocks(list(pieces))
    acc = BlockAccessor.for_block(block)
    batch = acc.to_batch()
    if not batch:
        return []
    keys = np.asarray(batch[key])
    out_blocks = []
    for kval in np.unique(keys):
        idx = np.flatnonzero(keys == kval)
        group = {k: np.asarray(v)[idx] for k, v in batch.items()}
        res = fn(group)
        out_blocks.append(res)
    return out_blocks


class GroupedData:
    def __init__(self, dataset, key: str):
        self._ds = dataset
        self._key = key

    # -- aggregate entry points -----------------------------------------

    def aggregate(self, *aggs: AggregateFn):
        """Returns a Dataset of one row per group:
        {key, <agg.output_name>...}."""
        from ray_tpu_torch.data.dataset import Dataset, from_items

        ds, key = self._ds, self._key
        agg_list = list(aggs)
        part_fn = ray_tpu_torch.remote(_block_partials)

        def source():
            refs = []
            for bundle in ds.iter_bundles():
                for ref in bundle.refs:
                    # pass the ref — task args auto-deref, block bytes
                    # never transit the driver
                    refs.append(part_fn.remote(ref, key, agg_list))
            merged: dict = {}
            for partials in ray_tpu_torch.get(refs):
                for kval, plist in partials.items():
                    if kval not in merged:
                        merged[kval] = plist
                    else:
                        merged[kval] = [a.merge(x, y) for a, x, y in
                                        zip(aggs, merged[kval], plist)]
            rows = []
            for kval in sorted(merged):
                row = {key: kval}
                for agg, p in zip(aggs, merged[kval]):
                    row[agg.output_name] = agg.finalize(p)
                rows.append(row)
            return from_items(rows)._source_fn()

        return Dataset(source)

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof=ddof))

    def map_groups(self, fn):
        """Apply ``fn(group_batch_dict) -> batch_dict`` per group.
        Distributed exchange: blocks are hash-partitioned by key (map
        tasks), then one reduce task per partition applies fn to each of
        its whole groups — partitions process in parallel and blocks
        move by ObjectRef (args auto-deref in tasks)."""
        from ray_tpu_torch.data.dataset import Dataset

        ds, key = self._ds, self._key
        part_task = ray_tpu_torch.remote(_partition_by_key)
        reduce_task = ray_tpu_torch.remote(_group_map)

        def source():
            from ray_tpu_torch.data.dataset import _bundle_of

            in_refs = [ref for bundle in ds.iter_bundles()
                       for ref in bundle.refs]
            n_parts = max(1, len(in_refs))
            piece_refs = []
            for ref in in_refs:
                refs = part_task.options(num_returns=n_parts).remote(
                    ref, key, n_parts)
                piece_refs.append([refs] if n_parts == 1 else refs)
            out_refs = [
                reduce_task.remote(fn, key,
                                   *[plist[p] for plist in piece_refs])
                for p in range(n_parts)
            ]
            bundles = []
            for out_blocks in ray_tpu_torch.get(out_refs):
                bundles.extend(
                    _bundle_of(b) for b in out_blocks
                    if BlockAccessor.for_block(b).num_rows())
            return bundles

        return Dataset(source)
