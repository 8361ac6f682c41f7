"""Dataset: a lazy logical plan over blocks, run by the streaming executor.

Port of ``ray_tpu/data/dataset.py`` (reference:
``python/ray/data/dataset.py``, ``Dataset`` :178, ``map_batches:397``,
``iter_batches:3499``, ``streaming_split:1149``), with the logical plan
and the physical operators in one layer: each transform appends an
operator factory, and ``_build_ops`` makes the topology at iteration
time. Blocks are numpy column dicts (the device feed's host format) or
lists of rows. The shuffles draw from the same ``np.random.default_rng``
seeds as JAX's, so a seed gives the same order of rows.

``pyarrow``, ``pandas`` and ``PIL`` are imported inside the functions
that need them; where one is missing, the call raises an ``ImportError``
that names the package. The column transforms and the image decode are
module-level functions bound with ``functools.partial``, so a pipeline
of module-level functions runs on a cluster's workers too.

``streaming_split`` deals the bundles round-robin, each to exactly one
split, as JAX does. Where JAX's pump ends every split early and silently
when the pipeline raises (its end marker is put in a ``finally``,
``ray_tpu/data/dataset.py:404-413``), the port's carries the error: a
split's iterator raises it after the bundles dealt to it before.
"""

from __future__ import annotations

import builtins
import functools
import importlib
import queue as _queue
import threading
from typing import Any, Callable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks
from ray_tpu_torch.data.execution import (
    AllToAllOperator,
    ExecutionOptions,
    InputDataOperator,
    LimitOperator,
    MapOperator,
    PhysicalOperator,
    RefBundle,
    StreamingExecutor,
)


class Dataset:
    def __init__(self, source_fn: Callable[[], list[RefBundle]],
                 ops: tuple = (), options: ExecutionOptions | None = None):
        self._source_fn = source_fn
        self._ops = ops          # tuple of factories () -> PhysicalOperator
        self._options = options or ExecutionOptions()

    # ------------------------------------------------------------------
    # transforms (lazy)
    # ------------------------------------------------------------------

    def _with(self, factory) -> "Dataset":
        return Dataset(self._source_fn, self._ops + (factory,), self._options)

    def map_batches(self, fn, *, compute: str = "tasks", num_cpus: float = 1,
                    actor_pool_size: int = 2,
                    max_actor_pool_size: int | None = None) -> "Dataset":
        """Apply ``fn(batch_dict) -> batch_dict`` per block.
        ``compute="actors"`` keeps fn state resident (pass a zero-arg
        factory as ``fn`` to build per-actor state once); the pool
        autoscales between actor_pool_size and max_actor_pool_size."""
        return self._with(lambda: MapOperator(
            "MapBatches", "batches", fn, compute=compute, num_cpus=num_cpus,
            actor_pool_size=actor_pool_size,
            max_actor_pool_size=max_actor_pool_size))

    def map(self, fn, **kw) -> "Dataset":
        return self._with(lambda: MapOperator("Map", "rows", fn, **kw))

    def flat_map(self, fn, **kw) -> "Dataset":
        return self._with(lambda: MapOperator("FlatMap", "flat", fn, **kw))

    def filter(self, fn, **kw) -> "Dataset":
        return self._with(lambda: MapOperator("Filter", "filter", fn, **kw))

    def limit(self, n: int) -> "Dataset":
        return self._with(lambda: LimitOperator(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(lambda: AllToAllOperator(
            f"Repartition[{num_blocks}]",
            lambda bundles: _repartition(bundles, num_blocks)))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        from ray_tpu_torch.data.context import DataContext

        def do_shuffle(bundles):
            if DataContext.get_current().use_push_based_shuffle:
                return _push_shuffle(bundles, seed)
            return _shuffle(bundles, seed)

        return self._with(lambda: AllToAllOperator(
            "RandomShuffle", do_shuffle))

    def sort(self, key: str) -> "Dataset":
        return self._with(lambda: AllToAllOperator(
            f"Sort[{key}]", lambda bundles: _sort(bundles, key)))

    def union(self, other: "Dataset") -> "Dataset":
        left_src, right_src = self._source_fn, other._source_fn
        left_ops, right_ops = self._ops, other._ops

        def source():
            return (_drain(left_src, left_ops, self._options)
                    + _drain(right_src, right_ops, other._options))
        return Dataset(source, (), self._options)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise join of two row-aligned datasets (reference:
        Dataset.zip). Right columns that collide get a ``_1`` suffix."""
        left, right = self, other

        def source():
            lb = _gather_rows(list(left.iter_bundles()))
            rb = _gather_rows(list(right.iter_bundles()))
            la = BlockAccessor.for_block(lb).to_batch()
            ra = BlockAccessor.for_block(rb).to_batch()
            n_l = BlockAccessor.for_block(lb).num_rows()
            n_r = BlockAccessor.for_block(rb).num_rows()
            if n_l != n_r:
                raise ValueError(
                    f"zip requires equal row counts, got {n_l} vs {n_r}")
            out = dict(la)
            for k, v in ra.items():
                name = k
                suffix = 1
                while name in out:  # probe until unique; never overwrite
                    name = f"{k}_{suffix}"
                    suffix += 1
                out[name] = v
            return _emit_blocks(out, 8)
        return Dataset(source, (), self._options)

    # -- column ops (reference: dataset.py add_column/drop_columns/...) --

    def add_column(self, name: str, fn) -> "Dataset":
        return self.map_batches(functools.partial(_add_column, name, fn))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(functools.partial(_drop_columns,
                                                  frozenset(cols)))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self.map_batches(functools.partial(_select_columns,
                                                  list(cols)))

    def rename_columns(self, mapping: dict) -> "Dataset":
        return self.map_batches(functools.partial(_rename_columns,
                                                  dict(mapping)))

    def random_sample(self, fraction: float, *, seed=None) -> "Dataset":
        """Uniform row sample. Runs as an exchange so each block draws
        from a distinct per-block-index stream — a per-batch rng seeded
        identically would repeat the same keep-mask in every block (a
        positionally biased sample)."""
        def do_sample(bundles):
            out = []
            for i, b in enumerate(bundles):
                block = _gather_rows([b])
                acc = BlockAccessor.for_block(block)
                batch = acc.to_batch()
                n = acc.num_rows()
                rng = np.random.default_rng(
                    None if seed is None else [seed, i])
                keep = rng.random(n) < fraction
                sampled = {k: np.asarray(v)[keep] for k, v in batch.items()}
                sacc = BlockAccessor.for_block(sampled)
                if sacc.num_rows():
                    out.append(RefBundle([ray_tpu_torch.put(sampled)],
                                         num_rows=sacc.num_rows(),
                                         size_bytes=sacc.size_bytes()))
            return out
        return self._with(lambda: AllToAllOperator("RandomSample",
                                                   do_sample))

    # -- grouped / global aggregates ------------------------------------

    def groupby(self, key: str):
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    def aggregate(self, *aggs):
        """Whole-dataset aggregation → single result dict."""
        merged = [None] * len(aggs)
        for batch in self.iter_batches():
            for i, agg in enumerate(aggs):
                col = np.asarray(batch[agg.on]) if agg.on else \
                    np.arange(len(next(iter(batch.values()))))
                p = agg.partial(col)
                merged[i] = p if merged[i] is None else agg.merge(
                    merged[i], p)
        return {agg.output_name: agg.finalize(p)
                for agg, p in builtins.zip(aggs, merged) if p is not None}

    def groupby_all(self, *aggs):
        return self.aggregate(*aggs)

    def sum(self, on: str):
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on))[f"sum({on})"]

    def min(self, on: str):
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on))[f"min({on})"]

    def max(self, on: str):
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on))[f"max({on})"]

    def mean(self, on: str):
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof=ddof))[f"std({on})"]

    def unique(self, column: str) -> list:
        vals = set()
        for batch in self.iter_batches():
            vals.update(np.unique(np.asarray(batch[column])).tolist())
        return sorted(vals)

    def schema(self) -> dict:
        """Column name -> dtype of the first non-empty block."""
        for batch in self.iter_batches():
            if batch:
                return {k: np.asarray(v).dtype for k, v in batch.items()}
        return {}

    def split(self, n: int) -> list["Dataset"]:
        """Materialize into EXACTLY n row-balanced datasets (some may be
        empty when rows < n — callers index one per rank). For streaming
        per-rank ingest use streaming_split."""
        merged = _gather_rows(list(self.iter_bundles()))
        acc = BlockAccessor.for_block(merged)
        total = acc.num_rows()
        out = []
        for i in builtins.range(n):
            start = i * total // n
            end = (i + 1) * total // n
            part = acc.slice(start, end)
            pacc = BlockAccessor.for_block(part)
            bundles = ([RefBundle([ray_tpu_torch.put(part)],
                                  num_rows=pacc.num_rows(),
                                  size_bytes=pacc.size_bytes())]
                       if pacc.num_rows() else [])
            out.append(Dataset((lambda bb=bundles: list(bb)), (),
                               self._options))
        return out

    # -- writes (reference: data/datasource write paths) -----------------

    def write_parquet(self, path: str) -> None:
        import os

        pa = _optional("pyarrow")
        pq = _optional("pyarrow.parquet", "pyarrow")

        os.makedirs(path, exist_ok=True)
        for i, batch in enumerate(self.iter_batches()):
            table = pa.table({k: np.asarray(v) for k, v in batch.items()})
            pq.write_table(table, os.path.join(path, f"part-{i:05d}.parquet"))

    def write_csv(self, path: str) -> None:
        import csv as _csv
        import os

        os.makedirs(path, exist_ok=True)
        for i, batch in enumerate(self.iter_batches()):
            keys = list(batch)
            with open(os.path.join(path, f"part-{i:05d}.csv"), "w",
                      newline="") as f:
                w = _csv.writer(f)
                w.writerow(keys)
                n = len(batch[keys[0]]) if keys else 0
                for r in builtins.range(n):
                    w.writerow([batch[k][r] for k in keys])

    def write_sql(self, sql: str, connection_factory) -> None:
        """Write rows through a parameterized INSERT over a DB-API 2
        connection (reference: Dataset.write_sql, sql_datasource.py)."""
        from ray_tpu_torch.data.sql import write_sql as _write_sql

        _write_sql(self, sql, connection_factory)

    def write_json(self, path: str) -> None:
        import json as _json
        import os

        os.makedirs(path, exist_ok=True)
        for i, batch in enumerate(self.iter_batches()):
            with open(os.path.join(path, f"part-{i:05d}.json"), "w") as f:
                keys = list(batch)
                n = len(batch[keys[0]]) if keys else 0
                for r in builtins.range(n):
                    row = {k: np.asarray(batch[k][r]).item()
                           if hasattr(batch[k][r], "item") else batch[k][r]
                           for k in keys}
                    f.write(_json.dumps(row) + "\n")

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _build_ops(self) -> list[PhysicalOperator]:
        ops: list[PhysicalOperator] = [InputDataOperator(self._source_fn())]
        for factory in self._ops:
            ops.append(factory())
        return ops

    def iter_bundles(self) -> Iterator[RefBundle]:
        executor = StreamingExecutor(self._build_ops(), self._options)
        self._last_stats = executor.stats
        yield from executor.execute()

    def stats(self):
        """Per-operator execution breakdown (reference: ``ds.stats()``
        — ``data/_internal/stats.py``): wall time, bundles/bytes/rows in
        and out, and task wall-time distribution. Uses the LAST
        execution's stats when this dataset has been consumed; executes
        once otherwise. The returned DatasetStats prints the summary and
        indexes per-operator metrics by name (``stats()["Map"]``)."""
        stats = getattr(self, "_last_stats", None)
        if stats is None or stats.end_t is None:
            list(self.iter_bundles())
            stats = self._last_stats
        return stats

    def iter_batches(self) -> Iterator[dict]:
        for bundle in self.iter_bundles():
            for ref in bundle.refs:
                block = ray_tpu_torch.get(ref)
                yield BlockAccessor.for_block(block).to_batch()

    def iter_rows(self) -> Iterator[Any]:
        for bundle in self.iter_bundles():
            for ref in bundle.refs:
                yield from BlockAccessor.for_block(
                    ray_tpu_torch.get(ref)).iter_rows()

    def take(self, n: int = 20) -> list:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def to_arrow(self):
        """Materialize as one pyarrow Table (reference:
        ``Dataset.to_arrow_refs`` surface, eagerly concatenated)."""
        pa = _optional("pyarrow")

        return pa.Table.from_pandas(self.to_pandas(),
                                    preserve_index=False)

    def to_pandas(self):
        """Materialize as one pandas DataFrame (reference:
        ``Dataset.to_pandas``) — concatenates whole column batches,
        never per-row dicts."""
        pd = _optional("pandas")

        def frame(batch):
            # multi-dim columns can't build a DataFrame column-wise;
            # fall back to object cells (list of per-row arrays)
            cols = {k: (list(v) if getattr(v, "ndim", 1) > 1 else v)
                    for k, v in batch.items()}
            return pd.DataFrame(cols)

        frames = [frame(b) for b in self.iter_batches()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(b.num_rows for b in self.iter_bundles())

    def materialize(self) -> "Dataset":
        bundles = list(self.iter_bundles())
        return Dataset(lambda: bundles, (), self._options)


    # ------------------------------------------------------------------
    # consumption for training (reference: streaming_split:1149)
    # ------------------------------------------------------------------

    def streaming_split(self, n: int) -> list["DataIterator"]:
        """n iterators fed round-robin from ONE shared streaming execution
        (per-rank ingest; each bundle goes to exactly one split). If the
        pipeline raises, each split's iterator raises that error after
        the bundles dealt to it before (module docstring)."""
        from ray_tpu_torch.data.iterator import DataIterator

        splits = _Splits([_queue.Queue(maxsize=4)
                          for _ in builtins.range(n)])
        splits.start(self)
        return [DataIterator(_SplitFeed(splits, i))
                for i in builtins.range(n)]

    def iterator(self) -> "DataIterator":
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self.iter_bundles())

    def __repr__(self):
        return f"Dataset(ops={len(self._ops)})"


class _Splits:
    """The queues of one ``streaming_split`` and their pump, a thread
    that runs the pipeline once. ``deal``: each bundle to one queue,
    round-robin (JAX's split); else each to every queue. ``blocks``: the
    queues take each of a bundle's blocks as a numpy column dict read
    from the store (a trainer's rank processes, which are not workers of
    the runtime), else the bundle. ``close`` ends the pump at its next
    put and the execution with it."""

    def __init__(self, queues: list, *, deal: bool = True,
                 blocks: bool = False):
        self.queues, self.deal, self.blocks = queues, deal, blocks
        self.closed = threading.Event()
        self.error: "_SplitError | None" = None
        self.thread: threading.Thread | None = None

    def start(self, ds: "Dataset"):
        self.thread = threading.Thread(target=self.pump, args=(ds,),
                                       daemon=True, name="streaming_split")
        self.thread.start()

    def _put(self, q, item) -> bool:
        while not self.closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                pass
        return False

    def _items(self, bundle: RefBundle) -> list:
        if not self.blocks:
            return [bundle]
        return [BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_batch()
                for ref in bundle.refs]

    def pump(self, ds: "Dataset"):
        n = len(self.queues)
        end = None
        bundles = ds.iter_bundles()
        try:
            for i, bundle in enumerate(bundles):
                targets = [self.queues[i % n]] if self.deal else self.queues
                for item in self._items(bundle):
                    for q in targets:
                        if not self._put(q, item):
                            return
        except Exception as e:  # noqa: BLE001 - carried to the splits
            end = self.error = _SplitError(e)
        finally:
            bundles.close()   # the executor's operators shut down
            for q in self.queues:
                self._put(q, end)

    def close(self):
        self.closed.set()


class _SplitError:
    """A split's end marker when the pipeline raised. A rank process gets
    its text only: an exception need not pickle."""

    def __init__(self, error: Exception | None, text: str | None = None):
        self.error = error
        self.text = text or f"{type(error).__name__}: {error}"

    def __reduce__(self):
        return (_SplitError, (None, self.text))


class _SplitFeed:
    """Split ``index``'s bundles, read from its queue; iterable once (a
    second iteration ends at once, as JAX's generator does)."""

    def __init__(self, splits: _Splits, index: int):
        self.splits, self.index = splits, index
        self.ended = False

    def __iter__(self):
        q = self.splits.queues[self.index]
        while not self.ended:
            try:
                item = q.get(timeout=0.1)
            except _queue.Empty:
                if self.splits.closed.is_set():
                    return
                continue
            if item is None or isinstance(item, _SplitError):
                self.ended = True
            if item is None:
                return
            if isinstance(item, _SplitError):
                raise RuntimeError(
                    f"streaming_split: the pipeline raised {item.text}"
                ) from item.error
            yield item

    def close(self):
        self.splits.close()


def _drain(source_fn, ops, options) -> list[RefBundle]:
    ds = Dataset(source_fn, ops, options)
    return list(ds.iter_bundles())


# ---------------------------------------------------------------------------
# all-to-all transforms (centralized v1; push-based shuffle is a planned
# upgrade — reference toggles via DataContext.use_push_based_shuffle)
# ---------------------------------------------------------------------------

def _gather_rows(bundles: list[RefBundle]):
    blocks = []
    for b in bundles:
        blocks.extend(ray_tpu_torch.get(list(b.refs)))
    return concat_blocks(blocks)


def _emit_blocks(block, num_blocks: int) -> list[RefBundle]:
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    num_blocks = max(1, min(num_blocks, n) if n else 1)
    out = []
    for i in builtins.range(num_blocks):
        start = i * n // num_blocks
        end = (i + 1) * n // num_blocks
        part = acc.slice(start, end)
        pacc = BlockAccessor.for_block(part)
        out.append(RefBundle([ray_tpu_torch.put(part)],
                             num_rows=pacc.num_rows(),
                             size_bytes=pacc.size_bytes()))
    return out


def _repartition(bundles, num_blocks):
    return _emit_blocks(_gather_rows(bundles), num_blocks)


def _shuffle(bundles, seed):
    merged = _gather_rows(bundles)
    acc = BlockAccessor.for_block(merged)
    n = acc.num_rows()
    perm = np.random.default_rng(seed).permutation(n)
    if isinstance(merged, dict):
        shuffled = {k: np.asarray(v)[perm] for k, v in merged.items()}
    else:
        shuffled = [merged[i] for i in perm]
    return _emit_blocks(shuffled, max(1, len(bundles)))


def _sort(bundles, key):
    merged = _gather_rows(bundles)
    if isinstance(merged, dict):
        order = np.argsort(np.asarray(merged[key]), kind="stable")
        out = {k: np.asarray(v)[order] for k, v in merged.items()}
    else:
        out = sorted(merged, key=lambda r: r[key])
    return _emit_blocks(out, max(1, len(bundles)))


# ---------------------------------------------------------------------------
# sources (reference: data/read_api.py + datasource/)
# ---------------------------------------------------------------------------

def _bundle_of(block) -> RefBundle:
    acc = BlockAccessor.for_block(block)
    return RefBundle([ray_tpu_torch.put(block)], num_rows=acc.num_rows(),
                     size_bytes=acc.size_bytes())


def range(n: int, *, num_blocks: int = 8) -> Dataset:  # noqa: A001
    def source():
        out = []
        for i in builtins.range(num_blocks):
            start = i * n // num_blocks
            end = (i + 1) * n // num_blocks
            if end > start:
                out.append(_bundle_of(
                    {"id": np.arange(start, end, dtype=np.int64)}))
        return out
    return Dataset(source)


def from_items(items: list, *, num_blocks: int = 8) -> Dataset:
    items = list(items)

    def source():
        out = []
        nb = max(1, min(num_blocks, len(items)))
        for i in builtins.range(nb):
            start = i * len(items) // nb
            end = (i + 1) * len(items) // nb
            if end > start:
                out.append(_bundle_of(items[start:end]))
        return out
    return Dataset(source)


def from_numpy(arrays: dict, *, num_blocks: int = 8) -> Dataset:
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    n = len(next(iter(arrays.values())))

    def source():
        out = []
        nb = max(1, min(num_blocks, n))
        for i in builtins.range(nb):
            start = i * n // nb
            end = (i + 1) * n // nb
            if end > start:
                out.append(_bundle_of(
                    {k: v[start:end] for k, v in arrays.items()}))
        return out
    return Dataset(source)


def _resolve_fs(path: str):
    """(filesystem, fs_path) for a possibly-URI path (reference: the
    pyarrow.fs resolution behind every datasource — ``file://``, S3/GCS
    URIs included). Plain local paths bypass pyarrow entirely."""
    if "://" not in path:
        return None, path
    pafs = _optional("pyarrow.fs", "pyarrow")

    return pafs.FileSystem.from_uri(path)


def _open_path(path: str, mode: str = "r"):
    """open() for local paths OR pyarrow.fs URIs — the shared IO hook
    behind every datasource (reference: pyarrow.fs usage across
    data/datasource/). Modes: "r" text, "rb" binary, "csv" text with
    universal-newline handling disabled (the csv module's contract)."""
    fs, fsp = _resolve_fs(path)
    if fs is None:
        if mode == "csv":
            return open(fsp, newline="")
        return open(fsp, mode)
    import io

    stream = fs.open_input_file(fsp)
    if mode == "rb":
        return stream
    return io.TextIOWrapper(stream, newline="" if mode == "csv" else None)


def read_json(paths, *, num_blocks: int = 8) -> Dataset:
    """Line-delimited JSON files → row datasets."""
    import json as _json

    if isinstance(paths, str):
        paths = [paths]

    def source():
        rows = []
        for p in paths:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(_json.loads(line))
        return [b for ds_b in [from_items(rows, num_blocks=num_blocks)
                               ._source_fn()] for b in ds_b]
    return Dataset(source)


def read_csv(paths, *, num_blocks: int = 8) -> Dataset:
    import csv as _csv

    if isinstance(paths, str):
        paths = [paths]

    def source():
        rows = []
        for p in paths:
            with _open_path(p, "csv") as f:
                rows.extend(dict(r) for r in _csv.DictReader(f))
        return from_items(rows, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


# ---------------------------------------------------------------------------
# push-based shuffle (reference: push_based_shuffle_task_scheduler.py,
# toggled by DataContext.use_push_based_shuffle)
# ---------------------------------------------------------------------------

def _shuffle_map_partition(block, n_parts: int, seed):
    """Map stage task: split one block's rows uniformly at random into
    n_parts partition blocks."""
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n_parts, size=n)
    batch = acc.to_batch()
    parts = []
    for p in builtins.range(n_parts):
        idx = np.flatnonzero(assign == p)
        parts.append({k: np.asarray(v)[idx] for k, v in batch.items()})
    return parts


def _shuffle_reduce(seed, *part_blocks):
    """Reduce stage task: concat this partition's pieces and shuffle
    within the partition. Returns (block, (rows, bytes)) as two objects
    so the driver can build a RefBundle from the tiny metadata object
    without pulling the block."""
    merged = concat_blocks(list(part_blocks))
    acc = BlockAccessor.for_block(merged)
    n = acc.num_rows()
    perm = np.random.default_rng(seed).permutation(n) if n else []
    if isinstance(merged, dict):
        block = {k: np.asarray(v)[perm] for k, v in merged.items()}
    else:
        block = [merged[i] for i in perm]
    bacc = BlockAccessor.for_block(block)
    return block, (bacc.num_rows(), bacc.size_bytes())


def _push_shuffle(bundles, seed):
    """Two-stage distributed shuffle: every map task emits one piece per
    reduce partition; reduce tasks concat+shuffle their pieces. Blocks
    move by ObjectRef end to end (task args auto-deref), so the driver
    only ever touches per-partition metadata tuples."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    n_parts = ctx.shuffle_partitions or max(1, len(bundles))
    map_task = ray_tpu_torch.remote(_shuffle_map_partition)
    reduce_task = ray_tpu_torch.remote(_shuffle_reduce)

    piece_refs = []  # piece_refs[map_idx][part] -> ObjectRef of one piece
    i = 0
    for b in bundles:
        for ref in b.refs:
            sub = seed + i if seed is not None else None
            refs = map_task.options(num_returns=n_parts).remote(
                ref, n_parts, sub)
            piece_refs.append([refs] if n_parts == 1 else refs)
            i += 1
    block_refs, meta_refs = [], []
    for p in builtins.range(n_parts):
        pieces = [plist[p] for plist in piece_refs]
        rseed = None if seed is None else seed + 100_003 + p
        bref, mref = reduce_task.options(num_returns=2).remote(
            rseed, *pieces)
        block_refs.append(bref)
        meta_refs.append(mref)
    out = []
    for bref, (n, nbytes) in builtins.zip(block_refs,
                                          ray_tpu_torch.get(meta_refs)):
        if n:
            out.append(RefBundle([bref], num_rows=n, size_bytes=nbytes))
    return out


# ---------------------------------------------------------------------------
# parquet IO (reference: data/datasource/parquet_datasource.py; pyarrow)
# ---------------------------------------------------------------------------

def read_parquet(paths, *, num_blocks: int = 8, columns=None) -> Dataset:
    """Parquet files → column-dict blocks (one or more blocks per file's
    row groups). Paths may be local or pyarrow.fs URIs (``file://``,
    ``s3://``, ``gs://`` — credentials per pyarrow)."""
    pq = _optional("pyarrow.parquet", "pyarrow")

    if isinstance(paths, str):
        paths = [paths]

    def source():
        out = []
        per_file = max(1, num_blocks // len(paths))
        for p in paths:
            fs, fsp = _resolve_fs(p)
            table = pq.read_table(fsp, columns=columns, filesystem=fs)
            cols = {name: table.column(name).to_numpy(zero_copy_only=False)
                    for name in table.column_names}
            out.extend(_emit_blocks(cols, per_file))
        return out
    return Dataset(source)


def from_arrow(tables, *, num_blocks: int = 8) -> Dataset:
    """pyarrow Table(s) → column-block dataset (reference:
    ``data/read_api.py from_arrow``)."""
    pa = _optional("pyarrow")

    if isinstance(tables, pa.Table):
        tables = [tables]
    if not tables:
        return from_items([])
    table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
    cols = {name: table.column(name).to_numpy(zero_copy_only=False)
            for name in table.column_names}
    return from_numpy(cols, num_blocks=num_blocks)


def from_pandas(dfs, *, num_blocks: int = 8) -> Dataset:
    """pandas DataFrame(s) → column-block dataset (reference:
    ``data/read_api.py from_pandas``)."""
    pd = _optional("pandas")

    if isinstance(dfs, pd.DataFrame):
        dfs = [dfs]
    frames = [df.reset_index(drop=True) for df in dfs]
    if not frames:
        return from_items([])
    merged = frames[0] if len(frames) == 1 else pd.concat(
        frames, ignore_index=True)
    if not len(merged.columns):   # from_numpy({}) would StopIteration
        return from_items([])
    return from_numpy({c: merged[c].to_numpy() for c in merged.columns},
                      num_blocks=num_blocks)


def read_text(paths, *, num_blocks: int = 8, drop_empty: bool = True
              ) -> Dataset:
    """Text files → one row per line, column ``text`` (reference:
    ``data/read_api.py read_text``)."""
    if isinstance(paths, str):
        paths = [paths]

    def source():
        lines = []
        for p in paths:
            with _open_path(p) as f:
                for line in f:
                    line = line.rstrip("\r\n")   # CRLF-safe
                    if line or not drop_empty:
                        lines.append({"text": line})
        return from_items(lines, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


def read_binary_files(paths, *, include_paths: bool = False,
                      num_blocks: int = 8) -> Dataset:
    """Whole files as ``bytes`` rows (reference: ``read_binary_files``)."""
    if isinstance(paths, str):
        paths = [paths]

    def source():
        rows = []
        for p in paths:
            with _open_path(p, "rb") as f:
                row = {"bytes": f.read()}
                if include_paths:
                    row["path"] = p
                rows.append(row)
        return from_items(rows, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


def read_tfrecords(paths, *, num_blocks: int = 8) -> Dataset:
    """TFRecord files of ``tf.train.Example`` records → one dict row per
    record (reference: ``datasource/tfrecords_datasource.py``). Parsed
    WITHOUT tensorflow — see ``ray_tpu_torch.data.tfrecord`` for the wire
    codecs. pyarrow.fs URIs work like every other reader."""
    from ray_tpu_torch.data import tfrecord as _tfr

    if isinstance(paths, str):
        paths = [paths]

    def source():
        rows = []
        for p in paths:
            with _open_path(p, "rb") as f:
                data = f.read()
            for record in _tfr.iter_records(data):
                rows.append(_tfr.parse_example(record))
        return from_items(rows, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


def write_tfrecords_file(rows, path: str):
    """Write dict rows to ONE TFRecord file of tf.train.Example records
    (the reference's ``write_tfrecords`` writes a file per block; a
    single-file helper keeps the API honest without a writer plan)."""
    from ray_tpu_torch.data import tfrecord as _tfr

    with _open_path(path, "wb") as f:
        for row in rows:
            f.write(_tfr.frame_record(_tfr.build_example(row)))


def read_avro(paths, *, num_blocks: int = 8) -> Dataset:
    """Avro object container files → one dict row per record
    (reference: ``datasource/avro_datasource.py``). Decoded WITHOUT an
    avro library — see ``ray_tpu_torch.data.avro`` for the binary codec
    (null + deflate codecs). pyarrow.fs URIs work like every other
    reader."""
    from ray_tpu_torch.data import avro as _avro

    if isinstance(paths, str):
        paths = [paths]

    def source():
        rows = []
        for p in paths:
            with _open_path(p, "rb") as f:
                rows.extend(_avro.iter_avro(f.read()))
        return from_items(rows, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


def write_avro_file(rows, path: str, *, schema: dict | None = None,
                    codec: str = "null"):
    """Write dict rows to ONE avro container file (schema inferred from
    the first row when omitted; single-file helper mirroring
    ``write_tfrecords_file``)."""
    from ray_tpu_torch.data import avro as _avro

    with _open_path(path, "wb") as f:
        f.write(_avro.write_avro(rows, schema, codec=codec))


def read_webdataset(paths, *, num_blocks: int = 8) -> Dataset:
    """WebDataset tar shards → one dict row per sample (reference:
    ``datasource/webdataset_datasource.py``): files grouped by basename
    before the first extension dot; row keys are the extensions plus
    ``__key__``. ``.cls`` decodes to int, ``.txt``/``.json`` to
    str/object; other extensions stay raw bytes."""
    import io
    import json as _json
    import tarfile

    if isinstance(paths, str):
        paths = [paths]

    def _decode(ext: str, data: bytes):
        if ext == "cls":
            return int(data.decode("utf-8").strip())
        if ext in ("txt", "text"):
            return data.decode("utf-8")
        if ext == "json":
            return _json.loads(data.decode("utf-8"))
        return data

    def source():
        rows = []
        for p in paths:
            with _open_path(p, "rb") as f:
                blob = f.read()
            with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
                current_key = None
                row: dict = {}
                for member in tar:
                    if not member.isfile():
                        continue
                    # key = directory + basename-stem (webdataset
                    # convention): the extension split happens on the
                    # BASENAME only — a dot in a directory name must not
                    # corrupt the key — while same basenames in
                    # different directories stay different samples
                    dirpart, _, base = member.name.rpartition("/")
                    stem, _, ext = base.partition(".")
                    key = f"{dirpart}/{stem}" if dirpart else stem
                    if key != current_key:
                        if row:
                            rows.append(row)
                        current_key = key
                        row = {"__key__": key}
                    row[ext] = _decode(
                        ext, tar.extractfile(member).read())
                if row:
                    rows.append(row)
        return from_items(rows, num_blocks=num_blocks)._source_fn()
    return Dataset(source)


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tiff")


def _expand_image_paths(paths) -> list[str]:
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, names in sorted(os.walk(p)):
                for n in sorted(names):
                    if n.lower().endswith(_IMAGE_EXTS):
                        files.append(os.path.join(root, n))
        elif os.path.exists(p):
            files.append(p)
        else:
            raise FileNotFoundError(f"no such image file or directory: {p}")
    return files


def read_images(paths, *, size: tuple | None = None, mode: str = "RGB",
                include_paths: bool = False,
                num_blocks: int | None = None) -> Dataset:
    """Image files/directories → rows with an ``image`` ndarray column
    (reference: ``data/datasource/image_datasource.py:41``; the input
    side of ViT).

    Listing happens on the driver; DECODING happens inside the streaming
    executor's map tasks, so ingest parallelizes across the cluster and
    flows through the byte-budget backpressure like any other operator.

    size: optional (height, width) resize. mode: PIL conversion mode
    ("RGB", "L", ...). Decoded dtype is uint8, shape [H, W, C] ([H, W]
    for mode "L").
    """
    files = _expand_image_paths(paths)
    if not files:
        raise FileNotFoundError(f"no image files under {paths!r}")
    n_blocks = num_blocks or min(len(files), 8)

    _optional("PIL.Image", "PIL")
    return from_items([{"path": f} for f in files],
                      num_blocks=n_blocks).map(functools.partial(
                          _decode_image, size=size, mode=mode,
                          include_paths=include_paths))


def _decode_image(row: dict, *, size, mode, include_paths) -> dict:
    """A map task of ``read_images``: decode one file (PIL), convert to
    ``mode``, resize to ``size``."""
    Image = _optional("PIL.Image", "PIL")

    img = Image.open(row["path"])
    if mode:
        img = img.convert(mode)
    if size is not None:
        img = img.resize((size[1], size[0]))  # PIL takes (w, h)
    out = {"image": np.asarray(img)}
    if include_paths:
        out["path"] = row["path"]
    return out


# ---------------------------------------------------------------------------
# column transforms (module level: bound with functools.partial, they
# reach a cluster's workers by stdlib pickle)
# ---------------------------------------------------------------------------

def _add_column(name, fn, batch):
    batch = dict(batch)
    batch[name] = np.asarray(fn(batch))
    return batch


def _drop_columns(drop, batch):
    return {k: v for k, v in batch.items() if k not in drop}


def _select_columns(keep, batch):
    return {k: batch[k] for k in keep}


def _rename_columns(mapping, batch):
    return {mapping.get(k, k): v for k, v in batch.items()}


def _optional(module: str, package: str | None = None):
    """Import ``module``, which an optional package provides; where it is
    missing, an ``ImportError`` that names the package."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        pkg = package or module
        raise ImportError(
            f"this call needs the optional package {pkg!r}, which is not "
            f"installed (pip install {pkg if pkg != 'PIL' else 'pillow'})"
        ) from e
