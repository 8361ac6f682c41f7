"""Preprocessors: fit/transform feature pipelines over Datasets.

Port of ``ray_tpu/data/preprocessors.py`` (reference:
``python/ray/data/preprocessors/``: the ``Preprocessor`` base, scalers,
encoders, ``Concatenator``, ``BatchMapper``, ``Chain``). Fitting runs
through the distributed aggregates (``data/aggregate.py``), statistics
per block merged, so the dataset never materializes in one place;
transforms are ``map_batches`` and stream.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.data.aggregate import Max, Mean, Min, Std


class Preprocessor:
    """fit(ds) learns state; transform(ds) applies it lazily."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and type(self)._fit is not Preprocessor._fit:
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform")
        return ds.map_batches(self._transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: dict) -> dict:
        """Apply to a single in-memory batch (serving-time path)."""
        return self._transform_batch(dict(batch))

    # -- subclass hooks --------------------------------------------------

    def _fit(self, ds):  # stateless preprocessors skip this
        pass

    def _transform_batch(self, batch: dict) -> dict:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict = {}

    def _fit(self, ds):
        aggs = []
        for c in self.columns:
            aggs += [Mean(c), Std(c, ddof=0)]
        out = ds.aggregate(*aggs)
        self.stats_ = {
            c: (out[f"mean({c})"], out[f"std({c})"] or 1.0)
            for c in self.columns
        }

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            std = std if std else 1.0
            batch[c] = (np.asarray(batch[c], dtype=np.float64) - mean) / std
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict = {}

    def _fit(self, ds):
        aggs = []
        for c in self.columns:
            aggs += [Min(c), Max(c)]
        out = ds.aggregate(*aggs)
        self.stats_ = {c: (out[f"min({c})"], out[f"max({c})"])
                       for c in self.columns}

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            denom = (hi - lo) or 1.0
            batch[c] = (np.asarray(batch[c], dtype=np.float64) - lo) / denom
        return batch


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes (sorted value order)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: list = []

    def _fit(self, ds):
        self.classes_ = ds.unique(self.label_column)

    def _transform_batch(self, batch):
        batch = dict(batch)
        lookup = {v: i for i, v in enumerate(self.classes_)}
        col = batch[self.label_column]
        batch[self.label_column] = np.asarray(
            [lookup[v.item() if hasattr(v, "item") else v] for v in col],
            dtype=np.int64)
        return batch


class OneHotEncoder(Preprocessor):
    """Categorical columns -> one-hot 0/1 columns named col_value."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.classes_: dict = {}

    def _fit(self, ds):
        self.classes_ = {c: ds.unique(c) for c in self.columns}

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            vals = np.asarray(batch.pop(c))
            for cls in self.classes_[c]:
                batch[f"{c}_{cls}"] = (vals == cls).astype(np.int64)
        return batch


class Concatenator(Preprocessor):
    """Merge feature columns into one float matrix column (the layout the
    trainer feeds to the device)."""

    def __init__(self, columns: list[str],
                 output_column_name: str = "features", dtype=np.float32):
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _transform_batch(self, batch):
        batch = dict(batch)
        mats = []
        for c in self.columns:
            col = np.asarray(batch.pop(c))
            mats.append(col[:, None] if col.ndim == 1 else col)
        batch[self.output_column_name] = np.concatenate(
            mats, axis=1).astype(self.dtype)
        return batch


class BatchMapper(Preprocessor):
    """Wrap an arbitrary batch function as a (stateless) preprocessor."""

    def __init__(self, fn):
        self.fn = fn

    def _transform_batch(self, batch):
        return self.fn(dict(batch))


class Chain(Preprocessor):
    """Sequential composition; fit runs left to right on progressively
    transformed data (same as the reference's Chain)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def fit(self, ds):
        cur = ds
        for st in self.stages:
            st.fit(cur)
            cur = st.transform(cur)
        self._fitted = True
        return self

    def _transform_batch(self, batch):
        for st in self.stages:
            batch = st._transform_batch(dict(batch))
        return batch
