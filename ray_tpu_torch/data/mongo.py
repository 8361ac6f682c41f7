"""MongoDB datasource: ``read_mongo`` and ``write_mongo``.

Port of ``ray_tpu/data/mongo.py`` (reference:
``python/ray/data/datasource/mongo_datasource.py``). The collection
crosses task boundaries as a factory (a live client does not pickle), as
``read_sql``'s connection does. The factory returns an object with
pymongo's ``Collection`` surface (``find``, ``insert_many``, and
``database.client.close`` where it closes), so pymongo itself is never
imported: anything with that surface works.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.data.dataset import Dataset, from_items


def read_mongo(collection_factory: Callable, *,
               query: dict | None = None,
               projection: dict | None = None,
               num_blocks: int = 8) -> Dataset:
    """Materialize ``collection.find(query, projection)`` as a row
    Dataset (reference: ``ray.data.read_mongo``). The ``_id`` field is
    stringified (ObjectId isn't a plain-data type)."""

    def source():
        coll = collection_factory()
        try:
            cursor = (coll.find(query or {}, projection)
                      if projection is not None else coll.find(query or {}))
            rows = []
            for doc in cursor:
                doc = dict(doc)
                if "_id" in doc:
                    doc["_id"] = str(doc["_id"])
                rows.append(doc)
        finally:
            _close(coll)
        return from_items(rows, num_blocks=num_blocks)._source_fn()

    return Dataset(source)


def write_mongo(ds: Dataset, collection_factory: Callable) -> None:
    """Insert every row as a document (reference:
    ``Dataset.write_mongo``): ``insert_many`` per block."""
    from ray_tpu_torch.data.sql import rows_from_batch

    coll = collection_factory()
    try:
        for batch in ds.iter_batches():
            docs = rows_from_batch(batch)
            if docs:
                coll.insert_many(docs)
    finally:
        _close(coll)


def _close(coll):
    try:
        coll.database.client.close()
    except Exception:  # noqa: BLE001 - duck-typed double without close
        pass
