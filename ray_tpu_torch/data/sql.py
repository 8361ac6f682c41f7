"""SQL datasource: ``read_sql`` and ``write_sql`` over any DB-API 2
connection.

Port of ``ray_tpu/data/sql.py`` (reference:
``python/ray/data/datasource/sql_datasource.py``: the reader takes a
``connection_factory`` returning a DB-API 2 connection, such as
``sqlite3.connect``). The factory, not a live connection, crosses task
boundaries: a connection does not pickle, so each read opens its own.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch.data.dataset import Dataset, from_items


def read_sql(sql: str, connection_factory: Callable, *,
             num_blocks: int = 8) -> Dataset:
    """Execute ``sql`` and return a row Dataset (one dict per row,
    column names from ``cursor.description``).

    Reference: ``ray.data.read_sql(sql, connection_factory)``
    (sql_datasource.py). The query runs once at materialization; rows
    split into ``num_blocks`` blocks for downstream parallelism."""

    def source():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
        finally:
            conn.close()
        return from_items(rows, num_blocks=num_blocks)._source_fn()

    return Dataset(source)


def write_sql(ds: Dataset, sql: str, connection_factory: Callable) -> None:
    """Write every row through a parameterized statement (reference:
    ``Dataset.write_sql(sql, connection_factory)``): ``sql`` is an
    INSERT with ``?``/``%s`` placeholders matching the dataset's column
    order, executed via ``executemany`` per block, one commit at the
    end."""
    conn = connection_factory()
    try:
        cur = conn.cursor()
        for batch in ds.iter_batches():
            rows = [tuple(r.values()) for r in rows_from_batch(batch)]
            if rows:
                cur.executemany(sql, rows)
        conn.commit()
    finally:
        conn.close()


def rows_from_batch(batch: dict) -> list[dict]:
    """Columnar batch -> row dicts with numpy scalars coerced to native
    Python (DB drivers reject np.int64 etc.). Shared by the SQL and
    Mongo writers."""
    keys = list(batch)
    n = len(batch[keys[0]]) if keys else 0
    return [{k: _py(batch[k][i]) for k in keys} for i in range(n)]


def _py(v):
    """numpy scalars -> native Python (sqlite3 rejects np.int64 etc.)."""
    item = getattr(v, "item", None)
    return item() if item is not None and getattr(v, "ndim", 0) == 0 else v
