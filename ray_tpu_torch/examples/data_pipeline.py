"""Quickstart: a streaming data pipeline with distributed transforms.

    python -m ray_tpu_torch.examples.data_pipeline

The port's copy of ``ray_tpu/examples/data_pipeline.py`` (reference: the
Dataset quickstarts of Ray Data's docs: read -> map_batches -> groupby ->
iterate), on the in-process runtime. ``main()`` prints each group's row
and the execution's stats, and returns the rows.
"""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import data


def main():
    ray_tpu_torch.init(num_cpus=4)
    ds = data.from_numpy({
        "x": np.arange(10_000, dtype=np.float32),
        "group": np.arange(10_000) % 7,
    })
    out = (ds
           .map_batches(lambda b: {**b, "y": b["x"] * 2 + 1})
           .filter(lambda row: row["group"] != 3)
           .groupby("group").mean("y"))
    rows = sorted(out.take_all(), key=lambda r: r["group"])
    for row in rows:
        print(row)
    print(out.stats())
    ray_tpu_torch.shutdown()
    return rows


if __name__ == "__main__":
    main()
