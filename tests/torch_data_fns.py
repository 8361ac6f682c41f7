"""Map functions and rank loops of the port's data tests
(``tests/test_torch_data_ingest.py``, ``tests/test_torch_data_dataset.py``).

Module level, and no ``ray_tpu`` import: a rank process receives its loop
by plain ``pickle``, and a port cluster's worker imports this module by
reference to run a map task. No torch at module level, so a cold worker
stays quick.
"""

import json
import os

import numpy as np

# the stored tokens are offset by this, mod the vocabulary
OFFSET = 7


def offset_tokens(batch, vocab):
    """The stored form of a batch: its tokens offset by OFFSET."""
    return {**batch, "tokens": (batch["tokens"] + OFFSET) % vocab}


def undo_offset(batch, vocab):
    """The inverse of ``offset_tokens``."""
    return {**batch, "tokens": (batch["tokens"] - OFFSET) % vocab}


def double_x(batch):
    return {**batch, "x": batch["x"] * 2}


def keep_even(row):
    return int(row["id"]) % 2 == 0


def square_row(row):
    return {"id": row["id"], "sq": int(row["id"]) ** 2}


def fail_at_block(batch, at=40):
    """Raises on the block that holds id ``at``."""
    if (np.asarray(batch["id"]) == at).any():
        raise ValueError(f"bad row {at}")
    return batch


def shard_train_loop(config):
    """Each rank trains its own ``Trainer`` (no process group) from the
    same seed on each of its shards (``<name>_shard`` for each name of
    ``config["shards"]``), ``config["steps"]`` steps of ``batch_size``
    rows, and writes the losses and the rows it read to
    ``<trial_dir>/shard_train_rank<r>.json``; rank 0 reports."""
    import torch

    torch.set_num_threads(1)
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.trainer import Trainer

    ctx = session.get_context()
    out = {}
    for name in config["shards"]:
        trainer = Trainer(config["model_config"], config["train_config"],
                          device="cpu")
        state = trainer.init_state(seed=config["seed"])
        losses, rows = [], []
        for batch in config[f"{name}_shard"].iter_torch_batches(
                batch_size=config["batch_size"], device="cpu"):
            rows += batch["tokens"][:, 0].tolist()
            state, m = trainer.train_step(state, batch["tokens"])
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "rows": rows}
    with open(os.path.join(ctx.trial_dir,
                           f"shard_train_rank{ctx.rank}.json"), "w") as f:
        json.dump(out, f)
    session.report({"done": 1.0})


def read_shard_loop(config):
    """Read the whole shard, row by row, then report."""
    from ray_tpu_torch.train import session

    n = sum(1 for _ in config["train_shard"].iter_rows())
    session.report({"rows": float(n)})
