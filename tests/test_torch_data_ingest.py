"""The trainer's ingest from a port ``Dataset`` on the CPU
(``train/data_parallel_trainer.py``'s ``_dataset_feed``), and a pipeline
on a port cluster.

- ``DataParallelTrainer`` on two gloo ranks deals a ``Dataset`` by
  ``streaming_split`` (round-robin, disjoint): each rank's rows and its
  ``llama_tiny`` losses equal those of the same rows passed as columns,
  bit for bit, in the same run.
- ``TorchMeshTrainer`` on two gloo ranks fed by a pipeline (the stored
  tokens offset, undone by a module-level ``map_batches``, ``sort`` on a
  row index, ``drop_columns``, ``repartition`` into blocks that do not
  hold a whole batch) gives the losses and gradient norms of the same
  rows as columns, bit for bit; without the undoing map they differ.
- A pipeline that raises: JAX's ``streaming_split`` ends its splits early
  and says nothing; the port's splits raise, and ``fit()`` returns the
  error in ``Result.error`` within the test's limit, no rank left.
- A pipeline of module-level functions on a port cluster gives the
  in-process rows, and its ``iter_torch_batches`` tensors own their
  memory (an in-place add leaves the stored blocks as they were).
"""

import functools
import glob
import json
import multiprocessing
import threading

import numpy as np
import pytest

import ray_tpu_torch
import torch_data_fns as fns
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.train import data_parallel_trainer as dpt
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

LIMIT_S = 120.0
VOCAB = 256
SEQ = 17
CFG = tllama.LlamaConfig(vocab_size=VOCAB, d_model=32, n_layers=2,
                         n_heads=4, n_kv_heads=4, d_ff=64, head_dim=8,
                         remat="none", dtype="float32")


def _fit(trainer):
    """``trainer.fit()`` within LIMIT_S: on expiry every child process is
    killed and the test fails. Afterwards no child process is left."""
    box = {}

    def run():
        try:
            box["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    if t.is_alive():
        for p in multiprocessing.active_children():
            p.kill()
        pytest.fail(f"fit() did not finish within {LIMIT_S} s")
    assert multiprocessing.active_children() == []
    if "error" in box:
        raise box["error"]
    return box["result"]


def _cpu(n: int) -> ScalingConfig:
    return ScalingConfig(num_workers=n, use_gpu=False)


def _tokens(rows: int, seed: int = 3) -> np.ndarray:
    """Row i starts with token i (a row's id in what a rank read)."""
    t = np.random.default_rng(seed).integers(0, VOCAB, (rows, SEQ))
    t[:, 0] = np.arange(rows)
    return t.astype(np.int64)


@pytest.fixture(scope="module")
def local_runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def test_data_parallel_trainer_deals_a_dataset_as_the_columns(
        local_runtime, tmp_path):
    """16 rows in blocks of 4, stored so that the round-robin deal gives
    each rank the contiguous half that the columns give it: the same rows
    and the same losses, bit for bit, on both ranks."""
    tokens = _tokens(16)
    order = [*range(0, 4), *range(8, 12), *range(4, 8), *range(12, 16)]
    ds = tdata.from_numpy({"tokens": tokens[order]}, num_blocks=4)
    result = _fit(dpt.DataParallelTrainer(
        fns.shard_train_loop, scaling_config=_cpu(2),
        run_config=RunConfig(storage_path=str(tmp_path)),
        train_loop_config={
            "model_config": CFG, "seed": 0, "batch_size": 4,
            "train_config": TrainConfig(mesh_axes={"dp": 1},
                                        learning_rate=1e-3,
                                        warmup_steps=1, total_steps=50),
            "shards": ["train", "cols"]},
        datasets={"train": ds, "cols": {"tokens": tokens}}))
    assert result.error is None, result.error
    ranks = [json.load(open(p)) for p in sorted(glob.glob(
        str(tmp_path / "**" / "shard_train_rank*.json"), recursive=True))]
    assert [r["cols"]["rows"] for r in ranks] == [list(range(8)),
                                                  list(range(8, 16))]
    for r in ranks:
        assert r["train"]["rows"] == r["cols"]["rows"]
        assert len(r["train"]["losses"]) == 2
        assert r["train"]["losses"] == r["cols"]["losses"]


def _mesh_trainer(tmp_path, data, name):
    return dpt.TorchMeshTrainer(
        CFG, TrainConfig(mesh_axes={"dp": 2}, learning_rate=1e-3,
                         warmup_steps=1, total_steps=50),
        train_loop_config={"seed": 0, "steps": 2, "batch_size": 4},
        scaling_config=_cpu(2),
        run_config=RunConfig(storage_path=str(tmp_path / name)),
        datasets={"train": data})


def _stored(tokens):
    """The rows stored offset, in a seeded permutation, with their
    index."""
    perm = np.random.default_rng(11).permutation(len(tokens))
    stored = fns.offset_tokens({"tokens": tokens[perm]}, VOCAB)
    return {"tokens": stored["tokens"], "idx": perm}


def _pipeline(tokens, undo=True):
    ds = tdata.from_numpy(_stored(tokens), num_blocks=4)
    if undo:
        ds = ds.map_batches(functools.partial(fns.undo_offset, vocab=VOCAB))
    return ds.sort("idx").drop_columns(["idx"]).repartition(3)


def test_mesh_trainer_fed_by_a_pipeline_as_by_the_columns(local_runtime,
                                                          tmp_path):
    """Two global batches of 4 rows on {dp 2}: the pipeline's blocks (2,
    3 and 3 rows) re-batched across their boundaries give the columns'
    losses and gradient norms bit for bit; without the undoing map
    (control) the first loss differs."""
    tokens = _tokens(8)
    got = [b["tokens"] for b in _pipeline(tokens).iter_batches()]
    assert [len(b) for b in got] == [2, 3, 3]
    np.testing.assert_array_equal(np.concatenate(got), tokens)
    cols = _fit(_mesh_trainer(tmp_path, {"tokens": tokens}, "cols"))
    fed = _fit(_mesh_trainer(tmp_path, _pipeline(tokens), "fed"))
    for r in (cols, fed):
        assert r.error is None, r.error
    want = [(m["loss"], m["grad_norm"]) for m in cols.metrics_history]
    assert len(want) == 2
    assert [(m["loss"], m["grad_norm"]) for m in fed.metrics_history] == \
        want
    # the control: the stored tokens reach the trainer as they are
    control = np.concatenate([b["tokens"] for b in _pipeline(
        tokens, undo=False).iter_batches()])
    tr = Trainer(CFG, TrainConfig(mesh_axes={"dp": 1}, learning_rate=1e-3,
                                  warmup_steps=1, total_steps=50),
                 device="cpu")
    _, m = tr.train_step(tr.init_state(seed=0), control[:4])
    assert abs(float(m["loss"]) - want[0][0]) > 1e-3


# JAX's pump thread dies of the pipeline's error: what this test shows
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_pipeline_that_raises_ends_fit_with_its_error(local_runtime,
                                                        ray_tpu_start,
                                                        tmp_path):
    """The block holding id 40 raises. JAX's split iterators end early
    without a word; the port's raise it, after the bundles dealt before;
    ``fit()`` on two ranks returns it in ``Result.error``."""
    fail = functools.partial(fns.fail_at_block, at=40)
    jax_rows = [sorted(int(r["id"]) for r in it.iter_rows()) for it in
                jdata.range(80, num_blocks=8).map_batches(fail)
                .streaming_split(2)]
    assert sum(len(r) for r in jax_rows) < 80          # truncated, silent
    assert all(40 not in r for r in jax_rows)
    splits = tdata.range(80, num_blocks=8).map_batches(fail)\
        .streaming_split(2)
    seen = []
    with pytest.raises(RuntimeError, match="bad row 40"):
        for it in splits:
            for row in it.iter_rows():
                seen.append(int(row["id"]))
    assert 40 not in seen
    result = _fit(dpt.DataParallelTrainer(
        fns.read_shard_loop, scaling_config=_cpu(2),
        run_config=RunConfig(storage_path=str(tmp_path)),
        datasets={"train": tdata.range(80, num_blocks=8).map_batches(
            fail)}))
    assert result.error is not None and "bad row 40" in result.error


def _cluster_pipeline():
    return (tdata.range(40, num_blocks=4)
            .map(fns.square_row)
            .filter(fns.keep_even)
            .sort("id")
            .repartition(3))


def test_module_level_pipeline_on_a_cluster_gives_the_local_rows():
    """The same pipeline on the in-process runtime and on a port cluster
    (tasks in worker processes): equal rows. Its torch batches own their
    memory: an in-place add on a tensor leaves the stored block as it
    was, on the cluster and in-process."""
    from ray_tpu_torch.cluster_utils import Cluster

    def own_memory():
        mat = _cluster_pipeline().materialize()
        before = [b["sq"].copy() for b in mat.iter_batches()]
        for b in mat.iterator().iter_torch_batches(device="cpu",
                                                   drop_last=False):
            b["sq"].add_(1)
        after = [b["sq"] for b in mat.iter_batches()]
        return all(np.array_equal(x, y) for x, y in zip(before, after))

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        local = _cluster_pipeline().take_all()
        assert own_memory()
    finally:
        ray_tpu_torch.shutdown()
    c = Cluster()
    try:
        c.add_node(num_cpus=2)
        ray_tpu_torch.init(address=c.gcs_address)
        got = _cluster_pipeline().take_all()
        assert own_memory()
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    assert [r["id"] for r in local] == list(range(0, 40, 2))
    assert got == local
