"""The port's multi-process train harness on the CPU: rank processes over
gloo (``train/worker_group.py``, ``train/data_parallel_trainer.py``,
``parallel/process_group.py``) and ``Trainer(process_group=)``.

- Parity: a world-2 gloo run of ``Trainer`` with a process group matches,
  after 2 steps and within 1e-5, the single-controller ``Trainer`` on
  {"dp": 2} and ``JaxTrainer`` on a {"dp": 2} mesh of JAX's 8 CPU devices,
  from the same weights (``convert.params_from_numpy``); also with -1
  padding on one rank's rows only. Ranks that skip the gradient
  all-reduce (the control) must break that bound.
- Harness behaviour, as ``tests/test_train_harness.py`` checks the JAX
  harness: rank-0 reports and their history, distinct ranks, dataset
  shards, ``FailureConfig`` retries that resume from the last checkpoint,
  top-k retention (``_TopKCheckpoints`` against the JAX class), and an
  error in one rank surfacing as ``Result.error`` with no process left.

Every run is joined within its own time limit (``_fit``), its ranks kill
on expiry, and its ranks run one thread each (the loops in
``torch_harness_loops.py``, which import no jax, so they reach the ranks
by pickle).
"""

import glob
import json
import multiprocessing
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_harness_loops as loops
from ray_tpu.air.config import CheckpointConfig as JaxCheckpointConfig
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.train.data_parallel_trainer import \
    _TopKCheckpoints as JaxTopK
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.train import data_parallel_trainer as dpt
from ray_tpu_torch.train.state import TrainState
from ray_tpu_torch.train.trainer import TrainConfig, Trainer, _local_axes
from ray_tpu_torch.train.worker_group import WorkerGroup

LIMIT_S = 120.0
VOCAB = 256


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
    """``n`` ranks on the CPU over gloo."""
    return ScalingConfig(num_workers=n, use_gpu=False)


def _run_config(tmp_path, **kw):
    return RunConfig(storage_path=str(tmp_path), **kw)


def _rank_files(tmp_path, name):
    files = sorted(glob.glob(str(tmp_path / "**" / f"{name}_rank*.json"),
                             recursive=True))
    return [json.load(open(f)) for f in files]


# --- harness behaviour ---------------------------------------------------


def test_reports_distinct_ranks_and_dataset_shards(tmp_path):
    """Three ranks: rank 0's three reports are the result and its history;
    each rank has its own rank (its stats come back in rank order); each
    reads its contiguous part of the dataset, the parts covering it
    once."""
    ids = np.arange(64, dtype=np.int64)
    result = _fit(dpt.DataParallelTrainer(
        loops.report_loop, scaling_config=_cpu(3),
        run_config=_run_config(tmp_path), datasets={"train": {"id": ids}}))
    assert result.error is None
    assert result.metrics["rank"] == 0 and result.metrics["world"] == 3
    assert len(result.metrics_history) == 3
    assert result.metrics["loss"] == pytest.approx(1 / 3)
    assert result.first_report_s is not None and result.first_report_s > 0
    assert [s["rank"] for s in result.rank_stats] == [0, 1, 2]
    assert all(s["device"] == "cpu" for s in result.rank_stats)
    for s in result.rank_stats:
        tel = s["telemetry"]
        assert tel["steps"] == 3 and len(tel["history"]) == 3
    shards = _rank_files(tmp_path, "shard")
    assert [s["rows"] for s in shards] == [21, 21, 22]
    assert sum(s["total"] for s in shards) == int(ids.sum())
    assert shards[0]["batch_rows"] == [8, 8, 5]


def test_failure_config_retries_resume_from_the_last_checkpoint(tmp_path):
    result = _fit(dpt.DataParallelTrainer(
        loops.flaky_loop, scaling_config=_cpu(1),
        run_config=_run_config(
            tmp_path, failure_config=FailureConfig(max_failures=1))))
    assert result.error is None
    assert result.metrics == {"ok": 1, "resumed_from": 2}


def test_failure_without_retries_keeps_the_error(tmp_path):
    result = _fit(dpt.DataParallelTrainer(
        loops.flaky_loop, scaling_config=_cpu(1),
        run_config=_run_config(tmp_path)))
    assert "transient-failure" in result.error
    assert result.checkpoint_dir.endswith("ckpt_2")


def test_error_in_one_rank_surfaces_and_no_rank_is_left(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the error comes
    back with its traceback, and rank 0 is killed (``_fit`` asserts no
    child process is left)."""
    result = _fit(dpt.DataParallelTrainer(
        loops.error_loop, scaling_config=_cpu(2),
        run_config=_run_config(tmp_path)))
    assert result.error is not None
    assert "ValueError: broken loop" in result.error
    assert "Traceback" in result.error


def test_a_taken_rendezvous_port_is_retried_once(tmp_path, monkeypatch):
    """The port bound as port 0 can be taken before rank 0 binds it: that
    rank fails with EADDRINUSE and the group starts once more on a new
    port. A port taken twice fails the run."""
    from ray_tpu_torch.parallel import process_group
    from ray_tpu_torch.train import worker_group

    taken = socket.socket()
    taken.bind(("localhost", 0))
    taken.listen()
    ports = [taken.getsockname()[1]]
    monkeypatch.setattr(worker_group, "free_port", lambda: ports.pop()
                        if ports else process_group.free_port())
    try:
        result = _fit(dpt.DataParallelTrainer(
            loops.report_loop, scaling_config=_cpu(2),
            run_config=_run_config(tmp_path)))
        assert result.error is None and len(result.metrics_history) == 3
        ports[:] = [taken.getsockname()[1]] * 2
        result = _fit(dpt.DataParallelTrainer(
            loops.report_loop, scaling_config=_cpu(1),
            run_config=_run_config(tmp_path)))
        assert "EADDRINUSE" in result.error
    finally:
        taken.close()


def test_nccl_refuses_two_ranks_per_card_before_any_rank_starts(tmp_path):
    cards = torch.cuda.device_count()
    trainer = dpt.DataParallelTrainer(
        loops.report_loop, scaling_config=ScalingConfig(
            num_workers=cards + 1, use_gpu=True, backend="nccl"),
        run_config=_run_config(tmp_path))
    with pytest.raises(RuntimeError, match="refuses two ranks on one GPU"):
        trainer.fit()
    assert multiprocessing.active_children() == []
    with pytest.raises(ValueError, match="needs use_gpu"):
        WorkerGroup(ScalingConfig(backend="nccl", use_gpu=False))
    with pytest.raises(ValueError, match="unknown backend"):
        WorkerGroup(ScalingConfig(backend="mpi"))
    assert ScalingConfig(use_gpu=True).resolved_backend() == "nccl"
    assert ScalingConfig(use_gpu=False).resolved_backend() == "gloo"


def test_the_harness_runs_on_the_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch):
    """As every entry point of the port: a default ScalingConfig asks for
    the card (nccl), and on a host without one the harness raises before
    any rank starts, over either backend; no rank falls back to the CPU.
    Outside a rank the session's context names the card too."""
    from ray_tpu_torch.parallel.process_group import rank_device
    from ray_tpu_torch.train import session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert ScalingConfig().use_gpu
    assert ScalingConfig().resolved_backend() == "nccl"
    for scaling in (None, ScalingConfig(num_workers=2, backend="gloo")):
        trainer = dpt.DataParallelTrainer(
            loops.report_loop, scaling_config=scaling,
            run_config=_run_config(tmp_path))
        with pytest.raises(RuntimeError, match="use_gpu=False"):
            trainer.fit()
        assert multiprocessing.active_children() == []
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        rank_device(0, True)
    assert rank_device(1, False) == torch.device("cpu")
    assert session.TrainContext().device == "cuda"


@pytest.mark.parametrize("seq", [
    ("score", "max", 2, [3.0, 1.0, 4.0, 1.5, 9.0]),
    ("score", "min", 2, [3.0, 1.0, 4.0, 1.5, 9.0]),
    (None, "max", 3, [0.0] * 5),
    ("score", "max", None, [2.0, 1.0]),
])
def test_top_k_checkpoints_match_jax(tmp_path, seq):
    """The port's retention against the JAX class on the same sequence:
    the same survivors on disk, the same best and latest."""
    attr, order, keep, scores = seq
    runs = {}
    for name, cls, cfg_cls in (("jax", JaxTopK, JaxCheckpointConfig),
                               ("torch", dpt._TopKCheckpoints,
                                CheckpointConfig)):
        root = tmp_path / name
        mgr = cls(cfg_cls(num_to_keep=keep, checkpoint_score_attribute=attr,
                          checkpoint_score_order=order))
        for i, s in enumerate(scores):
            d = root / f"ckpt_{i}"
            d.mkdir(parents=True)
            mgr.add(str(d), {"score": s})
        runs[name] = (sorted(os.listdir(root)),
                      os.path.basename(mgr.best()),
                      os.path.basename(mgr.latest()))
    assert runs["torch"] == runs["jax"]


def test_process_group_collectives(tmp_path):
    """all_reduce (sum, mean, bf16), broadcast, all_gather_object, the
    bucketed gradient all-reduce (packed leaves, a leaf larger than a
    bucket, two dtypes), and check_same raising for differing states."""
    shapes = [(3,), (2, 2), (5,), (20,)]
    result = _fit(dpt.DataParallelTrainer(
        loops.collectives_loop, scaling_config=_cpu(2),
        train_loop_config={"bucket_bytes": 64, "shapes": shapes},
        run_config=_run_config(tmp_path)))
    assert result.error is None
    outs = _rank_files(tmp_path, "collectives")
    assert len(outs) == 2
    want_grads = [np.array(a) + np.array(b)
                  for a, b in zip(outs[0]["mine"], outs[1]["mine"])]
    for r, out in enumerate(outs):
        assert out["sum"] == [3.0, 6.0]
        assert out["mean"] == [1.5, 3.0]
        assert out["bf16_sum"] == [1.5] * 3
        assert out["broadcast"] == [1.0, 1.0]
        assert out["gathered"] == [{"rank": 0}, {"rank": 1}]
        for got, want in zip(out["grads"], want_grads):
            np.testing.assert_allclose(got, want, rtol=1e-6)
        assert out["stats"]["grad_all_reduces"] == 1
        assert "differ before the first step" in out["differ_raised"]
        assert "'b'" in out["differ_raised"]


# --- Trainer over a process group ------------------------------------------


def _configs():
    """The tiny Llama of ``tests/test_elastic.py`` in float32, both
    packages."""
    kw = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=4, d_ff=64, head_dim=8, remat="none",
              dtype="float32")
    return jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)


TRAIN_KW = dict(mesh_axes={"dp": 2}, learning_rate=1e-3, warmup_steps=1,
                total_steps=50)


def _batches(pad: bool):
    """Two global batches [4, 17]; with ``pad``, the last 5 targets of
    rank 1's rows (rows 2 and 3) are -1 and rank 0's rows have none."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        b = rng.integers(0, VOCAB, (4, 17)).astype(np.int64)
        if pad:
            b[2:, -5:] = -1
        out.append(b)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(
        tree, torch.Tensor) else tree)}


def _max_err(got: dict, want: dict) -> float:
    assert set(want) <= set(got)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def test_process_group_trainer_matches_single_controller_and_jax(tmp_path):
    """World 2 over gloo, 2 steps, four cases from one spawn: even rows,
    padding on rank 1's rows only, and two controls on the padded rows:
    the skipped all-reduce and a mean in place of the sum. Both ranks end
    equal; each case's losses, gradient norms and parameters match the
    single-controller Trainer on {"dp": 2} and JaxTrainer on {"dp": 2}
    within 1e-5; each control is off by more than that (the mean only in
    the gradient norms: the clip and Adam do not see a uniform scale)."""
    jcfg, tcfg = _configs()
    jt = JaxTrainer(jcfg, JaxTrainConfig(**TRAIN_KW), mesh=jax_create_mesh(
        {"dp": 2}, devices=jax.devices()[:2]))
    jstate0 = jt.init_state(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jstate0.params)
    cases = {"even": _batches(False), "padded": _batches(True),
             "padded_skip_all_reduce": _batches(True),
             "padded_mean_all_reduce": _batches(True)}
    out = tmp_path / "params"
    out.mkdir()
    result = _fit(dpt.DataParallelTrainer(
        loops.train_loop, scaling_config=_cpu(2),
        train_loop_config={"model_config": tcfg,
                           "train_config": TrainConfig(**TRAIN_KW),
                           "params": params_np, "cases": cases,
                           "out": str(out)},
        run_config=_run_config(tmp_path)))
    assert result.error is None, result.error
    errs = {}
    for case, batches in cases.items():
        ranks = [dict(np.load(out / f"{case}_rank{r}.npz"))
                 for r in range(2)]
        # the single controller on {"dp": 2}
        tr = Trainer(tcfg, TrainConfig(**TRAIN_KW), device="cpu",
                     mesh=create_mesh({"dp": 2}, devices=["cpu"] * 2))
        state = TrainState.create(convert.params_from_numpy(
            tcfg, params_np, device="cpu"), tr.optimizer)
        # JaxTrainer on {"dp": 2}, from the same weights
        jstate = jt.init_state(jax.random.key(0))
        losses, jlosses, norms, jnorms = [], [], [], []
        for batch in batches:
            state, m = tr.train_step(state, batch)
            jstate, jm = jt.train_step(jstate, jnp.asarray(batch))
            losses.append(float(m["loss"]))
            jlosses.append(float(jm["loss"]))
            norms.append(float(m["grad_norm"]))
            jnorms.append(float(jm["grad_norm"]))
        single = _flat(state.params)
        jax_params = _flat(jax.tree.map(np.asarray, jstate.params))
        # every rank: its parameters and gradient norms against both
        # references (the losses are all-reduced, the same for a control)
        errs[case] = min(max(
            _max_err(r, single), _max_err(r, jax_params),
            float(np.abs(r["grad_norms"] - norms).max()),
            float(np.abs(r["grad_norms"] - jnorms).max())) for r in ranks)
        if "all_reduce" in case:
            continue
        assert _max_err(ranks[1], ranks[0]) == 0.0, case
        np.testing.assert_array_equal(ranks[1]["grad_norms"],
                                      ranks[0]["grad_norms"], err_msg=case)
        np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=0,
                                   atol=1e-5, err_msg=case)
        np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=0,
                                   atol=1e-5, err_msg=case)
    assert errs["even"] <= 1e-5 and errs["padded"] <= 1e-5, errs
    assert errs["padded_skip_all_reduce"] > 1e-5, errs
    assert errs["padded_mean_all_reduce"] > 1e-5, errs


def test_mesh_trainer_world_2_declares_each_rank_its_rows(tmp_path):
    """``TorchMeshTrainer`` on two gloo ranks, {"dp": 2}, 2 steps of [4,
    17] global batches through the device feed (on the CPU): rank 0's
    losses and gradient norms match the single-controller Trainer on
    {"dp": 2} from the same seed within 1e-5; each rank declares the
    FLOPs of its own rows (6 · parameters · 2 · 17, half the global
    batch's), so a rank's MFU is its own; its telemetry books the
    gradient all-reduce of every step into ``collective_sync``."""
    from ray_tpu_torch.train.optim import tree_leaves

    _, tcfg = _configs()
    tokens = np.random.default_rng(3).integers(0, VOCAB, (8, 17))
    result = _fit(dpt.TorchMeshTrainer(
        tcfg, TrainConfig(**TRAIN_KW),
        train_loop_config={"seed": 0, "steps": 2, "batch_size": 4},
        scaling_config=_cpu(2), run_config=_run_config(tmp_path),
        datasets={"train": {"tokens": tokens}}))
    assert result.error is None, result.error
    tr = Trainer(tcfg, TrainConfig(**TRAIN_KW), device="cpu",
                 mesh=create_mesh({"dp": 2}, devices=["cpu"] * 2))
    state = tr.init_state(seed=0)
    want = []
    for batch in (tokens[:4], tokens[4:]):
        state, m = tr.train_step(state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    got = [(m["loss"], m["grad_norm"]) for m in result.metrics_history]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    n_params = sum(x.numel() for x in tree_leaves(
        tllama.init_params(tcfg, seed=0, device="cpu")))
    assert len(result.rank_stats) == 2
    for stats in result.rank_stats:
        tel = stats["telemetry"]
        assert tel["flops_per_step"] == 6.0 * n_params * 2 * 17
        assert stats["process_group"]["grad_all_reduces"] == 2
        assert [h["stages"]["collective_sync"] > 0
                for h in tel["history"]] == [True, True]


def test_local_axes_span_dp_only():
    assert _local_axes({"dp": 2}, 2) == {"dp": 1}
    assert _local_axes({"dp": 4, "fsdp": 2}, 2) == {"dp": 2, "fsdp": 2}
    assert _local_axes({"dp": -1, "tp": 2}, 3) == {"dp": 1, "tp": 2}
    for axes in ({"fsdp": 2}, {"dp": 3}, {"pp": 2, "dp": 1}):
        with pytest.raises(NotImplementedError, match="later slice"):
            _local_axes(axes, 2)


class _FakeGroup:
    """A one-rank stand-in for a ``ProcessGroup`` (no collective runs)."""

    rank, world_size = 1, 2


def test_rank_rows_and_device_batches_are_not_copied():
    """A process keeps rows [rank·B/world, (rank+1)·B/world) of the global
    batch, as views of a tensor already on its device."""
    _, tcfg = _configs()
    tr = Trainer(tcfg, TrainConfig(**TRAIN_KW), device="cpu",
                 process_group=_FakeGroup())
    assert tr.mesh.shape == {"dp": 1}
    batch = torch.arange(4 * 17).reshape(4, 17)
    rows = tr._rank_rows(batch)
    assert torch.equal(rows, batch[2:])
    assert tr._to_device(rows).data_ptr() == batch[2:].data_ptr()
    rows = tr._rank_rows({"tokens": batch.numpy(), "n": np.int64(3)})
    assert rows["n"] == 3 and np.array_equal(rows["tokens"],
                                             batch.numpy()[2:])
    with pytest.raises(ValueError, match="does not divide"):
        tr._rank_rows(batch[:3])
