"""fsdp, tp and sp across rank processes on the CPU: the port's
``Trainer(process_group=)`` on a global mesh whose places are dealt to
gloo rank processes (``parallel.mesh.split_axes``), against
``JaxTrainer`` on the same global mesh of JAX's 8 CPU devices.

Each world is spawned once for all its cases (``DataParallelTrainer``
with ``ScalingConfig(num_workers=n, use_gpu=False)``, the loop
``torch_harness_loops.cross_process_loop``), joined within 120 s and its
ranks killed on expiry. In float32 at tiny widths, from JAX's initial
weights (``convert.params_from_numpy``), every chunk of each process's
places of the final parameters and Adam moments is held against JAX's
``addressable_shards`` at that place (2e-4, as
``tests/test_torch_spmd.py``), and the losses and gradient norms within
1e-5 relative. The cases:

- ``llama_tiny`` under ``fsdp_tp`` on {fsdp 2, tp 2}: world 4 (one place
  a process; dense and fused loss) and world 2 (fsdp across the
  processes, tp inside each);
- ``gpt`` of 5 heads on {tp 2} at world 2 (the fused qkv's columns move
  between the processes, ``collectives.regroup``);
- ``bert_tiny`` under ``fsdp_tp`` through the mlm hook at world 4;
- ``llama`` on {sp 4} under ``fsdp_tp_sp`` at world 4, the ring between
  the processes: the flash body (chunks of 256 tokens, the kernels' plain
  versions) and the reference body;
- the controls, each of which must break the bound: the rank-list
  ``psum`` backward in place of Megatron's ``f``/``g`` pair, the fsdp
  gathers' reduce-scatter skipped, and the ring shifted the wrong way.
"""

import dataclasses
import multiprocessing
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_harness_loops as loops
from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.train import data_parallel_trainer as dpt

LIMIT_S = 120.0
VOCAB = 160
STEPS = 2
LR = 1e-3
FSDP_TP = {"fsdp": 2, "tp": 2}
SP4 = {"sp": 4}
MODULES = {"llama": (jllama, tllama), "gpt": (jgpt, tgpt),
           "bert": (jbert, tbert)}


def _configs(family, **overrides):
    jmod, tmod = MODULES[family]
    return tuple(dataclasses.replace(getattr(mod, f"{family}_tiny")(VOCAB),
                                     dtype="float32", **overrides)
                 for mod in (jmod, tmod))


def _batch(family, b, s, seed):
    """Tokens [b, s + 1] with some -1 padding in the last row, or bert's
    masked-LM batch over padded rows [b, s]."""
    rng = np.random.default_rng(seed)
    if family != "bert":
        tokens = rng.integers(0, VOCAB, (b, s + 1)).astype(np.int64)
        tokens[-1, -5:] = -1
        return tokens
    targets = rng.integers(4, VOCAB, (b, s)).astype(np.int64)
    mask = rng.random((b, s)) < 0.3
    lengths = rng.integers(s // 2, s + 1, b)
    attn = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    return {"tokens": np.where(mask, 3, targets), "targets": targets,
            "loss_mask": mask & (attn > 0), "attention_mask": attn}


def _mlm_loss(model_cfg, params, batch):
    return jbert.mlm_loss(model_cfg, params, batch["tokens"],
                          batch["targets"],
                          attention_mask=batch["attention_mask"],
                          loss_mask=batch["loss_mask"])


# name -> (family, config overrides, mesh, strategy, train kwargs,
# batch (b, s), world, case options)
CASES = {
    "llama_fsdp_tp_dense": ("llama", {}, FSDP_TP, "fsdp_tp", {}, (4, 32),
                            4, {}),
    "llama_fsdp_tp_fused": ("llama", {}, FSDP_TP, "fsdp_tp",
                            {"fused_loss": True, "loss_chunk": 16}, (4, 32),
                            4, {}),
    "bert_fsdp_tp_hook": ("bert", {}, FSDP_TP, "fsdp_tp", {}, (4, 16), 4,
                          {"hook": True}),
    "llama_sp4_flash": ("llama", {"head_dim": 64}, SP4, "fsdp_tp_sp", {},
                        (1, 1024), 4, {"ring_impl": "flash"}),
    "llama_sp4_reference": ("llama", {}, SP4, "fsdp_tp_sp", {}, (2, 64), 4,
                            {"ring_impl": "reference"}),
    "llama_fsdp_tp_world2": ("llama", {}, FSDP_TP, "fsdp_tp", {}, (4, 32),
                             2, {}),
    "gpt5_tp2_world2": ("gpt", {"d_model": 160, "n_heads": 5, "d_ff": 320},
                        {"tp": 2}, "tp", {}, (4, 32), 2, {}),
}
CONTROLS = {
    "control_psum_backward": ("llama_fsdp_tp_dense", "psum_backward"),
    "control_skip_reduce_scatter": ("llama_fsdp_tp_dense",
                                    "skip_reduce_scatter"),
    "control_reversed_ring": ("llama_sp4_reference", "reversed_ring"),
}


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


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _jax_run(name):
    """JaxTrainer's run of a case on the global mesh: its initial weights
    (numpy), its losses and norms, and its final trees' arrays."""
    family, over, axes, strategy, kw, (b, s), _, opts = CASES[name]
    jcfg, tcfg = _configs(family, **over)
    n = int(np.prod(list(axes.values())))
    jmesh = jax_create_mesh(axes, devices=jax.devices()[:n])
    train = dict(mesh_axes=axes, strategy=strategy, learning_rate=LR,
                 warmup_steps=1, total_steps=50, **kw)
    jt = JaxTrainer(jcfg, JaxTrainConfig(**train), mesh=jmesh,
                    loss_fn=_mlm_loss if opts.get("hook") else None)
    jstate = jt.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = [_batch(family, b, s, seed) for seed in range(STEPS)]
    losses, norms = [], []
    for batch in batches:
        jstate, m = jt.train_step(jstate, jax.tree.map(jnp.asarray, batch))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    adam = jstate.opt_state[1][0]
    final = {f"{tree}.{k}": v for tree, node in (
        ("params", jstate.params), ("mu", adam.mu), ("nu", adam.nu))
        for k, v in _named(node)}
    case = {"model_config": tcfg, "train": train, "params": params,
            "batches": batches, **opts}
    return {"case": case, "jmesh": jmesh, "losses": losses, "norms": norms,
            "final": final, "world": CASES[name][6]}


def _spawn(tmp_path, world, cases):
    out = tmp_path / f"world{world}"
    out.mkdir()
    result = _fit(dpt.DataParallelTrainer(
        loops.cross_process_loop,
        scaling_config=ScalingConfig(num_workers=world, use_gpu=False),
        train_loop_config={"cases": cases, "out": str(out)},
        run_config=RunConfig(storage_path=str(tmp_path / "runs"))))
    assert result.error is None, result.error
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(world)] for name in cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX reference and its ranks' results: each world
    spawned once for all its cases (the controls run the case they
    break)."""
    ref = {name: _jax_run(name) for name in CASES}
    got = {}
    for world in (4, 2):
        cases = {n: r["case"] for n, r in ref.items() if r["world"] == world}
        cases.update({n: {**ref[base]["case"], "control": control}
                      for n, (base, control) in CONTROLS.items()
                      if ref[base]["world"] == world})
        got.update(_spawn(tmp_path_factory.mktemp("xproc"), world, cases))
    return ref, got


def _errors(ref, ranks) -> dict:
    """The worst error of the ranks' chunks against JAX's shards at their
    places (absolute), and of their losses and norms (relative)."""
    flat = list(ref["jmesh"].devices.ravel())
    chunk = 0.0
    for rank in ranks:
        for key, got in rank.items():
            if "@" not in key:
                continue
            leaf, place = key.split("@")
            want = next(np.asarray(sh.data) for sh in
                        ref["final"][leaf].addressable_shards
                        if sh.device == flat[int(place)])
            assert got.shape == want.shape, key
            chunk = max(chunk, float(np.abs(got - want).max()))
    rel = max(float(np.abs(np.asarray(r[k]) / np.asarray(w) - 1).max())
              for r in ranks for k, w in (("losses", ref["losses"]),
                                          ("grad_norms", ref["norms"])))
    return {"chunk": chunk, "rel": rel}


@pytest.mark.parametrize("name", list(CASES))
def test_processes_match_jax_trainer(runs, name):
    """Every chunk of each process's places of the final parameters and
    moments against JAX's shards at those places, within 2e-4; every
    process's losses and gradient norms within 1e-5 relative."""
    ref, got = runs
    errs = _errors(ref[name], got[name])
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


@pytest.mark.parametrize("name", list(CONTROLS))
def test_controls_break_the_bound(runs, name):
    ref, got = runs
    errs = _errors(ref[CONTROLS[name][0]], got[name])
    assert errs["chunk"] > 2e-4 or errs["rel"] > 1e-5, errs


# --- per-process checkpoints and the retry that resumes from them ---------


@pytest.fixture(scope="module")
def resumed(runs, tmp_path_factory):
    """``llama_fsdp_tp_dense`` on 4 processes through a retry: one step,
    a per-process checkpoint, a failure, the restore, the last step."""
    from ray_tpu_torch.air.config import FailureConfig

    ref = runs[0]["llama_fsdp_tp_dense"]
    tmp = tmp_path_factory.mktemp("resume")
    out = tmp / "out"
    out.mkdir()
    result = _fit(dpt.DataParallelTrainer(
        loops.resume_loop,
        scaling_config=ScalingConfig(num_workers=4, use_gpu=False),
        train_loop_config={"case": ref["case"], "out": str(out)},
        run_config=RunConfig(storage_path=str(tmp / "runs"),
                             failure_config=FailureConfig(max_failures=1))))
    assert result.error is None, result.error
    files = {stage: [dict(np.load(out / f"{stage}_rank{r}.npz"))
                     for r in range(4)]
             for stage in ("saved", "restored", "resumed")}
    return ref, result, files


def test_per_process_checkpoint_restores_bit_for_bit(resumed):
    """Each process writes its own chunks (``<step>.proc<r>of4.pt``) and
    reads back exactly those of its places on the same layout."""
    _, _, files = resumed
    ckpt = {str(f["checkpoint_dir"]) for f in files["restored"]}
    assert len(ckpt) == 1
    assert sorted(os.listdir(ckpt.pop())) == [f"1.proc{r}of4.pt"
                                              for r in range(4)]
    for saved, restored in zip(files["saved"], files["restored"]):
        keys = [k for k in saved if "@" in k]
        assert keys
        assert sorted(keys) == sorted(k for k in restored if "@" in k)
        for k in keys:
            np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)


def test_retry_resumes_from_the_per_process_checkpoint(resumed):
    """The retry's last step from the restored chunks ends where the
    uninterrupted JaxTrainer run ends (every chunk within 2e-4, the
    losses and norms of both steps within 1e-5 relative)."""
    ref, result, files = resumed
    assert result.metrics == {"step": STEPS}
    ranks = [{**done, "losses": np.concatenate([first["losses"],
                                                 done["losses"]]),
              "grad_norms": np.concatenate([first["grad_norms"],
                                            done["grad_norms"]])}
             for first, done in zip(files["saved"], files["resumed"])]
    errs = _errors(ref, ranks)
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


# --- the collectives across processes and their conjugates -----------------

HAVE = [(0, 6), (6, 12)]
WANT = [[(3, 9)], [(0, 3), (9, 12)]]
# op -> (input shape, (function, keyword arguments))
OPS = {
    "psum": ((4, 6), ("psum", {})),
    "pmax": ((4, 6), ("pmax", {})),
    "all_gather": ((4, 6), ("all_gather", {"gather_axis": 1})),
    "all_gather_stacked": ((4, 6), ("all_gather", {"tiled": False})),
    "reduce_scatter": ((4, 6), ("reduce_scatter", {"scatter_axis": 1})),
    "ring_shift": ((4, 6), ("ring_shift", {})),
    "all_to_all": ((4, 6), ("all_to_all", {"split_axis": 0,
                                           "concat_axis": 1})),
    "regroup": ((4, 6), ("regroup", {"have": HAVE, "want": WANT})),
    "reduce_from_group": ((4, 6), ("reduce_from_group", {})),
    "copy_to_group": ((4, 6), ("copy_to_group", {})),
    "gather_from_group": ((4, 6), ("gather_from_group", {})),
    # q, k, v [1, 8, 4, 16] stacked: each process 8 tokens of 16
    "ulysses": ((3, 1, 8, 4, 16), ("ulysses_attention", {})),
}


# the most a staged round may hold in the staged runs: 16 float32 values
STAGED_BUCKET_BYTES = 64


@pytest.fixture(scope="module")
def collectives_run(tmp_path_factory):
    """Every op on the tp lines of {fsdp 2, tp 2} over 4 processes (ranks
    0 and 1 one line, 2 and 3 the other), as it runs and (``<op>_staged``)
    staged through the host buffer in rounds of STAGED_BUCKET_BYTES."""
    out = tmp_path_factory.mktemp("collectives")
    result = _fit(dpt.DataParallelTrainer(
        loops.collectives_across_loop,
        scaling_config=ScalingConfig(num_workers=4, use_gpu=False),
        train_loop_config={"axes": FSDP_TP, "axis": "tp", "ops": OPS,
                           "out": str(out),
                           "staged_bucket_bytes": STAGED_BUCKET_BYTES},
        run_config=RunConfig(storage_path=str(out / "runs"))))
    assert result.error is None, result.error
    return {f"{op}{tag}": [dict(np.load(out / f"{op}{tag}_rank{r}.npz"))
                           for r in range(4)]
            for op in OPS for tag in ("", "_staged")}


def _inputs(rank, shape):
    return (np.random.default_rng(100 + rank).standard_normal(shape)
            .astype(np.float32))


def _expected(op, line, shape):
    """The outputs and input gradients of ``op`` on the processes of
    ``line``: the rank-list collective differentiated by autograd, or, for
    Megatron's pair and the piece-keeping gather, their definitions."""
    import torch

    from ray_tpu_torch.parallel import collectives as col

    xs = [torch.from_numpy(_inputs(r, shape)).requires_grad_(True)
          for r in line]
    fn, kw = OPS[op][1]
    if fn == "reduce_from_group":
        ys = col.psum(xs)
    elif fn == "copy_to_group":
        ys = [x * 1 for x in xs]
    elif fn == "gather_from_group":
        ys = col.all_gather(xs)
    elif fn == "ulysses_attention":
        from ray_tpu_torch.parallel.ulysses import ulysses_attention

        ys = ulysses_attention(*([x[i] for x in xs] for i in range(3)))
    else:
        ys = getattr(col, fn)(xs, **kw)
    cots = [torch.from_numpy(np.random.default_rng(200 + r).standard_normal(
        tuple(y.shape)).astype(np.float32)) for r, y in zip(line, ys)]
    if fn == "pmax":
        return [y.detach() for y in ys], [torch.zeros_like(x) for x in xs]
    if fn == "reduce_from_group":
        return [y.detach() for y in ys], cots
    if fn == "copy_to_group":
        return [x.detach() for x in xs], [sum(cots)] * len(xs)
    if fn == "gather_from_group":
        return [y.detach() for y in ys], [c.chunk(len(xs))[i]
                                          for i, c in enumerate(cots)]
    grads = torch.autograd.grad(ys, xs, cots)
    return [y.detach() for y in ys], list(grads)


@pytest.mark.parametrize("op", list(OPS))
def test_collective_across_processes_and_its_conjugate(collectives_run, op):
    """Each process's output and input gradient against the rank-list
    collective on the same chunks (its VJP; Ulysses' attention through
    its two all-to-alls), or Megatron's definitions:
    ``g`` sums forward and passes the gradient, ``f`` passes forward and
    sums the gradient, ``gather_from_group`` keeps its piece of it."""
    shape = OPS[op][0]
    for line in ([0, 1], [2, 3]):
        ys, grads = _expected(op, line, shape)
        for i, r in enumerate(line):
            got = collectives_run[op][r]
            assert int(got["index"]) == i
            np.testing.assert_allclose(got["y"], ys[i].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{op} y {r}")
            np.testing.assert_allclose(got["grad"], grads[i].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{op} grad {r}")


@pytest.mark.parametrize("op", list(OPS))
def test_staged_collective_moves_in_bounded_rounds(collectives_run, op):
    """The same op with gloo's staging through the host buffer (the path
    of a CUDA tensor) taken for the CPU tensors, in rounds of at most
    STAGED_BUCKET_BYTES (a few values: every collective is cut into many
    rounds, and the ranks must cut alike): the outputs and gradients of
    the unstaged run, bit for bit, bytes staged, and no staging buffer
    larger than a round."""
    for r in range(4):
        want, got = collectives_run[op][r], collectives_run[f"{op}_staged"][r]
        np.testing.assert_array_equal(got["y"], want["y"],
                                      err_msg=f"{op} y {r}")
        np.testing.assert_array_equal(got["grad"], want["grad"],
                                      err_msg=f"{op} grad {r}")
        assert int(want["staged_bytes"]) == 0
        assert int(got["staged_bytes"]) > 0
        assert 0 < int(got["buffer_bytes"]) <= STAGED_BUCKET_BYTES


# --- TorchMeshTrainer across processes; what is refused ---------------------


def test_mesh_trainer_spans_fsdp_and_tp_over_four_ranks(tmp_path):
    """``TorchMeshTrainer`` on {fsdp 2, tp 2} under fsdp_tp over four gloo
    ranks, 2 steps of [4, 33] global batches through the device feed:
    rank 0's losses and gradient norms match the single-controller
    Trainer on the same mesh from the same seed (1e-5 relative); each
    rank declares the FLOPs of its own work (its rows, over tp: a quarter
    of the global batch's 6 · parameters · tokens)."""
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer

    _, tcfg = _configs("llama")
    kw = dict(mesh_axes=FSDP_TP, strategy="fsdp_tp", learning_rate=LR,
              warmup_steps=1, total_steps=50)
    tokens = np.random.default_rng(3).integers(0, VOCAB, (8, 33))
    result = _fit(dpt.TorchMeshTrainer(
        tcfg, TrainConfig(**kw),
        train_loop_config={"seed": 0, "steps": 2, "batch_size": 4},
        scaling_config=ScalingConfig(num_workers=4, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path)),
        datasets={"train": {"tokens": tokens}}))
    assert result.error is None, result.error
    tr = Trainer(tcfg, TrainConfig(**kw), device="cpu",
                 mesh=create_mesh(FSDP_TP, devices=["cpu"] * 4))
    state = tr.init_state(seed=0)
    want = []
    for batch in (tokens[:4], tokens[4:]):
        state, m = tr.train_step(state, batch)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    got = [(m["loss"], m["grad_norm"]) for m in result.metrics_history]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    n_params = sum(x.numel() for x in tree_leaves(
        tllama.init_params(tcfg, seed=0, device="cpu")))
    assert len(result.rank_stats) == 4
    for stats in result.rank_stats:
        assert stats["telemetry"]["flops_per_step"] == \
            6.0 * n_params * 4 * 33 / 4


def test_what_spans_processes_is_refused_before_any_rank_starts(tmp_path):
    """What JAX cannot form raises before anything runs: a mesh that does
    not deal into equal blocks ({dp 3} at world 2; JAX gives every
    process as many devices). The layouts an earlier slice refused are
    checked before any rank starts and split as JAX splits them: the
    ring across processes beside other places in a process ({sp 2, tp
    2}: sp across, tp 2 in each) and an axis cut between processes ({tp
    4}: tp 2 in each). ``loss_and_grads`` still raises where fsdp or pp
    split the loss between processes. Nothing falls back to one
    process."""
    from ray_tpu_torch.train.trainer import TrainConfig, Trainer, _local_axes

    _, tcfg = _configs("llama")
    with pytest.raises(ValueError, match="equal block"):
        dpt.TorchMeshTrainer(
            tcfg, TrainConfig(mesh_axes={"dp": 3}, strategy="fsdp"),
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
            run_config=RunConfig(storage_path=str(tmp_path)))
    for axes, strategy, local in (
            ({"sp": 2, "tp": 2}, "fsdp_tp_sp", {"sp": 1, "tp": 2}),
            ({"tp": 4}, "fsdp_tp", {"tp": 2})):
        dpt.TorchMeshTrainer(
            tcfg, TrainConfig(mesh_axes=axes, strategy=strategy),
            scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
            run_config=RunConfig(storage_path=str(tmp_path)))
        assert _local_axes(axes, 2, strategy) == local
    assert multiprocessing.active_children() == []
    # one process of two sharing {fsdp 2}, or {pp 2}: its loss is a part
    # of the global one, which only train_step sums
    for axes, strategy, axis in (({"fsdp": 2}, "fsdp", "fsdp"),
                                 ({"pp": 2}, "pp_fsdp", "pp")):
        tr = Trainer(tcfg, TrainConfig(mesh_axes=axes, strategy=strategy),
                     device="cpu", process_group=_OneOfTwo())
        assert tr.mesh.spans(axis) and tr.mesh.local_shape == {axis: 1}
        with pytest.raises(NotImplementedError, match=axis):
            tr.loss_and_grads(tllama.init_params(tcfg, device="cpu"),
                              _batch("llama", 2, 8, 0))


class _OneOfTwo:
    """A stand-in for rank 0 of a two-process group (no collective runs:
    a line of the whole world needs no subgroup)."""

    rank, world_size = 0, 2
