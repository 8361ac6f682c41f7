"""Layouts whose process boundary cuts an axis, on the CPU: the port's
``Trainer(process_group=)`` on a global mesh dealt to two gloo rank
processes as JAX deals it (``parallel.mesh.split_axes``: rank ``p`` owns
the places ``[p·n/2, (p+1)·n/2)``, so ``{tp 4}`` gives each process tp
indices ``[2p, 2p + 2)``), against ``JaxTrainer`` on the same global mesh
of JAX's CPU devices.

The world is spawned once for all its cases (``DataParallelTrainer`` with
``ScalingConfig(num_workers=2, use_gpu=False)``, the loop
``torch_harness_loops.cut_loop``), joined within 120 s and its ranks
killed on expiry. In float32 at tiny widths, from JAX's initial weights
(``convert.params_from_numpy``), every chunk of each process's places of
the final parameters and Adam moments is held against JAX's
``addressable_shards`` at that place (2e-4), and the losses and gradient
norms within 1e-5 relative. The cases, all at world 2:

- ``llama`` on ``{fsdp 4}``; on ``{tp 4}`` under ``fsdp_tp``, dense and
  fused; a ``gpt`` of 5 heads on ``{tp 4}`` (its fused qkv's columns
  regrouped across the cut); ``llama`` on ``{sp 2, tp 2}`` under
  ``fsdp_tp_sp`` (the ring between the processes, each process's two tp
  places in one ring) and on ``{sp 4}`` (two ring ranks a process), each
  with the flash body (the kernels' plain versions) and the reference
  body; ``llama`` on ``{pp 4}`` under ``pp_fsdp`` (two stages a
  process);
- ``mixtral``'s ``spmd.placed_forward`` on ``{ep 4}`` (two expert places
  a process), against JAX's forward and, bit for bit, against the
  port's one-process placed forward;
- the ``{tp 4}`` state saved by both processes, each its own chunks,
  restored bit for bit onto a one-process mesh;
- each collective over a cut axis, and its conjugate, against the
  rank-list collective on the four global chunks;
- ``ElasticTrainer(process_group=)`` reforming from {tp 2} (one place a
  process) into {tp 4} (tp cut) and back, each restore bit for bit and
  the steps against JAX's ``ElasticTrainer`` reforming 2 -> 4 -> 2
  devices;
- the controls, each of which must break the bound: the local sum
  skipped before the subgroup's all-reduce, the ring's shift across the
  process boundary reversed, and a reduce-scatter's local split in the
  wrong order.

Also, without a spawn, the NCCL warm-up of every line before the first
exchange (``process_group.mesh_layout``).
"""

import dataclasses
import functools
import math
import multiprocessing
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_harness_loops as loops
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.models import mixtral as jmixtral
from ray_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ray_tpu.parallel.sharding import PRESETS as JAX_PRESETS
from ray_tpu.parallel.sharding import shard_tree as jax_shard_tree
from ray_tpu.train.elastic import ElasticTrainer as JaxElasticTrainer
from ray_tpu.train.trainer import JaxTrainer
from ray_tpu.train.trainer import TrainConfig as JaxTrainConfig
from ray_tpu_torch import convert
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmixtral
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel import process_group as pgm
from ray_tpu_torch.parallel.mesh import create_mesh
from ray_tpu_torch.parallel.sharding import PRESETS, shard_tree
from ray_tpu_torch.train import data_parallel_trainer as dpt
from ray_tpu_torch.train import spmd
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.trainer import TrainConfig, Trainer

LIMIT_S = 120.0
WORLD = 2
VOCAB = 160
STEPS = 2
LR = 1e-3
CAPACITY_FACTOR = 0.5
MODULES = {"llama": (jllama, tllama), "gpt": (jgpt, tgpt)}
TP4_HEADS = {"n_heads": 8, "n_kv_heads": 4}
FLASH = {"head_dim": 64}

# name -> (family, config overrides, mesh, strategy, train kwargs,
# batch (b, s), case options)
CASES = {
    "llama_fsdp4": ("llama", {}, {"fsdp": 4}, "fsdp", {}, (4, 32), {}),
    "llama_tp4_dense": ("llama", TP4_HEADS, {"tp": 4}, "fsdp_tp", {},
                        (2, 32), {}),
    "llama_tp4_fused": ("llama", TP4_HEADS, {"tp": 4}, "fsdp_tp",
                        {"fused_loss": True, "loss_chunk": 16}, (2, 32), {}),
    "gpt5_tp4": ("gpt", {"d_model": 160, "n_heads": 5, "d_ff": 320},
                 {"tp": 4}, "tp", {}, (2, 32), {}),
    "llama_sp2_tp2_flash": ("llama", FLASH, {"sp": 2, "tp": 2},
                            "fsdp_tp_sp", {}, (1, 512),
                            {"ring_impl": "flash"}),
    "llama_sp2_tp2_reference": ("llama", FLASH, {"sp": 2, "tp": 2},
                                "fsdp_tp_sp", {}, (1, 512),
                                {"ring_impl": "reference"}),
    "llama_sp4_flash": ("llama", FLASH, {"sp": 4}, "fsdp_tp_sp", {},
                        (1, 1024), {"ring_impl": "flash"}),
    "llama_sp4_reference": ("llama", FLASH, {"sp": 4}, "fsdp_tp_sp", {},
                            (1, 1024), {"ring_impl": "reference"}),
    "llama_pp4": ("llama", {"n_layers": 4}, {"pp": 4}, "pp_fsdp",
                  {"n_microbatches": 4}, (4, 32), {}),
}
CONTROLS = {
    "control_local_sum_skipped": ("llama_tp4_dense", "local_sum_skipped"),
    "control_boundary_reversed": ("llama_sp4_reference",
                                  "boundary_reversed"),
    "control_local_split_reversed": ("llama_fsdp4", "local_split_reversed"),
}
EP_AXES = {"ep": 4}
# the collectives over {tp 4}'s cut axis: op -> (a chunk's shape,
# (function, keyword arguments))
HAVE = [(0, 3), (3, 6), (6, 9), (9, 12)]
WANT = [[(2, 5)], [(0, 2), (11, 12)], [(5, 11)], [(6, 7)]]
OPS = {
    "psum": ((4, 8), ("psum", {})),
    "pmax": ((4, 8), ("pmax", {})),
    "all_gather": ((4, 8), ("all_gather", {"gather_axis": 1})),
    "all_gather_stacked": ((4, 8), ("all_gather", {"tiled": False})),
    "reduce_scatter": ((4, 8), ("reduce_scatter", {"scatter_axis": 1})),
    "reduce_scatter_stacked": ((4, 8), ("reduce_scatter",
                                        {"tiled": False})),
    "ring_shift": ((4, 8), ("ring_shift", {})),
    "ring_shift_back": ((4, 8), ("ring_shift", {"shift": -1})),
    "ppermute": ((4, 8), ("ppermute", {"perm": [(0, 2), (1, 0), (2, 3),
                                                (3, 1)]})),
    "all_to_all": ((4, 8), ("all_to_all", {"split_axis": 0,
                                           "concat_axis": 1})),
    "regroup": ((4, 3), ("regroup", {"have": HAVE, "want": WANT})),
    "logsumexp": ((4, 8), ("logsumexp", {})),
    "reduce_from_group": ((4, 8), ("reduce_from_group", {})),
    "copy_to_group": ((4, 8), ("copy_to_group", {})),
    "gather_from_group": ((4, 8), ("gather_from_group", {})),
    # q, k, v [1, 8, 4, 16] stacked: each rank 8 tokens of 32
    "ulysses": ((3, 1, 8, 4, 16), ("ulysses_attention", {})),
}
COLLECTIVE_AXES = {"tp": 4}


def _configs(family, **overrides):
    jmod, tmod = MODULES[family]
    return tuple(dataclasses.replace(getattr(mod, f"{family}_tiny")(VOCAB),
                                     dtype="float32", **overrides)
                 for mod in (jmod, tmod))


def _tokens(b, s, seed):
    """Tokens [b, s + 1] with some -1 padding in the last row."""
    tokens = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    tokens[-1, -5:] = -1
    return tokens.astype(np.int64)


def _jax_mesh(axes):
    return jax_create_mesh(axes, devices=jax.devices()[:math.prod(
        axes.values())])


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@functools.lru_cache(maxsize=None)
def _jax_reference(family, over, axes, strategy, kw, batch):
    """JaxTrainer's run on the global mesh (shared by the cases that
    differ only in the port's ring body): its initial weights, losses,
    norms and final trees."""
    over, axes, kw = dict(over), dict(axes), dict(kw)
    jcfg, tcfg = _configs(family, **over)
    jmesh = _jax_mesh(axes)
    train = dict(mesh_axes=axes, strategy=strategy, learning_rate=LR,
                 warmup_steps=1, total_steps=50, **kw)
    jt = JaxTrainer(jcfg, JaxTrainConfig(**train), mesh=jmesh)
    jstate = jt.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = [_tokens(*batch, seed) for seed in range(STEPS)]
    losses, norms = [], []
    for b in batches:
        jstate, m = jt.train_step(jstate, jnp.asarray(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    adam = jstate.opt_state[1][0]
    final = {f"{tree}.{k}": v for tree, node in (
        ("params", jstate.params), ("mu", adam.mu), ("nu", adam.nu))
        for k, v in _named(node)}
    case = {"model_config": tcfg, "train": train, "params": params,
            "batches": batches}
    return {"case": case, "jmesh": jmesh, "losses": losses, "norms": norms,
            "final": final}


def _reference(name):
    family, over, axes, strategy, kw, batch, opts = CASES[name]
    ref = _jax_reference(family, tuple(over.items()), tuple(axes.items()),
                         strategy, tuple(kw.items()), batch)
    return {**ref, "case": {**ref["case"], **opts}}


def _ep_reference():
    """Mixtral's forward on {ep 4}: JAX's on its placed tree, and the
    port's one-process placed forward on the same weights."""
    jcfg, tcfg = (dataclasses.replace(mod.mixtral_tiny(VOCAB),
                                      dtype="float32",
                                      capacity_factor=CAPACITY_FACTOR)
                  for mod in (jmixtral, tmixtral))
    params = jmixtral.init_params(jcfg, jax.random.key(0))
    placed = jax_shard_tree(params, jmixtral.param_logical_axes(jcfg),
                            _jax_mesh(EP_AXES), JAX_PRESETS["moe"])
    tokens = np.random.default_rng(2).integers(0, VOCAB, (4, 16))
    logits, aux = jax.jit(lambda p, t: jmixtral.forward(
        jcfg, p, t, return_aux_loss=True))(placed, jnp.asarray(tokens))
    numpy_params = jax.tree.map(np.asarray, params)
    mesh = create_mesh(EP_AXES, devices=["cpu"] * 4)
    one = shard_tree(convert.params_from_numpy(tcfg, numpy_params,
                                               device="cpu"),
                     tmixtral.param_logical_axes(tcfg), mesh, PRESETS["moe"])
    with torch.no_grad():
        port, port_aux = spmd.placed_forward(
            tmixtral, tcfg, one, torch.as_tensor(tokens), mesh=mesh,
            rules=PRESETS["moe"], return_aux_loss=True)
    case = {"model_config": tcfg, "axes": EP_AXES, "tokens": tokens,
            "params": numpy_params}
    return {"case": case, "logits": np.asarray(logits), "aux": float(aux),
            "port": port.numpy(), "port_aux": float(port_aux)}


# the elastic job's places at each stage: one a process, two, one
ELASTIC_DEVICES = (1, 2, 1)


def _elastic_reference(tmp):
    """JAX's ElasticTrainer over {tp n} on 2, 4 and again 2 of its CPU
    devices, one step at each, a checkpoint after each step: its initial
    weights, batches, losses, norms and final state."""
    jcfg, tcfg = _configs("llama", **TP4_HEADS)
    train = dict(strategy="fsdp_tp", learning_rate=LR, warmup_steps=1,
                 total_steps=50)
    n = [WORLD * k for k in ELASTIC_DEVICES]
    jet = JaxElasticTrainer(jcfg, JaxTrainConfig(**train),
                            checkpoint_dir=str(tmp / "jax_elastic"),
                            mesh_axes_fn=loops.tp_axes,
                            devices=jax.devices()[:n[0]],
                            checkpoint_every=1)
    jstate = jet.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, jstate.params)
    batches = [_tokens(4, 32, 20 + i) for i in range(len(n))]
    metrics = []
    for i, places in enumerate(n):
        if i:
            jstate = jet.reform(devices=jax.devices()[:places])
        jstate = jet.fit(jstate, iter(batches[i:i + 1]), steps=1,
                         on_metrics=metrics.append)
    adam = jstate.opt_state[1][0]
    final = {f"{tree}.{k}": v for tree, node in (
        ("params", jstate.params), ("mu", adam.mu), ("nu", adam.nu))
        for k, v in _named(node)}
    job = {"model_config": tcfg, "train": train, "params": params,
           "batches": batches,
           "devices": [["cpu"] * k for k in ELASTIC_DEVICES],
           "checkpoint_dir": str(tmp / "torch_elastic")}
    out = {"job": job, "final": final, "jmesh": jet.trainer.mesh,
           "losses": [m["loss"] for m in metrics],
           "norms": [m["grad_norm"] for m in metrics]}
    jet.close()
    return out


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


def _load(out, name):
    return [dict(np.load(out / f"{name}_rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's JAX reference and its ranks' results, the world
    spawned once for all of them (the controls run the case they
    break)."""
    tmp = tmp_path_factory.mktemp("cut")
    out = tmp / "out"
    out.mkdir()
    ref = {name: _reference(name) for name in CASES}
    ep = _ep_reference()
    elastic = _elastic_reference(tmp)
    train = {n: r["case"] for n, r in ref.items()}
    train.update({n: {**ref[base]["case"], "control": control}
                  for n, (base, control) in CONTROLS.items()})
    train["llama_tp4_dense"] = {**train["llama_tp4_dense"],
                                "save": str(tmp / "tp4_ckpt")}
    result = _fit(dpt.DataParallelTrainer(
        loops.cut_loop,
        scaling_config=ScalingConfig(num_workers=WORLD, use_gpu=False),
        train_loop_config={
            "train": train, "forward": {"mixtral_ep4": ep["case"]},
            "collectives": {"axes": COLLECTIVE_AXES, "axis": "tp",
                            "ops": OPS},
            "elastic": elastic["job"], "out": str(out)},
        run_config=RunConfig(storage_path=str(tmp / "runs"))))
    assert result.error is None, result.error
    got = {name: _load(out, name) for name in [*train, "mixtral_ep4"]}
    got.update({f"cut_{op}": _load(out, f"cut_{op}") for op in OPS})
    got["cut_elastic"] = _load(out, "cut_elastic")
    ref["cut_elastic"] = elastic
    return ref, ep, got, tmp / "tp4_ckpt"


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
def test_cut_layout_matches_jax_trainer(runs, name):
    """Every chunk of each process's places of the final parameters and
    moments against JAX's shards at those places, within 2e-4; every
    process's losses and gradient norms within 1e-5 relative."""
    ref, _, got, _ = runs
    errs = _errors(ref[name], got[name])
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


@pytest.mark.parametrize("name", list(CONTROLS))
def test_cut_controls_break_the_bound(runs, name):
    ref, _, got, _ = runs
    errs = _errors(ref[CONTROLS[name][0]], got[name])
    assert errs["chunk"] > 2e-4 or errs["rel"] > 1e-5, errs


def test_placed_forward_over_a_cut_ep(runs):
    """Mixtral's forward on {ep 4} at world 2: each process runs its two
    expert places (one expert each, at the global capacity), routes the
    global batch once a layer, and returns the global logits (no data
    axis spans the processes): within 2e-4 of JAX's forward (aux 1e-5
    relative) and bit for bit the port's one-process placed forward."""
    _, ep, got, _ = runs
    cfg = ep["case"]["model_config"]
    capacity = int(CAPACITY_FACTOR * 64 * cfg.top_k / cfg.n_experts)
    for r in got["mixtral_ep4"]:
        assert float(np.abs(r["logits"] - ep["logits"]).max()) <= 2e-4
        assert abs(float(r["aux"]) / ep["aux"] - 1) <= 1e-5
        np.testing.assert_array_equal(r["logits"], ep["port"])
        assert float(r["aux"]) == ep["port_aux"]
        assert r["experts"].tolist() == [
            [1, capacity, cfg.d_model, 1, cfg.d_model, cfg.d_ff]
        ] * (2 * cfg.n_layers)
        kept, assigned = r["routed"].T
        assert list(assigned) == [64 * cfg.top_k] * cfg.n_layers
        assert (kept < assigned).all()


def test_cut_save_restores_bit_for_bit_onto_one_process(runs):
    """The {tp 4} state saved by the two processes (each its chunks, to
    ``<step>.proc<r>of2.pt``) restores onto a one-process {tp 4} mesh:
    every chunk of every place equals the chunk the process holding that
    place saved, bit for bit."""
    ref, _, got, ckpt = runs
    case = ref["llama_tp4_dense"]["case"]
    assert sorted(p.name for p in ckpt.iterdir()) == [
        f"{STEPS}.proc{r}of{WORLD}.pt" for r in range(WORLD)]
    tr = Trainer(case["model_config"], TrainConfig(**case["train"]),
                 device="cpu", mesh=create_mesh({"tp": 4},
                                                devices=["cpu"] * 4))
    state = CheckpointManager(str(ckpt)).restore(
        shardings=tr.state_shardings())
    assert state.step == STEPS
    restored = {}
    for tree in ("params", "mu", "nu"):
        node = state.params if tree == "params" else state.opt_state[tree]
        restored.update(loops.placed_chunks(node, tr.mesh, f"{tree}."))
    saved = {k: v for rank in got["llama_tp4_dense"] for k, v in rank.items()
             if "@" in k}
    assert sorted(saved) == sorted(restored)
    for key, want in saved.items():
        np.testing.assert_array_equal(restored[key], want, err_msg=key)


def _whole(ranks, prefix) -> dict:
    """Every leaf under ``prefix`` assembled whole from the ranks'
    chunks by index range (``<prefix><leaf>|<range>``)."""
    from ray_tpu_torch.train.checkpoint import _range

    parts = {}
    for rank in ranks:
        for key, chunk in rank.items():
            if key.startswith(prefix) and "|" in key:
                leaf, rng = key[len(prefix):].split("|")
                parts.setdefault(leaf, []).append((_range(rng), chunk))
    out = {}
    for leaf, chunks in parts.items():
        shape = [max(r[d][1] for r, _ in chunks)
                 for d in range(len(chunks[0][0]))]
        whole = np.full(shape, np.nan, dtype=chunks[0][1].dtype)
        for r, c in chunks:
            whole[tuple(slice(a, b) for a, b in r)] = c
        out[leaf] = whole
    return out


def test_elastic_reforms_into_and_out_of_a_cut_layout(runs):
    """``ElasticTrainer(process_group=)`` at world 2: one step on {tp 2},
    a reform into {tp 4} (each process tp indices [2p, 2p + 2)), one
    step, a reform back onto {tp 2}, one step, a checkpoint after each
    (every process its chunks). Each restore's chunks equal the saved
    state's slices bit for bit; the final chunks within 2e-4 of JAX's
    ElasticTrainer reformed 2 -> 4 -> 2 devices, the losses and norms of
    the three steps within 1e-5 relative."""
    ref, _, got, _ = runs
    ranks = got["cut_elastic"]
    for i in range(1, len(ELASTIC_DEVICES)):
        saved = _whole(ranks, f"saved{i}.")
        assert saved and not any(np.isnan(v).any() for v in saved.values())
        from ray_tpu_torch.train.checkpoint import _range

        n = 0
        for rank in ranks:
            for key, chunk in rank.items():
                if key.startswith(f"restored{i}.") and "|" in key:
                    leaf, rng = key[len(f"restored{i}."):].split("|")
                    want = saved[leaf][tuple(slice(a, b)
                                             for a, b in _range(rng))]
                    np.testing.assert_array_equal(chunk, want, err_msg=key)
                    n += 1
        assert n
    assert all(str(r["mesh"]) == "{'tp': 2}" for r in ranks)
    errs = _errors(ref["cut_elastic"], ranks)
    assert errs["chunk"] <= 2e-4 and errs["rel"] <= 1e-5, errs


def _inputs(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _expected(op, shape):
    """Every global chunk's output and input gradient of ``op`` over the
    four ranks: the rank-list collective differentiated by autograd, or,
    for Megatron's pair and the block-keeping gather, their definitions
    with the two chunks of a process summed as the rank list sums
    them."""
    n, k = 4, 2
    xs = [_inputs(100 + i, shape).requires_grad_(True) for i in range(n)]
    fn, kw = OPS[op][1]
    if fn in ("reduce_from_group", "gather_from_group"):
        ys = col.psum(xs) if fn == "reduce_from_group" else col.all_gather(xs)
    elif fn == "copy_to_group":
        ys = [x * 1 for x in xs]
    elif fn == "ulysses_attention":
        from ray_tpu_torch.parallel.ulysses import ulysses_attention

        ys = ulysses_attention(*([x[i] for x in xs] for i in range(3)))
    else:
        ys = getattr(col, fn)(xs, **kw)
    cots = [_inputs(200 + i, tuple(y.shape)) for i, y in enumerate(ys)]
    outs = [y.detach() for y in ys]
    if fn == "pmax":
        return outs, [torch.zeros_like(x) for x in xs]
    # a process's own sum of its chunks' cotangents
    own = [sum(cots[p * k:(p + 1) * k]) for p in range(n // k)]
    if fn == "reduce_from_group":
        return outs, [own[i // k] for i in range(n)]
    if fn == "copy_to_group":
        return outs, [sum(cots[q * k + i % k] for q in range(n // k))
                      for i in range(n)]
    if fn == "gather_from_group":
        return outs, [own[i // k].chunk(n)[i] for i in range(n)]
    return outs, list(torch.autograd.grad(ys, xs, cots))


@pytest.mark.parametrize("op", list(OPS))
def test_collective_over_a_cut_axis_and_its_conjugate(runs, op):
    """Each collective over {tp 4}'s axis cut between the two processes,
    each holding two chunks: every chunk's output and input gradient
    against the rank-list collective on the four global chunks (its VJP;
    Ulysses' attention through its two all-to-alls), or Megatron's
    definitions: ``g`` sums forward and passes a process's gradient,
    ``f`` passes forward and sums the gradient over the processes,
    ``gather_from_group`` keeps the process's block of it."""
    _, _, got, _ = runs
    ys, grads = _expected(op, OPS[op][0])
    for p, r in enumerate(got[f"cut_{op}"]):
        assert int(r["size"]) == 4 and int(r["first"]) == 2 * p
        for i in range(2):
            g = 2 * p + i
            np.testing.assert_allclose(r[f"y{i}"], ys[g].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{op} y {g}")
            np.testing.assert_allclose(r[f"grad{i}"], grads[g].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{op} grad {g}")


def test_psum_of_16_bit_floats_rounds_once():
    """``psum`` and ``reduce_scatter`` add bf16 chunks in float32 and
    round once, so that the sum across processes (each process's chunks
    summed in float32, then the processes') holds the rank list's
    whatever the grouping; ``local_sum`` keeps float32 for the subgroup's
    collective. A sum rounded after each add differs."""
    xs = [_inputs(300 + i, (64, 16)).to(torch.bfloat16) for i in range(4)]
    once = sum(x.float() for x in xs).to(torch.bfloat16)
    for y in col.psum(xs):
        assert y.dtype == torch.bfloat16 and torch.equal(y, once)
    for i, y in enumerate(col.reduce_scatter(xs)):
        assert torch.equal(y, once.chunk(4)[i])
    assert col.local_sum(xs[:2]).dtype == torch.float32
    stepwise = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert not torch.equal(stepwise, once)


# --- the NCCL warm-up of every line (no spawn) ---------------------------


def _record(monkeypatch):
    """``torch.distributed`` as ``process_group`` calls it, recorded:
    each group is ("group", its ranks), an all-reduce a warm-up on its
    group, a ``batch_isend_irecv`` an exchange on its ops' group."""
    events = []
    dist = pgm.dist
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: ("group", tuple(ranks)))
    monkeypatch.setattr(dist, "all_reduce", lambda t, op=None, group=None:
                        events.append(("warm", group)))
    monkeypatch.setattr(dist, "P2POp", lambda op, t, peer, group:
                        SimpleNamespace(group=group))
    monkeypatch.setattr(dist, "batch_isend_irecv",
                        lambda ops: events.append(("exchange",
                                                   ops[0].group)) or [])
    return events


@pytest.mark.parametrize("axes,world", [({"pp": 4, "fsdp": 2}, 8),
                                        ({"pp": 4, "fsdp": 4}, 8),
                                        ({"fsdp": 4, "tp": 2}, 2)])
def test_every_line_warmed_before_the_first_exchange(monkeypatch, axes,
                                                     world):
    """Under NCCL every process runs a first collective on each of its
    lines (the subgroups ``mesh_layout`` makes, the whole world where a
    line is all of it) before any exchange, so that the 1F1B's first
    ticks, where only some ranks of a line post, come after its
    communicator exists: every line of {pp 4, fsdp 2} and of the cut
    layouts {pp 4, fsdp 4} and {fsdp 4, tp 2} is warmed on every one of
    its ranks, once, before the first exchange on it. Under gloo nothing
    is added."""
    events = _record(monkeypatch)
    warmed = {}
    for backend in ("nccl", "gloo"):
        for rank in range(world):
            pgm._LINES.clear()
            pgm._WARM.clear()
            events.clear()
            pg = pgm.ProcessGroup(backend, rank, world, torch.device("cpu"))
            layout = pgm.mesh_layout(pg, axes)
            mesh_layout_events = list(events)
            for group in layout.groups.values():
                pg.exchange({(group.index + 1) % group.size: torch.ones(2)},
                            {(group.index - 1) % group.size: (
                                (2,), torch.float32, torch.device("cpu"))},
                            group)
            if backend == "gloo":
                assert not [e for e in events if e[0] == "warm"]
                continue
            warms = [g for kind, g in mesh_layout_events if kind == "warm"]
            assert len(warms) == len(set(map(str, warms)))
            for group in layout.groups.values():
                assert group.handle in warms, group
                first = next(i for i, e in enumerate(events)
                             if e == ("exchange", group.handle))
                assert ("warm", group.handle) in events[:first]
                warmed.setdefault(group.ranks, set()).add(rank)
    procs = pgm.split_axes(axes, world)[1]
    assert len(warmed) == sum(world // n for n in procs.values())
    assert all(set(ranks) == members for ranks, members in warmed.items())
