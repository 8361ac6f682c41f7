"""Trainer: the training step of a model family over a mesh.

Port of ``ray_tpu/train/trainer.py`` (``JaxTrainer``): ``TrainConfig``
keeps the same fields and defaults, and ``Trainer`` keeps its surface
(``init_state``, ``train_step``, ``fit``, ``abstract_state``,
``state_shardings``, the ``loss_fn`` hook, ``fused_loss`` and
``loss_chunk``, ``n_microbatches``, ``mesh=``). Where JAX jit-compiles
one SPMD step over a mesh and donates the state, the port runs eagerly,
one rank at a time (``train.spmd``), and updates the state's tensors in
place: the gradients come from ``torch.autograd``, and the optimizer
(``train.optim.AdamW``, the same recipe as JAX's optax chain) updates one
chunk at a time.

The mesh (``parallel.mesh``, single-controller as in JAX) is the one
given, or one built from ``mesh_axes`` with every place on the trainer's
device. The sharding rules (a preset name or ``ShardingRules``) become
``self.rules``, and the state is placed by them (``state_shardings``):
``init_state`` places each leaf, and a state of plain tensors given to
``train_step`` is placed as views of its tensors (all places on their
device), so it is updated in place. On a mesh of one place a placed leaf
is the tensor itself. As in JAX:

- the batch is cut over the data axes (``batch_sharding``), fsdp leaves
  are gathered before use, tp cuts Llama's heads and MLP (``train.spmd``);
- when ``rules.seq`` names a mesh axis wider than one, Llama's attention
  runs as ring attention over it (``attn_impl="ring"``);
- when ``rules.layers`` names one (``pp_fsdp``), Llama's layers run as
  the 1F1B pipeline (``parallel.pipeline.pipeline_value_and_grad``) over
  ``n_microbatches`` microbatches (default: the number of stages).

Across processes (``process_group=``, a ``parallel.process_group``
``ProcessGroup``), as JAX across the processes of ``jax.distributed``:
the global mesh's ``dp`` axis spans the processes, one process a ``dp``
index (the group's rank), and each process drives the other axes on its
own mesh, as above. ``train_step`` takes the global batch and keeps this
rank's rows; the loss is the global masked mean (each rank's token count
is all-reduced first, and its loss, before the backward, weighted by its
share of the tokens, a float32 scalar on the device), and the gradients
are summed over the ranks before the update, so every rank takes the same
step. Before the first step the ranks' states
are checked equal by checksum. fsdp, tp, sp or pp across processes raise
``NotImplementedError``.

The model family comes from the config's type, as in JAX: llama, gpt or
bert (``_resolve_family``); any other config raises ``TypeError``. A
family other than llama trains on ``family.forward`` and the next-token
cross-entropy, or on the ``loss_fn`` hook, which bert needs (it has no
causal-LM forward); ``fused_loss``, ring attention, the pipeline and the
tensor-parallel block are llama's alone.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.mesh import Mesh, create_mesh
from ray_tpu_torch.parallel.pipeline import pipeline_value_and_grad
from ray_tpu_torch.parallel.sharding import (PRESETS, ShardedTensor,
                                             ShardingRules, batch_sharding,
                                             device_put, map_trees,
                                             place_tree, replicated,
                                             same_device, tree_shardings)
from ray_tpu_torch.train import spmd
from ray_tpu_torch.train.optim import AdamW, warmup_cosine_decay_schedule
from ray_tpu_torch.train.state import TrainState, state_logical_axes


@dataclass
class TrainConfig:
    """Scaling and optimization config (the fields of the JAX package's
    ``TrainConfig``)."""

    mesh_axes: dict = field(default_factory=lambda: {"dp": -1})
    strategy: str = "fsdp"          # sharding preset name or ShardingRules
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    # JAX donates the old state to the step; the port updates it in place
    donate_state: bool = True
    # chunked cross-entropy that never holds the [B, S, vocab] float32
    # logits (llama.fused_cross_entropy)
    fused_loss: bool = False
    loss_chunk: int = 1024
    # pipeline parallelism (strategy="pp_fsdp"): microbatch count
    # (default: the number of stages, the least that fills the pipeline);
    # the schedule is 1F1B (parallel.pipeline)
    n_microbatches: int | None = None


def _rules(strategy) -> ShardingRules:
    if isinstance(strategy, ShardingRules):
        return strategy
    if strategy not in PRESETS:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{tuple(PRESETS)} or ShardingRules")
    return PRESETS[strategy]


def _mesh_on(device, mesh_axes: dict) -> Mesh:
    """A mesh of ``mesh_axes`` with every place on ``device`` (a -1 axis
    takes size 1)."""
    n = math.prod(n for n in mesh_axes.values() if n != -1)
    return create_mesh(mesh_axes, devices=[device] * n)


def _local_axes(mesh_axes: dict, world: int) -> dict:
    """The axes of one process's mesh when ``world`` processes span the
    global mesh's dp axis (one process a dp index, or an equal share of
    them)."""
    dp = mesh_axes.get("dp", 1)
    if dp == -1:
        return {**mesh_axes, "dp": 1}
    if dp % world:
        raise NotImplementedError(
            f"{world} processes span only the global mesh's dp axis "
            f"(dp={dp} in {mesh_axes}): fsdp, tp, sp or pp across processes "
            "come with a later slice of the port (ROADMAP Queue A)")
    return {**mesh_axes, "dp": dp // world}


def _named_chunks(tree, prefix="") -> list:
    """(name, tensor) of every distinct chunk of a tree of tensors and
    placed tensors, in tree order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _named_chunks(v, f"{prefix}{k}.")]
    if isinstance(tree, ShardedTensor):
        return [(f"{prefix[:-1]}[{place}]", c) for place, c in
                tree.distinct()]
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    return []


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor))


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clip, the Llama recipe
    (``JaxTrainer._make_optimizer``)."""
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.1)
    return AdamW(schedule, max_grad_norm=cfg.max_grad_norm, b1=cfg.b1,
                 b2=cfg.b2, weight_decay=cfg.weight_decay)


class Trainer:
    """Trainer of a llama, gpt or bert model over a mesh (one card holds
    every place of it unless the mesh names other devices).

    Usage::

        trainer = Trainer(llama.llama3_8b(), TrainConfig(
            mesh_axes={"fsdp": 2, "tp": 2}, strategy="fsdp_tp"))
        state = trainer.init_state(seed=0)
        state, metrics = trainer.train_step(state, batch)  # [B, S+1] tokens
    """

    def __init__(self, model_cfg, cfg: TrainConfig, *,
                 mesh: Mesh | None = None, loss_fn: Callable | None = None,
                 device="cuda", process_group=None):
        """``loss_fn(model_cfg, params, batch) -> scalar`` overrides the
        default next-token cross-entropy. ``process_group``: this
        process's ``ProcessGroup`` when the global mesh's dp axis spans
        processes (``mesh``, if given, is then this process's mesh)."""
        self.family = self._resolve_family(model_cfg)
        self.device = resolve_device(device)
        self.rules = _rules(cfg.strategy)
        self.process_group = process_group
        axes = cfg.mesh_axes if process_group is None else _local_axes(
            cfg.mesh_axes, process_group.world_size)
        self.mesh = mesh if mesh is not None else _mesh_on(self.device, axes)
        self._states_checked = False
        # sequence parallelism: ring attention when the rules cut seq over
        # a mesh axis that exists on this mesh and is wider than one
        sp = self.rules.seq
        self.attn_impl = (
            "ring" if sp is not None and sp in self.mesh.axis_names
            and self.mesh.shape[sp] > 1 else "auto")
        self.sp_axis = sp if self.attn_impl == "ring" else "sp"
        # pipeline parallelism: when the rules cut the stacked-layer dim
        # over a mesh axis that exists with size > 1
        ppax = self.rules.layers
        self.pp_axis = (
            ppax if isinstance(ppax, str) and ppax in self.mesh.axis_names
            and self.mesh.shape[ppax] > 1 else None)
        if self.family is not llama and (cfg.fused_loss
                                         or self.attn_impl == "ring"):
            raise ValueError(
                "fused_loss / ring attention are llama-only paths")
        if loss_fn is not None and (cfg.fused_loss or self.pp_axis):
            raise ValueError(
                "custom loss_fn cannot combine with fused_loss or "
                "pipeline parallelism (both own the loss computation)")
        # families without a causal-LM `forward` need the loss hook
        if loss_fn is None and not hasattr(self.family, "forward"):
            raise ValueError(
                f"{self.family.__name__} has no causal-LM default; pass "
                "loss_fn= (e.g. wrapping bert.mlm_loss)")
        if self.pp_axis:
            if self.family is not llama:
                raise ValueError(
                    "pipeline parallelism is wired for the llama family "
                    "only (make_llama_stage_fn)")
            n_pp = self.mesh.shape[self.pp_axis]
            if model_cfg.n_layers % n_pp:
                raise ValueError(f"n_layers={model_cfg.n_layers} not "
                                 f"divisible by pp={n_pp}")
            if cfg.fused_loss:
                raise ValueError(
                    "fused_loss is redundant under pipeline parallelism: "
                    "the 1F1B loss slot already computes the head "
                    "per-microbatch")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.optimizer = make_optimizer(cfg)
        # the per-rank step's checks (a tp block for the family, heads
        # dividing over tp) run now, as JAX's placement would refuse
        self._rank_step()

    @staticmethod
    def _resolve_family(model_cfg):
        if isinstance(model_cfg, llama.LlamaConfig):
            return llama
        from ray_tpu_torch.models import bert, gpt

        if isinstance(model_cfg, gpt.GPTConfig):
            return gpt
        if isinstance(model_cfg, bert.BertConfig):
            return bert
        raise TypeError(
            f"unsupported model config {type(model_cfg).__name__}; "
            "expected LlamaConfig, GPTConfig, or BertConfig")

    def _rank_step(self) -> spmd.RankStep:
        # built per step: the step reads model_cfg (its remat) as it is now
        return spmd.RankStep(
            self.family, self.model_cfg, self.mesh, self.rules,
            attn_impl=self.attn_impl, sp_axis=self.sp_axis,
            fused_loss=self.cfg.fused_loss, loss_chunk=self.cfg.loss_chunk,
            loss_fn=self.loss_fn)

    # --- state ---

    def abstract_state(self) -> TrainState:
        """The state's structure, shapes and dtypes, on the meta device
        (no memory): what state shardings and checkpoint restores read."""
        params = self.family.init_params(self.model_cfg, device="meta")
        return TrainState.create(params, self.optimizer)

    def state_shardings(self) -> TrainState:
        """The ``NamedSharding`` of every leaf of the state: the moments
        inherit their parameters' (``state_logical_axes``), the step
        count and step are replicated."""
        axes = state_logical_axes(
            self.abstract_state(),
            self.family.param_logical_axes(self.model_cfg))
        return tree_shardings(axes, self.mesh, self.rules)

    def init_state(self, seed: int = 0) -> TrainState:
        """Random parameters (``family.init_params`` with ``seed``) and a
        fresh optimizer state, each leaf placed by its sharding (on one
        card, as views: nothing is copied)."""
        params = self.family.init_params(self.model_cfg, seed=seed,
                                         device=self.device)
        state = TrainState.create(params, self.optimizer)
        if self.mesh.size == 1:
            return state
        return place_tree(state, self.state_shardings())

    def _placed(self, tree, shardings):
        """``tree`` with its plain tensors placed by ``shardings`` as views
        (each place on the tensor's device); placed leaves stay."""
        def put(x, sharding):
            if isinstance(x, ShardedTensor) or not isinstance(
                    x, torch.Tensor):
                return x
            if not all(same_device(x.device, d)
                       for d in self.mesh.devices.ravel()):
                raise ValueError(
                    f"a state of plain tensors on {x.device} cannot be "
                    f"placed as views over {self.mesh}: place it first "
                    "(init_state, or place_tree(state, "
                    "trainer.state_shardings()))")
            return device_put(x, sharding)
        return map_trees(put, tree, shardings, is_leaf=_is_leaf)

    # --- train step ---

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return torch.as_tensor(np.asarray(batch) if not
                               isinstance(batch, torch.Tensor) else batch,
                               device=self.mesh.devices.ravel()[0])

    def _place_batch(self, batch):
        """``batch`` on the mesh's first device, placed by
        ``_batch_shardings`` (as JAX's ``train_step`` puts it)."""
        batch = self._to_device(batch)
        return place_tree(batch, self._batch_shardings(batch))

    def _loss_fn(self, params, batch):
        """The loss of ``params`` (plain or placed) on ``batch``."""
        placed = self._placed(params, self.state_shardings().params)
        return self._rank_step().loss(placed, self._place_batch(batch))

    def _pp_loss_and_grad(self, params: dict, batch, weight=None):
        """1F1B pipelined loss and gradients by chunk
        (``pipeline_value_and_grad`` implements the backward itself: it is
        not differentiated through)."""
        step = self._rank_step()
        n_pp = self.mesh.shape[self.pp_axis]
        m = self.cfg.n_microbatches or n_pp
        batch = batch.unshard()
        inputs, targets = batch[:, :-1], batch[:, 1:]
        mask = (targets != -1).float()
        b, s = inputs.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        # the stages' blocks: each the pp index's layer group, placed over
        # the rest of the mesh, one placed tensor per layer (differentiated
        # layer by layer: unbind's backward would stack a stage's layer
        # gradients while they are still held, twice a stage's gradient);
        # the io params (embedding, final norm and head) are replicated
        # over pp
        stacked = [{n: st.take(self.pp_axis, i)
                    for n, st in params["blocks"].items()}
                   for i in range(n_pp)]
        stages = [{n: spmd.unbind_layers(st) for n, st in stage.items()}
                  for stage in stacked]
        io = {k: v for k, v in params.items() if k != "blocks"}
        mb = b // m
        (loss_sum, weight_sum), (d_sp, d_io, _) = pipeline_value_and_grad(
            step.stage_fn, step.head_fn(self.pp_axis), stages, io,
            inputs.reshape(m, mb, s), targets.reshape(m, mb, s),
            mask.reshape(m, mb, s), mesh=self.mesh, axis=self.pp_axis,
            embed_fn=step.embed_fn(self.pp_axis))
        count = weight_sum.clamp(min=1.0)
        grads = {}
        for name, st in io.items():
            for c, g in zip(st.chunks, d_io[name].chunks):
                grads[id(c)] = g
        for i, stage in enumerate(stacked):
            per_layer, d_sp[i] = d_sp[i], None
            for name, st in stage.items():
                layers = per_layer.pop(name)
                for place, c in st.distinct():
                    grads[id(c)] = torch.stack(
                        [g.chunks[place] for g in layers])
        # grads are of loss_sum; mean-loss grads = grads / sum(mask)
        # (times ``weight``), in each parameter's dtype (shared chunks
        # share a gradient: once)
        divisor = count if weight is None else count / weight
        for g in {id(g): g for g in grads.values()}.values():
            g.div_(divisor)
        return loss_sum / count, grads

    def _chunk_grads(self, params: dict, batch, weight=None):
        """The loss and the gradient of every distinct chunk of a placed
        parameter tree, by ``id(chunk)``; with ``weight`` (a scalar), the
        gradient of ``weight`` times the loss."""
        chunks = spmd.distinct_chunks(params)
        for c in chunks:
            c.requires_grad_(True)
        if self.pp_axis:
            return self._pp_loss_and_grad(params, batch, weight)
        loss = self._rank_step().loss(params, batch)
        # a parameter the loss does not use gets a zero gradient, as jax.grad
        grads = torch.autograd.grad(
            loss if weight is None else loss * weight, chunks,
            allow_unused=True, materialize_grads=True)
        return loss, {id(c): g for c, g in zip(chunks, grads)}

    def loss_and_grads(self, params, batch):
        """The loss of ``params`` on ``batch`` and its gradient, in the
        form of ``params``: placed tensors for a placed tree, global
        tensors for plain ones. No update."""
        placed = self._placed(params, self.state_shardings().params)
        loss, grads = self._chunk_grads(placed, self._place_batch(batch))

        def grad_of(x, st):
            if not isinstance(st, ShardedTensor):
                return x
            g = ShardedTensor(st.shape, st.dtype, st.sharding,
                              [grads[id(c)] for c in st.chunks])
            return g if isinstance(x, ShardedTensor) else g.unshard()
        return loss.detach(), map_trees(grad_of, params, placed,
                                        is_leaf=_is_leaf)

    def train_step(self, state: TrainState, batch):
        """One optimization step, in place on ``state``. ``batch``: int
        [B, S+1] tokens (the last column is the shifted target; -1 =
        padding), or, with a custom ``loss_fn``, any dictionary of arrays.
        Returns ``(state, {"loss", "grad_norm", "step"})``; loss and
        grad_norm (before clipping) are float32 scalars on the card."""
        placed = self._placed(state, self.state_shardings())
        pg = self.process_group
        if pg is not None:
            if not self._states_checked:
                pg.check_same(_named_chunks(
                    {"params": placed.params, "mu": placed.opt_state["mu"],
                     "nu": placed.opt_state["nu"]}) + [(
                        "step", torch.tensor(
                            [float(state.step),
                             float(state.opt_state["count"])],
                            device=self.device))])
                self._states_checked = True
            batch = self._to_device(self._rank_rows(batch))
            share = self._token_share(batch)
        else:
            share = None
        loss, grads = self._chunk_grads(placed.params,
                                        self._place_batch(batch), share)
        if pg is not None:
            loss = pg.all_reduce(loss.detach() * share)
            # each distinct gradient once (pipeline stages share some)
            distinct = {id(g): g for g in (
                grads[id(c)] for c in spmd.distinct_chunks(placed.params))}
            pg.all_reduce_grads(list(distinct.values()))
        gnorm = spmd.apply_update(
            self.optimizer, placed.params, grads, state.opt_state,
            (placed.opt_state["mu"], placed.opt_state["nu"]))
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    def _rank_rows(self, batch):
        """This process's rows of a global batch: rows [rank·B/world,
        (rank+1)·B/world) of every leaf with a batch axis."""
        pg = self.process_group
        if isinstance(batch, dict):
            return {k: self._rank_rows(v) for k, v in batch.items()}
        if int(getattr(batch, "ndim", 0)) == 0:
            return batch
        n = batch.shape[0]
        if n % pg.world_size:
            raise ValueError(f"global batch of {n} rows does not divide over "
                             f"{pg.world_size} processes")
        per = n // pg.world_size
        return batch[pg.rank * per:(pg.rank + 1) * per]

    def _token_share(self, batch):
        """This rank's share of the global batch's loss weight: its
        unpadded target tokens over every rank's (the token counts
        all-reduced), so that the ranks' weighted means sum to the global
        masked mean; a float32 scalar on the device (no wait for the
        card). With the ``loss_fn`` hook, whose weights the trainer cannot
        see, each rank weighs 1/world."""
        pg = self.process_group
        if self.loss_fn is not None:
            return 1.0 / pg.world_size
        n = (batch[:, 1:] != -1).sum(dtype=torch.float32)
        total = pg.all_reduce(n.clone())
        return n / total.clamp(min=1.0)

    def _batch_shardings(self, batch):
        """Per-leaf data sharding: dim 0 is the batch axis, the rest
        replicated, so dict batches may mix ranks (e.g. [B, S] tokens
        with [B] labels)."""
        def leaf(x):
            nd = int(getattr(x, "ndim", 0))
            if nd == 0:   # python scalars and 0-d arrays: replicated
                return replicated(self.mesh)
            return batch_sharding(self.mesh, self.rules, ndim=nd,
                                  shard_seq=False)
        if isinstance(batch, dict):
            return {k: self._batch_shardings(v) for k, v in batch.items()}
        return leaf(batch)

    def fit(self, state: TrainState, data_iter, *, steps: int,
            log_every: int = 10, callback: Callable | None = None):
        history = []
        t0 = time.perf_counter()
        for i in range(steps):
            state, metrics = self.train_step(state, next(data_iter))
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_s"] = (i + 1) / (time.perf_counter() - t0)
                history.append(m)
                if callback:
                    callback(m)
        return state, history
