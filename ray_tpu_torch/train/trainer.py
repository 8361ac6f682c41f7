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
  are gathered before use, tp cuts the heads and MLP of Llama and GPT
  (GPT's fused qkv columns need not hold whole heads), and the vocabulary
  stays cut over tp through the embedding and the loss (``train.spmd``);
- when ``rules.seq`` names a mesh axis wider than one, Llama's attention
  runs as ring attention over it (``attn_impl="ring"``);
- when ``rules.layers`` names one (``pp_fsdp``), Llama's layers run as
  the 1F1B pipeline (``parallel.pipeline.pipeline_value_and_grad``) over
  ``n_microbatches`` microbatches (default: the number of stages).

Across processes (``process_group=``, a ``parallel.process_group``
``ProcessGroup``), as JAX across the processes of ``jax.distributed``:
the global mesh's places are dealt to the processes in row-major order,
an equal contiguous block each (``parallel.mesh.split_axes``): any axis
may span processes, one index a process, or be cut at the process
boundary, a run of consecutive indices a process, and each process
drives its own places, as above, with subgroup collectives along the
spanned axes (``train.spmd``). Over a spanned pp each process holds its
own stages' layers (and the io parameters, replicated over pp) and runs
those stages' slots of the 1F1B schedule, the activations and gradients
sent between the stages' processes
(``parallel.pipeline``), which sum the io gradients and the loss over
pp. ``train_step`` takes the
global batch and keeps this process's rows over the spanned data axes
(and, under a spanned sp, ``train.spmd`` its chunk of the sequence after
the shift); the loss is the global masked mean (each process's token
count is summed over the processes that compute different parts of it,
and its loss, before the backward, weighted by its share of the tokens, a
float32 scalar on the device). A leaf's gradient is summed over those
processes along every axis that does not cut it (dp always; fsdp for a
leaf it does not cut, whose cut leaves come back reduce-scattered by the
gathers' backward; sp for every leaf), so that every replica of an index
range takes the same step, and the clip norm counts each range once.
Before the first step the replicas of every index range are checked
equal by checksum. A placed state across processes holds this process's
chunks only (``init_state``, or ``place_tree`` of a state on the
process's device).

The model family comes from the config's type, as in JAX: llama, gpt or
bert (``_resolve_family``); any other config raises ``TypeError``. GPT
trains on the next-token cross-entropy of its forward, per rank as
Llama's; bert needs the ``loss_fn`` hook (it has no causal-LM forward),
which sees the gathered parameters under every preset. ``fused_loss``,
ring attention and the pipeline are llama's alone.
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
from ray_tpu_torch.parallel.mesh import Mesh, create_mesh, split_axes
from ray_tpu_torch.parallel.pipeline import pipeline_value_and_grad
from ray_tpu_torch.parallel.process_group import mesh_layout
from ray_tpu_torch.parallel.sharding import (PRESETS, ShardedTensor,
                                             ShardingRules, _axes_of,
                                             batch_sharding, device_put,
                                             map_trees, place_tree,
                                             replicated, same_device,
                                             tree_shardings)
from ray_tpu_torch.train import spmd
from ray_tpu_torch.train.optim import (AdamW, tree_leaves,
                                      warmup_cosine_decay_schedule)
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


def _mesh_on(device, mesh_axes: dict, layout=None) -> Mesh:
    """A mesh of ``mesh_axes`` with every place on ``device`` (a -1 axis
    takes size 1), this process's part of a global mesh with
    ``layout``."""
    n = math.prod(n for n in mesh_axes.values() if n != -1)
    mesh = create_mesh(mesh_axes, devices=[device] * n)
    return Mesh(mesh.devices, mesh.axis_names, layout)


def _local_axes(mesh_axes: dict, world: int, strategy=None) -> dict:
    """The axes of one process's mesh when ``world`` processes share the
    global mesh ``mesh_axes`` (``parallel.mesh.split_axes``), checked
    before any process starts: a mesh that does not deal into equal grid
    blocks raises, as ``split_axes`` says why. ``strategy`` is checked
    to be a known preset or rules."""
    if strategy is not None:
        _rules(strategy)
    return split_axes(mesh_axes, world)[0]


def _named_chunks(tree, prefix="") -> list:
    """(name, tensor) of every distinct chunk of a tree of tensors and
    placed tensors, in tree order; a chunk is named by its leaf and its
    index range, which replicas share."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _named_chunks(v, f"{prefix}{k}.")]
    if isinstance(tree, ShardedTensor):
        indices = tree.sharding.indices(tree.shape)
        return [(f"{prefix[:-1]}"
                 f"{[(s.start, s.stop) for s in indices[place]]}", c)
                for place, c in tree.distinct()]
    if isinstance(tree, torch.Tensor):
        return [(prefix[:-1], tree)]
    return []


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor))


def _zeros_like(st: ShardedTensor) -> ShardedTensor:
    """Zeros placed as ``st`` is, shared chunks sharing."""
    made = {id(c): torch.zeros_like(c) for _, c in st.distinct()}
    return ShardedTensor(st.shape, st.dtype, st.sharding,
                         [made[id(c)] for c in st.chunks])


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
        process's ``ProcessGroup`` when the global mesh ``mesh_axes``
        spans processes (``mesh``, if given, is then this process's
        mesh)."""
        self.family = self._resolve_family(model_cfg)
        self.device = resolve_device(device)
        self.rules = _rules(cfg.strategy)
        self.process_group = process_group
        if mesh is None and process_group is not None:
            _local_axes(cfg.mesh_axes, process_group.world_size,
                        cfg.strategy)
            layout = mesh_layout(process_group, cfg.mesh_axes)
            mesh = _mesh_on(self.device, layout.local, layout)
        self.mesh = mesh if mesh is not None else _mesh_on(
            self.device, cfg.mesh_axes)
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
        # the per-rank step's checks (Llama's heads dividing over tp) run
        # now, as JAX's placement would refuse
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
        card, as views: nothing is copied; a mesh of one place here keeps
        plain tensors). Cut across processes, each process keeps its
        chunks alone, its moments made at their size."""
        params = self.family.init_params(self.model_cfg, seed=seed,
                                         device=self.device)
        shardings = self.state_shardings()
        across = [sh for sh in tree_leaves(shardings.params)
                  if sh.spans_processes()]
        if self.mesh.devices.size == 1 and not across:
            return TrainState.create(params, self.optimizer)
        if not across:
            return place_tree(TrainState.create(params, self.optimizer),
                              shardings)
        params = place_tree(params, shardings.params)
        zeros = {"mu": map_trees(_zeros_like, params, is_leaf=_is_leaf),
                 "nu": map_trees(_zeros_like, params, is_leaf=_is_leaf)}
        return TrainState(params=params, opt_state={"count": 0, **zeros},
                          step=0)

    def _placed(self, tree, shardings):
        """``tree`` with its plain tensors placed by ``shardings`` as views
        (each place on the tensor's device); placed leaves stay."""
        def put(x, sharding):
            if isinstance(x, ShardedTensor) or not isinstance(
                    x, torch.Tensor):
                return x
            if sharding.spans_processes() or not all(
                    same_device(x.device, d)
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
        """``batch`` (this process's rows across processes) on the mesh's
        first device, placed over this process's places by
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
        # this process's stages: all of them, or its own where pp spans
        # processes (the pipeline then runs that stage's slots alone)
        n_local = self.mesh.local_shape[self.pp_axis]
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
                   for i in range(n_local)]
        stages = [{n: spmd.unbind_layers(st) for n, st in stage.items()}
                  for stage in stacked]
        io = {k: v for k, v in params.items() if k != "blocks"}
        mb = b // m
        x_micro = inputs.reshape(m, mb, s)
        (loss_sum, weight_sum), (d_sp, d_io, _) = pipeline_value_and_grad(
            step.stage_fn, step.head_fn(self.pp_axis), stages, io, x_micro,
            targets.reshape(m, mb, s), mask.reshape(m, mb, s),
            mesh=self.mesh, axis=self.pp_axis,
            embed_fn=step.embed_fn(self.pp_axis),
            like=step.stage_like(self.pp_axis, x_micro[0],
                                 params["embedding"].dtype))
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
        tensors for plain ones. No update. Where fsdp, sp or pp split the
        loss between processes, each process's part is only summed by
        ``train_step``: this raises there."""
        split = set(self._rank_step().split_axes) - {"dp"}
        if self.pp_axis and self.mesh.spans(self.pp_axis):
            split.add(self.pp_axis)
        if split:
            raise NotImplementedError(
                f"loss_and_grads with {sorted(split)} across processes: "
                "their parts of the loss are summed in train_step")
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
        step = self._rank_step()
        reduce_norm = None
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
            batch = self._to_device(self._rank_rows(batch, step))
            share = self._token_share(batch, step)
            reduce_norm = pg.all_reduce
        else:
            share = None
        loss, grads = self._chunk_grads(placed.params,
                                        self._place_batch(batch), share)
        if pg is not None:
            loss = self._split_sum(loss.detach() * share, step)
            self._all_reduce_grads(placed.params, grads, step)
        gnorm = spmd.apply_update(
            self.optimizer, placed.params, grads, state.opt_state,
            (placed.opt_state["mu"], placed.opt_state["nu"]), reduce_norm)
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    def _rank_rows(self, batch, step=None):
        """This process's rows of a global batch: its block of the pieces
        the batch axis is cut into, over the spanned axes whose processes
        compute different parts of the loss (``RankStep.split_axes``); the
        whole batch along the others."""
        if isinstance(batch, dict):
            return {k: self._rank_rows(v, step) for k, v in batch.items()}
        if int(getattr(batch, "ndim", 0)) == 0:
            return batch
        step = step or self._rank_step()
        mesh = self.mesh
        axes = list(_axes_of(batch_sharding(
            mesh, self.rules, 2, shard_seq=False).spec[0]))
        sizes = [mesh.shape[a] for a in axes]
        lo, span = [], []
        for a in axes:
            split = a in step.split_axes
            lo.append(mesh.offset(a) if split else 0)
            span.append(mesh.local_shape[a] if split else mesh.shape[a])
        # one contiguous block: the spanned axes lead (split_axes)
        first = int(np.ravel_multi_index(lo, sizes)) if axes else 0
        count = math.prod(span)
        n, pieces = batch.shape[0], math.prod(sizes)
        if n % pieces:
            raise ValueError(f"global batch of {n} rows does not divide over "
                             f"{pieces} data ranks")
        per = n // pieces
        return batch[first * per:(first + count) * per]

    def _split_sum(self, x, step):
        """``x`` summed over the processes that compute different parts of
        the loss (one line of each split axis in turn), in place."""
        for a in step.split_axes:
            self.process_group.all_reduce(x, group=self.mesh.group(a))
        return x

    def _token_share(self, batch, step=None):
        """This process's share of the global batch's loss weight: its
        unpadded target tokens (of its chunk of the sequence under a
        spanned sp) over those of every process that computes another
        part of the loss, so that the weighted means sum to the global
        masked mean; a float32 scalar on the device (no wait for the
        card). With the ``loss_fn`` hook, whose weights the trainer cannot
        see, each of those processes weighs alike."""
        step = step or self._rank_step()
        if self.loss_fn is not None:
            return 1.0 / math.prod(self.mesh.group(a).size
                                   for a in step.split_axes)
        n = (step.seq_chunk(batch[:, 1:]) != -1).sum(dtype=torch.float32)
        total = self._split_sum(n.clone(), step)
        return n / total.clamp(min=1.0)

    def _all_reduce_grads(self, params: dict, grads: dict, step) -> None:
        """Sum each leaf's gradient over every split axis that does not
        cut it (each distinct gradient once: pipeline stages share
        some)."""
        pg = self.process_group
        for a in step.split_axes:
            leaves = [st for st in tree_leaves(params)
                      if a not in st.sharding.cut_axes()]
            distinct = {id(g): g for g in (
                grads[id(c)] for st in leaves for _, c in st.distinct())}
            if not distinct:
                continue
            pg.all_reduce_grads(list(distinct.values()),
                                group=self.mesh.group(a))

    def _batch_shardings(self, batch):
        """Per-leaf data sharding: dim 0 is the batch axis, the rest
        replicated, so dict batches may mix ranks (e.g. [B, S] tokens
        with [B] labels)."""
        mesh = self.mesh.local()

        def leaf(x):
            nd = int(getattr(x, "ndim", 0))
            if nd == 0:   # python scalars and 0-d arrays: replicated
                return replicated(mesh)
            return batch_sharding(mesh, self.rules, ndim=nd,
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
