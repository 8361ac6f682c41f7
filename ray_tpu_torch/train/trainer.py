"""Trainer: the training step of a model family, on one card.

Port of ``ray_tpu/train/trainer.py`` (``JaxTrainer``): ``TrainConfig``
keeps the same fields and defaults, and ``Trainer`` keeps its surface
(``init_state``, ``train_step``, ``fit``, the ``loss_fn`` hook,
``fused_loss`` and ``loss_chunk``, ``mesh=``). Where JAX jit-compiles one
SPMD step over a mesh and donates the state, the port runs eagerly and
updates the state's tensors in place: the gradients come from
``torch.autograd.grad``, and the optimizer (``train.optim.AdamW``, the
same recipe as JAX's optax chain) updates one tensor at a time.

The mesh (``parallel.mesh``, single-controller as in JAX) is the one
given, or one built from ``mesh_axes`` with every place on the trainer's
device. The sharding rules (a preset name or ``ShardingRules``) become
``self.rules``; when ``rules.seq`` names a mesh axis wider than one,
llama's attention runs as ring attention over it (``attn_impl="ring"``),
as in JAX. Every other axis wider than one, a pipeline (``pp``) and
``n_microbatches > 1`` need the state placed across ranks, which comes
with slice 7 of the port; they raise ``NotImplementedError``.

The model family comes from the config's type, as in JAX: llama, gpt or
bert (``_resolve_family``); any other config raises ``TypeError``. A
family other than llama trains on ``family.forward`` and the next-token
cross-entropy, or on the ``loss_fn`` hook, which bert needs (it has no
causal-LM forward); ``fused_loss`` and ring attention are llama's alone.
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
from ray_tpu_torch.parallel.sharding import PRESETS, ShardingRules
from ray_tpu_torch.train.optim import (AdamW, tree_leaves,
                                       warmup_cosine_decay_schedule)
from ray_tpu_torch.train.state import TrainState


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
    # pipeline microbatches: more than one needs the pipeline of slice 7
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


def _check_one_card(mesh: Mesh, seq_axis, cfg: TrainConfig) -> None:
    """Raise on what needs the state placed across ranks: a mesh axis
    wider than one other than the ring's ``seq_axis``, or microbatches."""
    wide = {ax: n for ax, n in mesh.shape.items() if n > 1 and ax != seq_axis}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} need the state placed across ranks (FSDP, "
            "TP, pipeline), which comes with slice 7 of the port; only the "
            "sharding rules' seq axis may be wider than one")
    if cfg.n_microbatches not in (None, 1):
        raise NotImplementedError(
            f"n_microbatches={cfg.n_microbatches} needs the 1F1B pipeline, "
            "which comes with slice 7 of the port")


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
    """Trainer of a llama, gpt or bert model on one card, sequence
    parallel over a mesh when the rules cut the sequence.

    Usage::

        trainer = Trainer(llama.llama3_8b(), TrainConfig())
        state = trainer.init_state(seed=0)
        state, metrics = trainer.train_step(state, batch)  # [B, S+1] tokens
    """

    def __init__(self, model_cfg, cfg: TrainConfig, *,
                 mesh: Mesh | None = None, loss_fn: Callable | None = None,
                 device="cuda"):
        """``loss_fn(model_cfg, params, batch) -> scalar`` overrides the
        default next-token cross-entropy."""
        self.family = self._resolve_family(model_cfg)
        self.device = resolve_device(device)
        self.rules = _rules(cfg.strategy)
        self.mesh = mesh if mesh is not None else _mesh_on(self.device,
                                                           cfg.mesh_axes)
        # sequence parallelism: ring attention when the rules cut seq over
        # a mesh axis that exists on this mesh and is wider than one
        sp = self.rules.seq
        self.attn_impl = (
            "ring" if sp is not None and sp in self.mesh.axis_names
            and self.mesh.shape[sp] > 1 else "auto")
        self.sp_axis = sp if self.attn_impl == "ring" else "sp"
        _check_one_card(self.mesh, sp if self.attn_impl == "ring" else None,
                        cfg)
        if self.family is not llama and (cfg.fused_loss
                                         or self.attn_impl == "ring"):
            raise ValueError(
                "fused_loss / ring attention are llama-only paths")
        if loss_fn is not None and cfg.fused_loss:
            raise ValueError("custom loss_fn cannot combine with fused_loss "
                             "(both own the loss computation)")
        # families without a causal-LM `forward` need the loss hook
        if loss_fn is None and not hasattr(self.family, "forward"):
            raise ValueError(
                f"{self.family.__name__} has no causal-LM default; pass "
                "loss_fn= (e.g. wrapping bert.mlm_loss)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.optimizer = make_optimizer(cfg)

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

    def init_state(self, seed: int = 0) -> TrainState:
        params = self.family.init_params(self.model_cfg, seed=seed,
                                         device=self.device)
        return TrainState.create(params, self.optimizer)

    def _loss_fn(self, params, batch):
        if self.loss_fn is not None:
            return self.loss_fn(self.model_cfg, params, batch)
        inputs, targets = batch[:, :-1], batch[:, 1:]
        mask = (targets != -1).float()
        if self.family is not llama:
            logits = self.family.forward(self.model_cfg, params, inputs)
            return llama.cross_entropy_loss(logits, targets.clamp(min=0),
                                            mask=mask)
        ring = dict(attn_impl=self.attn_impl, mesh=self.mesh,
                    sp_axis=self.sp_axis)
        if self.cfg.fused_loss:
            hidden = llama.forward_hidden(self.model_cfg, params, inputs,
                                          **ring)
            return llama.fused_cross_entropy(
                self.model_cfg, params, hidden, targets, mask=mask,
                chunk=self.cfg.loss_chunk)
        logits = llama.forward(self.model_cfg, params, inputs, **ring)
        return llama.cross_entropy_loss(logits, targets.clamp(min=0),
                                        mask=mask)

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return torch.as_tensor(np.asarray(batch) if not
                               isinstance(batch, torch.Tensor) else batch,
                               device=self.device)

    def train_step(self, state: TrainState, batch):
        """One optimization step, in place on ``state``. ``batch``: int
        [B, S+1] tokens (the last column is the shifted target; -1 =
        padding), or, with a custom ``loss_fn``, any dictionary of arrays.
        Returns ``(state, {"loss", "grad_norm", "step"})``; loss and
        grad_norm (before clipping) are float32 scalars on the card."""
        batch = self._to_device(batch)
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss = self._loss_fn(state.params, batch)
        # a parameter the loss does not use gets a zero gradient, as jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        gnorm = self.optimizer.update(leaves, list(grads), state.opt_state)
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

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
