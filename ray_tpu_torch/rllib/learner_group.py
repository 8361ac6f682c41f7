"""The learner plane: one learner, or data-parallel learners.

Port of ``ray_tpu/rllib/learner_group.py`` (reference:
``rllib/core/learner/learner_group.py:61,145``). An algorithm plugs in
``init_fn(seed, device=) -> module`` (``rllib.ppo.init_module``,
``rllib.recurrent.init_recurrent_module``),
``loss_fn(module, batch) -> (total, stats)`` (``ppo_loss``,
``impala_loss``; the learner differentiates it, where JAX's ``grad_fn``
returns the gradients) and ``tx``, the port's ``AdamW``. These reach rank
processes by plain ``pickle``, so they are module-level functions or
``functools.partial``s of them.

- ``Learner``: the module on one device and its optimizer state; an
  update is the loss's gradients, then one optimizer step (JAX's
  in-process jit, ``num_learners=0``).
- ``mode="mesh"`` (``_MeshLearner``, ``:45``): a ``{"dp": n}`` mesh
  (``parallel.mesh.create_mesh``; one card may fill every place). The
  batch, padded to a multiple of n (``_pad_to_multiple``), is cut into n
  equal shards on the places and the parameters are replicated; each
  place's gradients of its shard's mean loss are averaged over dp
  (``collectives.pmean``), then one optimizer step follows. With equal
  shards the mean of shard means is the padded batch's mean, so this is
  one learner on the padded batch, as XLA's psum makes JAX's.
- ``mode="actors"`` (``:108-210``): n rank processes of the harness
  (``train.worker_group.WorkerGroup.execute``) over ``torch.distributed``:
  gloo on the CPU and for several ranks on one card, NCCL with a card a
  rank (``parallel.process_group.check_backend``). Each rank holds a
  replica built from the same seed (checked equal), takes its shard of the
  padded batch, sums the gradients over the ranks
  (``ProcessGroup.all_reduce_grads``) and divides by the world size; the
  calling process averages the ranks' stats (``:201``).
"""

from __future__ import annotations

import copy
import os
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _pad_to_multiple(batch: dict, k: int) -> dict:
    """Pad the leading axis to a multiple of k by wrapping (mesh-sharded
    updates need equal per-shard sizes; wrapped rows re-weight a few
    samples — the standard drop-or-pad trade, biased toward pad)."""
    n = len(next(iter(batch.values())))
    rem = n % k
    if rem == 0:
        return batch
    extra = k - rem
    idx = np.arange(extra) % n
    return {key: np.concatenate([v, v[idx]]) for key, v in batch.items()}


def _tensors(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_grads(loss_fn: Callable, module: torch.nn.Module,
               batch: dict) -> tuple:
    """The gradients of ``loss_fn(module, batch)``'s total with respect to
    ``module.parameters()`` (in their order; zeros for a parameter the
    total does not use, as ``jax.grad`` gives), and its stats, detached."""
    total, stats = loss_fn(module, batch)
    params = list(module.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return ([torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)],
            {k: v.detach() for k, v in stats.items()})


def sgd_step(loss_fn: Callable, module: torch.nn.Module, opt_state: dict,
             batch: dict, tx) -> dict:
    """One step of ``tx`` on ``module`` in place from ``loss_fn``'s
    gradients on a batch of tensors; returns the stats (detached tensors)
    of the parameters before the step (JAX's fused update, without its
    jit)."""
    grads, stats = loss_grads(loss_fn, module, batch)
    tx.update(list(module.parameters()), grads, opt_state)
    return stats


def _floats(stats: dict) -> dict:
    """Stats as Python floats, read from the device at once."""
    return dict(zip(stats, torch.stack(list(stats.values())).tolist()))


class Learner:
    """One learner: ``module`` on ``device`` and its optimizer state.
    ``update(batch)`` takes a numpy batch and returns its stats as floats;
    ``get_params``/``set_params`` move the parameters as JAX's numpy tree
    (``set_params`` keeps the optimizer state, as JAX's single learner
    does)."""

    def __init__(self, *, init_fn: Callable, loss_fn: Callable, tx,
                 seed: int, device="cuda"):
        self.device = resolve_device(device)
        self.module = init_fn(seed, device=self.device)
        self.loss_fn = loss_fn
        self.tx = tx
        self.opt_state = tx.init(dict(self.module.named_parameters()))

    def _grads(self, batch: dict) -> tuple:
        return loss_grads(self.loss_fn, self.module,
                          _tensors(batch, self.device))

    def update(self, batch: dict) -> dict:
        grads, stats = self._grads(batch)
        self.tx.update(list(self.module.parameters()), grads,
                       self.opt_state)
        return _floats(stats)

    def get_params(self) -> dict:
        return self.module.numpy_tree()

    def set_params(self, params: dict) -> None:
        """``params`` a numpy tree of JAX's ``init_module`` or, with a
        ``"cell"`` layer, of ``init_recurrent_module`` (its ``cell_type``
        optional; a tree of another cell than the module's raises)."""
        from ray_tpu_torch import convert

        if "cell" in params:
            self.module = convert.recurrent_from_numpy(
                params, cell_type=getattr(self.module, "cell_type", None),
                device=self.device)
        else:
            self.module = convert.policy_value_from_numpy(
                params, device=self.device)

    def stop(self) -> None:
        pass


class _MeshLearner(Learner):
    """Data-parallel learners on the places of a ``{"dp": n}`` mesh
    (module docstring). The parameters live on the first place; a place
    on another device works on a copy made each update."""

    def __init__(self, *, num_learners: int, devices=None, device="cuda",
                 **kw):
        from ray_tpu_torch.parallel.mesh import create_mesh

        if devices is None:
            devices = [resolve_device(device)] * num_learners
        self.num_learners = num_learners
        self.mesh = create_mesh({"dp": num_learners}, devices=devices)
        self.places = self.mesh.axis_devices("dp")
        super().__init__(device=self.places[0], **kw)

    def _grads(self, batch: dict) -> tuple:
        from ray_tpu_torch.parallel import collectives

        batch = _pad_to_multiple(batch, self.num_learners)
        shards = {k: collectives.shard(torch.as_tensor(v), self.places, 0)
                  for k, v in batch.items()}
        per_place = []
        for i, place in enumerate(self.places):
            replica = self.module if place == self.device else \
                copy.deepcopy(self.module).to(place)
            per_place.append(loss_grads(self.loss_fn, replica,
                                        {k: v[i] for k, v in shards.items()}))
        grads = [collectives.pmean([g[j] for g, _ in per_place])[0]
                 for j in range(len(per_place[0][0]))]
        stats = {k: collectives.pmean([s[k] for _, s in per_place])[0]
                 for k in per_place[0][1]}
        return grads, stats

    def set_params(self, params: dict) -> None:
        """Replace the parameters (a checkpoint's restore); the optimizer
        state restarts fresh, as JAX's ``_MeshLearner.set_params``."""
        super().set_params(params)
        self.opt_state = self.tx.init(dict(self.module.named_parameters()))


class _Replica(Learner):
    """One learner replica in a rank process: its shard of the padded
    batch, the gradients summed over the ranks and divided by the world
    size. The ranks share the host's cores: each takes an equal part for
    its intra-op threads (with torch's default, every rank's pool takes
    them all and the ranks' threads contend)."""

    def __init__(self, ctx, **kw):
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // ctx.world_size))
        super().__init__(device=ctx.device, **kw)
        self.ctx = ctx
        ctx.process_group.check_same(list(self.module.named_parameters()))

    def _grads(self, batch: dict) -> tuple:
        rank, world = self.ctx.rank, self.ctx.world_size
        per = len(next(iter(batch.values()))) // world
        grads, stats = super()._grads(
            {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()})
        self.ctx.process_group.all_reduce_grads(grads)
        return [g.div_(world) for g in grads], stats

    def set_params(self, params: dict) -> None:
        super().set_params(params)
        self.opt_state = self.tx.init(dict(self.module.named_parameters()))


def _replica_call(method: str, *args):
    """Run ``method`` of this rank's replica (made by ``"init"``)."""
    from ray_tpu_torch.train import session

    ctx = session.get_context()
    if method == "init":
        init_fn, loss_fn, tx, seed = args
        ctx.objects["learner"] = _Replica(ctx, init_fn=init_fn,
                                          loss_fn=loss_fn, tx=tx, seed=seed)
        return ctx.rank
    return getattr(ctx.objects["learner"], method)(*args)


class _ActorLearners:
    """n learner replicas in rank processes (module docstring)."""

    def __init__(self, *, init_fn, loss_fn, tx, num_learners: int,
                 seed: int, device="cuda"):
        from ray_tpu_torch.air.config import ScalingConfig
        from ray_tpu_torch.train.worker_group import WorkerGroup

        dev = resolve_device(device)
        use_gpu = dev.type == "cuda"
        backend = "nccl" if use_gpu and \
            num_learners <= torch.cuda.device_count() else "gloo"
        self.num_learners = num_learners
        self.group = WorkerGroup(ScalingConfig(
            num_workers=num_learners, use_gpu=use_gpu, backend=backend))
        self.group.execute(_replica_call, "init", init_fn, loss_fn, tx, seed)

    def update(self, batch: dict) -> dict:
        batch = _pad_to_multiple(batch, self.num_learners)
        stats = self.group.execute(_replica_call, "update", batch)
        return {k: float(np.mean([s[k] for s in stats])) for k in stats[0]}

    def get_params(self) -> dict:
        return self.group.execute(_replica_call, "get_params")[0]

    def set_params(self, params: dict) -> None:
        self.group.execute(_replica_call, "set_params", params)

    def stop(self) -> None:
        self.group.shutdown()


class LearnerGroup:
    """Facade (reference: ``LearnerGroup`` learner_group.py:61): owns the
    learner plane, dispatches batches, exposes the parameters as a numpy
    tree. ``devices`` (mesh mode): the places, default ``device`` on
    every one."""

    def __init__(self, *, init_fn: Callable, loss_fn: Callable, tx,
                 num_learners: int = 1, mode: str = "mesh", seed: int = 0,
                 device="cuda", devices=None):
        if mode not in ("mesh", "actors"):
            raise ValueError(f"unknown learner mode {mode!r}")
        self.mode = mode
        kw = dict(init_fn=init_fn, loss_fn=loss_fn, tx=tx,
                  num_learners=max(1, num_learners), seed=seed,
                  device=device)
        self._impl = _MeshLearner(devices=devices, **kw) \
            if mode == "mesh" else _ActorLearners(**kw)

    def update(self, batch: dict) -> dict:
        return self._impl.update(batch)

    def get_params(self) -> dict:
        return self._impl.get_params()

    def set_params(self, params: dict) -> None:
        """Replace every replica's parameters (a checkpoint's restore);
        the optimizer state restarts fresh on every learner."""
        self._impl.set_params(params)

    def stop(self) -> None:
        self._impl.stop()


def build_learner(*, num_learners: int, mode: str, **kw):
    """An algorithm's learner: one ``Learner`` for ``num_learners`` 0,
    else a ``LearnerGroup`` of that many."""
    if num_learners > 0:
        return LearnerGroup(num_learners=num_learners, mode=mode, **kw)
    return Learner(**kw)
