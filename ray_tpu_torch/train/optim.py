"""The trainer's optimizer: optax's recipe, written out for PyTorch.

``JaxTrainer`` (``ray_tpu/train/trainer.py:167-179``) chains
``optax.clip_by_global_norm(max_grad_norm)`` with
``optax.adamw(warmup_cosine_decay_schedule(...), b1, b2,
weight_decay)``. This module computes the same update:

- the learning rate of step ``count`` (0-based, so step 0's rate is the
  schedule's initial value) from ``warmup_cosine_decay_schedule``;
- the gradients scaled by ``max_norm / norm`` when their global norm is
  not below ``max_norm`` (optax's clip; ``clip_grad_norm_`` would add 1e-6
  to the divisor);
- Adam moments in the parameters' dtype, bias-corrected with the 1-based
  step, ``mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * param``
  on every parameter, times ``-lr``.

The update runs in place, one tensor (and, for large tensors, one slice
along the first axis) at a time, with float32 arithmetic on the slice: a
foreach update over the whole list would make float32 temporaries the
size of all the parameters. JAX returns a new state and donates the old
one instead.

In bf16 the port rounds at other points than optax. optax computes each
operation of the chain in the dtype of the gradients and moments, so in
bf16 it rounds after every operation; the port lifts each slice to
float32, does all of Adam's arithmetic there and rounds only the stored
moments and the parameter. optax's per-operation rounding is no fixed
target either: XLA's ``xla_allow_excess_precision``, on by default, lets
the compiled bf16 chain keep float32 intermediates and drop some of
those roundings. So the port keeps float32 arithmetic, and
``tests/test_torch_train.py`` bounds the difference in bf16: after five
steps the parameters within 4 ulps (10% of them differing), the moments
within a few roundings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# elements per slice of the update (float32 temporaries of 256 MB)
_SLICE = 1 << 26


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (which includes the
    warmup). Returns a function of the 0-based step count."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * \
                count / warmup_steps
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def tree_leaves(tree) -> list:
    """The tensors of a nested dictionary, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to each tensor of a nested dictionary; other leaves
    (step counts) are kept as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _slices(x: torch.Tensor) -> tuple:
    """``x`` cut along its first axis into views of at most about _SLICE
    elements (``x`` itself when it is small)."""
    if x.dim() == 0 or x.numel() <= _SLICE:
        return (x,)
    rows = max(1, _SLICE // (x.numel() // x.shape[0]))
    return x.split(rows)


def sum_of_squares(tensors, device=None) -> torch.Tensor:
    """The sum of squares of all the tensors, in float32, one slice at a
    time (a float32 zero on ``device`` for none)."""
    total = None
    for x in tensors:
        for sl in _slices(x):
            sq = sl.float().square().sum()
            total = sq if total is None else total + sq.to(total.device)
    return torch.zeros((), device=device) if total is None else total


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) of all the tensors, in float32 (optax's
    ``global_norm``), one slice at a time."""
    return sum_of_squares(tensors).sqrt()


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    b1, b2, eps, weight_decay=weight_decay))`` with an in-place update.
    ``init(params)`` makes the state: the step ``count`` and the moments
    ``mu``, ``nu`` in the parameters' structure and dtypes."""

    def __init__(self, schedule, *, max_grad_norm: float, b1: float,
                 b2: float, eps: float = 1e-8, weight_decay: float):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params: list, grads: list, state: dict, *,
               moments: tuple | None = None, norm_of: list | None = None,
               reduce_sq=None) -> torch.Tensor:
        """Update ``params`` (the leaves of the state's parameter tree, in
        ``tree_leaves`` order) in place from ``grads``; advance ``state``.
        ``moments``: the (mu, nu) tensors of ``params``, in order (default:
        the leaves of the state's trees); ``norm_of``: the gradients whose
        global norm clips (default: ``grads``; a placed state passes one
        chunk per index range, so replicas count once); ``reduce_sq``: a
        function that sums the squared norm over processes. Returns that
        norm, before clipping."""
        sq = sum_of_squares(grads if norm_of is None else norm_of,
                            params[0].device if params else None)
        norm = (sq if reduce_sq is None else reduce_sq(sq)).sqrt()
        norm_f = float(norm)
        clip = not norm_f < self.max_grad_norm
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        # optax's bias correction, 1 - decay**count in float32 (in double,
        # 1 - 0.999 sits 1.3e-5 from float32's 1 - 0.999, which moves every
        # first step by 6.4e-6)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        mus, nus = moments if moments is not None else (
            tree_leaves(state["mu"]), tree_leaves(state["nu"]))
        for p, g, m, v in zip(params, grads, mus, nus, strict=True):
            for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                      _slices(v)):
                gf = gs.float()
                if clip:
                    gf = gf / norm_f * self.max_grad_norm
                # mul (not mul_): float() of a float32 slice is the slice
                mf = ms.float().mul(self.b1).add_(gf, alpha=1.0 - self.b1)
                vf = vs.float().mul(self.b2).addcmul_(gf, gf,
                                                      value=1.0 - self.b2)
                ms.copy_(mf)
                vs.copy_(vf)
                upd = mf.div_(bc1).div_(vf.div_(bc2).sqrt_().add_(self.eps))
                upd.add_(ps.float(), alpha=self.weight_decay)
                ps.add_(upd, alpha=-lr)
        state["count"] = count
        return norm
