"""Pipeline parallelism: stage-split layers and microbatch rotation.

Port of ``ray_tpu/parallel/pipeline.py``. The stacked layer arrays are
split into ``n_stages`` contiguous groups (``split_stages``), one per
index of the ``pp`` mesh axis, and microbatches flow through the stages.
Two schedules:

- ``pipeline_apply``: GPipe forward. Its backward is autograd through the
  host loop (the mirror-image reverse pipeline).
- ``pipeline_value_and_grad``: 1F1B. Forward and backward interleave,
  the loss and its gradient are computed per microbatch on the last stage
  (the loss slot), so microbatch m's backward starts S-1 ticks after its
  forward. Only stage inputs are stashed, in a ring of 2·S slots per
  stage, and each backward slot re-runs its stage forward from the
  stashed input (rematerialization built in). It returns the gradients:
  it implements backprop and is not differentiated through.

Host-loop honesty note. JAX runs the schedule as one lockstep
``lax.scan`` in which every stage executes every slot of every tick, the
inactive ones masked out with ``jnp.where`` (data-dependent branches
around GSPMD's collectives would deadlock the mesh), so the warm-up and
cool-down bubbles burn FLOPs there. The port is single-controller
(``parallel.mesh``): its schedule is a Python loop over ticks and stages
that skips the inactive slots. A masked slot adds zeros in JAX, so the
results are the same; the slots that run, and their order within a tick
(forward, loss, backward), are JAX's.

Devices. A stage function receives its inputs where the previous stage
left them and moves what it needs to its own places (``Tensor.to`` is a
no-op on one card and a differentiable copy across cards). Stage and io
parameters are trees (dicts, lists, tuples) of tensors or of placed
tensors (``parallel.sharding.ShardedTensor``), whose chunks are
differentiated one distinct chunk at a time; activations are tensors or
lists of tensors.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import ShardedTensor


def split_stages(stacked_params, n_stages: int):
    """Reshape stacked per-layer params [L, ...] -> [n_stages, L/ns, ...]
    (views)."""

    def reshape(a):
        l = a.shape[0]
        if l % n_stages:
            raise ValueError(
                f"{l} layers not divisible by {n_stages} pipeline stages")
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])

    return _map_tensors(reshape, stacked_params)


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, ShardedTensor):
        return ShardedTensor(tree.shape, tree.dtype, tree.sharding,
                             [fn(c) for c in tree.chunks])
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _positions(tree) -> list:
    """Every tensor (or None) of ``tree`` in order, one entry per position
    (a placed tensor's chunks included, repeats included)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _positions(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _positions(v)]
    if isinstance(tree, ShardedTensor):
        return list(tree.chunks)
    return [tree] if tree is None or isinstance(tree, torch.Tensor) else []


def _distinct(tree) -> list:
    seen, out = set(), []
    for t in _positions(tree):
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _aliases(tree):
    """``tree`` with each distinct tensor replaced by a detached alias
    (the same storage, a leaf of its own, requiring a gradient when it
    is a float), shared positions sharing one alias; and the aliases, in
    ``_distinct`` order."""
    alias = {}
    for t in _distinct(tree):
        a = t.detach()
        if a.is_floating_point():
            a.requires_grad_(True)
        alias[id(t)] = a
    return _map_tensors(lambda t: alias[id(t)], tree), list(alias.values())


def _grads(outputs, grad_outputs, inputs: list) -> list:
    """d(outputs . grad_outputs)/d inputs; positions whose gradient is
    None are skipped, inputs nothing reaches get None."""
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if g is not None]
    if not pairs:
        return [None] * len(inputs)
    wanted = [i for i, t in enumerate(inputs) if t.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], [inputs[i]
                              for i in wanted], [g for _, g in pairs],
                              allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(wanted, got):
        out[i] = g
    return out


def _input_grads(tree, aliases: list, grads: list):
    """The gradient tree of an activation input: each distinct tensor's
    gradient at its first position, None at its repeats (fed back as an
    output gradient, a repeat must not count twice)."""
    by_id = {id(a): g for a, g in zip(aliases, grads)}
    seen = set()

    def pick(t):
        if id(t) in seen:
            return None
        seen.add(id(t))
        g = by_id[id(t)]
        return torch.zeros_like(t) if g is None else g
    return _map_tensors(pick, tree)


def _accumulate(acc: dict, aliases: list, grads: list):
    """acc[id(alias)] += grad, in the parameter's dtype (JAX adds each
    microbatch's gradient to a carry of the parameters' dtype)."""
    for a, g in zip(aliases, grads):
        if g is None:
            continue
        if id(a) in acc:
            acc[id(a)].add_(g)
        else:
            acc[id(a)] = g


def _param_grads(tree, aliases: list, acc: dict):
    """The gradient tree of a parameter tree: every position of a tensor
    holds its total gradient (zeros where nothing reached it)."""
    grads = {id(a): acc[id(a)] if id(a) in acc else torch.zeros_like(a)
             for a in aliases}
    return _map_tensors(lambda t: grads[id(t)], tree)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, *,
                   mesh: Mesh, axis: str = "pp"):
    """Run the GPipe schedule. ``stage_fn(stage_params, x) -> x`` is
    applied by every stage; ``stage_params``: a tree of [n_stages, L/ns,
    ...] tensors; ``x_micro``: [M, mb, ...] microbatched activations.
    Returns the [M, mb, ...] outputs of the last stage. Differentiable."""
    n_stages = mesh.shape[axis]
    m = x_micro.shape[0]
    if m < n_stages:
        raise ValueError(
            f"need at least {n_stages} microbatches to fill the pipeline, "
            f"got {m}")
    stages = [_map_tensors(lambda a, s=s: a[s], stage_params)
              for s in range(n_stages)]
    buf = [None] * n_stages
    outs = [None] * m
    for t in range(m + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            f = t - s      # stage s runs microbatch t - s
            if not 0 <= f < m:
                continue
            y = stage_fn(stages[s], x_micro[f] if s == 0 else buf[s])
            if s == n_stages - 1:
                outs[f] = y.to(x_micro.dtype)
            else:
                nxt[s + 1] = y
        buf = nxt
    return torch.stack(outs)


def _read_slot(b: int, window: int) -> int:
    """The stash slot a backward slot reads microbatch ``b``'s input from
    (the slot its forward slot wrote)."""
    return b % window


def pipeline_value_and_grad(stage_fn, head_fn, stage_params, io_params,
                            x_micro, tgt_micro, msk_micro, *, mesh: Mesh,
                            axis: str = "pp", embed_fn=None):
    """1F1B pipelined loss and backprop.

    ``stage_fn(stage_params, x) -> y``; ``head_fn(io_params, y, tgt, msk)
    -> (loss_sum, weight_sum)`` float32 scalars; ``stage_params``: a tree
    of [n_stages, ...] tensors (``split_stages``), or a list of one tree
    per stage; ``io_params``: a tree of the head's weights, and the
    embedding's when ``embed_fn(io_params, tokens) -> x`` is given (run in
    stage 0's forward slot, its vjp in stage 0's backward slot);
    ``x_micro`` [M, mb, ...] activations, or [M, mb, s] tokens with
    ``embed_fn``; ``tgt_micro``, ``msk_micro`` [M, mb, s].

    Returns ``(loss_sum, weight_sum), (d_stage_params, d_io_params,
    d_x_micro)``, the gradients of ``loss_sum`` (scale by
    ``1/weight_sum`` outside for the mean-loss gradients: the weight does
    not depend on the parameters). ``d_stage_params`` has
    ``stage_params``' form; ``d_x_micro`` is None with ``embed_fn``
    (tokens have no gradient; the embedding's is folded into
    ``d_io_params``).

    Schedule (S stages, M microbatches, tick t, stage s): forward slot
    f = t - s; loss slot on the last stage on this tick's output;
    backward slot b = t - 2(S-1) + s (on the last stage b = f). T = M +
    2(S-1) ticks. The embedding (stage 0) and the head (the last stage)
    accumulate into one ``d_io_params``: with tied embeddings both
    contributions land in one leaf.
    """
    n_stages = mesh.shape[axis]
    m = x_micro.shape[0]
    window = 2 * n_stages
    ticks = m + 2 * (n_stages - 1)
    stacked = not isinstance(stage_params, list)
    per_stage = ([_map_tensors(lambda a, s=s: a[s], stage_params)
                  for s in range(n_stages)] if stacked else stage_params)
    if len(per_stage) != n_stages:
        raise ValueError(f"{len(per_stage)} stage trees for {n_stages} "
                         "stages")
    stages, stage_leaves = zip(*(_aliases(sp) for sp in per_stage))
    io, io_leaves = _aliases(io_params)
    d_stage = [{} for _ in range(n_stages)]
    # JAX keeps d_io per stage and sums the stages at the end: the head's
    # gradients on the last stage, the embedding's on stage 0
    d_io_head, d_io_embed = {}, {}
    loss = weight = None
    fbuf = [None] * n_stages
    bbuf = [None] * n_stages
    stash = [[None] * window for _ in range(n_stages)]
    d_x = [None] * m
    for t in range(ticks):
        nf, nb = [None] * n_stages, [None] * n_stages
        for s in range(n_stages):
            last = s == n_stages - 1
            dy = None
            # --- forward slot: microbatch f flows down the stages ---
            f = t - s
            if 0 <= f < m:
                with torch.no_grad():
                    if s > 0:
                        inp = fbuf[s]
                    elif embed_fn is None:
                        inp = x_micro[f]
                    else:
                        inp = embed_fn(io, x_micro[f])
                    stash[s][f % window] = inp
                    y = stage_fn(stages[s], inp)
                if last:
                    # --- loss slot: the last stage turns y into a gradient
                    y_in, y_leaves = _aliases(y)
                    with torch.enable_grad():
                        l_mb, w_mb = head_fn(io, y_in, tgt_micro[f],
                                             msk_micro[f])
                    grads = _grads([l_mb], [torch.ones_like(l_mb)],
                                   io_leaves + y_leaves)
                    _accumulate(d_io_head, io_leaves,
                                grads[:len(io_leaves)])
                    dy = _input_grads(y_in, y_leaves,
                                      grads[len(io_leaves):])
                    # a slot's gradients go now, not when the next slot's
                    # have been made beside them
                    del grads
                    loss = l_mb.detach() if loss is None else \
                        loss + l_mb.detach().to(loss.device)
                    w_mb = w_mb.detach()
                    weight = w_mb if weight is None else \
                        weight + w_mb.to(weight.device)
                else:
                    nf[s + 1] = y
            # --- backward slot: microbatch b flows back up the stages ---
            b = t - 2 * (n_stages - 1) + s
            if 0 <= b < m:
                g_in = dy if last else bbuf[s]
                x_in, x_leaves = _aliases(stash[s][_read_slot(b, window)])
                with torch.enable_grad():
                    out = stage_fn(stages[s], x_in)
                grads = _grads(_positions(out), _positions(g_in),
                               x_leaves + list(stage_leaves[s]))
                _accumulate(d_stage[s], stage_leaves[s],
                            grads[len(x_leaves):])
                dx = _input_grads(x_in, x_leaves, grads[:len(x_leaves)])
                del grads, out
                if s > 0:
                    nb[s - 1] = dx
                elif embed_fn is None:
                    d_x[b] = dx
                else:
                    # stage 0 turns its input gradient into the
                    # embedding's
                    with torch.enable_grad():
                        e = embed_fn(io, x_micro[b])
                    _accumulate(d_io_embed, io_leaves,
                                _grads(_positions(e), _positions(dx),
                                       io_leaves))
        fbuf, bbuf = nf, nb
    d_sp = [_param_grads(sp, leaves, acc) for sp, leaves, acc in
            zip(stages, stage_leaves, d_stage)]
    if stacked:
        d_sp = _stack_trees(d_sp)
    for k, g in d_io_head.items():
        if k in d_io_embed:
            d_io_embed[k] = d_io_embed[k] + g
        else:
            d_io_embed[k] = g
    d_io = _param_grads(io, io_leaves, d_io_embed)
    d_x = torch.stack(d_x) if embed_fn is None else None
    return (loss, weight), (d_sp, d_io, d_x)


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Llama integration
# ---------------------------------------------------------------------------


def make_llama_stage_fn(cfg, sin, cos, attn_impl: str = "auto"):
    """(stage_blocks [L/ns, ...], x [mb, s, d]) -> x: one pipeline stage,
    its contiguous layer group in order, honouring cfg.remat."""
    from ray_tpu_torch.models.llama import _block, remat_block, unstack_layers

    def stage_fn(stage_blocks, xm):
        body = remat_block(cfg, partial(_block, cfg, sin=sin, cos=cos,
                                        segment_ids=None,
                                        attn_impl=attn_impl))
        for p in unstack_layers(stage_blocks):
            xm = body(xm, p)
        return xm

    return stage_fn


def make_llama_head_fn(cfg):
    """(head_params, y [mb, s, d], tgt [mb, s], msk [mb, s]) ->
    (loss_sum, weight_sum): final norm, LM head and masked cross-entropy
    sums, for the 1F1B loss slot. head_params = {"final_norm",
    "embedding"|"lm_head"}."""
    from ray_tpu_torch.ops.matmul import matmul_f32
    from ray_tpu_torch.ops.norms import rms_norm

    def head_fn(hp, y, tgt, msk):
        h = rms_norm(y, hp["final_norm"], eps=cfg.rms_eps)
        head = hp["embedding"].T if cfg.tie_embeddings else hp["lm_head"]
        logits = matmul_f32(h, head)
        lse = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(-1, tgt.clamp(min=0).long()[..., None])[..., 0]
        mk = msk.float()
        return ((lse - tl) * mk).sum(), mk.sum()

    return head_fn


def llama_forward_pipelined(cfg, params: dict, tokens, *, mesh: Mesh,
                            axis: str = "pp",
                            n_microbatches: int | None = None,
                            attn_impl: str = "auto"):
    """Llama forward with the layer stack pipelined over ``axis`` (GPipe).

    The embedding and the LM head run outside the pipelined region (their
    cost is O(vocab) once, not per layer). Default positions only (no
    packing or segment ids)."""
    from ray_tpu_torch.models.llama import lm_head_weights
    from ray_tpu_torch.ops.matmul import matmul_f32
    from ray_tpu_torch.ops.norms import rms_norm
    from ray_tpu_torch.ops.rope import rope_sin_cos

    n_stages = mesh.shape[axis]
    m = n_microbatches or n_stages
    b, s = tokens.shape
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    x = params["embedding"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :]
    sin, cos = rope_sin_cos(positions, cfg.head_dim, theta=cfg.rope_theta)
    stage_fn = make_llama_stage_fn(cfg, sin, cos, attn_impl)
    stage_params = split_stages(params["blocks"], n_stages)
    out = pipeline_apply(stage_fn, stage_params,
                         x.reshape(m, b // m, s, x.shape[-1]), mesh=mesh,
                         axis=axis)
    x = rms_norm(out.reshape(b, s, x.shape[-1]), params["final_norm"],
                 eps=cfg.rms_eps)
    return matmul_f32(x, lm_head_weights(cfg, params))
