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

Across processes. Where the ``pp`` axis spans processes
(``parallel.mesh``), each process holds its ``k`` consecutive stages (one
where pp spans the processes one stage each, more where the process
boundary cuts it) and runs only their slots of the same schedule: the
forward slot f = t - s, the backward slot b = t - 2(S-1) + s, T = M +
2(S-1) ticks, a stash of 2·S stage inputs a stage. At the end of each
tick the activations move on to stage s+1 and the gradients back to
stage s-1 (JAX's ``perm_f`` and ``perm_b``): between this process's own
stages as they are, to another process's stage by one
``ProcessGroup.exchange`` a direction (a ``batch_isend_irecv``: no pair
deadlocks on the order of its sends). Every process derives the tick's
sends from the same (t, s) formulas for every stage, and posts its own
and the receives addressed to it, so that a send is always its peer's
receive of the same tick and an idle slot posts nothing. The head and
its vjp run only on the last stage, the embedding and its vjp only on
stage 0 (JAX runs both masked on every stage: the sums below make the
results the same). The io parameters' gradients, ``loss_sum`` and
``weight_sum`` are then summed over the stages' processes, as JAX sums
them over ``pp``, so that the replicas of the io parameters stay equal
in every process.

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


def forward_peer(s: int, n: int) -> int:
    """The stage that takes stage ``s``'s activations (JAX's ``perm_f``;
    a module attribute, so a fault check can replace it)."""
    return (s + 1) % n


def backward_peer(s: int, n: int) -> int:
    """The stage that takes stage ``s``'s input gradient (``perm_b``)."""
    return (s - 1) % n


def reduce_io_grads(grads: list, group) -> None:
    """The io parameters' gradients summed over the stages' processes, in
    place (JAX's sum over ``pp``; a module attribute, so a fault check
    can replace it)."""
    group.pg.all_reduce_grads(grads, group=group)


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


def _loss_slot(head_fn, io, io_leaves: list, y, tgt, msk, d_io: dict):
    """The last stage's loss slot on its output ``y``: the head's loss and
    weight sums, their gradient in the io parameters added to ``d_io``.
    Returns (the gradient of ``y``, loss sum, weight sum); the slot's
    other gradients go when it returns, before the next slot's are
    made."""
    y_in, y_leaves = _aliases(y)
    with torch.enable_grad():
        l_mb, w_mb = head_fn(io, y_in, tgt, msk)
    grads = _grads([l_mb], [torch.ones_like(l_mb)], io_leaves + y_leaves)
    _accumulate(d_io, io_leaves, grads[:len(io_leaves)])
    return (_input_grads(y_in, y_leaves, grads[len(io_leaves):]),
            l_mb.detach(), w_mb.detach())


def _backward_slot(stage_fn, stage, leaves: list, x, g_in, d_stage: dict):
    """A backward slot: the stage re-run from its stashed input ``x``
    (rematerialization) and differentiated against ``g_in``, its
    parameters' gradients added to ``d_stage``. Returns the gradient of
    ``x``."""
    x_in, x_leaves = _aliases(x)
    with torch.enable_grad():
        out = stage_fn(stage, x_in)
    grads = _grads(_positions(out), _positions(g_in),
                   x_leaves + list(leaves))
    _accumulate(d_stage, leaves, grads[len(x_leaves):])
    return _input_grads(x_in, x_leaves, grads[:len(x_leaves)])


def _embed_backward(embed_fn, io, io_leaves: list, tokens, dx,
                    d_io: dict) -> None:
    """Stage 0 turns its input gradient ``dx`` into the embedding's, added
    to ``d_io``."""
    with torch.enable_grad():
        e = embed_fn(io, tokens)
    _accumulate(d_io, io_leaves,
                _grads(_positions(e), _positions(dx), io_leaves))


def pipeline_value_and_grad(stage_fn, head_fn, stage_params, io_params,
                            x_micro, tgt_micro, msk_micro, *, mesh: Mesh,
                            axis: str = "pp", embed_fn=None, like=None):
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

    Where ``axis`` spans processes (module docstring), ``stage_params``
    is this process's stages (a list of one tree each, or [k, ...]
    tensors) and so is ``d_stage_params``; ``like``, a tree of tensors
    with the
    activations' structure, shapes, dtypes and devices (default:
    ``x_micro[0]``), gives the shapes of what a stage receives; the
    losses and ``d_io_params`` (``d_x_micro`` too) are the sums over the
    stages.
    """
    if mesh.spans(axis):
        return _stage_value_and_grad(
            stage_fn, head_fn, stage_params, io_params, x_micro, tgt_micro,
            msk_micro, group=mesh.group(axis), k=mesh.local_shape[axis],
            embed_fn=embed_fn, like=x_micro[0] if like is None else like)
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
                    dy, l_mb, w_mb = _loss_slot(head_fn, io, io_leaves, y,
                                                tgt_micro[f], msk_micro[f],
                                                d_io_head)
                    loss = l_mb if loss is None else \
                        loss + l_mb.to(loss.device)
                    weight = w_mb if weight is None else \
                        weight + w_mb.to(weight.device)
                else:
                    nf[s + 1] = y
            # --- backward slot: microbatch b flows back up the stages ---
            b = t - 2 * (n_stages - 1) + s
            if 0 <= b < m:
                dx = _backward_slot(stage_fn, stages[s], stage_leaves[s],
                                    stash[s][_read_slot(b, window)],
                                    dy if last else bbuf[s], d_stage[s])
                if s > 0:
                    nb[s - 1] = dx
                elif embed_fn is None:
                    d_x[b] = dx
                else:
                    _embed_backward(embed_fn, io, io_leaves, x_micro[b], dx,
                                    d_io_embed)
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


def _wire_positions(like) -> list:
    """The first position of each distinct tensor of ``like``: what goes
    between the stages (the rest repeat one of them)."""
    seen, out = set(), []
    for i, t in enumerate(_positions(like)):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(i)
    return out


def _flat_wire(tree, wire: list) -> torch.Tensor:
    """The tensors of ``tree`` at the ``wire`` positions, flat and joined
    on the first one's device."""
    pos = _positions(tree)
    home = pos[wire[0]].device
    return torch.cat([pos[i].detach().reshape(-1).to(home) for i in wire])


def _unflat_wire(flat, like, wire: list, repeats: bool):
    """``like``'s tree from a received flat tensor (None: zeros, what
    ``lax.ppermute`` gives a stage nobody sends to): each distinct
    tensor of ``like`` its piece, on its device; at its repeats the same
    tensor (``repeats``, activations) or None (a gradient counts once)."""
    pos = _positions(like)
    sizes = [pos[i].numel() for i in wire]
    pieces = flat.split(sizes) if flat is not None else [None] * len(wire)
    got = {}
    for i, piece in zip(wire, pieces):
        t = pos[i]
        got[id(t)] = torch.zeros_like(t) if piece is None else \
            piece.view(t.shape).to(t.device)
    seen = set()

    def pick(t):
        if id(t) in seen and not repeats:
            return None
        seen.add(id(t))
        return got[id(t)]
    return _map_tensors(pick, like)


def _tick_posts(t: int, n: int, m: int) -> tuple:
    """The (sender, receiver) stages of tick ``t``'s activation and
    gradient moves, from the schedule's formulas for every stage: stage
    ``r`` sends its output on when its forward slot t - r ran and it is
    not the last, its input gradient back when its backward slot
    t - 2(n-1) + r ran and it is not the first."""
    fwd = [(r, forward_peer(r, n)) for r in range(n - 1) if 0 <= t - r < m]
    bwd = [(r, backward_peer(r, n)) for r in range(1, n)
           if 0 <= t - 2 * (n - 1) + r < m]
    return fwd, bwd


def _move(group, k: int, posts: list, outs: list, like, wire: list,
          repeats: bool) -> list:
    """The moves of a tick along the stages' ``group`` (``k`` stages a
    process): each post's output of this process's stage ``outs[j]`` to
    its receiver, kept here when that is one of this process's stages,
    else in one exchange with each other process (the posts in order,
    which sender and receiver read alike). Returns what reaches each of
    this process's stages, as ``like``'s tree (None: nothing)."""
    me = group.index
    got = [None] * k
    sends, srcs = {}, {}
    for src, dst in posts:
        (p_src, j_src), (p_dst, j_dst) = divmod(src, k), divmod(dst, k)
        if p_src == me and p_dst == me:
            got[j_dst] = outs[j_src]
        elif p_src == me:
            sends.setdefault(p_dst, []).append(_flat_wire(outs[j_src], wire))
        elif p_dst == me:
            srcs.setdefault(p_src, []).append(j_dst)
    if not sends and not srcs:
        return got
    first = _positions(like)[wire[0]]
    numel = sum(_positions(like)[i].numel() for i in wire)
    recv = group.pg.exchange(
        {q: torch.cat(ts) for q, ts in sends.items()},
        {q: ((len(js) * numel,), first.dtype, first.device)
         for q, js in srcs.items()}, group)
    for q, js in srcs.items():
        for j, flat in zip(js, recv[q].split(numel)):
            got[j] = _unflat_wire(flat, like, wire, repeats)
    return got


def _stage_value_and_grad(stage_fn, head_fn, stage_params, io_params,
                          x_micro, tgt_micro, msk_micro, *, group, k,
                          embed_fn, like):
    """``pipeline_value_and_grad`` where the stages are dealt to the
    processes of ``group``, ``k`` consecutive stages a process: this
    process runs stages ``group.index·k`` to ``group.index·k + k - 1``'s
    slots of the schedule (module docstring)."""
    n = k * group.size
    mine = range(group.index * k, (group.index + 1) * k)
    m = x_micro.shape[0]
    window = 2 * n
    stacked = not isinstance(stage_params, list)
    per_stage = ([_map_tensors(lambda a, j=j: a[j], stage_params)
                  for j in range(k)] if stacked else stage_params)
    if len(per_stage) != k:
        raise ValueError(f"{len(per_stage)} stage trees for this process's "
                         f"{k} stages")
    stages, stage_leaves = zip(*(_aliases(sp) for sp in per_stage))
    io, io_leaves = _aliases(io_params)
    wire = _wire_positions(like)
    d_stage, d_io = [{} for _ in range(k)], {}
    loss = weight = None
    fbuf, bbuf = [None] * k, [None] * k
    stash = [[None] * window for _ in range(k)]
    d_x = [None] * m
    for t in range(m + 2 * (n - 1)):
        ys, dxs = [None] * k, [None] * k
        for j, s in enumerate(mine):
            last, first = s == n - 1, s == 0
            dy = None
            # --- forward slot ---
            f = t - s
            if 0 <= f < m:
                with torch.no_grad():
                    if not first:
                        inp = fbuf[j] if fbuf[j] is not None else \
                            _unflat_wire(None, like, wire, True)
                    elif embed_fn is None:
                        inp = x_micro[f]
                    else:
                        inp = embed_fn(io, x_micro[f])
                    stash[j][f % window] = inp
                    y = stage_fn(stages[j], inp)
                if last:
                    # --- loss slot ---
                    dy, l_mb, w_mb = _loss_slot(head_fn, io, io_leaves, y,
                                                tgt_micro[f], msk_micro[f],
                                                d_io)
                    loss = l_mb if loss is None else loss + l_mb
                    weight = w_mb if weight is None else weight + w_mb
                else:
                    ys[j] = y
            # --- backward slot ---
            b = t - 2 * (n - 1) + s
            if 0 <= b < m:
                g_in = dy if last else (
                    bbuf[j] if bbuf[j] is not None else
                    _unflat_wire(None, like, wire, False))
                dx = _backward_slot(stage_fn, stages[j], stage_leaves[j],
                                    stash[j][_read_slot(b, window)], g_in,
                                    d_stage[j])
                if not first:
                    dxs[j] = dx
                elif embed_fn is None:
                    d_x[b] = dx
                else:
                    _embed_backward(embed_fn, io, io_leaves, x_micro[b], dx,
                                    d_io)
        # --- the tick's moves: activations on, gradients back ---
        fwd, bwd = _tick_posts(t, n, m)
        fbuf = _move(group, k, fwd, ys, like, wire, True)
        bbuf = _move(group, k, bwd, dxs, like, wire, False)
    d_sp = [_param_grads(st, leaves, acc) for st, leaves, acc in
            zip(stages, stage_leaves, d_stage)]
    if stacked:
        d_sp = _stack_trees(d_sp)
    io_grads = [d_io[id(a)] if id(a) in d_io else torch.zeros_like(a)
                for a in io_leaves]
    reduce_io_grads(io_grads, group)
    by_id = dict(zip(map(id, io_leaves), io_grads))
    d_io_tree = _map_tensors(lambda a: by_id[id(a)], io)
    home = _positions(like)[wire[0]].device
    zero = torch.zeros((), dtype=torch.float32, device=home)
    sums = torch.stack([(zero if v is None else v.float().to(home))
                        for v in (loss, weight)])
    group.pg.all_reduce(sums, group=group)
    if embed_fn is None:
        d_x = torch.stack([g if g is not None else torch.zeros_like(like)
                           for g in d_x]) if group.index == 0 else \
            torch.zeros_like(x_micro)
        group.pg.all_reduce(d_x, group=group)
    else:
        d_x = None
    return (sums[0], sums[1]), (d_sp, d_io_tree, d_x)


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
