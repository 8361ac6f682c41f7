"""The per-rank training step on a placed state: by hand, what GSPMD does
in ``JaxTrainer._step`` (``ray_tpu/train/trainer.py:308``), and the
forward over a placed tree (``placed_forward``: what
``jax.jit(family.forward)`` runs on a tree placed by ``shard_tree``).

In JAX the state lives placed on the mesh and ``jit`` with GSPMD inserts
the collectives. The port is single-controller (``parallel.mesh``): this
module runs the step one rank at a time and moves data between ranks with
the rank-list collectives of ``parallel.collectives``. The gradient is
autograd's through those collectives: the backward of ``all_gather`` is a
reduce-scatter, of ``psum`` a ``psum``, of a move between devices the
move back.

- **dp and fsdp.** The batch is cut over ``("dp", "fsdp")`` as
  ``batch_sharding(..., shard_seq=False)`` cuts it: one chunk per data
  rank, and each data rank runs its chunk. A parameter cut over an axis
  is all-gathered before use (``_Gathers``), and its gradient comes back
  cut. Ranks of one gather group share its result (one tensor on one
  card).
- **The per-layer gathers run inside the remat'd block**
  (``llama.remat_block``), so the backward gathers again, as FSDP does:
  under ``full`` remat no gathered layer outlives its layer (at
  Llama-3-8B, keeping the gathered weights of all 32 layers until the
  backward would not fit beside the 64 GB state).
- **tp, Llama and Mixtral.** Megatron, as ``TP_RULES`` place the
  weights: ``wq``, ``wk`` and ``wv`` are cut by q heads and kv heads,
  ``w_gate`` and ``w_up`` by ``mlp``, so each tp rank runs attention on
  its own ``n_heads/tp`` q heads and ``n_kv_heads/tp`` kv heads (the
  flash kernels at those head counts; the heads must divide over tp);
  ``wo`` and ``w_down`` are cut on their input dimension and their
  outputs are ``psum``med over tp.
- **tp, GPT and BERT.** The fused ``wqkv`` [d, 3d] is cut into
  contiguous column chunks of ``[q | k | v]``, which need not hold whole
  heads (at ``gpt_tiny`` on tp 2, chunk 0 is all of q and half of k), and
  ``wo``'s rows into chunks that may split a head. So each rank runs the
  column-parallel qkv product on its chunk, the columns move to whole
  heads per rank (``collectives.regroup``; the first ``n_heads % tp``
  ranks take one head more: GPT-2 XL's 25 run as 13 and 12 on tp 2),
  attention runs on those heads, the output moves to the column range of
  the rank's rows of ``wo``, and the row-parallel product is ``psum``med
  with ``bo`` added after the sum. The MLP is column-parallel ``w_up``
  and ``b_up``, GELU, row-parallel ``w_down``, the ``psum``, ``b_down``.
  One helper serves GPT's pre-LN and BERT's post-LN order.
- **The vocabulary stays cut over tp** where the rules cut it there: the
  embedding lookup runs on each tp rank's vocab range (zero outside it)
  and the rows are ``psum``med (``reduce_embed``); the loss computes
  each rank's float32 logits against its piece of the head (or of the
  tied embedding) and combines them in the log-sum-exp
  (``collectives.logsumexp``, its exp-sums ``reduce_vocab``), the
  target's logit from its owner rank, in the dense loss, the chunked one
  (``llama.vocab_parallel_cross_entropy``) and the 1F1B ``head_fn``. The
  head and the embedding are gathered over fsdp, never over tp.
- **Mixtral's experts over ep** (``MOE_RULES``). The router's float32
  logits of every data rank are gathered and routed once, so capacity
  (``capacity_factor·T·k/E``), queue positions and the aux loss are over
  the global tokens, as ``moe_ffn`` on ``h.reshape(b*s, d)`` is under
  GSPMD. Each data rank sums its tokens into every expert's capacity
  slots in float32; each ep place adds those partials for its own
  ``E/ep`` experts, rounds them once to the model's dtype and runs only
  its experts' products, their ``mlp`` cut over tp and ``psum``med in
  float32 (``_expert_ffn``, ``reduce_mlp``); the experts' outputs come
  back to the data ranks (``gather_experts``) for the combine.
- **Replicated work is done once a process.** What every rank of an
  axis computes alike in JAX (the embedding's positions, the loss's final
  norm, all work over an axis that cuts neither the batch nor a weight)
  runs once in a process, at the axis' first local rank. Under ring
  attention the ranks of the sequence axis run the attention
  (``parallel.ring_attention`` on the mesh's sp ranks at that place); the
  rest of the layer runs once over the whole sequence, as on the port's
  ring path of slice 6.
- **Across processes** (a mesh with a ``ProcessLayout``,
  ``parallel.mesh``): the step runs this process's places only, and an
  axis whose places lie in other processes moves its data by the
  subgroup collectives of ``parallel.collectives``, which take this
  process's run of places along it (one, or ``k`` where the process
  boundary cuts the axis) and combine them with the other processes'.
  Each process does its own copy of replicated work, as every device
  does under GSPMD. The
  processes along a spanned axis either compute different parts of the
  loss (``split_axes``: dp and fsdp, each its rows, and sp, each its
  chunk of the sequence, on the ring between processes with the rope
  positions offset by the chunk's start) or compute it alike (tp, whose
  processes all hold the data rank's residual stream; under the
  ``loss_fn`` hook every axis but dp). The fsdp gathers over a split
  axis reduce-scatter their gradient back; over an alike axis they keep
  their piece of it (``gather_from_group``). A tp block across processes
  is Megatron's (over a cut tp, the local places' partial sums first):
  ``tp_enter`` (``f``, the identity forward and an
  all-reduce backward) where the normed activation enters the
  column-parallel products and the vocab-parallel head, ``tp_exit``
  (``g``, an all-reduce forward and the identity backward) after ``wo``,
  ``w_down``, the embedding lookup and the loss's exp-sums and target
  logits; a ``psum`` there would count each gradient once per tp
  process. GPT's and BERT's columns move between processes by an
  exchange (``regroup`` with ``group=``). The trainer sums the gradient
  of a leaf over every split axis that does not cut it, and
  ``apply_update``'s clip norm counts each index range once across
  processes. Over a spanned ep each process runs its own experts on the
  tokens of every data process: the router logits are gathered over the
  data processes in the batch's row order and routed alike everywhere
  (``route_logits``), the slot partials summed over them, and every
  expert's output gathered over ep. Over a spanned pp each process holds
  its stages and runs their slots of the 1F1B (``parallel.pipeline``),
  the embedding and head on this process's rows. Where the ring runs
  between processes and a process holds several tp places of a data
  rank, their heads ride one ring (``_ring_across``).
- **The optimizer on chunks** (``apply_update``). AdamW updates each
  distinct chunk in place; the global norm for the clip counts each index
  range once, so replicated chunks are not counted twice, and replicas of
  one range on different devices first ``psum`` their gradients.

A custom ``loss_fn`` sees the whole batch and the gathered parameters
(the mean of a masked loss cannot be rebuilt from per-chunk means); the
default losses combine per-rank sums, as the global mean would.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import bert, gpt, llama, mixtral
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.moe import router_topk
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.rope import rope_sin_cos
from ray_tpu_torch.parallel.collectives import (all_gather, copy_to_group,
                                                gather_from_group, psum,
                                                reduce_from_group, regroup)
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import (ShardedTensor, _axes_of,
                                             batch_sharding, device_put)
from ray_tpu_torch.train.optim import tree_leaves

# the sums and exchanges of the per-rank blocks (module attributes, so a
# fault check can replace one): after wo, after w_down (and the experts'
# down products), the vocab-parallel log-sum-exp's exp-sums, the
# vocab-parallel embedding's rows, and the experts' outputs from the ep
# places back to the data ranks
reduce_attention = psum
reduce_mlp = psum
reduce_vocab = psum
reduce_embed = psum
gather_experts = all_gather
# a tp block across processes: Megatron's g at the exit of a tp region and
# f at its entry (the module docstring)
tp_exit = reduce_from_group
tp_enter = copy_to_group

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo_e")


def _flat(mesh: Mesh, coords: tuple) -> int:
    return int(np.ravel_multi_index(coords, mesh.devices.shape))


def _device(mesh: Mesh, coords: tuple) -> torch.device:
    return mesh.devices[coords]


def wide_axis(mesh: Mesh, entry) -> str | None:
    """The mesh axis a rule entry names when it is on ``mesh`` and wider
    than one (a tuple of axes must name at most one such)."""
    wide = [a for a in _axes_of(entry)
            if a in mesh.axis_names and mesh.shape[a] > 1]
    if len(wide) > 1:
        raise NotImplementedError(f"rule entry {entry!r} cuts over several "
                                  f"wide axes {wide}")
    return wide[0] if wide else None


def tp_axis(mesh: Mesh, rules) -> str | None:
    """The tensor-parallel axis: the wide axis the rules cut heads, kv
    heads and mlp over (all three, or none of them)."""
    axes = {wide_axis(mesh, getattr(rules, k))
            for k in ("heads", "kv_heads", "mlp")}
    if len(axes) > 1:
        raise NotImplementedError(
            f"rules cut heads, kv_heads and mlp over {axes}: a tp block "
            "cuts all three over one axis")
    return axes.pop()


class _Gathers:
    """All-gathers of placed tensors over every axis of their spec but the
    kept ones (``parallel.collectives.all_gather``, one per group of
    ranks). Within one ``_Gathers`` a group gathers once and its ranks
    share the result. Over an axis that spans processes the gather takes
    this process's places along it and runs on its subgroup too: a
    reduce-scatter backward over the ``split`` axes, whose processes
    compute different parts of the loss, and this process's block of the
    gradient over the others (``gather_from_group``)."""

    def __init__(self, split=()):
        self._memo = {}
        self.split = split

    def local(self, st: ShardedTensor, coords: tuple, keep=()):
        """The tensor of the place at ``coords`` with every axis of the
        spec gathered but those in ``keep``."""
        steps = [(d, ax) for d, entry in enumerate(st.spec)
                 for ax in reversed(_axes_of(entry))
                 if ax not in keep and st.mesh.shape[ax] > 1]
        return self._at(st, steps, len(steps), tuple(coords))

    def _at(self, st, steps, level, coords):
        if level == 0:
            return st.chunks[_flat(st.mesh, coords)]
        d, ax = steps[level - 1]
        i = st.mesh.axis_names.index(ax)
        ring = [coords[:i] + (k,) + coords[i + 1:]
                for k in range(st.mesh.local_shape[ax])]
        xs = [self._at(st, steps, level - 1, c) for c in ring]
        key = (tuple(map(id, xs)), d, ax)
        if key not in self._memo:
            kw, gather = {}, all_gather
            if st.mesh.spans(ax):
                kw["group"] = st.mesh.group(ax)
                if ax not in self.split:
                    gather = gather_from_group
            # the inputs stay referenced, so their ids stay theirs
            self._memo[key] = (gather(xs, gather_axis=d, **kw), xs)
        return self._memo[key][0][coords[i]]


def unbind_layers(st: ShardedTensor) -> list:
    """A stacked [L, ...] placed tensor as one placed tensor per layer:
    each distinct chunk unbound once, shared places sharing."""
    if wide_axis(st.mesh, st.spec[0] if st.spec else None):
        raise ValueError(f"the layer dim of {st} is cut; take a stage "
                         "first")
    per = {id(c): torch.unbind(c) for _, c in st.distinct()}
    sharding = type(st.sharding)(st.mesh, type(st.spec)(*st.spec[1:]))
    return [ShardedTensor(st.shape[1:], st.dtype, sharding,
                          [per[id(c)][i] for c in st.chunks])
            for i in range(st.shape[0])]


def head_ranges(n_heads: int, n: int) -> list:
    """The heads of each of ``n`` tp ranks, as (first, stop): whole heads,
    the first ``n_heads % n`` ranks one more (GSPMD cuts the fused qkv's
    columns without regard to heads, so the count need not divide)."""
    sizes = [n_heads // n + (r < n_heads % n) for r in range(n)]
    return [(sum(sizes[:r]), sum(sizes[:r + 1])) for r in range(n)]


def _even(width: int, n: int) -> list:
    return [(r * width // n, (r + 1) * width // n) for r in range(n)]


def qkv_columns(d: int, head_dim: int, heads: list) -> list:
    """Each tp rank's columns of q, k and v in the fused ``[q | k | v]``
    space of ``wqkv`` (GPT's and BERT's layout): its heads' columns in
    each third, as ``regroup`` ranges (a fault check may replace it)."""
    return [[[(off + a * head_dim, off + z * head_dim)] for a, z in heads]
            for off in (0, d, 2 * d)]


def _lookup(pieces: list, tokens, off: int = 0) -> list:
    """Each rank's rows of an embedding cut along the vocab (piece ``i``
    the next rows, the first from row ``off``): the token's row where the
    rank holds it, zero elsewhere."""
    out = []
    for e in pieces:
        local = tokens.to(e.device) - off
        own = (local >= 0) & (local < e.shape[0])
        out.append(torch.where(own[..., None],
                               e[local.clamp(0, e.shape[0] - 1)], 0.0))
        off += e.shape[0]
    return out


def _expert_ffn(x, w_gate, w_up, w_down):
    """One ep place's experts on their capacity slots x [e, C, d], with
    its columns of ``mlp``: SwiGLU rounded to x's dtype, then the float32
    partial of the down product (``moe_ffn``'s arithmetic)."""
    h = (F.silu(matmul_f32(x, w_gate)) * matmul_f32(x, w_up)).to(x.dtype)
    return matmul_f32(h, w_down)


class RankStep:
    """The loss of one step over the ranks of a mesh, from a placed
    parameter tree (``ShardedTensor`` leaves). ``loss(params, batch)``
    is differentiable in every chunk; ``forward`` runs the family's
    forward (``placed_forward``); ``stage_fn``, ``embed_fn`` and
    ``head_fn`` are the 1F1B pipeline's, for Llama."""

    def __init__(self, family, cfg, mesh: Mesh, rules, *, attn_impl="auto",
                 sp_axis="sp", fused_loss=False, loss_chunk=1024,
                 loss_fn=None):
        self.family, self.cfg, self.mesh, self.rules = family, cfg, mesh, \
            rules
        self.attn_impl, self.sp_axis = attn_impl, sp_axis
        self.fused_loss, self.loss_chunk = fused_loss, loss_chunk
        self.loss_fn = loss_fn
        self.tp = tp_axis(mesh, rules)
        # the vocabulary stays cut where the rules cut it over the tp axis
        self.vocab_tp = self.tp is not None and \
            wide_axis(mesh, rules.vocab) == self.tp
        self.ep = wide_axis(mesh, rules.expert) if family is mixtral \
            else None
        self.data_axes = tuple(
            a for a in _axes_of(batch_sharding(mesh, rules, 2,
                                               shard_seq=False).spec[0])
            if mesh.shape[a] > 1)
        # across processes: the axes whose processes compute different
        # parts of the loss, and the tp and sp lines
        split = ("dp",) if loss_fn is not None else \
            self.data_axes + ((sp_axis,) if attn_impl == "ring" else ())
        self.split_axes = tuple(a for a in split if mesh.spans(a))
        self.tp_group = mesh.group(self.tp) if self.tp and \
            mesh.spans(self.tp) else None
        self.sp_group = mesh.group(sp_axis) if attn_impl == "ring" and \
            mesh.spans(sp_axis) else None
        if self.tp is None:
            return
        n = mesh.shape[self.tp]
        if family in (llama, mixtral):
            if cfg.n_heads % n or cfg.n_kv_heads % n:
                raise ValueError(f"{cfg.n_heads} q and {cfg.n_kv_heads} kv "
                                 f"heads do not divide over {self.tp}={n}")
            self.tp_cfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // n,
                n_kv_heads=cfg.n_kv_heads // n)
        else:
            self.heads = head_ranges(cfg.n_heads, n)

    # --- the ranks ---

    def units(self, mesh: Mesh, base: dict | None = None) -> list:
        """The data ranks of ``mesh`` in this process, each as the
        coordinates of its tp ranks here (one place when there is no tp
        axis; this process's run of tp indices where tp spans processes).
        ``base`` fixes other axes (a pipeline stage); the rest sit at
        0."""
        names = mesh.axis_names
        data = [a for a in self.data_axes if a in names]
        sizes = [mesh.local_shape[a] for a in data]
        n_tp = mesh.local_shape[self.tp] if self.tp in names else 1
        out = []
        for k in range(math.prod(sizes)):
            at = dict(base or {})
            at.update(zip(data, map(int, np.unravel_index(k, sizes))))
            places = []
            for t in range(n_tp):
                if self.tp in names:
                    at[self.tp] = t
                places.append(tuple(at.get(a, 0) for a in names))
            out.append(places)
        return out

    def expert_places(self, mesh: Mesh) -> list:
        """Each ep index's tp places, the data axes at 0 (one group of
        every expert when the rules cut no expert over a wide axis)."""
        n_ep = mesh.local_shape[self.ep] if self.ep else 1
        n_tp = mesh.local_shape[self.tp] if self.tp else 1
        return [[tuple({self.ep: i, self.tp: t}.get(a, 0)
                       for a in mesh.axis_names) for t in range(n_tp)]
                for i in range(n_ep)]

    def chunks_of(self, placed: ShardedTensor, units: list) -> list:
        """A batch placed by ``batch_sharding``: the chunk at each data
        rank's first place."""
        return [placed.chunks[_flat(self.mesh, p[0])] for p in units]

    def cut(self, x: torch.Tensor, units: list, local: bool = False) -> list:
        """``x`` (a forward's global tokens, or with ``local`` this
        process's rows, as a pipeline microbatch holds them) cut over the
        data ranks as ``batch_sharding`` cuts a batch."""
        mesh = self.mesh.local() if local else self.mesh
        return self.chunks_of(device_put(x, batch_sharding(
            mesh, self.rules, x.dim(), shard_seq=False)), units)

    def _ring_mesh(self, mesh: Mesh, coords: tuple) -> Mesh | None:
        if self.attn_impl != "ring":
            return None
        return mesh.line(self.sp_axis, dict(zip(mesh.axis_names, coords)))

    def seq_chunk(self, x: torch.Tensor) -> torch.Tensor:
        """This process's chunk of the sequence (dim 1) when the ring's
        axis spans processes; ``x`` itself otherwise."""
        if self.sp_group is None:
            return x
        n, i = self.sp_group.size, self.sp_group.index
        if x.shape[1] % n:
            raise ValueError(f"sequence of {x.shape[1]} tokens does not "
                             f"divide over {n} sp processes")
        return x.chunk(n, dim=1)[i]

    def _sum(self, reduce, parts: list) -> list:
        """The tp ranks' partial sums: ``reduce`` over the local ranks, or
        ``tp_exit`` over the tp processes."""
        if self.tp_group is not None:
            return tp_exit(parts, self.tp_group)
        return reduce(parts)

    def _enter(self, h):
        """A replicated activation entering a tp region across processes
        (``tp_enter``); itself otherwise."""
        return h if self.tp_group is None else tp_enter(h, self.tp_group)

    # --- the layers ---

    def _rope(self, s: int, devices) -> dict:
        # a chunk of the sequence starts at its offset in the whole
        start = 0 if self.sp_group is None else self.sp_group.index * s
        out = {}
        for dev in devices:
            if str(dev) not in out:
                positions = torch.arange(start, start + s, dtype=torch.int32,
                                         device=dev)[None, :]
                out[str(dev)] = rope_sin_cos(positions, self.cfg.head_dim,
                                             theta=self.cfg.rope_theta)
        return out

    def _layer(self, xs_units, layer: dict, *, mesh, units, rope,
               segments):
        """One transformer block on every rank: each rank's weights
        gathered (all but tp) inside the call, the tp ranks' partial sums
        psummed. Returns the ranks' activations and Mixtral's aux loss
        (None for the dense families)."""
        g = _Gathers(self.split_axes)
        keep = (self.tp,) if self.tp else ()
        out = []
        for places, xs, seg in zip(units, xs_units, segments):
            ps = [{n: g.local(st, c, keep) for n, st in layer.items()
                   if n not in _EXPERT_LEAVES} for c in places]
            if self.family in (gpt, bert):
                out.append(self._fused_qkv_block(xs, ps, seg))
            else:
                out.append(self._llama_block(mesh, places, xs, ps, rope))
        if self.family is not mixtral:
            return out, None
        return self._moe(g, layer, mesh, units, out)

    def _llama_block(self, mesh, places, xs, ps, rope):
        """Llama's block, or Mixtral's attention sublayer (its MoE comes
        after, over every data rank), on one data rank's tp places."""
        moe = self.family is mixtral
        ring = [dict(mesh=self._ring_mesh(mesh, c), sp_axis=self.sp_axis)
                for c in places]
        sc = [rope[str(x.device)] for x in xs]
        if self.tp is None:
            block = llama.attention_sublayer if moe else llama._block
            return [block(self.cfg, xs[0], ps[0], *sc[0], None,
                          self.attn_impl, **ring[0])]
        enter = None if self.tp_group is None else self._enter
        if self.sp_group is not None and len(places) > 1:
            parts = self._ring_across(xs, ps, sc, ring[0], enter)
        else:
            parts = [llama.attention_out(self.tp_cfg, x, p, *sin_cos, None,
                                         self.attn_impl, enter=enter, **r)
                     for x, p, sin_cos, r in zip(xs, ps, sc, ring)]
        xs = [x + y for x, y in zip(xs, self._sum(reduce_attention, parts))]
        if moe:
            return xs
        parts = [llama.mlp_out(self.cfg, x, p, enter=enter)
                 for x, p in zip(xs, ps)]
        return [x + y for x, y in zip(xs, self._sum(reduce_mlp, parts))]

    def _ring_across(self, xs, ps, sc, ring, enter):
        """The attention of one data rank's tp places when the ring runs
        between processes: each place's q, k and v, their heads joined
        into one ring (one exchange of K/V a step for all of them, the
        kernels launched on all their heads), the output split back to
        the places' ``wo``."""
        qkv = [llama.attention_qkv(self.tp_cfg, x, p, *sin_cos, enter=enter)
               for x, p, sin_cos in zip(xs, ps, sc)]
        home = xs[0].device
        q, k, v = (torch.cat([t[i].to(home) for t in qkv], dim=2)
                   for i in range(3))
        out = llama.ring_attention(q, k, v, mesh=ring["mesh"],
                                   axis=ring["sp_axis"], causal=True)
        b, s = xs[0].shape[:2]
        return [o.reshape(b, s, -1).to(x.device) @ p["wo"]
                for o, x, p in zip(out.chunk(len(xs), dim=2), xs, ps)]

    def _fused_qkv_block(self, xs, ps, seg):
        """GPT's pre-LN or BERT's post-LN block on one data rank's tp
        places (see the module docstring)."""
        cfg, family = self.cfg, self.family
        if self.tp is None:
            return [family._block(cfg, xs[0], ps[0], seg, self.attn_impl)]
        post = family is bert
        d, hd, n = cfg.d_model, cfg.head_dim, self.mesh.shape[self.tp]
        b, s, _ = xs[0].shape
        move = partial(regroup, group=self.tp_group)

        def norm(x, p, i):
            return layer_norm(x, p[f"ln{i}_w"], p[f"ln{i}_b"],
                              eps=cfg.ln_eps)

        hs = xs if post else [norm(x, p, 1) for x, p in zip(xs, ps)]
        qkv = [self._enter(h) @ p["wqkv"] + p["bqkv"]
               for h, p in zip(hs, ps)]
        q, k, v = (move(qkv, _even(3 * d, n), want)
                   for want in qkv_columns(d, hd, self.heads))
        outs = [attention(*(t.reshape(b, s, -1, hd) for t in qkv_r),
                          causal=not post, segment_ids=seg,
                          impl=self.attn_impl).reshape(b, s, -1)
                for qkv_r in zip(q, k, v)]
        outs = move(outs, [(a * hd, z * hd) for a, z in self.heads],
                    [[r] for r in _even(d, n)])
        parts = self._sum(reduce_attention,
                          [o @ p["wo"] for o, p in zip(outs, ps)])
        xs = [x + y + p["bo"] for x, y, p in zip(xs, parts, ps)]
        if post:
            xs = [norm(x, p, 1) for x, p in zip(xs, ps)]
        hs = xs if post else [norm(x, p, 2) for x, p in zip(xs, ps)]
        ups = [F.gelu(self._enter(h) @ p["w_up"] + p["b_up"],
                      approximate="tanh") for h, p in zip(hs, ps)]
        parts = self._sum(reduce_mlp,
                          [u @ p["w_down"] for u, p in zip(ups, ps)])
        xs = [x + y + p["b_down"] for x, y, p in zip(xs, parts, ps)]
        return [norm(x, p, 2) for x, p in zip(xs, ps)] if post else xs

    def route_logits(self, logits, mesh):
        """The router's float32 logits of every data rank, in the batch's
        row order, from this process's (``logits``, its data ranks'
        rows); and the row of the first of them. Where data axes span
        processes the logits are gathered over them, the minor axis
        first (a few kB a layer: [T, E])."""
        data = [a for a in self.data_axes if mesh.spans(a)]
        block = int(np.ravel_multi_index(
            [mesh.layout.index[a] for a in data],
            [mesh.layout.procs[a] for a in data])) if data else 0
        first = block * logits.shape[0]
        for a in reversed(data):
            logits = all_gather([logits], gather_axis=0,
                                group=mesh.group(a))[0]
        return logits, first

    def _moe(self, g: _Gathers, layer: dict, mesh, units, xs_units):
        """Mixtral's MoE sublayer over every data rank: global routing,
        each ep place its own experts (see the module docstring).
        Returns the ranks' activations and the layer's aux loss."""
        cfg = self.cfg
        keep = (self.tp,) if self.tp else ()
        e, d = cfg.n_experts, cfg.d_model
        hs, logits = [], []
        for places, xs in zip(units, xs_units):
            h = rms_norm(xs[0], g.local(layer["mlp_norm"], places[0], keep),
                         eps=cfg.rms_eps).reshape(-1, d)
            hs.append(h)
            logits.append(h.float() @ g.local(layer["router"], places[0],
                                              keep).float())
        home = hs[0].device
        every, first = self.route_logits(
            torch.cat([x.to(home) for x in logits]), mesh)
        rows = first + np.cumsum([0] + [h.shape[0] for h in hs])
        capacity = max(1, int(cfg.capacity_factor * every.shape[0]
                              * cfg.top_k / e))
        dispatch, combine, aux = router_topk(every, top_k=cfg.top_k,
                                             capacity=capacity)
        dtype = hs[0].dtype
        # each data rank's tokens into every expert's slots, float32
        partials = [matmul_f32(
            dispatch[a:z].to(h.device, dtype).reshape(z - a, -1).T, h)
            for h, a, z in zip(hs, rows[:-1], rows[1:])]
        groups = self.expert_places(mesh)
        # this process's ep indices: all, or its own where ep spans
        n_ep = mesh.shape[self.ep] if self.ep else 1
        ep0 = mesh.offset(self.ep) if self.ep else 0
        slots = e // n_ep * capacity
        keep = tuple(a for a in (self.ep, self.tp) if a)
        spanned_data = [a for a in self.data_axes if mesh.spans(a)]
        outs = []
        for i, group in enumerate(groups, start=ep0):
            dev = mesh.devices[group[0]]
            total = None
            for part in partials:
                piece = part[i * slots:(i + 1) * slots].to(dev)
                total = piece if total is None else total + piece
            # the other data processes' tokens into these experts' slots
            for a in spanned_data:
                total = psum([total], group=mesh.group(a))[0]
            x = self._enter(total.to(dtype).reshape(-1, capacity, d))
            parts = [_expert_ffn(x.to(mesh.devices[c]),
                                 *(g.local(layer[n], c, keep)
                                   for n in _EXPERT_LEAVES))
                     for c in group]
            outs.append(self._sum(reduce_mlp, parts)[0].to(dtype))
        # every expert's outputs, from the ep places (processes) that ran
        # them, at every data rank
        expert_out = gather_experts(
            outs, gather_axis=0, **({"group": mesh.group(self.ep)}
                                    if self.ep and mesh.spans(self.ep)
                                    else {}))[0].reshape(-1, d)
        out = []
        for places, xs, a, z in zip(units, xs_units, rows[:-1], rows[1:]):
            x = xs[0]
            y = matmul_f32(combine[a:z].to(x.device, dtype).reshape(z - a, -1),
                           expert_out.to(x.device)).to(dtype)
            x = x + y.reshape(x.shape)
            out.append([x.to(mesh.devices[c]) for c in places])
        return out, aux

    def run_layers(self, blocks: dict, xs_units: list, units: list,
                   mesh: Mesh, segments=None) -> tuple:
        """Every layer of ``blocks`` (placed stacked tensors, or lists of
        one placed tensor per layer) over the ranks, each through the
        config's remat policy; ``segments`` each data rank's attention
        segment ids (BERT's padding mask). Returns the ranks' activations
        and the layers' aux losses (Mixtral; empty otherwise)."""
        rope = self._rope(xs_units[0][0].shape[1],
                          [x.device for xs in xs_units for x in xs]) \
            if self.family in (llama, mixtral) else None
        per_layer = {n: st if isinstance(st, list) else unbind_layers(st)
                     for n, st in blocks.items()}
        body = llama.remat_block(self.cfg, partial(
            self._layer, mesh=mesh, units=units, rope=rope,
            segments=segments or [None] * len(units)),
            self.family.REMAT_POLICIES)
        n_layers = len(next(iter(per_layer.values())))
        aux = []
        for i in range(n_layers):
            xs_units, a = body(xs_units, {n: ls[i] for n, ls in
                                          per_layer.items()})
            if a is not None:
                aux.append(a)
        return xs_units, aux

    # --- the embedding and the head ---

    def _embed(self, g: _Gathers, params: dict, tokens: list, units: list,
               mesh: Mesh, types=None) -> list:
        """Each data rank's embedded tokens, on each of its tp ranks: the
        lookup cut over the vocab where the rules cut it there, then (gpt,
        bert) the positions, bert's token types and LayerNorm, once at
        the data rank's first place."""
        cfg, emb = self.cfg, params["embedding"]
        out = []
        for k, (places, tok) in enumerate(zip(units, tokens)):
            if self.vocab_tp:
                pieces = [g.local(emb, c, (self.tp,)) for c in places]
                first = mesh.offset(self.tp) * pieces[0].shape[0]
                x = self._sum(reduce_embed, _lookup(pieces, tok, first))[0]
            else:
                table = g.local(emb, places[0])
                x = table[tok.to(table.device)]
            if self.family in (gpt, bert):
                s = tok.shape[1]
                if s > cfg.max_seq_len:
                    raise ValueError(f"sequence length {s} exceeds "
                                     f"max_seq_len={cfg.max_seq_len}")
                x = x + g.local(params["pos_embedding"], places[0])[:s][None]
            if self.family is bert:
                if types is not None:
                    x = x + g.local(params["type_embedding"], places[0])[
                        types[k].to(x.device)]
                x = layer_norm(x, g.local(params["emb_ln_w"], places[0]),
                               g.local(params["emb_ln_b"], places[0]),
                               eps=cfg.ln_eps)
            out.append([x.to(_device(mesh, c)) for c in places])
        return out

    def _final_norm(self, g: _Gathers, params: dict, x, place):
        if self.family is gpt:
            return layer_norm(x, g.local(params["final_ln_w"], place),
                              g.local(params["final_ln_b"], place),
                              eps=self.cfg.ln_eps)
        return rms_norm(x, g.local(params["final_norm"], place),
                        eps=self.cfg.rms_eps)

    def _head(self, g: _Gathers, params: dict, place, keep=()):
        """The LM head [d, vocab] at ``place``: ``lm_head``, or the tied
        embedding transposed; with ``keep=(tp,)`` that place's vocab
        piece."""
        if "lm_head" in params:
            return g.local(params["lm_head"], place, keep)
        return g.local(params["embedding"], place, keep).T

    def _vocab_places(self, places: list) -> tuple:
        """The places that hold the head's vocab pieces, and the axes their
        pieces keep: every tp place where the rules cut the vocab over tp,
        else the data rank's first place with the head whole."""
        if self.vocab_tp:
            return places, (self.tp,)
        return places[:1], ()

    def _logits(self, g: _Gathers, params: dict, places: list, h):
        """One data rank's float32 logits [b, s, vocab], each vocab piece
        computed at its place, joined on the first."""
        places, keep = self._vocab_places(places)
        return torch.cat([matmul_f32(h.to(_device(self.mesh, c)),
                                     self._head(g, params, c, keep))
                          .to(h.device) for c in places], dim=-1)

    def _loss(self, g: _Gathers, params: dict, places: list, h, targets,
              mask, fused: bool):
        """The mean masked cross-entropy of one data rank, chunked when
        ``fused``: vocab-parallel over its tp places where the rules cut
        the vocab there (the head never gathered over tp)."""
        places, keep = self._vocab_places(places)
        group = self.tp_group if self.vocab_tp else None
        reduce = reduce_vocab if group is None else \
            partial(tp_exit, group=group)
        return llama.vocab_parallel_cross_entropy(
            [h.to(_device(self.mesh, c)) if group is None else
             self._enter(h) for c in places],
            [self._head(g, params, c, keep) for c in places], targets,
            mask=mask, chunk=self.loss_chunk if fused else None,
            reduce=reduce, group=group)

    # --- the losses ---

    def lm_loss(self, params: dict, batch: ShardedTensor):
        """The next-token loss of Llama or GPT: each data rank runs its
        chunk of the batch through the embedding, the layers and the
        head; the ranks' masked sums combine as the global mean."""
        mesh = self.mesh
        units = self.units(mesh)
        chunks = self.chunks_of(batch, units)
        g = _Gathers(self.split_axes)
        # the shift first, then this process's chunk of the sequence
        xs = self._embed(g, params, [self.seq_chunk(c[:, :-1])
                                     for c in chunks], units, mesh)
        xs, _ = self.run_layers(params["blocks"], xs, units, mesh)
        parts = []
        for places, x, c in zip(units, xs, chunks):
            targets = self.seq_chunk(c[:, 1:]).to(x[0].device)
            mask = (targets != -1).float()
            h = self._final_norm(g, params, x[0], places[0])
            parts.append((self._loss(g, params, places, h, targets, mask,
                                     self.fused_loss), mask.sum()))
        return _combine(parts)

    def hook_loss(self, params: dict, batch):
        """The ``loss_fn`` hook on the whole batch, the parameters
        gathered at the first place."""
        home = tuple(0 for _ in self.mesh.axis_names)
        batch = {k: v.unshard() for k, v in batch.items()} \
            if isinstance(batch, dict) else batch.unshard()
        return self.loss_fn(self.cfg, _gathered(_Gathers(self.split_axes),
                                                params, home), batch)

    def loss(self, params: dict, batch):
        """The loss of placed ``params`` on a batch placed by
        ``batch_sharding`` (a dictionary of them for the hook)."""
        if self.loss_fn is not None:
            return self.hook_loss(params, batch)
        return self.lm_loss(params, batch)

    def forward(self, params: dict, tokens: torch.Tensor, *,
                attention_mask=None, token_type_ids=None,
                return_aux_loss: bool = False):
        """``family.forward`` (bert: ``encode``) of placed ``params`` on
        ``tokens`` [B, S], cut over the data ranks: the global float32
        logits [B, S, vocab] (bert: the hidden states [B, S, d]) on the
        mesh's first device; Mixtral with ``return_aux_loss`` also its
        weighted aux loss. On a mesh across processes ``tokens`` is the
        global batch and the result this process's rows of the global
        logits, its block of the batch as the data axes cut it (the whole
        batch where no data axis spans processes); Mixtral's aux loss is
        the global one."""
        mesh = self.mesh
        units = self.units(mesh)
        g = _Gathers()
        cut = partial(self.cut, units=units)
        types = None if token_type_ids is None else cut(token_type_ids)
        segments = None if attention_mask is None else [
            m.int() for m in cut(attention_mask)]
        xs = self._embed(g, params, cut(tokens), units, mesh, types)
        xs, aux = self.run_layers(params["blocks"], xs, units, mesh,
                                  segments)
        home = mesh.devices.ravel()[0]
        if self.family is bert:
            return torch.cat([x[0].to(home) for x in xs])
        out = torch.cat([self._logits(
            g, params, places, self._final_norm(g, params, x[0], places[0]))
            .to(home) for places, x in zip(units, xs)])
        if return_aux_loss:
            return out, torch.stack(aux).sum() * self.cfg.aux_loss_weight
        return out

    # --- the 1F1B pipeline's functions (Llama) ---

    def stage_fn(self, blocks: dict, xs_units: list) -> list:
        """One pipeline stage: its layers (``blocks``: one placed tensor
        per layer and leaf, on the stage's mesh) over the stage's ranks,
        the inputs moved there."""
        mesh = next(iter(blocks.values()))[0].mesh
        units = self.units(mesh)
        xs_units = [[x.to(_device(mesh, c)) for x, c in zip(xs, places)]
                    for xs, places in zip(xs_units, units)]
        return self.run_layers(blocks, xs_units, units, mesh)[0]

    def embed_fn(self, pp_axis: str):
        """(io params, tokens [mb, s]) -> each data rank's embedded
        microbatch chunk, at the first stage (this process's, where
        ``pp_axis`` spans processes)."""
        def embed(io, tokens):
            units = self.units(self.mesh, {pp_axis: 0})
            return self._embed(_Gathers(self.split_axes), io,
                               self.cut(tokens, units, local=True), units,
                               self.mesh)
        return embed

    def stage_like(self, pp_axis: str, tokens, dtype) -> list:
        """Empty activations of the microbatch ``tokens`` [mb, s] in the
        stage functions' form (each data rank's rows at each of its
        places, one tensor a data rank): the shapes of what a stage
        receives from another stage's process."""
        units = self.units(self.mesh, {pp_axis: 0})
        return [[torch.empty(*tok.shape, self.cfg.d_model, dtype=dtype,
                             device=_device(self.mesh, places[0]))]
                * len(places) for places, tok in
                zip(units, self.cut(tokens, units, local=True))]

    def head_fn(self, pp_axis: str):
        """(io params, the last stage's activations, targets, mask) ->
        (loss sum, weight sum) over the data ranks: final norm, LM head
        and masked cross-entropy sums (JAX's ``make_llama_head_fn``),
        through the chunked loss (chunks of ``loss_chunk`` rows,
        vocab-parallel where the rules cut the vocab over tp) so that no
        microbatch's [mb, s, vocab] float32 logits exist at once (2 GB
        for 2 x 2048 tokens at Llama-3's vocab, beside a 64 GB state)."""
        def head_fn(io, ys, tgt, msk):
            units = self.units(self.mesh,
                               {pp_axis: self.mesh.local_shape[pp_axis] - 1})
            g = _Gathers(self.split_axes)
            loss = weight = None
            for places, y, t, mk in zip(units, ys,
                                        self.cut(tgt, units, local=True),
                                        self.cut(msk, units, local=True)):
                dev = _device(self.mesh, places[0])
                h = self._final_norm(g, io, y[0].to(dev), places[0])
                mk = mk.to(dev).float()
                ws = mk.sum()
                mean = self._loss(g, io, places, h, t.to(dev), mk, True)
                ls = mean * ws.clamp(min=1.0)
                loss = ls if loss is None else loss + ls.to(loss.device)
                weight = ws if weight is None else \
                    weight + ws.to(weight.device)
            return loss, weight
        return head_fn


def _gathered(g: _Gathers, params, coords: tuple):
    if isinstance(params, dict):
        return {k: _gathered(g, v, coords) for k, v in params.items()}
    return g.local(params, coords)


def placed_forward(family, cfg, params: dict, tokens, *, mesh: Mesh, rules,
                   attn_impl: str = "auto", **kwargs):
    """The forward of ``family`` (llama, gpt, mixtral; bert's ``encode``)
    over a tree placed by ``shard_tree(params, axes, mesh, rules)``: the
    counterpart of ``jax.jit(family.forward)(placed, tokens)``. Each data
    rank runs its rows of ``tokens`` [B, S] with the per-rank blocks
    (tensor-parallel where the rules cut heads, Mixtral's experts over
    ``ep`` with global routing) and the global output comes back on the
    mesh's first device. On a mesh across processes (``parallel.mesh``)
    each process runs its places, ``tokens`` is the global batch, and the
    result is this process's rows of the global output, its block of the
    batch as ``batch_sharding`` cuts it over the data axes that span
    processes (all rows where none does). ``kwargs``:
    ``return_aux_loss`` (mixtral), ``attention_mask`` and
    ``token_type_ids`` (bert)."""
    step = RankStep(family, cfg, mesh, rules, attn_impl=attn_impl)
    return step.forward(params, torch.as_tensor(tokens), **kwargs)

def _combine(parts: list):
    """The mean loss over every data rank's tokens from each rank's mean
    and token count (one rank: its loss as it is)."""
    if len(parts) == 1:
        return parts[0][0]
    home = parts[0][0].device
    total = sum(loss.to(home) * n.to(home) for loss, n in parts)
    count = sum(n.to(home) for _, n in parts)
    return total / count.clamp(min=1.0)


def distinct_chunks(tree) -> list:
    """Every distinct chunk of a tree of placed tensors, in tree order."""
    seen, out = set(), []
    for st in tree_leaves(tree):
        for _, c in st.distinct():
            if id(c) not in seen:
                seen.add(id(c))
                out.append(c)
    return out


def _counts_norm(st: ShardedTensor) -> bool:
    """Whether this process counts its index ranges of ``st`` in the clip
    norm: it is the first process along every spanned axis that does not
    cut ``st`` (the others hold replicas of the same ranges)."""
    layout = st.mesh.layout
    if layout is None:
        return True
    cut = st.sharding.cut_axes()
    return all(i == 0 for a, i in layout.index.items() if a not in cut)


def apply_update(optimizer, params: dict, grads: dict, opt_state: dict,
                 moments: tuple, reduce_norm=None):
    """AdamW on chunks: ``params`` and ``moments`` (mu, nu) are trees of
    placed tensors with one placement, ``grads`` maps ``id(chunk)`` to its
    gradient, ``opt_state`` holds the step count. Replicas of an index
    range on different devices psum their gradients first; the clip's
    global norm counts each index range once, across processes too
    (``reduce_norm`` sums the processes' squared norms). Returns the
    norm."""
    ps, gs, ms, vs, norm_of = [], [], [], [], []
    for p, m, v in zip(tree_leaves(params), tree_leaves(moments[0]),
                       tree_leaves(moments[1]), strict=True):
        ranges, indices = {}, p.sharding.indices(p.shape)
        counted = _counts_norm(p)
        for place, chunk in p.distinct():
            idx = indices[place]
            ranges.setdefault(tuple((s.start, s.stop) for s in idx),
                              []).append((place, chunk))
        for group in ranges.values():
            g = [grads[id(c)] for _, c in group]
            if len(g) > 1:
                g = psum(g)
            if counted:
                norm_of.append(g[0])
            for (place, c), gi in zip(group, g):
                ps.append(c)
                gs.append(gi)
                ms.append(m.chunks[place])
                vs.append(v.chunks[place])
    return optimizer.update(ps, gs, opt_state, moments=(ms, vs),
                            norm_of=norm_of, reduce_sq=reduce_norm)
