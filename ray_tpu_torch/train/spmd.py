"""The per-rank training step on a placed state: by hand, what GSPMD does
in ``JaxTrainer._step`` (``ray_tpu/train/trainer.py:308``).

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
- **The per-layer gathers of Llama run inside the remat'd block**
  (``llama.remat_block``), so the backward gathers again, as FSDP does:
  under ``full`` remat no gathered layer outlives its layer (at
  Llama-3-8B, keeping the gathered weights of all 32 layers until the
  backward would not fit beside the 64 GB state).
- **tp (Llama).** Megatron, as ``TP_RULES`` place the weights: ``wq``,
  ``wk`` and ``wv`` are cut by q heads and kv heads, ``w_gate`` and
  ``w_up`` by ``mlp``, so each tp rank runs attention on its own
  ``n_heads/tp`` q heads and ``n_kv_heads/tp`` kv heads (the flash
  kernels at those head counts); ``wo`` and ``w_down`` are cut on their
  input dimension and their outputs are ``psum``med over tp. The
  vocab-cut embedding and LM head are all-gathered before use, as fsdp
  leaves are (a vocab-parallel loss is later work). GPT and BERT have no
  tp block yet.
- **Replicated work is done once.** What every rank of an axis computes
  alike in JAX (the embedding lookup and the loss over the tp ranks, all
  work over an axis that cuts neither the batch nor a weight) runs once,
  at the axis' first rank. Under ring attention the ranks of the
  sequence axis run the attention (``parallel.ring_attention`` on the
  mesh's sp ranks at that place); the rest of the layer runs once over
  the whole sequence, as on the port's ring path of slice 6.
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

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_sin_cos
from ray_tpu_torch.parallel.collectives import all_gather, psum
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.sharding import (ShardedTensor, _axes_of,
                                             batch_sharding, device_put)
from ray_tpu_torch.train.optim import tree_leaves

# the two sums of a tensor-parallel block, after wo and after w_down
# (module attributes, so a fault check can replace one)
reduce_attention = psum
reduce_mlp = psum


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
    share the result."""

    def __init__(self):
        self._memo = {}

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
                for k in range(st.mesh.shape[ax])]
        xs = [self._at(st, steps, level - 1, c) for c in ring]
        key = (tuple(map(id, xs)), d)
        if key not in self._memo:
            # the inputs stay referenced, so their ids stay theirs
            self._memo[key] = (all_gather(xs, gather_axis=d), xs)
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


class RankStep:
    """The loss of one step over the ranks of a mesh, from a placed
    parameter tree (``ShardedTensor`` leaves). ``loss(params, batch)``
    is differentiable in every chunk; ``stage_fn``, ``embed_fn`` and
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
        self.data_axes = tuple(
            a for a in _axes_of(batch_sharding(mesh, rules, 2,
                                               shard_seq=False).spec[0])
            if mesh.shape[a] > 1)
        if self.tp is not None:
            n = mesh.shape[self.tp]
            if family is not llama:
                raise NotImplementedError(
                    f"{family.__name__} has no tensor-parallel block yet "
                    f"(a {self.tp} axis of {n}): it comes with slice 9 of "
                    "the port (ROADMAP Queue A item 3); dp and fsdp work")
            if cfg.n_heads % n or cfg.n_kv_heads % n:
                raise ValueError(f"{cfg.n_heads} q and {cfg.n_kv_heads} kv "
                                 f"heads do not divide over {self.tp}={n}")
            self.tp_cfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // n,
                n_kv_heads=cfg.n_kv_heads // n)

    # --- the ranks ---

    def units(self, mesh: Mesh, base: dict | None = None) -> list:
        """The data ranks of ``mesh``, each as the coordinates of its tp
        ranks (one place when there is no tp axis). ``base`` fixes other
        axes (a pipeline stage); the rest sit at 0."""
        names = mesh.axis_names
        data = [a for a in self.data_axes if a in names]
        sizes = [mesh.shape[a] for a in data]
        n_tp = mesh.shape[self.tp] if self.tp in names else 1
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

    def chunks_of(self, placed: ShardedTensor, units: list) -> list:
        """A batch placed by ``batch_sharding``: the chunk at each data
        rank's first place."""
        return [placed.chunks[_flat(self.mesh, p[0])] for p in units]

    def cut(self, x: torch.Tensor, units: list) -> list:
        """``x`` (a pipeline microbatch) cut over the data ranks as
        ``batch_sharding`` cuts a batch."""
        return self.chunks_of(device_put(x, batch_sharding(
            self.mesh, self.rules, x.dim(), shard_seq=False)), units)

    def _ring_mesh(self, mesh: Mesh, coords: tuple) -> Mesh | None:
        if self.attn_impl != "ring":
            return None
        devs = mesh.axis_devices(self.sp_axis,
                                 at=dict(zip(mesh.axis_names, coords)))
        grid = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            grid[i] = d
        return Mesh(grid, (self.sp_axis,))

    # --- Llama ---

    def _rope(self, s: int, devices) -> dict:
        out = {}
        for dev in devices:
            if str(dev) not in out:
                positions = torch.arange(s, dtype=torch.int32,
                                         device=dev)[None, :]
                out[str(dev)] = rope_sin_cos(positions, self.cfg.head_dim,
                                             theta=self.cfg.rope_theta)
        return out

    def _layer(self, xs_units, layer: dict, *, mesh, units, rope):
        """One transformer block on every rank: each rank's weights
        gathered (all but tp) inside the call, the tp ranks' partial sums
        psummed."""
        g = _Gathers()
        keep = (self.tp,) if self.tp else ()
        out = []
        for places, xs in zip(units, xs_units):
            ps = [{n: g.local(st, c, keep) for n, st in layer.items()}
                  for c in places]
            ring = [dict(mesh=self._ring_mesh(mesh, c),
                         sp_axis=self.sp_axis) for c in places]
            sc = [rope[str(x.device)] for x in xs]
            if len(places) == 1:
                out.append([llama._block(self.cfg, xs[0], ps[0], *sc[0],
                                         None, self.attn_impl, **ring[0])])
                continue
            parts = [llama.attention_out(self.tp_cfg, x, p, *sin_cos, None,
                                         self.attn_impl, **r)
                     for x, p, sin_cos, r in zip(xs, ps, sc, ring)]
            xs = [x + y for x, y in zip(xs, reduce_attention(parts))]
            parts = [llama.mlp_out(self.cfg, x, p) for x, p in zip(xs, ps)]
            out.append([x + y for x, y in zip(xs, reduce_mlp(parts))])
        return out

    def run_layers(self, blocks: dict, xs_units: list, units: list,
                   mesh: Mesh) -> list:
        """Every layer of ``blocks`` (placed stacked tensors, or lists of
        one placed tensor per layer) over the ranks, each through the
        config's remat policy."""
        rope = self._rope(xs_units[0][0].shape[1],
                          [x.device for xs in xs_units for x in xs])
        per_layer = {n: st if isinstance(st, list) else unbind_layers(st)
                     for n, st in blocks.items()}
        body = llama.remat_block(self.cfg, partial(
            self._layer, mesh=mesh, units=units, rope=rope))
        n_layers = len(next(iter(per_layer.values())))
        for i in range(n_layers):
            xs_units = body(xs_units, {n: ls[i] for n, ls in
                                       per_layer.items()})
        return xs_units

    def _embed(self, g: _Gathers, embedding: ShardedTensor, tokens: list,
               units: list, mesh: Mesh) -> list:
        """Each data rank's embedded tokens, on each of its tp ranks."""
        out = []
        for places, tok in zip(units, tokens):
            emb = g.local(embedding, places[0])
            x = emb[tok.to(emb.device)]
            out.append([x.to(_device(mesh, c)) for c in places])
        return out

    def _head(self, g: _Gathers, params: dict, places: list) -> torch.Tensor:
        name = "embedding" if self.cfg.tie_embeddings else "lm_head"
        w = g.local(params[name], places[0])
        return w.T if self.cfg.tie_embeddings else w

    def llama_loss(self, params: dict, batch: ShardedTensor):
        cfg, mesh = self.cfg, self.mesh
        units = self.units(mesh)
        chunks = self.chunks_of(batch, units)
        g = _Gathers()
        xs = self._embed(g, params["embedding"], [c[:, :-1] for c in chunks],
                         units, mesh)
        xs = self.run_layers(params["blocks"], xs, units, mesh)
        parts = []
        for places, x, c in zip(units, xs, chunks):
            targets = c[:, 1:].to(x[0].device)
            mask = (targets != -1).float()
            h = rms_norm(x[0], g.local(params["final_norm"], places[0]),
                         eps=cfg.rms_eps)
            head = self._head(g, params, places)
            if self.fused_loss:
                # lm_head_weights of this tree is the gathered head
                io = {"embedding": head.T} if cfg.tie_embeddings \
                    else {"lm_head": head}
                loss = llama.fused_cross_entropy(
                    cfg, io, h, targets, mask=mask, chunk=self.loss_chunk)
            else:
                loss = llama.cross_entropy_loss(
                    matmul_f32(h, head), targets.clamp(min=0), mask=mask)
            parts.append((loss, mask.sum()))
        return _combine(parts)

    # --- the other families, and the loss_fn hook ---

    def _gathered(self, g: _Gathers, params, coords: tuple):
        if isinstance(params, dict):
            return {k: self._gathered(g, v, coords)
                    for k, v in params.items()}
        return g.local(params, coords)

    def family_loss(self, params: dict, batch: ShardedTensor):
        """A causal LM other than Llama: each data rank runs the family's
        forward on its chunk with the parameters gathered."""
        units = self.units(self.mesh)
        g = _Gathers()
        parts = []
        for places, c in zip(units, self.chunks_of(batch, units)):
            inputs, targets = c[:, :-1], c[:, 1:]
            mask = (targets != -1).float()
            logits = self.family.forward(
                self.cfg, self._gathered(g, params, places[0]), inputs)
            parts.append((llama.cross_entropy_loss(
                logits, targets.clamp(min=0), mask=mask), mask.sum()))
        return _combine(parts)

    def hook_loss(self, params: dict, batch):
        """The ``loss_fn`` hook on the whole batch, the parameters
        gathered at the first place."""
        home = tuple(0 for _ in self.mesh.axis_names)
        batch = {k: v.unshard() for k, v in batch.items()} \
            if isinstance(batch, dict) else batch.unshard()
        return self.loss_fn(self.cfg, self._gathered(_Gathers(), params,
                                                     home), batch)

    def loss(self, params: dict, batch):
        """The loss of placed ``params`` on a batch placed by
        ``batch_sharding`` (a dictionary of them for the hook)."""
        if self.loss_fn is not None:
            return self.hook_loss(params, batch)
        if self.family is llama:
            return self.llama_loss(params, batch)
        return self.family_loss(params, batch)

    # --- the 1F1B pipeline's functions (Llama) ---

    def stage_fn(self, blocks: dict, xs_units: list) -> list:
        """One pipeline stage: its layers (``blocks``: one placed tensor
        per layer and leaf, on the stage's mesh) over the stage's ranks,
        the inputs moved there."""
        mesh = next(iter(blocks.values()))[0].mesh
        units = self.units(mesh)
        xs_units = [[x.to(_device(mesh, c)) for x, c in zip(xs, places)]
                    for xs, places in zip(xs_units, units)]
        return self.run_layers(blocks, xs_units, units, mesh)

    def embed_fn(self, pp_axis: str):
        """(io params, tokens [mb, s]) -> each data rank's embedded
        microbatch chunk, at the first stage."""
        def embed(io, tokens):
            units = self.units(self.mesh, {pp_axis: 0})
            return self._embed(_Gathers(), io["embedding"],
                               self.cut(tokens, units), units,
                               self.mesh)
        return embed

    def head_fn(self, pp_axis: str):
        """(io params, the last stage's activations, targets, mask) ->
        (loss sum, weight sum) over the data ranks: final norm, LM head
        and masked cross-entropy sums (JAX's ``make_llama_head_fn``),
        through the chunked loss (``llama.fused_cross_entropy``, chunks of
        ``loss_chunk`` rows) so that no microbatch's [mb, s, vocab]
        float32 logits exist at once (2 GB for 2 x 2048 tokens at
        Llama-3's vocab, beside a 64 GB state)."""
        cfg = self.cfg

        def head_fn(io, ys, tgt, msk):
            units = self.units(self.mesh,
                               {pp_axis: self.mesh.shape[pp_axis] - 1})
            g = _Gathers()
            loss = weight = None
            for places, y, t, mk in zip(units, ys, self.cut(tgt, units),
                                        self.cut(msk, units)):
                dev = _device(self.mesh, places[0])
                h = rms_norm(y[0].to(dev), g.local(io["final_norm"],
                                                   places[0]),
                             eps=cfg.rms_eps)
                head = self._head(g, io, places)
                mk = mk.to(dev).float()
                ws = mk.sum()
                mean = llama.fused_cross_entropy(
                    cfg, {"embedding": head.T} if cfg.tie_embeddings
                    else {"lm_head": head}, h, t.to(dev), mask=mk,
                    chunk=self.loss_chunk)
                ls = mean * ws.clamp(min=1.0)
                loss = ls if loss is None else loss + ls.to(loss.device)
                weight = ws if weight is None else \
                    weight + ws.to(weight.device)
            return loss, weight
        return head_fn


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


def apply_update(optimizer, params: dict, grads: dict, opt_state: dict,
                 moments: tuple):
    """AdamW on chunks: ``params`` and ``moments`` (mu, nu) are trees of
    placed tensors with one placement, ``grads`` maps ``id(chunk)`` to its
    gradient, ``opt_state`` holds the step count. Replicas of an index
    range on different devices psum their gradients first; the clip's
    global norm counts each index range once. Returns the norm."""
    ps, gs, ms, vs, norm_of = [], [], [], [], []
    for p, m, v in zip(tree_leaves(params), tree_leaves(moments[0]),
                       tree_leaves(moments[1]), strict=True):
        ranges, indices = {}, p.sharding.indices(p.shape)
        for place, chunk in p.distinct():
            idx = indices[place]
            ranges.setdefault(tuple((s.start, s.stop) for s in idx),
                              []).append((place, chunk))
        for group in ranges.values():
            g = [grads[id(c)] for _, c in group]
            if len(g) > 1:
                g = psum(g)
            norm_of.append(g[0])
            for (place, c), gi in zip(group, g):
                ps.append(c)
                gs.append(gi)
                ms.append(m.chunks[place])
                vs.append(v.chunks[place])
    return optimizer.update(ps, gs, opt_state, moments=(ms, vs),
                            norm_of=norm_of)
