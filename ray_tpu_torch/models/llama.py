"""Llama-3-family transformer in PyTorch.

Port of ``ray_tpu/models/llama.py``. Parameters stay a plain dictionary
with JAX's stacked ``[L, ...]`` block layout, its names (``embedding``,
``blocks.wq``, ..., ``final_norm``, ``lm_head``) and its ``x @ W``
orientation, so weights carry across name for name
(``ray_tpu_torch.convert``). The ``lax.scan`` over layers is a Python loop
over ``unstack_layers``, which every family shares. Attention goes
through ``ops.attention.attention``, which sends a CUDA tensor of a
supported shape to the flash kernels.

Remat (``LlamaConfig.remat``) maps JAX's ``jax.checkpoint`` policies onto
``torch.utils.checkpoint`` per layer (``use_reentrant=False``):
``full`` saves only the layer input; ``dots`` also saves the outputs of
``aten.mm`` (the ``x @ W`` products with no batch dims, not the batched
products of reference attention: JAX's
``checkpoint_dots_with_no_batch_dims``); ``attn`` saves the flash
operator's ``out`` and ``lse`` (or the reference path's ``attn_out``), so
the backward never reruns the flash forward; ``dots_attn`` saves both.
The selective policies go through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``.

``fused_cross_entropy`` is JAX's chunked loss: the LM-head product and
the log-sum-exp run one sequence chunk at a time and the backward
recomputes each chunk's logits, so the ``[b, s, vocab]`` float32 logits
never exist.

``attn_impl="ring"`` runs sequence-parallel ring attention over the
``sp_axis`` of ``mesh`` (``parallel.ring_attention``), the path the
trainer takes when its sharding rules cut the sequence.
``param_logical_axes`` names each parameter's logical axes, which the
sharding rules map onto a mesh (``parallel.sharding``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import dtype_of, resolve_device
from ray_tpu_torch.ops.attention import ATTN_OUT_OP, attention
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_sin_cos
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.ring_attention import ring_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    # remat policy of each layer under autograd: none | full | dots |
    # attn | dots_attn (see the module docstring)
    remat: str = "full"
    tie_embeddings: bool = False

    @property
    def param_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama3_70b() -> LlamaConfig:
    return LlamaConfig(d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       d_ff=28672)


def llama_tiny(vocab_size: int = 512) -> LlamaConfig:
    """Test-size config."""
    return LlamaConfig(
        vocab_size=vocab_size, d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=256, head_dim=32, remat="none",
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical axis annotation tree, mirroring init_params' structure.
    The leading axis of stacked blocks carries the ``layers`` logical
    axis: replicated under the dp/fsdp/tp presets (rules.layers=None) and
    cut over ``pp`` under the pipeline preset, which puts the contiguous
    per-stage layer groups on their stage's places."""
    block = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),       # [L, D, H*hd]
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    axes = {
        "embedding": ("vocab", "embed"),
        "blocks": block,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


class ParamInit:
    """The draws of one ``init_params`` call, shared by the model families:
    normal draws in float32 times a scale (fan-in scaled for ``dense``),
    cast to the parameter's dtype, and constant leaves. A weight of more
    than two dimensions is drawn one trailing matrix at a time, so no
    float32 copy of a whole stack exists. ``generator`` (on ``device``)
    overrides ``seed``. On the meta device the leaves are empty: the
    parameter tree's structure, shapes and dtypes, with no memory (what
    ``convert.params_from_numpy`` checks a tree against)."""

    def __init__(self, dtype: torch.dtype, *, seed: int = 0,
                 generator: torch.Generator | None = None, device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype or self.dtype,
                          device=self.device)
        if out.is_meta:
            return out
        rows = out.reshape(-1, *shape[-2:]) if len(shape) > 2 else out[None]
        for i in range(rows.shape[0]):
            rows[i] = torch.randn(rows.shape[1:], generator=self.generator,
                                  device=self.device,
                                  dtype=torch.float32) * std
        return out

    def dense(self, shape, fan_in: int, dtype=None) -> torch.Tensor:
        return self.normal(shape, fan_in ** -0.5, dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)


def init_params(cfg: LlamaConfig, *, seed: int = 0,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters in the stacked-block layout: fan-in-scaled normal
    draws in float32, cast to the config's dtype (``ParamInit``). The draws
    are not JAX's: carry JAX weights across with
    ``convert.params_from_numpy``."""
    init = ParamInit(cfg.param_dtype, seed=seed, generator=generator,
                     device=device)
    d, n_layers = cfg.d_model, cfg.n_layers
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim

    def dense(shape, fan_in):
        return init.dense((n_layers,) + shape, fan_in)

    params = {"embedding": init.dense((cfg.vocab_size, d), d)}
    params["blocks"] = {
        "attn_norm": init.ones((n_layers, d)),
        "wq": dense((d, qdim), d),
        "wk": dense((d, kvdim), d),
        "wv": dense((d, kvdim), d),
        "wo": dense((qdim, d), qdim),
        "mlp_norm": init.ones((n_layers, d)),
        "w_gate": dense((d, cfg.d_ff), d),
        "w_up": dense((d, cfg.d_ff), d),
        "w_down": dense((cfg.d_ff, d), cfg.d_ff),
    }
    params["final_norm"] = init.ones((d,))
    if not cfg.tie_embeddings:
        params["lm_head"] = init.dense((d, cfg.vocab_size), d)
    return params


def num_params(params: dict) -> int:
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return tree.numel()
    return count(params)


def unstack_layers(blocks: dict):
    """The stacked blocks as one dictionary of weights per layer, each
    stack split once by ``torch.unbind`` (the backward then stacks the
    per-layer gradients in one allocation; indexing ``w[i]`` in the loop
    would make a zero-filled gradient the size of the whole stack for
    every layer)."""
    names = list(blocks)
    for ws in zip(*(torch.unbind(blocks[n]) for n in names)):
        yield dict(zip(names, ws))


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked blocks (views, no copies)."""
    return {name: w[i] for name, w in params["blocks"].items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def mlp_sublayer(cfg, x, p):
    """Pre-norm SwiGLU MLP sublayer; returns the residual-added stream."""
    return x + mlp_out(cfg, x, p)


def mlp_out(cfg, x, p, enter=None):
    """The MLP sublayer's output before the residual add (with a
    tensor-parallel rank's cut of the weights, its partial sum; ``enter``
    applied to the normed input before the column-parallel products)."""
    h = rms_norm(x, p["mlp_norm"], eps=cfg.rms_eps)
    if enter is not None:
        h = enter(h)
    gated = F.silu(h @ p["w_gate"]) * (h @ p["w_up"])
    return gated @ p["w_down"]


def attention_sublayer(cfg, x, p, sin, cos, segment_ids, attn_impl,
                       mesh=None, sp_axis="sp"):
    """Pre-norm attention sublayer; returns the residual-added stream.
    ``attn_impl="ring"`` needs ``mesh`` (with an ``sp_axis`` axis)."""
    return x + attention_out(cfg, x, p, sin, cos, segment_ids, attn_impl,
                             mesh=mesh, sp_axis=sp_axis)


def attention_qkv(cfg, x, p, sin, cos, enter=None):
    """The attention sublayer's q [b, s, n_heads, head_dim] and k, v
    [b, s, n_kv_heads, head_dim], roped (``enter`` as ``attention_out``'s)."""
    b, s, _ = x.shape
    h = rms_norm(x, p["attn_norm"], eps=cfg.rms_eps)
    if enter is not None:
        h = enter(h)
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def attention_out(cfg, x, p, sin, cos, segment_ids, attn_impl, mesh=None,
                  sp_axis="sp", enter=None):
    """The attention sublayer's output before the residual add, over
    ``cfg.n_heads`` q and ``cfg.n_kv_heads`` kv heads (with a
    tensor-parallel rank's cut of the weights and head counts, its
    partial sum; ``enter`` applied to the normed input before the
    column-parallel products). Under ``attn_impl="ring"`` on a ``mesh``
    whose ``sp_axis`` spans processes, ``x`` is this process's chunk of
    the sequence (``sin`` and ``cos`` at its positions)."""
    b, s, _ = x.shape
    q, k, v = attention_qkv(cfg, x, p, sin, cos, enter=enter)
    if attn_impl == "ring":
        if mesh is None:
            raise ValueError(
                "attn_impl='ring' requires mesh= (and an sp mesh axis)")
        if segment_ids is not None:
            raise ValueError("ring attention does not support segment_ids yet")
        attn_out = ring_attention(q, k, v, mesh=mesh, axis=sp_axis,
                                  causal=True)
    else:
        attn_out = attention(q, k, v, causal=True, segment_ids=segment_ids,
                             impl=attn_impl)
    attn_out = attn_out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return attn_out @ p["wo"]


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor, *,
            positions=None, segment_ids=None, attn_impl: str = "auto",
            mesh=None, sp_axis: str = "sp") -> torch.Tensor:
    """Token ids [batch, seq] -> logits [batch, seq, vocab] (float32).
    ``mesh`` is required for ``attn_impl="ring"`` (sequence parallel)."""
    x = forward_hidden(cfg, params, tokens, positions=positions,
                       segment_ids=segment_ids, attn_impl=attn_impl,
                       mesh=mesh, sp_axis=sp_axis)
    return matmul_f32(x, lm_head_weights(cfg, params))


def _block(cfg, x, p, sin, cos, segment_ids, attn_impl, mesh=None,
           sp_axis="sp"):
    """One transformer block: pre-norm attention + SwiGLU MLP."""
    x = attention_sublayer(cfg, x, p, sin, cos, segment_ids, attn_impl,
                           mesh=mesh, sp_axis=sp_axis)
    return mlp_sublayer(cfg, x, p)


# operators whose outputs each selective remat policy saves
# (aten.mm.dtype: matmul_f32's product on the card, which the MoE experts'
# dispatch and combine run; the experts' batched products are aten.bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)
_SAVED_OPS = {
    "dots": _DOTS,
    "attn": (FLASH_FWD_OP, ATTN_OUT_OP),
    "dots_attn": (*_DOTS, FLASH_FWD_OP, ATTN_OUT_OP),
}
REMAT_POLICIES = ("none", "full", *_SAVED_OPS)


def remat_block(cfg, block, policies=REMAT_POLICIES):
    """``block`` wrapped in the config's remat policy, one of ``policies``
    (the family's own; a no-op when autograd is off: nothing is saved
    then)."""
    if cfg.remat not in policies:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; expected one "
                         f"of {policies}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    if cfg.remat == "full":
        return partial(checkpoint, block, use_reentrant=False)
    return partial(checkpoint, block, use_reentrant=False,
                   context_fn=partial(create_selective_checkpoint_contexts,
                                      list(_SAVED_OPS[cfg.remat])))


def forward_hidden(cfg, params, tokens, *, positions=None, segment_ids=None,
                   attn_impl="auto", mesh=None,
                   sp_axis="sp") -> torch.Tensor:
    """Token ids -> final normalized hidden states [b, s, d] (the input to
    the LM head; split out so losses can fuse the head product)."""
    s = tokens.shape[1]
    x = params["embedding"][tokens]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None, :]
    sin, cos = rope_sin_cos(positions, cfg.head_dim, theta=cfg.rope_theta)
    body = remat_block(cfg, partial(_block, cfg, sin=sin, cos=cos,
                                    segment_ids=segment_ids,
                                    attn_impl=attn_impl, mesh=mesh,
                                    sp_axis=sp_axis))
    for p in unstack_layers(params["blocks"]):
        x = body(x, p)
    return rms_norm(x, params["final_norm"], eps=cfg.rms_eps)


def lm_head_weights(cfg, params) -> torch.Tensor:
    """The LM head matrix [d, vocab], honouring tie_embeddings."""
    return (params["embedding"].T if cfg.tie_embeddings
            else params["lm_head"])


def _target_logits(logits: list, targets, offsets,
                   reduce=collectives.psum) -> list:
    """Each row's logit at its target, from logits cut along the vocab
    (piece ``i`` holds columns from ``offsets[i]``): each piece's own
    where it holds the target, zero elsewhere, summed over the pieces
    with ``reduce``."""
    out = []
    for x, off in zip(logits, offsets):
        local = targets.to(x.device) - off
        own = (local >= 0) & (local < x.shape[-1])
        out.append(torch.where(
            own, x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])
            [..., 0], 0.0))
    return reduce(out)


def _target_reduce(reduce, group):
    """The sum of the pieces' target logits: the rank-list ``psum`` on
    one process, the loss's ``reduce`` across processes."""
    return collectives.psum if group is None else reduce


def _offsets(heads, group=None) -> list:
    """The first vocab column of each head piece (across processes, this
    process's pieces, the run of ``group``'s ranks at its index)."""
    widths = [h.shape[-1] for h in heads]
    base = 0 if group is None else group.index * len(widths) * widths[0]
    return [base + sum(widths[:i]) for i in range(len(widths))]


class _FusedCrossEntropy(torch.autograd.Function):
    """Mean cross-entropy over rows x [n, d] against the head [d, vocab],
    one chunk of rows at a time. The head may come cut along the vocab:
    ``pieces`` is (x, head piece) pairs, piece ``i`` on its own device
    holding the next columns, and the log-sum-exp combines the pieces'
    with ``reduce`` (``collectives.logsumexp``; across processes the
    pieces are those of ``group``'s processes, a run here), so no piece is
    gathered.
    The forward keeps each row's log-sum-exp (n floats a piece) and no
    logits; the backward recomputes a chunk's logits, turns them into
    their gradient in place and runs the two transposed products, summing
    each head piece's gradient over chunks in its own dtype."""

    @staticmethod
    def forward(ctx, targets, mask, chunk, z_loss, reduce, group, *pieces):
        xs, heads = pieces[0::2], pieces[1::2]
        offsets = _offsets(heads, group)
        n = xs[0].shape[0]
        lses = [torch.empty(n, dtype=torch.float32, device=x.device)
                for x in xs]
        total = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            logits = [matmul_f32(x[c0:c1], h) for x, h in zip(xs, heads)]
            for out, lse in zip(lses, collectives.logsumexp(
                    logits, reduce=reduce, group=group)):
                out[c0:c1] = lse
            lse = lses[0][c0:c1]
            nll = lse - _target_logits(logits, targets[c0:c1], offsets,
                                       _target_reduce(reduce, group))[0]
            if z_loss > 0.0:
                nll = nll + z_loss * lse.square()
            total += (nll * mask[c0:c1]).sum()
        count = mask.sum().clamp(min=1.0)
        ctx.save_for_backward(targets, mask, count, *pieces, *lses)
        ctx.chunk, ctx.z_loss, ctx.n_pieces = chunk, z_loss, len(xs)
        ctx.group = group
        return total / count

    @staticmethod
    def backward(ctx, g):
        targets, mask, count, *rest = ctx.saved_tensors
        k = ctx.n_pieces
        pieces, lses = rest[:2 * k], rest[2 * k:]
        xs, heads = pieces[0::2], pieces[1::2]
        n = xs[0].shape[0]
        # d loss / d logits of row i = w_i ((1 + 2 z lse_i) softmax_i - onehot_i)
        w = mask * (g / count)
        grads = []
        for x, head, lse, off in zip(xs, heads, lses,
                                     _offsets(heads, ctx.group)):
            dev = x.device
            wk, tk = w.to(dev), targets.to(dev) - off
            own = (tk >= 0) & (tk < head.shape[-1])
            tk = tk.clamp(0, head.shape[-1] - 1)
            dx = torch.empty_like(x)
            dhead = torch.zeros_like(head)
            for c0 in range(0, n, ctx.chunk):
                c1 = min(c0 + ctx.chunk, n)
                grad = matmul_f32(x[c0:c1], head)
                grad.sub_(lse[c0:c1, None]).exp_()
                coef = wk[c0:c1] * (1.0 + 2.0 * ctx.z_loss * lse[c0:c1])
                grad.mul_(coef[:, None])
                rows = torch.arange(c1 - c0, device=dev)
                # the target's one-hot, on the piece that holds it
                grad[rows, tk[c0:c1]] -= wk[c0:c1] * own[c0:c1]
                grad = grad.to(x.dtype)
                dx[c0:c1] = grad @ head.T
                dhead.addmm_(x[c0:c1].T, grad)
            grads += [dx, dhead]
        return (None,) * 6 + tuple(grads)


def fused_cross_entropy(cfg, params, hidden, targets, *, mask=None,
                        chunk: int = 1024, z_loss: float = 0.0):
    """Cross-entropy without the full [b, s, vocab] float32 logits: the
    LM-head product and the log-sum-exp run per chunk of ``chunk`` rows,
    and the backward recomputes them (about twice the head's FLOPs for
    vocab / chunk times less logits memory). hidden [b, s, d] from
    ``forward_hidden``; targets [b, s] int (-1 = padding); mask [b, s] in
    {0, 1}, by default ``targets >= 0``."""
    return vocab_parallel_cross_entropy(
        [hidden], [lm_head_weights(cfg, params)], targets, mask=mask,
        chunk=chunk, z_loss=z_loss)


def vocab_parallel_cross_entropy(hiddens: list, heads: list, targets, *,
                                 mask=None, chunk: int | None = 1024,
                                 z_loss: float = 0.0,
                                 reduce=collectives.psum, group=None):
    """The mean cross-entropy against an LM head cut along the vocab over
    ranks, none of it gathered: rank ``i`` holds ``hiddens[i]`` [b, s, d]
    (one tensor, on each rank's device) and ``heads[i]`` [d, V_i], the
    next V_i columns of the head. Each rank computes its float32 logits;
    the log-sum-exp sums the ranks' exponentials with ``reduce``, and the
    target's logit comes from the rank that holds it. ``chunk`` rows at a
    time as ``fused_cross_entropy`` (the same function for one rank), or
    the whole logits under autograd with ``chunk=None``. targets [b, s]
    int (-1 = padding); mask as ``fused_cross_entropy``'s. The loss is on
    the first rank's device. Across processes (``group``: the tp axis'
    ``AxisGroup``) each process holds its run of the pieces, at its index
    of the group, and ``reduce`` sums over them and the group."""
    n = targets.numel()
    flat = targets.reshape(n)
    mk = ((flat >= 0) if mask is None else mask.reshape(n)).float()
    flat = flat.clamp(min=0).long()
    xs = [h.reshape(n, -1) for h in hiddens]
    if chunk is not None:
        return _FusedCrossEntropy.apply(
            flat, mk, chunk, float(z_loss), reduce, group,
            *(t for pair in zip(xs, heads) for t in pair))
    logits = [matmul_f32(x, h) for x, h in zip(xs, heads)]
    lse = collectives.logsumexp(logits, reduce=reduce, group=group)[0]
    nll = lse - _target_logits(logits, flat, _offsets(heads, group),
                               _target_reduce(reduce, group))[0]
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    return (nll * mk).sum() / mk.sum().clamp(min=1.0)


def cross_entropy_loss(logits, targets, *, mask=None,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross-entropy in float32 with an optional z-loss.
    ``mask`` [batch, seq] in {0, 1} excludes padding from the mean."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - target_logit
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
