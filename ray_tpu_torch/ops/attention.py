"""Attention ops: GQA/MHA attention with float32 softmax.

Port of ``ray_tpu/ops/attention.py``. ``reference_attention`` is plain
tensor code; ``attention()`` dispatches to the hand-written flash kernels
(``ray_tpu_torch.ops.flash_attention``) by the same gate as the JAX
package, with "the tensor is on CUDA" in place of "the backend is TPU".
The reference path's output passes through ``attn_out``, the save point
of the ``attn``/``dots_attn`` remat policies (JAX names it with
``checkpoint_name(..., "attn_out")``); the flash path's save point is its
forward operator, whose outputs are the backward's residuals.

Conventions: q/k/v are [batch, seq, heads, head_dim]; GQA is expressed by
n_kv_heads < n_heads with n_heads % n_kv_heads == 0.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import flash_attention

F32_MIN = torch.finfo(torch.float32).min


@torch.library.custom_op("ray_tpu_torch::attn_out", mutates_args=())
def attn_out(x: torch.Tensor) -> torch.Tensor:
    """The identity, as an operator that selective checkpointing can save
    (an operator's output may not alias its input, hence the copy)."""
    return x.clone()


attn_out.register_autograd(lambda ctx, g: g)
ATTN_OUT_OP = torch.ops.ray_tpu_torch.attn_out.default


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def reference_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                        logits_soft_cap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Attention with float32 logits and softmax.

    The causal mask is aligned at the bottom right
    (``kpos <= qpos + (skv - sq)``), so a query block sits at the end of
    the kv window as in decoding. ``segment_ids`` ([batch, seq], int)
    masks cross-segment attention, for sequence packing. Masked logits
    take ``finfo(float32).min``, not -inf.
    """
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    n_rep = nh // nkv
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else hd ** -0.5

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)

    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = (kpos <= qpos + (skv - sq))[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), F32_MIN, device=q.device))

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention(q, k, v, *, causal=True, segment_ids=None,
              logits_soft_cap=None, impl: str = "auto"):
    """Dispatching entry point. ``impl``: auto | reference | flash."""
    if impl == "auto":
        impl = ("flash" if _flash_supported(q, segment_ids, logits_soft_cap,
                                            causal) else "reference")
    if impl == "flash":
        if segment_ids is not None or logits_soft_cap is not None:
            raise ValueError(
                "impl='flash' does not support segment_ids/logits_soft_cap "
                "yet; use impl='reference'")
        return flash_attention(q, k, v, causal=causal)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    return attn_out(reference_attention(q, k, v, causal=causal,
                                        segment_ids=segment_ids,
                                        logits_soft_cap=logits_soft_cap))


def _flash_supported(q, segment_ids, logits_soft_cap, causal) -> bool:
    if segment_ids is not None or logits_soft_cap is not None or not causal:
        return False
    if not q.is_cuda:
        return False
    b, s, h, d = q.shape
    return s >= 256 and s % 128 == 0 and d in (64, 128, 256)
