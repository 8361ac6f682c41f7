"""Mixtral-family sparse MoE transformer in PyTorch.

Port of ``ray_tpu/models/mixtral.py``: the Llama skeleton (stacked
``[L, ...]`` blocks, JAX's parameter names, ``x @ W``) with the dense
SwiGLU MLP replaced by the top-2 MoE FFN of ``ops.moe``. The attention
sublayer is Llama's (``llama.attention_sublayer``), so on the card it
goes through the flash kernels, forward and backward.

Remat (``MixtralConfig.remat``): ``none``, ``full`` or ``dots``, on
``llama.remat_block``. JAX's ``dots`` is
``checkpoint_dots_with_no_batch_dims``: it saves the products with no
batch dimension (the projections, and the dispatch and combine products
of ``moe_ffn``) and reruns the experts' per-expert (batched) products.
The port's ``dots`` saves ``aten.mm`` and not ``aten.bmm``, which is the
same split. ``param_logical_axes`` names each parameter's logical axes
(the experts' dimension is ``expert``, cut over ``ep`` by the ``moe``
preset).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from ray_tpu_torch._device import dtype_of
from ray_tpu_torch.models.llama import (ParamInit, attention_sublayer,
                                        cross_entropy_loss, num_params,
                                        remat_block, unstack_layers)
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.moe import moe_ffn
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import rope_sin_cos

__all__ = ["MixtralConfig", "mixtral_8x7b", "mixtral_tiny", "init_params",
           "forward", "loss_fn", "num_params", "param_logical_axes",
           "REMAT_POLICIES"]

REMAT_POLICIES = ("none", "full", "dots")


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    head_dim: int = 128
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "full"

    @property
    def param_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def mixtral_8x7b() -> MixtralConfig:
    return MixtralConfig()


def mixtral_tiny(vocab_size: int = 512) -> MixtralConfig:
    return MixtralConfig(
        vocab_size=vocab_size, d_model=128, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=256, head_dim=32, n_experts=4, top_k=2,
        remat="none",
    )


def param_logical_axes(cfg: MixtralConfig) -> dict:
    """Logical axis annotation tree, mirroring init_params' structure."""
    block = {
        "attn_norm": (None, "embed"),
        "wq": (None, "embed", "heads"),
        "wk": (None, "embed", "kv_heads"),
        "wv": (None, "embed", "kv_heads"),
        "wo": (None, "heads", "embed"),
        "mlp_norm": (None, "embed"),
        "router": (None, "embed", None),          # router stays replicated
        "wi_gate": (None, "expert", "embed", "mlp"),
        "wi_up": (None, "expert", "embed", "mlp"),
        "wo_e": (None, "expert", "mlp", "embed"),
    }
    return {
        "embedding": ("vocab", "embed"),
        "blocks": block,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(cfg: MixtralConfig, *, seed: int = 0,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (``llama.ParamInit``): fan-in-scaled normals cast
    to the config's dtype, except the router, which is float32 whatever
    the dtype (as JAX holds it). Expert weights are drawn one expert
    matrix at a time."""
    init = ParamInit(cfg.param_dtype, seed=seed, generator=generator,
                     device=device)
    d, n_layers, e = cfg.d_model, cfg.n_layers, cfg.n_experts
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim

    def dense(shape, fan_in, dtype=None):
        return init.dense((n_layers,) + shape, fan_in, dtype)

    blocks = {
        "attn_norm": init.ones((n_layers, d)),
        "wq": dense((d, qdim), d),
        "wk": dense((d, kvdim), d),
        "wv": dense((d, kvdim), d),
        "wo": dense((qdim, d), qdim),
        "mlp_norm": init.ones((n_layers, d)),
        "router": dense((d, e), d, dtype=torch.float32),
        "wi_gate": dense((e, d, cfg.d_ff), d),
        "wi_up": dense((e, d, cfg.d_ff), d),
        "wo_e": dense((e, cfg.d_ff, d), cfg.d_ff),
    }
    return {
        "embedding": init.dense((cfg.vocab_size, d), d),
        "blocks": blocks,
        "final_norm": init.ones((d,)),
        "lm_head": init.dense((d, cfg.vocab_size), d),
    }


def _block(cfg: MixtralConfig, x, p, sin, cos, segment_ids, attn_impl):
    b, s, d = x.shape
    x = attention_sublayer(cfg, x, p, sin, cos, segment_ids, attn_impl)
    h = rms_norm(x, p["mlp_norm"], eps=cfg.rms_eps)
    moe_out, aux = moe_ffn(
        h.reshape(b * s, d), p["router"], p["wi_gate"], p["wi_up"],
        p["wo_e"], top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    return x + moe_out.reshape(b, s, d), aux


def forward(cfg: MixtralConfig, params: dict, tokens: torch.Tensor, *,
            segment_ids=None, attn_impl: str = "auto",
            return_aux_loss: bool = False):
    """Token ids [batch, seq] -> logits [batch, seq, vocab] (float32); with
    ``return_aux_loss`` also the summed router load-balancing loss times
    ``aux_loss_weight``."""
    s = tokens.shape[1]
    x = params["embedding"][tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :]
    sin, cos = rope_sin_cos(positions, cfg.head_dim, theta=cfg.rope_theta)
    body = remat_block(cfg, partial(_block, cfg, sin=sin, cos=cos,
                                    segment_ids=segment_ids,
                                    attn_impl=attn_impl), REMAT_POLICIES)
    aux_losses = []
    for p in unstack_layers(params["blocks"]):
        x, aux = body(x, p)
        aux_losses.append(aux)
    x = rms_norm(x, params["final_norm"], eps=cfg.rms_eps)
    logits = matmul_f32(x, params["lm_head"])
    if return_aux_loss:
        return logits, torch.stack(aux_losses).sum() * cfg.aux_loss_weight
    return logits


def loss_fn(cfg: MixtralConfig, params: dict, tokens, targets, *,
            mask=None) -> torch.Tensor:
    """Next-token cross-entropy plus the weighted router aux loss."""
    logits, aux = forward(cfg, params, tokens, return_aux_loss=True)
    return cross_entropy_loss(logits, targets, mask=mask) + aux
