"""GPT-2-family transformer in PyTorch.

Port of ``ray_tpu/models/gpt.py``: learned absolute position embeddings,
pre-LN LayerNorm blocks with biases, multi-head attention (no GQA), a
GELU MLP and an LM head tied to the embedding, with float32 logits.
Parameters keep JAX's names and stacked ``[L, ...]`` layout (carry JAX
weights across with ``convert.params_from_numpy``). ``jax.nn.gelu``
defaults to the tanh approximation, so the port uses
``F.gelu(..., approximate="tanh")``. Attention goes through
``ops.attention.attention``: on the card, causal with no segment ids, the
flash kernels. Remat: ``none`` or ``full`` per layer.
``param_logical_axes`` names each parameter's logical axes, as JAX's
(same names as Llama's).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import dtype_of
from ray_tpu_torch.models.llama import (ParamInit, cross_entropy_loss,
                                        num_params, remat_block,
                                        unstack_layers)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.norms import layer_norm

__all__ = ["GPTConfig", "gpt2_small", "gpt2_xl", "gpt_tiny", "init_params",
           "forward", "cross_entropy_loss", "num_params",
           "param_logical_axes", "REMAT_POLICIES"]

REMAT_POLICIES = ("none", "full")


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    ln_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "none"           # "none" | "full"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def gpt2_small() -> GPTConfig:
    return GPTConfig()


def gpt2_xl() -> GPTConfig:
    return GPTConfig(d_model=1600, n_layers=48, n_heads=25, d_ff=6400,
                     remat="full")


def gpt_tiny(vocab_size: int = 512) -> GPTConfig:
    """Test-size config."""
    return GPTConfig(vocab_size=vocab_size, max_seq_len=128, d_model=128,
                     n_layers=2, n_heads=4, d_ff=256)


def param_logical_axes(cfg: GPTConfig) -> dict:
    """Logical axis annotation tree, mirroring init_params' structure."""
    block = {
        "ln1_w": ("layers", "embed"),
        "ln1_b": ("layers", "embed"),
        "wqkv": ("layers", "embed", "heads"),
        "bqkv": ("layers", "heads"),
        "wo": ("layers", "heads", "embed"),
        "bo": ("layers", "embed"),
        "ln2_w": ("layers", "embed"),
        "ln2_b": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
    }
    return {
        "embedding": ("vocab", "embed"),
        "pos_embedding": (None, "embed"),
        "blocks": block,
        "final_ln_w": ("embed",),
        "final_ln_b": ("embed",),
    }


def init_params(cfg: GPTConfig, *, seed: int = 0,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (``llama.ParamInit``): fan-in-scaled normals cast
    to the config's dtype, biases 0, LayerNorm scales 1; the position
    table at a tenth of the fan-in scale, as JAX draws it."""
    init = ParamInit(cfg.param_dtype, seed=seed, generator=generator,
                     device=device)
    d, n_layers = cfg.d_model, cfg.n_layers

    def dense(shape, fan_in):
        return init.dense((n_layers,) + shape, fan_in)

    blocks = {
        "ln1_w": init.ones((n_layers, d)),
        "ln1_b": init.zeros((n_layers, d)),
        "wqkv": dense((d, 3 * d), d),
        "bqkv": init.zeros((n_layers, 3 * d)),
        "wo": dense((d, d), d),
        "bo": init.zeros((n_layers, d)),
        "ln2_w": init.ones((n_layers, d)),
        "ln2_b": init.zeros((n_layers, d)),
        "w_up": dense((d, cfg.d_ff), d),
        "b_up": init.zeros((n_layers, cfg.d_ff)),
        "w_down": dense((cfg.d_ff, d), cfg.d_ff),
        "b_down": init.zeros((n_layers, d)),
    }
    return {
        "embedding": init.dense((cfg.vocab_size, d), d),
        "pos_embedding": init.normal((cfg.max_seq_len, d), 0.1 * d ** -0.5),
        "blocks": blocks,
        "final_ln_w": init.ones((d,)),
        "final_ln_b": init.zeros((d,)),
    }


def _block(cfg: GPTConfig, x, p, segment_ids, attn_impl):
    b, s, d = x.shape
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], eps=cfg.ln_eps)
    qkv = h @ p["wqkv"] + p["bqkv"]
    q, k, v = (t.reshape(b, s, cfg.n_heads, cfg.head_dim)
               for t in qkv.split(d, dim=-1))
    attn_out = attention(q, k, v, causal=True, segment_ids=segment_ids,
                         impl=attn_impl)
    x = x + attn_out.reshape(b, s, d) @ p["wo"] + p["bo"]
    h = layer_norm(x, p["ln2_w"], p["ln2_b"], eps=cfg.ln_eps)
    up = F.gelu(h @ p["w_up"] + p["b_up"], approximate="tanh")
    return x + up @ p["w_down"] + p["b_down"]


def forward(cfg: GPTConfig, params: dict, tokens: torch.Tensor, *,
            positions=None, segment_ids=None,
            attn_impl: str = "auto") -> torch.Tensor:
    """Token ids [b, s] -> logits [b, s, vocab] (float32, tied head)."""
    s = tokens.shape[1]
    if s > cfg.max_seq_len:
        # learned absolute positions: an index past the table is an error
        raise ValueError(
            f"sequence length {s} exceeds max_seq_len={cfg.max_seq_len}")
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]
    x = params["embedding"][tokens] + params["pos_embedding"][positions]
    body = remat_block(cfg, partial(_block, cfg, segment_ids=segment_ids,
                                    attn_impl=attn_impl), REMAT_POLICIES)
    for p in unstack_layers(params["blocks"]):
        x = body(x, p)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                   eps=cfg.ln_eps)
    return matmul_f32(x, params["embedding"].T)
