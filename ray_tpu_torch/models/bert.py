"""BERT-family bidirectional encoder in PyTorch.

Port of ``ray_tpu/models/bert.py``: learned absolute positions and
token-type embeddings, post-LN blocks (sublayer, residual add, then
LayerNorm), a GELU MLP (tanh approximation, ``jax.nn.gelu``'s default)
and the MLM head tied to the embedding, with a float32 ``mlm_bias`` in a
bf16 model. The padding mask goes to attention as ``segment_ids``: pad
tokens are segment 0 and still attend to each other, as in JAX.
Attention is non-causal with segment ids, so ``attention(impl="auto")``
takes the reference path on the card as on the TPU: no kernel runs here.
Remat: ``none`` or ``full`` per layer. ``param_logical_axes`` names each
parameter's logical axes, as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import dtype_of
from ray_tpu_torch.models.llama import (ParamInit, num_params, remat_block,
                                        unstack_layers)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.norms import layer_norm

__all__ = ["BertConfig", "bert_base", "bert_large", "bert_tiny",
           "init_params", "encode", "mlm_logits", "mlm_loss", "num_params",
           "param_logical_axes", "REMAT_POLICIES"]

REMAT_POLICIES = ("none", "full")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_seq_len: int = 512
    type_vocab_size: int = 2
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    ln_eps: float = 1e-12
    dtype: str = "bfloat16"
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096,
                      remat="full")


def bert_tiny(vocab_size: int = 512) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, max_seq_len=128, d_model=128,
                      n_layers=2, n_heads=4, d_ff=256)


def param_logical_axes(cfg: BertConfig) -> dict:
    """Logical axis annotation tree, mirroring init_params' structure."""
    block = {
        "wqkv": ("layers", "embed", "heads"),
        "bqkv": ("layers", "heads"),
        "wo": ("layers", "heads", "embed"),
        "bo": ("layers", "embed"),
        "ln1_w": ("layers", "embed"),
        "ln1_b": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
        "ln2_w": ("layers", "embed"),
        "ln2_b": ("layers", "embed"),
    }
    return {
        "embedding": ("vocab", "embed"),
        "pos_embedding": (None, "embed"),
        "type_embedding": (None, "embed"),
        "emb_ln_w": ("embed",),
        "emb_ln_b": ("embed",),
        "blocks": block,
        "mlm_dense_w": ("embed", "embed"),
        "mlm_dense_b": ("embed",),
        "mlm_ln_w": ("embed",),
        "mlm_ln_b": ("embed",),
        "mlm_bias": ("vocab",),
    }


def init_params(cfg: BertConfig, *, seed: int = 0,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (``llama.ParamInit``): fan-in-scaled normals cast
    to the config's dtype (the position and type tables at a tenth of that
    scale, as JAX draws them), biases 0, LayerNorm scales 1, and
    ``mlm_bias`` zeros in float32 whatever the dtype."""
    init = ParamInit(cfg.param_dtype, seed=seed, generator=generator,
                     device=device)
    d, n_layers = cfg.d_model, cfg.n_layers

    def dense(shape, fan_in):
        return init.dense((n_layers,) + shape, fan_in)

    blocks = {
        "wqkv": dense((d, 3 * d), d),
        "bqkv": init.zeros((n_layers, 3 * d)),
        "wo": dense((d, d), d),
        "bo": init.zeros((n_layers, d)),
        "ln1_w": init.ones((n_layers, d)),
        "ln1_b": init.zeros((n_layers, d)),
        "w_up": dense((d, cfg.d_ff), d),
        "b_up": init.zeros((n_layers, cfg.d_ff)),
        "w_down": dense((cfg.d_ff, d), cfg.d_ff),
        "b_down": init.zeros((n_layers, d)),
        "ln2_w": init.ones((n_layers, d)),
        "ln2_b": init.zeros((n_layers, d)),
    }
    return {
        "embedding": init.dense((cfg.vocab_size, d), d),
        "pos_embedding": init.normal((cfg.max_seq_len, d), 0.1 * d ** -0.5),
        "type_embedding": init.normal((cfg.type_vocab_size, d),
                                      0.1 * d ** -0.5),
        "emb_ln_w": init.ones((d,)),
        "emb_ln_b": init.zeros((d,)),
        "blocks": blocks,
        "mlm_dense_w": init.dense((d, d), d),
        "mlm_dense_b": init.zeros((d,)),
        "mlm_ln_w": init.ones((d,)),
        "mlm_ln_b": init.zeros((d,)),
        "mlm_bias": init.zeros((cfg.vocab_size,), dtype=torch.float32),
    }


def _block(cfg: BertConfig, x, p, attn_mask, attn_impl):
    """Post-LN block: sublayer -> residual add -> LayerNorm."""
    b, s, d = x.shape
    qkv = x @ p["wqkv"] + p["bqkv"]
    q, k, v = (t.reshape(b, s, cfg.n_heads, cfg.head_dim)
               for t in qkv.split(d, dim=-1))
    # bidirectional; padding masked through segment ids (pad tokens are
    # segment 0, real ones 1: cross-segment pairs are masked)
    attn_out = attention(q, k, v, causal=False, segment_ids=attn_mask,
                         impl=attn_impl)
    x = layer_norm(x + attn_out.reshape(b, s, d) @ p["wo"] + p["bo"],
                   p["ln1_w"], p["ln1_b"], eps=cfg.ln_eps)
    up = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return layer_norm(x + up @ p["w_down"] + p["b_down"],
                      p["ln2_w"], p["ln2_b"], eps=cfg.ln_eps)


def encode(cfg: BertConfig, params: dict, tokens: torch.Tensor, *,
           attention_mask=None, token_type_ids=None,
           attn_impl: str = "auto") -> torch.Tensor:
    """Token ids [b, s] -> contextual hidden states [b, s, d].
    ``attention_mask`` [b, s] in {0, 1} (1 = real token): a real token
    neither attends to padding nor is attended to by it."""
    s = tokens.shape[1]
    if s > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {s} exceeds max_seq_len={cfg.max_seq_len}")
    positions = torch.arange(s, device=tokens.device)[None, :]
    x = params["embedding"][tokens] + params["pos_embedding"][positions]
    if token_type_ids is not None:
        x = x + params["type_embedding"][token_type_ids]
    x = layer_norm(x, params["emb_ln_w"], params["emb_ln_b"],
                   eps=cfg.ln_eps)
    seg = attention_mask.int() if attention_mask is not None else None
    body = remat_block(cfg, partial(_block, cfg, attn_mask=seg,
                                    attn_impl=attn_impl), REMAT_POLICIES)
    for p in unstack_layers(params["blocks"]):
        x = body(x, p)
    return x


def mlm_logits(cfg: BertConfig, params: dict, hidden) -> torch.Tensor:
    """MLM head: dense, GELU, LayerNorm, then the tied embedding matrix
    with a float32 product, plus the float32 bias."""
    h = F.gelu(hidden @ params["mlm_dense_w"] + params["mlm_dense_b"],
               approximate="tanh")
    h = layer_norm(h, params["mlm_ln_w"], params["mlm_ln_b"],
                   eps=cfg.ln_eps)
    return matmul_f32(h, params["embedding"].T) + params["mlm_bias"]


def mlm_loss(cfg: BertConfig, params: dict, tokens, targets, *,
             attention_mask=None, loss_mask=None,
             attn_impl: str = "auto") -> torch.Tensor:
    """Masked-LM cross-entropy: ``targets`` are the original token ids;
    ``loss_mask`` [b, s] selects the positions the loss covers (the
    standard 15% MLM positions)."""
    hidden = encode(cfg, params, tokens, attention_mask=attention_mask,
                    attn_impl=attn_impl)
    logp = torch.log_softmax(mlm_logits(cfg, params, hidden), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    mask = (torch.ones_like(nll) if loss_mask is None
            else loss_mask.float())
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
