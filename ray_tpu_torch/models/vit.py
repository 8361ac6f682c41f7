"""Vision Transformer (ViT-L/16) in PyTorch.

Port of ``ray_tpu/models/vit.py``: the patch embedding is one product of
the reshaped patches (``patchify``, no convolution), a CLS token and
learned positions, pre-LN encoder blocks, and CLS or mean pooling into a
float32 classification head. Parameters are float32 by default
(``param_dtype``) and keep JAX's names and stacked ``[L, ...]`` layout.
Attention is ``impl="reference"``, as in JAX: non-causal over 197 tokens,
which no kernel of the port takes. ``param_logical_axes`` names each
parameter's logical axes, as JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (ParamInit, num_params,
                                        unstack_layers)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.matmul import matmul_f32
from ray_tpu_torch.ops.norms import layer_norm

__all__ = ["ViTConfig", "vit_tiny", "vit_l16", "init_params", "patchify",
           "forward", "num_params", "param_logical_axes"]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 1000
    ln_eps: float = 1e-6
    param_dtype: torch.dtype = torch.float32
    pool: str = "cls"            # "cls" token or "mean" pooling

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


def vit_tiny(image_size: int = 32, patch_size: int = 8,
             n_classes: int = 10) -> ViTConfig:
    """Test-size config."""
    return ViTConfig(image_size=image_size, patch_size=patch_size,
                     d_model=64, n_layers=2, n_heads=4, d_ff=128,
                     n_classes=n_classes)


def vit_l16() -> ViTConfig:
    """ViT-L/16 (the BASELINE's ViT-L)."""
    return ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


def param_logical_axes(cfg: ViTConfig) -> dict:
    """Logical axis annotation tree, mirroring init_params' structure."""
    block = {
        "ln1_w": ("layers", "embed"),
        "ln1_b": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "heads"),
        "wv": ("layers", "embed", "heads"),
        "wo": ("layers", "heads", "embed"),
        "ln2_w": ("layers", "embed"),
        "ln2_b": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
    }
    return {
        "patch_embed": (None, "embed"),
        "patch_bias": ("embed",),
        "pos_embed": (None, "embed"),
        "cls_token": ("embed",),
        "blocks": block,
        "final_ln_w": ("embed",),
        "final_ln_b": ("embed",),
        "head": ("embed", "vocab"),
        "head_bias": ("vocab",),
    }


def init_params(cfg: ViTConfig, *, seed: int = 0,
                generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (``llama.ParamInit``): fan-in-scaled normals in
    ``param_dtype``, the position table and CLS token at std 0.02, biases
    0, LayerNorm scales 1."""
    init = ParamInit(cfg.param_dtype, seed=seed, generator=generator,
                     device=device)
    d, n_layers = cfg.d_model, cfg.n_layers

    def dense(shape, fan_in):
        return init.dense((n_layers,) + shape, fan_in)

    blocks = {
        "ln1_w": init.ones((n_layers, d)),
        "ln1_b": init.zeros((n_layers, d)),
        "wq": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wo": dense((d, d), d),
        "ln2_w": init.ones((n_layers, d)),
        "ln2_b": init.zeros((n_layers, d)),
        "w_up": dense((d, cfg.d_ff), d),
        "b_up": init.zeros((n_layers, cfg.d_ff)),
        "w_down": dense((cfg.d_ff, d), cfg.d_ff),
        "b_down": init.zeros((n_layers, d)),
    }
    return {
        "patch_embed": init.dense((cfg.patch_dim, d), cfg.patch_dim),
        "patch_bias": init.zeros((d,)),
        "pos_embed": init.normal((cfg.n_patches + 1, d), 0.02),
        "cls_token": init.normal((d,), 0.02),
        "blocks": blocks,
        "final_ln_w": init.ones((d,)),
        "final_ln_b": init.zeros((d,)),
        "head": init.dense((d, cfg.n_classes), d),
        "head_bias": init.zeros((cfg.n_classes,)),
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P·P·C]: a reshape, no convolution."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    if h != cfg.image_size or w != cfg.image_size or c != cfg.channels:
        raise ValueError(
            f"expected [{cfg.image_size},{cfg.image_size},{cfg.channels}] "
            f"images, got {tuple(images.shape[1:])}")
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)          # [B, hp, wp, p, p, c]
    return x.reshape(b, cfg.n_patches, cfg.patch_dim)


def _block(cfg: ViTConfig, x, p):
    """Pre-LN encoder block: MHA and a GELU MLP, both with residuals."""
    b, s, d = x.shape
    h = layer_norm(x, p["ln1_w"], p["ln1_b"], eps=cfg.ln_eps)
    q, k, v = ((h @ p[w]).reshape(b, s, cfg.n_heads, cfg.head_dim)
               for w in ("wq", "wk", "wv"))
    attn = attention(q, k, v, causal=False, impl="reference")
    x = x + attn.reshape(b, s, d) @ p["wo"]
    h = layer_norm(x, p["ln2_w"], p["ln2_b"], eps=cfg.ln_eps)
    h = F.gelu(h @ p["w_up"] + p["b_up"], approximate="tanh")
    return x + (h @ p["w_down"] + p["b_down"])


def forward(cfg: ViTConfig, params: dict,
            images: torch.Tensor) -> torch.Tensor:
    """Images [B, H, W, C] (float; the caller normalizes) -> logits
    [B, n_classes] (float32)."""
    x = patchify(cfg, images).to(params["patch_embed"].dtype)
    x = x @ params["patch_embed"] + params["patch_bias"]   # [B, N, D]
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    for p in unstack_layers(params["blocks"]):
        x = _block(cfg, x, p)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                   eps=cfg.ln_eps)
    pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    return matmul_f32(pooled, params["head"]) + params["head_bias"].float()
